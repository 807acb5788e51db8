"""Gluon ``Parameter``, ``Constant`` and ``ParameterDict`` (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A Parameter holds one ``NDArray`` on one device (the reference's single
logical array; ``list_ctx`` is a veneer). Its tensor is an autograd leaf
once initialized with a grad_req other than ``null``: ``autograd.backward``
writes ``.grad`` under the reference's ``write``/``add``. Shapes may be
deferred: ``initialize()`` then only records the initializer and the
device, and the owning layer finishes the job at its first forward from
the input's shape (``shape_inferred``).

``ParameterDict.save``/``load`` write and read the reference's ``.params``
container (``ndarray/serialization.py``), keyed by parameter name; a
block's ``save_parameters``/``load_parameters`` key it by structural
name. ``Parameter.var()`` is the parameter's symbol variable.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from .. import initializer as _initializer
from ..base import MXNetError, dtype_name, dtype_np
from ..context import current_context
from ..ndarray import NDArray, zeros

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]

class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape was inferred and it was
    initialized."""


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype_np(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data: Optional[NDArray] = None
        self._deferred_init = None  # (init, ctx) captured at initialize()

    # ------------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        self._grad_req = req
        if self._data is not None and req != "null":
            self._data.attach_grad(req)

    def _shape_known(self) -> bool:
        return self.shape is not None and all(s > 0 for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._data is not None and not force_reinit:
            return
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0] if ctx else None  # one logical array
        ctx = ctx or current_context()
        if self.init is not None or init is not None:
            eff_init = _initializer.create(self.init if init is None
                                           else init)
        else:
            eff_init = _initializer.create(default_init or "uniform")
        if not self._shape_known():
            if not self.allow_deferred_init:
                raise ValueError(
                    f"Cannot initialize Parameter {self.name!r}: shape "
                    f"{self.shape} unknown and deferred init not allowed")
            self._deferred_init = (eff_init, ctx)
            return
        self._finish_init(eff_init, ctx)

    def _finish_init(self, init, ctx):
        arr = zeros(self.shape, dtype=dtype_name(self.dtype), ctx=ctx)
        init(self.name, arr)
        self._data = arr
        self._deferred_init = None
        if self._grad_req != "null":
            self._data.attach_grad(self._grad_req)

    def _finish_deferred_init(self, inferred_shape):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                f"Parameter {self.name!r} has unknown shape and was not "
                "initialize()d")
        self.shape = tuple(int(s) for s in inferred_shape)
        init, ctx = self._deferred_init
        self._finish_init(init, ctx)

    def shape_inferred(self, shape):
        """Called by the owning layer at its first forward with the
        actual shape."""
        if self._data is None:
            if self.shape is not None and len(self.shape) == len(shape):
                merged = tuple(int(b) if s in (0, -1, None) else int(s)
                               for s, b in zip(self.shape, shape))
            else:
                merged = tuple(int(s) for s in shape)
            self._finish_deferred_init(merged)

    # ------------------------------------------------------------------
    def data(self, ctx=None) -> NDArray:
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    f"Parameter {self.name!r} deferred-initialized; run a "
                    "forward pass (or set shape) before accessing data()")
            raise RuntimeError(f"Parameter {self.name!r} has not been "
                               "initialized")
        return self._data

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        return [self.data().context]

    @property
    def grad_(self):
        return self.data().grad

    def grad(self, ctx=None) -> NDArray:
        g = self.data().grad
        if g is None:
            raise RuntimeError(f"Parameter {self.name!r} has no gradient "
                               f"(grad_req={self._grad_req!r})")
        return g

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        g = self.data().grad
        if g is not None:
            g[:] = 0

    def set_data(self, data):
        """Set the value: an NDArray, a tensor or a numpy array, cast to
        the parameter's dtype on its device. Before initialization, an
        NDArray also fixes the shape and becomes the data."""
        if self._data is None:
            if isinstance(data, NDArray):
                self.shape = data.shape
                self._data = data.copy()
                if self._grad_req != "null":
                    self._data.attach_grad(self._grad_req)
            return
        _initializer._fill(self._data, data)

    def cast(self, dtype):
        self.dtype = dtype_np(dtype)
        if self._data is not None:
            req = self._grad_req
            self._data = self._data.astype(dtype_name(self.dtype))
            if req != "null":
                self._data.attach_grad(req)

    def reset_ctx(self, ctx):
        if self._data is not None:
            req = self._grad_req
            ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
            self._data = self._data.as_in_context(ctx)
            if req != "null":
                self._data.attach_grad(req)

    def _load_init(self, data: NDArray, ctx=None, cast_dtype=False,
                   dtype_source="current"):
        """Set the value from a loaded array. An uninitialized parameter
        takes the array's shape and lands on ``ctx`` (else the device its
        deferred init names, else the array's). ``cast_dtype`` with
        ``dtype_source="saved"`` makes the parameter take the saved dtype;
        otherwise the value is cast to the parameter's own dtype."""
        if cast_dtype and dtype_source == "saved":
            self.dtype = dtype_np(data.dtype)
            if self._data is not None:
                self.cast(self.dtype)
        if self._data is None:
            if ctx is None and self._deferred_init is not None:
                ctx = self._deferred_init[1]
            self.shape = tuple(data.shape)
            self._finish_init(lambda name, arr: None, ctx or data.context)
        elif tuple(self._data.shape) != tuple(data.shape):
            raise ValueError(f"Parameter {self.name!r}: shape "
                             f"{tuple(self._data.shape)}, the saved array "
                             f"{tuple(data.shape)}")
        _initializer._fill(self._data, data)

    def var(self):
        """The symbol variable of this parameter, named as it is and
        carrying its shape."""
        from ..symbol import var

        return var(self.name, shape=self.shape)

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={dtype_name(self.dtype)})")


class Constant(Parameter):
    """Non-trainable parameter holding a fixed value."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            from ..ndarray import array

            value = array(value)
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=dtype_name(value.dtype), init="zeros")
        self._value = value

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if self._data is None or force_reinit:
            self._data = self._value.copy()


class ParameterDict:
    """Ordered name -> Parameter mapping with a shared prefix."""

    def __init__(self, prefix="", shared=None):
        self.prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def get(self, name, **kwargs) -> Parameter:
        full = self.prefix + name
        if full in self._params:
            return self._params[full]
        if self._shared is not None and full in self._shared._params:
            self._params[full] = self._shared._params[full]
            return self._params[full]
        p = Parameter(full, **kwargs)
        self._params[full] = p
        return p

    def get_constant(self, name, value=None) -> Constant:
        full = self.prefix + name
        if full not in self._params:
            self._params[full] = Constant(full, value)
        return self._params[full]

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for p in self.values():
            p.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to ``filename``, keyed by its name less
        ``strip_prefix``."""
        from ..ndarray import save as nd_save

        arg = {}
        for p in self.values():
            n = p.name
            if strip_prefix and n.startswith(strip_prefix):
                n = n[len(strip_prefix):]
            arg[n] = p.data()
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set the parameters from ``filename`` (keys get
        ``restore_prefix``); a missing parameter raises ``KeyError``
        unless ``allow_missing``, an extra one unless ``ignore_extra``."""
        from ..ndarray import load as nd_load

        loaded = nd_load(filename, ctx=ctx)
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        for name, p in self._params.items():
            if name in loaded:
                p._load_init(loaded[name], ctx)
            elif not allow_missing:
                raise KeyError(f"Parameter {name} missing from file "
                               f"{filename}")
        if not ignore_extra:
            extra = set(loaded) - set(self._params)
            if extra:
                raise KeyError(f"file {filename} has extra parameters: "
                               f"{sorted(extra)}")

    # dict protocol ----------------------------------------------------
    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __getitem__(self, k):
        return self._params[k]

    def __contains__(self, k):
        return k in self._params

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __repr__(self):
        items = "\n".join(f"  {p!r}" for p in self.values())
        return f"ParameterDict(prefix={self.prefix!r}\n{items}\n)"
