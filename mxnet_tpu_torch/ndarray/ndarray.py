"""NDArray: the imperative array (counterpart of
``mxnet_tpu/ndarray/ndarray.py``).

An ``NDArray`` holds one ``torch.Tensor``, on ``cuda:0`` unless the caller
names another context. The reference's semantics are kept where torch's
defaults differ:

- Mutation (``x[:] = v``, ``+=``, ``out=``) rebinds the array to a new
  tensor and never writes into the old one, so a tensor that autograd
  saved for a recorded op is never changed under it: ``y = x * x`` keeps
  its gradient at 2 x_old after ``x[:] = 100``. Under ``record()`` an
  in-place op adopts the new tensor's graph node (``x *= 2`` then
  ``y = x * x`` differentiates through the ``*=``).
- Out-of-range reads clamp and out-of-range writes are dropped, as JAX's
  gathers and scatters do: ``arange(5)[10]`` is 4, index array
  ``[10, -7]`` reads ``[4, 0]``; negative indices count from the end; the
  gradient of a clamped read is dropped too. Torch would raise, and on
  CUDA assert on the device (``ops/indexing.py`` ``jax_getitem``).
- Creation follows JAX with 64-bit types off: float64 becomes float32,
  int64 becomes int32, and Python lists default to float32. Index arrays
  stay int32 here and become int64 only inside an op.
- Every operator call goes through :func:`invoke`, which runs the
  registered op under ``torch.no_grad()`` unless ``autograd.record()`` is
  on, so no graph is built outside ``record()`` even when an input is an
  attached variable (``autograd.py``).

``MX_SYNC=1`` or ``MXNET_ENGINE_TYPE=NaiveEngine`` (read once, at import)
waits for the device after every op.
"""
from __future__ import annotations

import weakref
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .._env import naive_engine
from ..base import dtype_name, dtype_np, dtype_torch
from ..context import Context, as_device, current_context
from ..ops import get_op
from ..ops.indexing import jax_getitem as _get
from ..ops.indexing import jax_setitem as _set
from ..ops.registry import OpDef

_MX_SYNC = naive_engine()

__all__ = ["NDArray", "invoke", "invoke_fn", "array", "zeros", "ones",
           "full", "empty", "arange", "save", "load", "concat", "stack",
           "waitall"]

_X32 = {torch.float64: torch.float32, torch.int64: torch.int32}


def _x32(t: torch.Tensor) -> torch.Tensor:
    """64-bit types as JAX stores them with x64 off: 32-bit."""
    dt = _X32.get(t.dtype)
    return t if dt is None else t.to(dt)


def _leaf(t: torch.Tensor, owner: "NDArray") -> torch.Tensor:
    """``t`` as an autograd leaf whose gradient belongs to ``owner``
    (``autograd.py`` finds it by its ``_mx_var``). Tensors that are not
    floating point are never differentiated and stay as they are."""
    if not (t.is_floating_point() or t.is_complex()):
        return t
    t = t.detach().requires_grad_(True)
    t._mx_var = weakref.ref(owner)
    return t


class NDArray:
    """An n-dimensional array on a device."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_var", "_version",
                 "__weakref__")

    def __init__(self, data, ctx: Optional[Context] = None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _x32(torch.from_numpy(np.array(np.asarray(data),
                                                  copy=True)))
        if dtype is not None:
            data = _x32(data.to(dtype_torch(dtype)))
        if ctx is not None:
            ctx = ctx if isinstance(ctx, Context) else Context(
                as_device(ctx))
            dev = as_device(ctx)
            if data.device != dev:
                data = data.to(dev)
        self._ctx = ctx
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._var = False
        self._version = 0

    # ------------------------------------------------------------------ core
    def astorch(self) -> torch.Tensor:
        """The tensor this array holds (the reference's ``asjax``)."""
        return self._data

    def _set_data(self, new) -> "NDArray":
        """Rebind to ``new`` (an NDArray or a tensor). An NDArray under
        ``record()`` is adopted with its graph node; anything else is
        detached, and an attached variable stays one (its new tensor is a
        fresh leaf of the same owner)."""
        from .. import autograd

        if isinstance(new, NDArray):
            adopt = autograd.is_recording()
            new = new._data
        else:
            adopt = False
        if not adopt:
            new = new.detach()
            if self._var and self._grad_req != "null":
                new = _leaf(new, self)
        self._data = new
        self._version += 1
        return self

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def dtype(self):
        """numpy dtype (``torch.bfloat16`` for bfloat16, which numpy has
        not)."""
        return dtype_np(self._data.dtype)

    @property
    def context(self) -> Context:
        if self._ctx is not None:
            return self._ctx
        return Context(self._data.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    # ------------------------------------------------------------- transfer
    def asnumpy(self) -> np.ndarray:
        """Blocking device-to-host copy; bfloat16 comes back as float32."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        """Wait until the array's device has finished its queued work."""
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    def as_in_context(self, ctx) -> "NDArray":
        ctx = ctx if isinstance(ctx, Context) else Context(as_device(ctx))
        if ctx == self.context:
            return self
        return NDArray(self._data.detach().to(as_device(ctx)), ctx=ctx)

    as_in_ctx = as_in_context

    def copyto(self, other) -> "NDArray":
        if isinstance(other, Context):
            return self.as_in_context(other)
        other._set_data(self._data.detach().to(other._data.device))
        return other

    def copy(self) -> "NDArray":
        return NDArray(self._data.detach(), ctx=self._ctx)

    def astype(self, dtype, copy=True) -> "NDArray":
        from .. import autograd

        dt = dtype_torch(dtype)
        dt = _X32.get(dt, dt)
        if not copy and self._data.dtype == dt:
            return self
        # float -> float casts stay on the tape (Cast has a gradient)
        if (autograd.is_recording() and dt.is_floating_point
                and self._data.is_floating_point()):
            return invoke_fn(lambda x: x.to(dt), [self])
        return _wrap(self._data.detach().to(dt), self)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach(), ctx=self._ctx)

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Mark for gradient computation: ``.grad`` is a zero array and the
        array's tensor becomes an autograd leaf."""
        self._grad_req = grad_req
        if grad_req != "null":
            self._grad = NDArray(torch.zeros_like(self._data.detach()),
                                 ctx=self._ctx)
            self._var = True
            self._data = _leaf(self._data, self)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # ------------------------------------------------------------- indexing
    def __getitem__(self, key):
        from .. import autograd

        key = _unwrap_key(key)
        if autograd.is_recording():
            return invoke_fn(lambda d: _get(d, key), [self])
        with torch.no_grad():
            return _wrap(_get(self._data, key), self)

    def __setitem__(self, key, value):
        from .. import autograd

        key = _unwrap_key(key)
        if autograd.is_recording() and isinstance(value, NDArray):
            self._set_data(invoke_fn(lambda d, v: _set(d, key, v),
                                     [self, value]))
            return
        if isinstance(value, NDArray):
            value = value._data
        with torch.no_grad():
            self._set_data(_set(self._data, key, value))

    # ---------------------------------------------------------- arithmetic
    def __add__(self, o):
        return _binary("broadcast_add", "_plus_scalar", self, o)

    def __radd__(self, o):
        return _binary("broadcast_add", "_plus_scalar", self, o)

    def __sub__(self, o):
        return _binary("broadcast_sub", "_minus_scalar", self, o)

    def __rsub__(self, o):
        return invoke("_rminus_scalar", [self], {"scalar": o})

    def __mul__(self, o):
        return _binary("broadcast_mul", "_mul_scalar", self, o)

    def __rmul__(self, o):
        return _binary("broadcast_mul", "_mul_scalar", self, o)

    def __truediv__(self, o):
        return _binary("broadcast_div", "_div_scalar", self, o)

    def __rtruediv__(self, o):
        return invoke("_rdiv_scalar", [self], {"scalar": o})

    def __mod__(self, o):
        return _binary("broadcast_mod", "_mod_scalar", self, o)

    def __pow__(self, o):
        return _binary("broadcast_power", "_power_scalar", self, o)

    def __rpow__(self, o):
        return invoke("_rpower_scalar", [self], {"scalar": o})

    def __neg__(self):
        return invoke("negative", [self], {})

    def __abs__(self):
        return invoke("abs", [self], {})

    def __iadd__(self, o):
        return self._set_data(_binary("broadcast_add", "_plus_scalar", self,
                                       o))

    def __isub__(self, o):
        return self._set_data(_binary("broadcast_sub", "_minus_scalar", self,
                                       o))

    def __imul__(self, o):
        return self._set_data(_binary("broadcast_mul", "_mul_scalar", self,
                                       o))

    def __itruediv__(self, o):
        return self._set_data(_binary("broadcast_div", "_div_scalar", self,
                                       o))

    def __eq__(self, o):
        if o is None:
            return False
        return _binary("broadcast_equal", "_equal_scalar", self, o)

    def __ne__(self, o):
        if o is None:
            return True
        return _binary("broadcast_not_equal", "_not_equal_scalar", self, o)

    def __gt__(self, o):
        return _binary("broadcast_greater", "_greater_scalar", self, o)

    def __ge__(self, o):
        return _binary("broadcast_greater_equal", "_greater_equal_scalar",
                       self, o)

    def __lt__(self, o):
        return _binary("broadcast_lesser", "_lesser_scalar", self, o)

    def __le__(self, o):
        return _binary("broadcast_lesser_equal", "_lesser_equal_scalar",
                       self, o)

    def __hash__(self):
        return id(self)

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __bool__(self):
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element "
                             "NDArray")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # ------------------------------------------------------- method aliases
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke("reshape", [self], {"shape": shape, **kwargs})

    def reshape_like(self, other):
        return invoke("reshape", [self], {"shape": other.shape})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return invoke("transpose", [self], {"axes": axes or None})

    @property
    def T(self):
        return self.transpose()

    def sum(self, axis=None, keepdims=False, **kw):
        return invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False, **kw):
        return invoke("mean", [self], {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False, **kw):
        return invoke("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False, **kw):
        return invoke("min", [self], {"axis": axis, "keepdims": keepdims})

    def prod(self, axis=None, keepdims=False, **kw):
        return invoke("prod", [self], {"axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False, **kw):
        return invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False, **kw):
        return invoke("argmin", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self, **kw):
        return invoke("norm", [self], kw)

    def abs(self):
        return invoke("abs", [self], {})

    def sqrt(self):
        return invoke("sqrt", [self], {})

    def square(self):
        return invoke("square", [self], {})

    def exp(self):
        return invoke("exp", [self], {})

    def log(self):
        return invoke("log", [self], {})

    def relu(self):
        return invoke("relu", [self], {})

    def sigmoid(self):
        return invoke("sigmoid", [self], {})

    def tanh(self):
        return invoke("tanh", [self], {})

    def clip(self, a_min=None, a_max=None):
        return invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def expand_dims(self, axis):
        return invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return invoke("squeeze", [self], {"axis": axis})

    def flatten(self):
        return invoke("Flatten", [self], {})

    def flip(self, axis):
        return invoke("flip", [self], {"axis": axis})

    def tile(self, reps):
        return invoke("tile", [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def broadcast_to(self, shape):
        return invoke("broadcast_to", [self], {"shape": shape})

    def broadcast_like(self, other):
        return invoke("broadcast_like", [self, other], {})

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                             "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kw):
        return invoke("one_hot", [self], {"depth": depth, **kw})

    def topk(self, **kw):
        return invoke("topk", [self], kw)

    def sort(self, **kw):
        return invoke("sort", [self], kw)

    def argsort(self, **kw):
        return invoke("argsort", [self], kw)

    def dot(self, other, **kw):
        return invoke("dot", [self, other], kw)

    def softmax(self, axis=-1):
        return invoke("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", [self], {"axis": axis})

    def tostype(self, stype):
        if stype == "default":
            return self
        raise NotImplementedError("sparse storage is not ported")

    def zeros_like(self):
        return invoke("zeros_like", [self], {})

    def ones_like(self):
        return invoke("ones_like", [self], {})


# ---------------------------------------------------------------------------
# Indexing with the reference's (JAX's) out-of-range rules
# ---------------------------------------------------------------------------

def _unwrap_key(key):
    """NDArray keys are index arrays (int32, as the reference reads them)."""
    if isinstance(key, NDArray):
        return key._data.detach().to(torch.int32)
    if isinstance(key, tuple):
        return tuple(_unwrap_key(k) for k in key)
    return key


def _wrap(data: torch.Tensor, like: Optional[NDArray] = None) -> NDArray:
    return NDArray(data, ctx=like._ctx if like is not None else None)


def _binary(op_name, scalar_op, lhs, rhs):
    if isinstance(rhs, NDArray):
        return invoke(op_name, [lhs, rhs], {})
    return invoke(scalar_op, [lhs], {"scalar": rhs})


# ---------------------------------------------------------------------------
# The dispatch choke point
# ---------------------------------------------------------------------------

def invoke(op: Any, inputs: Sequence[NDArray], kwargs: dict):
    """Execute a registered op eagerly: under ``torch.enable_grad()`` while
    ``autograd.record()`` is on and the op is differentiable, so that
    torch records it; under ``torch.no_grad()`` otherwise. ``out=`` rebinds
    the given array(s) to the result's tensors (detached, as the
    reference's ``out=`` keeps no graph node). Counts each call in
    ``invoke.calls``."""
    from .. import autograd

    opdef = op if isinstance(op, OpDef) else get_op(op)
    kwargs = dict(kwargs)
    out = kwargs.pop("out", None)
    invoke.calls += 1
    datas = [x._data if isinstance(x, NDArray) else x for x in inputs]
    if autograd.is_recording() and opdef.differentiable:
        with torch.enable_grad():
            result = opdef.fn(*datas, **kwargs)
            result = _on_tape(result, datas)
    else:
        with torch.no_grad():
            result = opdef.fn(*datas, **kwargs)
    result = _wrap_result(result, inputs)
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        results = result if isinstance(result, tuple) else (result,)
        for o, r in zip(outs, results):
            o._set_data(r._data)  # as the reference: no graph node adopted
        result = out
    if _MX_SYNC:
        for r in result if isinstance(result, (list, tuple)) else [result]:
            if isinstance(r, NDArray):
                r.wait_to_read()
    return result


invoke.calls = 0


def invoke_fn(fn, inputs: Sequence[NDArray], kwargs=None):
    """Invoke an ad-hoc pure function of tensors as if it were an op (used
    by ``__getitem__`` and model code such as attention). With Symbol
    inputs the function is spliced into the graph as one node
    (``symbol.invoke_fn``), so F-generic ``hybrid_forward`` code that uses
    it traces symbolically."""
    from ..symbol.symbol import Symbol, invoke_fn as _sym_invoke_fn

    if any(isinstance(x, Symbol) for x in inputs):
        return _sym_invoke_fn(fn, inputs, kwargs)
    opdef = OpDef("<lambda>", fn, num_outputs=1)
    return invoke(opdef, inputs, kwargs or {})


class _ZeroGrad(torch.autograd.Function):
    """Puts a recorded op's output that torch left off the graph (it does
    not depend on the inputs: ``BlockGrad``, ``zeros_like``) on the tape,
    with a zero gradient to each input, as the reference's tape records
    every op whose inputs are on it."""

    @staticmethod
    def forward(ctx, out, *inputs):
        ctx.specs = [(t.shape, t.dtype, t.device) for t in inputs]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (None, *[torch.zeros(s, dtype=d, device=dev)
                        for s, d, dev in ctx.specs])


def _on_tape(result, datas):
    """``result`` with each floating output that torch left off the graph
    put on it, when some input is on it."""
    live = [d for d in datas if isinstance(d, torch.Tensor)
            and d.requires_grad]
    if not live:
        return result
    outs = result if isinstance(result, (list, tuple)) else (result,)
    if all(o.requires_grad or not o.is_floating_point() for o in outs):
        return result
    fixed = tuple(_ZeroGrad.apply(o, *live) if o.is_floating_point()
                  and not o.requires_grad else o for o in outs)
    return fixed if isinstance(result, (list, tuple)) else fixed[0]


def _wrap_result(result, inputs):
    like = next((x for x in inputs if isinstance(x, NDArray)), None)
    if isinstance(result, (list, tuple)):
        return tuple(_wrap(r, like) for r in result)
    return _wrap(result, like)


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None) -> NDArray:
    """Create an NDArray. numpy and tensor sources keep their dtype (64-bit
    types become 32-bit); Python lists and scalars default to float32."""
    if dtype is None and not isinstance(source_array, (np.ndarray,
                                                       torch.Tensor,
                                                       NDArray)):
        dtype = np.float32
    return NDArray(source_array, ctx=ctx or current_context(), dtype=dtype)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return invoke("_zeros", [], {"shape": _tup(shape),
                                 "dtype": dtype_name(dtype or "float32"),
                                 "ctx": ctx or current_context()})


def ones(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return invoke("_ones", [], {"shape": _tup(shape),
                                "dtype": dtype_name(dtype or "float32"),
                                "ctx": ctx or current_context()})


def full(shape, val, ctx=None, dtype=None, **kw) -> NDArray:
    return invoke("_full", [], {"shape": _tup(shape), "value": val,
                                "dtype": dtype_name(dtype or "float32"),
                                "ctx": ctx or current_context()})


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype="float32") -> NDArray:
    return invoke("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat,
                                  "dtype": dtype,
                                  "ctx": ctx or current_context()})


def _tup(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def concat(*data, dim=1):
    return invoke("Concat", list(data), {"dim": dim})


def stack(*data, axis=0):
    return invoke("stack", list(data), {"axis": axis})


def waitall():
    """Wait until all queued device work is done (reference
    ``MXNDArrayWaitAll``)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def save(fname: str, data) -> None:
    """Save an NDArray, a list or a dict of them in the reference's binary
    container (``serialization.py``): the same bytes as the reference's
    ``nd.save`` for the same values."""
    from .serialization import host_array, save_nd

    if isinstance(data, NDArray):
        keys, arrays = [], [data]
    elif isinstance(data, dict):
        keys = list(data.keys())
        arrays = [data[k] for k in keys]
    elif isinstance(data, (list, tuple)):
        keys, arrays = [], list(data)
    else:
        raise TypeError(f"cannot save {type(data)}")
    save_nd(fname, [host_array(a) for a in arrays], keys)


def load(fname: str, ctx=None):
    """Load what :func:`save` (or the reference, or upstream MXNet) wrote:
    a list, or a dict when the file names its arrays. Arrays land on
    ``ctx`` (default: the current context, the card unless a ``with
    mx.cpu():`` scope is open). The npz container earlier builds of the
    reference wrote loads as well."""
    from .serialization import is_binary_nd, load_nd

    ctx = ctx or current_context()
    path = _npz_path(fname)
    with open(path, "rb") as f:
        head = f.read(8)
    if is_binary_nd(head):
        out = load_nd(path)
        if isinstance(out, dict):
            return {k: NDArray(v, ctx=ctx) for k, v in out.items()}
        return [NDArray(v, ctx=ctx) for v in out]
    with np.load(path, allow_pickle=False) as z:  # legacy npz container
        keys = list(z.keys())
        if keys == ["__single__"]:
            return [NDArray(z["__single__"], ctx=ctx)]
        if all(k.startswith("__list_") for k in keys):
            return [NDArray(z[f"__list_{i}__"], ctx=ctx)
                    for i in range(len(keys))]
        return {k: NDArray(z[k], ctx=ctx) for k in keys}


def _npz_path(fname):
    import os

    if os.path.exists(fname):
        return fname
    if os.path.exists(fname + ".npz"):
        return fname + ".npz"
    return fname
