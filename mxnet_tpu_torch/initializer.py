"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

The same registry by name and the same dispatch on the parameter's name:
names ending in ``bias``/``beta``/``mean`` start at 0, ``gamma``/``var`` at
1, everything else goes to the initializer's ``_init_weight``. Random
draws come from the framework stream of the array's device
(``random.generator``), on that device: they match the reference in
distribution only, as torch's generators do not give numpy's bits.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch

from . import random as _random
from .ndarray import NDArray

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "InitDesc", "Load", "create", "register"]

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(init, **kwargs) -> "Initializer":
    if init is None:
        return Uniform(0.07)
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str):
        name = init.lower()
        if name not in _REGISTRY:
            raise ValueError(f"unknown initializer {init!r}; have "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[name](**kwargs)
    raise TypeError(f"cannot create initializer from {init!r}")


def _fill(arr: NDArray, value) -> None:
    """Set every element of ``arr``: a scalar, a numpy array or a tensor,
    cast to the array's dtype on its device."""
    t = arr._data
    if isinstance(value, (int, float)):
        new = torch.full(t.shape, float(value), dtype=t.dtype,
                         device=t.device)
    else:
        if isinstance(value, NDArray):
            value = value._data
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value, np.float32))
        new = value.detach().to(device=t.device, dtype=t.dtype).reshape(
            t.shape)
    arr._set_data(new)


def _draw(arr: NDArray, kind: str, a: float, b: float) -> torch.Tensor:
    """f32 draws shaped like ``arr`` on its device: uniform on [a, b) or
    normal with mean a and deviation b."""
    dev = arr._data.device
    t = torch.empty(arr.shape, dtype=torch.float32, device=dev)
    gen = _random.generator(dev)
    if kind == "uniform":
        return t.uniform_(a, b, generator=gen)
    return t.normal_(a, b, generator=gen)


class Initializer:
    """Base: callable on (name, NDArray); dispatches by the name's
    suffix."""

    def __call__(self, name, arr: NDArray = None):
        if isinstance(name, NDArray):  # called as init(arr)
            self._init_weight("", name)
            return
        if name.endswith("bias") or name.endswith("beta") or \
                name.endswith("mean"):
            _fill(arr, 0.0)
        elif name.endswith("gamma") or name.endswith("var"):
            _fill(arr, 1.0)
        else:
            self._init_weight(name, arr)

    def init_array(self, name, shape, dtype, ctx=None) -> NDArray:
        from .ndarray import zeros

        arr = zeros(shape, dtype=dtype, ctx=ctx)
        self(name, arr)
        return arr

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        _fill(arr, 0.0)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        _fill(arr, 1.0)


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _init_weight(self, name, arr):
        _fill(arr, self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr):
        _fill(arr, _draw(arr, "uniform", -self.scale, self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, name, arr):
        _fill(arr, _draw(arr, "normal", 0.0, self.sigma))


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        probe = NDArray(torch.empty((nout, nin), device=arr._data.device))
        tmp = (_draw(probe, "uniform", -1.0, 1.0)
               if self.rand_type == "uniform"
               else _draw(probe, "normal", 0.0, 1.0))
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == tuple(tmp.shape) else v
        _fill(arr, self.scale * q.reshape(arr.shape))


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = shape[1] * hw if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        else:
            factor = fan_out
        scale = math.sqrt(self.magnitude / max(factor, 1))
        if self.rnd_type == "uniform":
            _fill(arr, _draw(arr, "uniform", -scale, scale))
        else:
            _fill(arr, _draw(arr, "normal", 0.0, scale))


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)


@register
class Bilinear(Initializer):
    def _init_weight(self, name, arr):
        shape = arr.shape
        weight = np.zeros(shape, dtype=np.float32)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        _fill(arr, weight)


@register
class LSTMBias(Initializer):
    def __init__(self, forget_bias=1.0):
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        n = arr.shape[0] // 4
        b[n:2 * n] = self.forget_bias  # i, f, g, o gate order
        _fill(arr, b)


class Mixed(Initializer):
    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), i) for p, i in zip(patterns,
                                                       initializers)]

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(f"parameter {name} did not match any pattern")


class InitDesc(str):
    """Parameter-name descriptor carrying init attrs: a ``str`` subclass,
    so that the suffix dispatch keeps working; ``attrs`` may carry
    ``__init__`` overrides, ``global_init`` the fallback initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


@register
class Load(Initializer):
    """Init from a dict of arrays (numpy, tensors or NDArrays; ``arg:``/
    ``aux:`` prefixes stripped; a ``.params`` file's through ``nd.load``),
    falling back to ``default_init`` for missing names."""

    def __init__(self, param, default_init=None, verbose=False):
        self.param = {}
        for k, v in dict(param).items():
            k = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) else k
            self.param[k] = v
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr: NDArray):
        if name in self.param:
            src = self.param[name]
            shape = tuple(src.shape)
            if shape != tuple(arr.shape):
                raise ValueError(
                    f"Load: shape mismatch for {name!r}: saved {shape} vs "
                    f"param {arr.shape}")
            _fill(arr, src)
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError(f"Load: no saved value for {name!r} and no "
                             "default_init")
