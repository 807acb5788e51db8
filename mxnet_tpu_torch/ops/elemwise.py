"""Elementwise + broadcast operator family (counterpart of
``mxnet_tpu/ops/elemwise.py``): unary math, activations, casts, the
broadcasting binary ops with their ``elemwise_*``/``_plus`` aliases and
the tensor-with-Python-scalar ops, each one torch expression.

Types follow the reference: a comparison returns the promoted type of its
inputs (1.0/0.0, not bool), a scalar op keeps a float tensor's type, and
an integer tensor with a float scalar gives float32.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .registry import alias, register


def _cbrt(x):
    x = x if x.is_floating_point() else x.float()
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _to_float(x):
    return x if x.is_floating_point() else x.float()


def sign(x):
    """``jnp.sign``: NaN stays NaN and a signed zero keeps its sign, where
    ``torch.sign`` gives 0 for both; the gradient is 0 everywhere."""
    if not (x.is_floating_point() or x.is_complex()):
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x.detach(), torch.sign(x))


def _logical_not(x):
    return (x == 0).to(x.dtype)


_UNARY = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "tanh": torch.tanh,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1 / _cbrt(x),
    "square": torch.square,
    "reciprocal": lambda x: 1 / x,
    "abs": torch.abs,
    "sign": sign,
    "round": torch.round,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "negative": torch.negative,
    "erf": lambda x: torch.erf(_to_float(x)),
    "erfinv": lambda x: torch.erfinv(_to_float(x)),
    "gamma": lambda x: torch.exp(torch.lgamma(_to_float(x))),
    "gammaln": lambda x: torch.lgamma(_to_float(x)),
    "digamma": lambda x: torch.digamma(_to_float(x)),
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.arcsin,
    "arccos": torch.arccos,
    "arctan": torch.arctan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "arcsinh": torch.arcsinh,
    "arccosh": torch.arccosh,
    "arctanh": torch.arctanh,
    "degrees": lambda x: torch.rad2deg(_to_float(x)),
    "radians": lambda x: torch.deg2rad(_to_float(x)),
    "logical_not": _logical_not,
    "isnan": torch.isnan,
    "isinf": torch.isinf,
    "isfinite": torch.isfinite,
}

_UNARY_TAGS = {"exp": ("exp",), "log": ("log",), "log10": ("log",),
               "log2": ("log",)}

for _name, _f in _UNARY.items():
    register(_name, ndarray_inputs=["x"],
             tags=_UNARY_TAGS.get(_name, ()))(_f)

alias("abs", "_abs")
alias("negative", "_np_negative")


def _logaddexp0(x):
    return torch.logaddexp(x, torch.zeros_like(x))


@register("softrelu", ndarray_inputs=["x"])
def _softrelu(x):
    return _logaddexp0(x)  # log(1 + exp(x)), numerically stable


@register("gelu", aliases=["_npx_gelu"], ndarray_inputs=["x"])
def _gelu(x, approximation="erf"):
    if approximation == "tanh":
        c = 0.7978845608028654  # sqrt(2/pi)
        return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))
    return 0.5 * x * (1.0 + torch.erf(x / 1.4142135623730951))


@register("silu", ndarray_inputs=["x"])
def _silu(x):
    return x * (1 / (1 + torch.exp(-x)))


@register("log_sigmoid", ndarray_inputs=["x"])
def _log_sigmoid(x):
    return -_logaddexp0(-x)


@register("mish", ndarray_inputs=["x"])
def _mish(x):
    return x * torch.tanh(_logaddexp0(x))


@register("clip", ndarray_inputs=["data"])
def _clip(data, a_min=None, a_max=None):
    if a_min is None and a_max is None:
        return data
    return torch.clamp(data, a_min, a_max)


@register("smooth_l1", ndarray_inputs=["data"])
def _smooth_l1(data, scalar=1.0):
    s2 = scalar * scalar
    a = torch.abs(data)
    return torch.where(a < 1.0 / s2, 0.5 * s2 * data * data, a - 0.5 / s2)


@register("Cast", aliases=["cast"], ndarray_inputs=["data"])
def _cast(data, dtype="float32"):
    return data.to(dtype_torch(dtype))


@register("amp_cast", ndarray_inputs=["data"])
def _amp_cast(data, dtype="float32"):
    return data.to(dtype_torch(dtype))


@register("amp_multicast",
          num_outputs=lambda kw: int(kw.get("num_outputs", 1)),
          ndarray_inputs="*")
def _amp_multicast(*data, num_outputs=None, cast_narrow=False):
    dts = [d.dtype for d in data]
    if cast_narrow:
        target = min(dts, key=lambda d: torch.empty((), dtype=d)
                     .element_size())
    else:
        target = dts[0]
        for d in dts[1:]:
            target = torch.promote_types(target, d)
    out = tuple(d.to(target) for d in data)
    return out if len(out) > 1 else out[0]


@register("zeros_like", ndarray_inputs=["data"])
def _zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like", ndarray_inputs=["data"])
def _ones_like(data):
    return torch.ones_like(data)


@register("shape_array", differentiable=False, ndarray_inputs=["data"])
def _shape_array(data):
    return torch.tensor(data.shape, dtype=torch.int32, device=data.device)


@register("size_array", differentiable=False, ndarray_inputs=["data"])
def _size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register("BlockGrad", aliases=["stop_gradient"], ndarray_inputs=["data"])
def _block_grad(data):
    return data.detach()


@register("identity", aliases=["_copy"], ndarray_inputs=["data"])
def _identity(data):
    return data


@register("MakeLoss", aliases=["make_loss"], ndarray_inputs=["data"])
def _make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    # forward is the identity; the gradient is scaled by grad_scale
    if grad_scale == 1.0:
        return data
    return data * grad_scale - (data * grad_scale - data).detach()


# ---------------------------------------------------------------------------
# Binary broadcast + elemwise ops
# ---------------------------------------------------------------------------

def _cmp(f):
    def op(a, b):
        return f(a, b).to(torch.result_type(a, b))

    return op


_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "mod": torch.remainder,
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
    "equal": _cmp(torch.eq),
    "not_equal": _cmp(torch.ne),
    "greater": _cmp(torch.gt),
    "greater_equal": _cmp(torch.ge),
    "lesser": _cmp(torch.lt),
    "lesser_equal": _cmp(torch.le),
    "logical_and": _cmp(lambda a, b: (a != 0) & (b != 0)),
    "logical_or": _cmp(lambda a, b: (a != 0) | (b != 0)),
    "logical_xor": _cmp(lambda a, b: (a != 0) ^ (b != 0)),
}

for _name, _f in _BINARY.items():
    register("broadcast_" + _name, ndarray_inputs=["a", "b"])(_f)

# elemwise_* variants require same shape in the reference; broadcasting is
# a superset, so they share implementations.
alias("broadcast_add", "elemwise_add", "_plus", "_add")
alias("broadcast_sub", "elemwise_sub", "_minus", "_sub")
alias("broadcast_mul", "elemwise_mul", "_mul")
alias("broadcast_div", "elemwise_div", "_div")
alias("broadcast_power", "_power", "_pow")
alias("broadcast_mod", "_mod")
alias("broadcast_maximum", "_maximum")
alias("broadcast_minimum", "_minimum")
alias("broadcast_equal", "_equal")
alias("broadcast_not_equal", "_not_equal")
alias("broadcast_greater", "_greater")
alias("broadcast_greater_equal", "_greater_equal")
alias("broadcast_lesser", "_lesser")
alias("broadcast_lesser_equal", "_lesser_equal")
alias("broadcast_logical_and", "_logical_and")
alias("broadcast_logical_or", "_logical_or")
alias("broadcast_logical_xor", "_logical_xor")
alias("broadcast_hypot", "_hypot")


@register("_scatter_elemwise_div", ndarray_inputs=["lhs", "rhs"])
def _scatter_div(lhs, rhs):
    return lhs / rhs


# ---------------------------------------------------------------------------
# Scalar ops (tensor with a Python scalar)
# ---------------------------------------------------------------------------

def _scalar_like(x, s):
    """The scalar as a 0-d tensor of x's type (of float32 for an integer x
    and a float s), on x's device."""
    dt = x.dtype
    if isinstance(s, float) and not x.is_floating_point():
        dt = torch.float32
    return torch.tensor(s, dtype=dt, device=x.device)


def _scalar_cmp(f):
    return lambda x, s: f(x, s).to(x.dtype)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(_scalar_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _scalar_like(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _scalar_like(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _scalar_like(x, s)),
    "_equal_scalar": _scalar_cmp(torch.eq),
    "_not_equal_scalar": _scalar_cmp(torch.ne),
    "_greater_scalar": _scalar_cmp(torch.gt),
    "_greater_equal_scalar": _scalar_cmp(torch.ge),
    "_lesser_scalar": _scalar_cmp(torch.lt),
    "_lesser_equal_scalar": _scalar_cmp(torch.le),
    "_logical_and_scalar": _scalar_cmp(lambda x, s: (x != 0) & (s != 0)),
    "_logical_or_scalar": _scalar_cmp(lambda x, s: (x != 0) | (s != 0)),
    "_logical_xor_scalar": _scalar_cmp(lambda x, s: (x != 0) ^ (s != 0)),
}


def _make_scalar_op(f):
    def op(data, scalar=0.0, is_int=None):
        return f(data, scalar)

    return op


for _name, _f in _SCALAR.items():
    register(_name, ndarray_inputs=["data"])(_make_scalar_op(_f))
