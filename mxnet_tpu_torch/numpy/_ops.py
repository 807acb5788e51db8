"""Explicit ``mx.np`` operators with mxnet-numpy semantics (counterpart of
``mxnet_tpu/numpy/_ops.py``).

What the semantics are, beyond calling the torch function of the same
name (which often differs):

- ``out=``: the result lands in the given ndarray (cast to its dtype) and
  that same ndarray is returned;
- ``where=`` on ufuncs: elements where the mask is False come from
  ``out``, which is then required;
- the reference's type rules, those of numpy with 32-bit defaults: no
  result is 64-bit; integer and bool inputs to the float functions
  (``divide``, ``mean``, ``std``, ``sqrt``, ...) give float32 while
  float16 stays float16; ``sum``/``prod``/``cumsum`` of ints and bools give
  int32; ``argmax``/``argmin``/``argsort`` and every other index result
  are int32 (torch returns int64); bitwise ops refuse floats, and
  ``subtract``/``negative``/``sign`` refuse bools, as the reference does;
- every array result is an :class:`NDArray` recorded on the autograd tape
  (through ``invoke_fn``), on the device of the inputs.
"""
from __future__ import annotations

import builtins
import math

import numpy as _onp
import torch

from ..base import dtype_torch
from ..context import current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import _x32, invoke_fn

__all__: list = []

_EXPLICIT = {}


def _np_op(name):
    def deco(fn):
        _EXPLICIT[name] = fn
        fn.__name__ = name
        globals()[name] = fn  # the ufunc factories don't assign the name
        __all__.append(name)
        return fn
    return deco


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------

def _unwrap(x):
    return x._data if isinstance(x, NDArray) else x


def _like(values):
    for v in values:
        if isinstance(v, NDArray):
            return v
    return None


def _nd(a, like=None) -> NDArray:
    """``a`` as an NDArray on the device of ``like`` (or the current
    context): Python scalars become 0-d arrays, which take part in type
    promotion as the reference's weakly typed scalars do."""
    if isinstance(a, NDArray):
        return a
    ctx = like.context if like is not None else current_context()
    if isinstance(a, torch.Tensor):
        return NDArray(_x32(a), ctx=ctx)
    return NDArray(_onp.asarray(a), ctx=ctx)


def _tensor(a, like=None) -> torch.Tensor:
    return _nd(a, like)._data


def _fix(r):
    """No 64-bit results (the reference's x64-off types)."""
    if isinstance(r, torch.Tensor):
        return _x32(r)
    if isinstance(r, (tuple, list)):
        return type(r)(_fix(v) for v in r)
    return r


def _invoke(pure, arrays, out=None):
    """Run ``pure`` over the array inputs on the tape; honor ``out=``."""
    like = _like(arrays)
    nds = [_nd(a, like) for a in arrays]
    res = invoke_fn(lambda *ts: _fix(pure(*ts)), nds)
    if out is not None:
        if not isinstance(out, NDArray):
            raise TypeError("out= must be an mx.np.ndarray")
        first = res[0] if isinstance(res, (tuple, list)) else res
        out._set_data(first._data.to(out._data.dtype))
        return out
    return res


def _wrap_out(res, like=None):
    if isinstance(res, (tuple, list)):
        return type(res)(_wrap_out(r, like) for r in res)
    if isinstance(res, torch.Tensor):
        return NDArray(_fix(res), ctx=like.context if like is not None
                       else None)
    return res


def _isbool(t) -> bool:
    return t.dtype == torch.bool


def _isint(t) -> bool:
    return not (t.is_floating_point() or t.is_complex() or _isbool(t))


def _to_float(t):
    return t if t.is_floating_point() else t.to(torch.float32)


def _int_if_bool(t):
    return t.to(torch.int32) if _isbool(t) else t


def _mask(where, base):
    m = _unwrap(where)
    if not isinstance(m, torch.Tensor):
        m = torch.as_tensor(_onp.asarray(m))
    return m.to(device=base.device, dtype=torch.bool)


def _axis_dims(axis):
    if axis is None:
        return None
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _torch_dtype(dtype):
    return None if dtype is None else dtype_torch(dtype)


# ---------------------------------------------------------------------------
# ufuncs
# ---------------------------------------------------------------------------

def _ufunc2(name, fn):
    @_np_op(name)
    def op(x1, x2, out=None, where=True, **kwargs):
        if where is True or where is None:
            return _invoke(fn, [x1, x2], out)
        if out is None:
            raise ValueError(
                f"np.{name}: where= requires out= (unselected elements are "
                "taken from out, matching numpy)")
        return _invoke(
            lambda a, b, base: torch.where(_mask(where, base),
                                           fn(a, b).to(base.dtype), base),
            [x1, x2, out], out)
    return op


def _ufunc1(name, fn):
    @_np_op(name)
    def op(x, out=None, where=True, **kwargs):
        if where is True or where is None:
            return _invoke(fn, [x], out)
        if out is None:
            raise ValueError(f"np.{name}: where= requires out=")
        return _invoke(
            lambda a, base: torch.where(_mask(where, base),
                                        fn(a).to(base.dtype), base),
            [x, out], out)
    return op


def _promoted(a, b):
    dt = torch.promote_types(a.dtype, b.dtype) if a.dim() and b.dim() \
        else torch.result_type(a, b)
    return a.to(dt), b.to(dt)


def _no_bool(name, fn):
    def f(a, b):
        if _isbool(a) and _isbool(b):
            raise TypeError(f"np.{name} is not supported for booleans")
        return fn(a, b)
    return f


def _bool_as(bool_fn, fn):
    """``fn``, with ``bool_fn`` where both operands are bool."""
    def f(a, b):
        if _isbool(a) and _isbool(b):
            return bool_fn(a, b)
        return fn(*_promoted(a, b))
    return f


def _bool_int(fn):
    """``fn`` with bool operands taken as int32 (the reference's
    ``mod``/``power``/``floor_divide`` of booleans)."""
    def f(a, b):
        return fn(*_promoted(_int_if_bool(a), _int_if_bool(b)))
    return f


def _int_div(fn, by_zero):
    """An integer division ``fn`` with XLA's results for a zero divisor,
    ``by_zero(a)`` (torch raises on the CPU and is undefined on the
    card); floats divide as IEEE does."""
    def f(a, b):
        a, b = _promoted(_int_if_bool(a), _int_if_bool(b))
        if a.is_floating_point():
            return fn(a, b)
        zero = b == 0
        q = fn(a, torch.where(zero, torch.ones_like(b), b))
        return torch.where(zero, by_zero(a).to(q.dtype), q)
    return f


def _rem_by_zero(a):
    return torch.zeros_like(a)


def _floordiv_by_zero(a):
    # XLA: a / 0 is -1, a % 0 is a; numpy's floor adjustment then
    # subtracts one wherever a is nonzero
    return torch.where(a == 0, torch.full_like(a, -1), torch.full_like(a, -2))


def _float2(fn):
    def f(a, b):
        a, b = _promoted(_to_float(a), _to_float(b))
        return fn(a, b)
    return f


def _bitwise2(name, fn):
    def f(a, b):
        if a.is_floating_point() or b.is_floating_point():
            raise TypeError(f"np.{name} is only defined for integers and "
                            "booleans")
        return fn(*_promoted(a, b))
    return f


def _shift(name, fn):
    def f(a, b):
        if a.is_floating_point() or b.is_floating_point():
            raise TypeError(f"np.{name} is only defined for integers")
        return fn(*_promoted(_int_if_bool(a), _int_if_bool(b)))
    return f


def _int_only(name, fn):
    def f(a, b):
        if not (_isint(a) and _isint(b)):
            raise ValueError(f"np.{name} is only defined for integers")
        return fn(*_promoted(a, b))
    return f


def _cmp(fn):
    def f(a, b):
        return fn(*_promoted(a, b))
    return f


def _heaviside(a, b):
    return torch.where(a < 0, torch.zeros_like(a),
                       torch.where(a > 0, torch.ones_like(a), b))


def _logaddexp2(a, b):
    return torch.logaddexp2(a, b)


_ufunc2("add", _bool_as(torch.logical_or, torch.add))
_ufunc2("subtract", _no_bool("subtract", lambda a, b: torch.sub(
    *_promoted(a, b))))
_ufunc2("multiply", _bool_as(torch.logical_and, torch.mul))
_ufunc2("mod", _int_div(torch.remainder, _rem_by_zero))
_ufunc2("remainder", _int_div(torch.remainder, _rem_by_zero))
_ufunc2("power", _bool_int(torch.pow))
_ufunc2("maximum", _bool_as(torch.logical_or, torch.maximum))
_ufunc2("minimum", _bool_as(torch.logical_and, torch.minimum))
_ufunc2("hypot", _float2(torch.hypot))
_ufunc2("arctan2", _float2(torch.atan2))
_ufunc2("copysign", _float2(torch.copysign))


@_np_op("divide")
def divide(x1, x2, out=None, where=True, **kwargs):
    # int/int division is float32 (the mxnet default float), never float64
    fn = _float2(torch.div)
    if where is True or where is None:
        return _invoke(fn, [x1, x2], out)
    if out is None:
        raise ValueError("np.divide: where= requires out=")
    return _invoke(
        lambda a, b, base: torch.where(_mask(where, base),
                                       fn(a, b).to(base.dtype), base),
        [x1, x2, out], out)


true_divide = divide
_EXPLICIT["true_divide"] = divide
__all__.append("true_divide")


def _fl(fn):
    return lambda x: fn(_to_float(x))


def _abs(x):
    return x if _isbool(x) else torch.abs(x)


def _sign(x):
    if _isbool(x):
        raise TypeError("np.sign is not supported for booleans")
    return torch.sign(x)


def _negative(x):
    if _isbool(x):
        raise TypeError("np.negative is not supported for booleans")
    return torch.neg(x)


def _int_identity(fn):
    """Rounding functions: identity on integers and booleans."""
    return lambda x: fn(x) if x.is_floating_point() else x


def _cbrt(x):
    x = _to_float(x)
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_ufunc1("sqrt", _fl(torch.sqrt))
_ufunc1("exp", _fl(torch.exp))
_ufunc1("log", _fl(torch.log))
_ufunc1("log2", _fl(torch.log2))
_ufunc1("log10", _fl(torch.log10))
_ufunc1("abs", _abs)
_ufunc1("absolute", _abs)
_ufunc1("sign", _sign)
_ufunc1("sin", _fl(torch.sin))
_ufunc1("cos", _fl(torch.cos))
_ufunc1("tan", _fl(torch.tan))
_ufunc1("arcsin", _fl(torch.asin))
_ufunc1("arccos", _fl(torch.acos))
_ufunc1("arctan", _fl(torch.atan))
_ufunc1("sinh", _fl(torch.sinh))
_ufunc1("cosh", _fl(torch.cosh))
_ufunc1("tanh", _fl(torch.tanh))
_ufunc1("negative", _negative)
_ufunc1("reciprocal", _fl(torch.reciprocal))
_ufunc1("square", lambda x: torch.square(_int_if_bool(x)))
_ufunc1("rint", _fl(torch.round))
_ufunc1("floor", _int_identity(torch.floor))
_ufunc1("ceil", _int_identity(torch.ceil))
_ufunc1("trunc", _int_identity(torch.trunc))


def _reduce(fn, x, axis, keepdims):
    dims = _axis_dims(axis)
    if dims is None:
        r = fn(x.reshape(-1), dim=0)
        if keepdims:
            r = r.reshape((1,) * x.dim())
        return r
    if not dims:
        return x
    return fn(x, dim=dims, keepdim=keepdims)


def _sum_t(x, dim, keepdim=False):
    return torch.sum(_int_if_bool(x), dim=dim, keepdim=keepdim)


def _prod_t(x, dim, keepdim=False):
    x = _int_if_bool(x)
    if isinstance(dim, tuple):
        for d in sorted((d % x.dim() for d in dim), reverse=True):
            x = torch.prod(x, dim=d, keepdim=keepdim)
        return x
    return torch.prod(x, dim=dim, keepdim=keepdim)


def _amax_t(x, dim, keepdim=False):
    if _isbool(x):
        return torch.amax(x.to(torch.uint8), dim=dim,
                          keepdim=keepdim).to(torch.bool)
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin_t(x, dim, keepdim=False):
    if _isbool(x):
        return torch.amin(x.to(torch.uint8), dim=dim,
                          keepdim=keepdim).to(torch.bool)
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _mean_t(x, dim, keepdim=False):
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _all_t(x, dim, keepdim=False):
    x = x.to(torch.bool)
    if isinstance(dim, tuple):
        return torch.all(x, dim=dim, keepdim=keepdim) if dim else x
    return torch.all(x, dim=dim, keepdim=keepdim)


def _any_t(x, dim, keepdim=False):
    x = x.to(torch.bool)
    return torch.any(x, dim=dim, keepdim=keepdim)


def _nan_fill(x, value):
    if not x.is_floating_point():
        return x
    return torch.where(torch.isnan(x), torch.full_like(x, value), x)


def _nanmax_t(x, dim, keepdim=False):
    if not x.is_floating_point():
        return _amax_t(x, dim, keepdim)
    r = torch.amax(_nan_fill(x, -math.inf), dim=dim, keepdim=keepdim)
    all_nan = torch.all(torch.isnan(x), dim=dim, keepdim=keepdim)
    return torch.where(all_nan, torch.full_like(r, math.nan), r)


def _nanmin_t(x, dim, keepdim=False):
    if not x.is_floating_point():
        return _amin_t(x, dim, keepdim)
    r = torch.amin(_nan_fill(x, math.inf), dim=dim, keepdim=keepdim)
    all_nan = torch.all(torch.isnan(x), dim=dim, keepdim=keepdim)
    return torch.where(all_nan, torch.full_like(r, math.nan), r)


def _nanmean_t(x, dim, keepdim=False):
    return torch.nanmean(x, dim=dim, keepdim=keepdim)


def _reduction(name, fn, float_result=False):
    @_np_op(name)
    def op(a, axis=None, dtype=None, out=None, keepdims=False, **kwargs):
        def pure(x):
            xx = _to_float(x) if float_result and dtype is None else x
            if dtype is not None:
                xx = x.to(_torch_dtype(dtype))
            return _reduce(fn, xx, axis, keepdims)
        return _invoke(pure, [a], out)
    return op


_reduction("sum", _sum_t)
_reduction("prod", _prod_t)
_reduction("mean", _mean_t, float_result=True)
_reduction("max", _amax_t)
_reduction("min", _amin_t)
_reduction("amax", _amax_t)
_reduction("amin", _amin_t)


def _var(x, axis, ddof, keepdims, nan=False):
    dims = _axis_dims(axis)
    if nan:
        mean = torch.nanmean(x, dim=dims, keepdim=True)
        sq = torch.square(x - mean)
        n = torch.sum(~torch.isnan(x), dim=dims, keepdim=keepdims)
        s = torch.nansum(sq, dim=dims, keepdim=keepdims)
        return s / (n - ddof).clamp(min=0).to(x.dtype)
    return torch.var(x, dim=dims, correction=ddof, keepdim=keepdims)


@_np_op("std")
def std(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, **kw):
    def pure(x):
        xx = _to_float(x) if dtype is None else x.to(_torch_dtype(dtype))
        return torch.sqrt(_var(xx, axis, ddof, keepdims))
    return _invoke(pure, [a], out)


@_np_op("var")
def var(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False, **kw):
    def pure(x):
        xx = _to_float(x) if dtype is None else x.to(_torch_dtype(dtype))
        return _var(xx, axis, ddof, keepdims)
    return _invoke(pure, [a], out)


def _arg(fn):
    def pure(x, axis):
        if _isbool(x):
            x = x.to(torch.int32)
        if axis is None:
            return fn(x.reshape(-1)).to(torch.int32)
        return fn(x, dim=axis).to(torch.int32)
    return pure


@_np_op("argmax")
def argmax(a, axis=None, out=None, **kw):
    # int32 indices, as the reference's (torch gives int64)
    return _invoke(lambda x: _arg(torch.argmax)(x, axis), [a], out)


@_np_op("argmin")
def argmin(a, axis=None, out=None, **kw):
    return _invoke(lambda x: _arg(torch.argmin)(x, axis), [a], out)


@_np_op("clip")
def clip(a, a_min=None, a_max=None, out=None, **kw):
    def pure(x):
        lo = None if a_min is None else _unwrap(a_min)
        hi = None if a_max is None else _unwrap(a_max)
        if lo is not None and hi is not None:
            return torch.minimum(torch.maximum(
                x, torch.as_tensor(lo, dtype=x.dtype, device=x.device)),
                torch.as_tensor(hi, dtype=x.dtype, device=x.device))
        return torch.clamp(x, min=lo, max=hi)
    return _invoke(pure, [a], out)


def _dot(x, y):
    if x.dim() == 0 or y.dim() == 0:
        return x * y
    if y.dim() == 1:
        return torch.matmul(x, y)
    if x.dim() <= 2:
        return torch.matmul(x, y)
    return torch.tensordot(x, y, dims=([x.dim() - 1], [y.dim() - 2]))


@_np_op("dot")
def dot(a, b, out=None):
    return _invoke(lambda x, y: _dot(*_promoted(x, y)), [a, b], out)


@_np_op("matmul")
def matmul(a, b, out=None, **kw):
    return _invoke(lambda x, y: torch.matmul(*_promoted(x, y)), [a, b], out)


@_np_op("tensordot")
def tensordot(a, b, axes=2):
    ax = axes
    if isinstance(ax, (list, tuple)):
        ax = tuple(list(x) if isinstance(x, (list, tuple)) else [x]
                   for x in ax)
    return _invoke(lambda x, y: torch.tensordot(*_promoted(x, y), dims=ax),
                   [a, b])


def _cat_dtype(ts):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


@_np_op("concatenate")
def concatenate(seq, axis=0, out=None):
    arrays = list(seq)
    if axis is None:
        return _invoke(lambda *ts: torch.cat(
            [t.reshape(-1) for t in _cat_dtype(ts)]), arrays, out)
    return _invoke(lambda *ts: torch.cat(_cat_dtype(ts), dim=axis), arrays,
                   out)


@_np_op("stack")
def stack(arrays, axis=0, out=None):
    arrays = list(arrays)
    return _invoke(lambda *ts: torch.stack(_cat_dtype(ts), dim=axis), arrays,
                   out)


def _split_points(n, ios, even):
    if isinstance(ios, (list, tuple)):
        pts = [builtins.min(builtins.max(int(i) if i >= 0 else n + int(i),
                                         0), n)
               for i in ios]
        bounds = [0] + pts + [n]
        return [(lo, builtins.max(hi, lo))
                for lo, hi in zip(bounds[:-1], bounds[1:])]
    k = int(ios)
    if even:
        if n % k:
            raise ValueError("array split does not result in an equal "
                             "division")
        step = n // k
        return [(i * step, (i + 1) * step) for i in range(k)]
    q, r = builtins.divmod(n, k)
    out, lo = [], 0
    for i in range(k):
        hi = lo + q + (1 if i < r else 0)
        out.append((lo, hi))
        lo = hi
    return out


def _split(ary, ios, axis, even):
    def pure(x):
        ax = axis % x.dim()
        pts = _split_points(x.shape[ax], ios, even)
        return tuple(x.narrow(ax, lo, hi - lo) for lo, hi in pts)
    outs = _invoke(pure, [ary])
    return list(outs) if isinstance(outs, (tuple, list)) else [outs]


@_np_op("split")
def split(ary, indices_or_sections, axis=0):
    return _split(ary, indices_or_sections, axis, True)


def _nonzero(t):
    return tuple(i.to(torch.int32) for i in torch.nonzero(t, as_tuple=True))


@_np_op("where")
def where(condition, x=None, y=None):
    if x is None and y is None:
        like = _like([condition])
        return tuple(NDArray(i, ctx=like.context if like is not None else None)
                     for i in _nonzero(_tensor(condition)))
    return _invoke(lambda c, a, b: torch.where(c.to(torch.bool),
                                               *_promoted(a, b)),
                   [condition, x, y])


@_np_op("reshape")
def reshape(a, newshape, order="C"):
    shape = (newshape,) if isinstance(newshape, int) else tuple(newshape)
    return _invoke(lambda x: torch.reshape(x, shape), [a])


@_np_op("transpose")
def transpose(a, axes=None):
    return _invoke(lambda x: x.permute(
        tuple(axes) if axes is not None else tuple(range(x.dim() - 1, -1,
                                                         -1))), [a])


@_np_op("swapaxes")
def swapaxes(a, axis1, axis2):
    return _invoke(lambda x: torch.swapaxes(x, axis1, axis2), [a])


@_np_op("expand_dims")
def expand_dims(a, axis):
    def pure(x):
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        nd_ = x.dim() + len(axes)
        for ax in sorted(a_ % nd_ for a_ in axes):
            x = torch.unsqueeze(x, ax)
        return x
    return _invoke(pure, [a])


@_np_op("squeeze")
def squeeze(a, axis=None):
    def pure(x):
        if axis is None:
            return torch.squeeze(x)
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        for ax in axes:
            if x.shape[ax] != 1:
                raise ValueError("cannot select an axis to squeeze out "
                                 "which has size not equal to one")
        return torch.squeeze(x, tuple(axes))
    return _invoke(pure, [a])


@_np_op("broadcast_to")
def broadcast_to(array, shape):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return _invoke(lambda x: torch.broadcast_to(x, shape).clone(), [array])


@_np_op("repeat")
def repeat(a, repeats, axis=None):
    def pure(x):
        r = _unwrap(repeats)
        if isinstance(r, torch.Tensor):
            r = r.to(x.device)
        elif not isinstance(r, int):
            r = torch.as_tensor(_onp.asarray(r), device=x.device)
        if axis is None:
            return torch.repeat_interleave(x.reshape(-1), r)
        return torch.repeat_interleave(x, r, dim=axis)
    return _invoke(pure, [a])


@_np_op("tile")
def tile(a, reps):
    reps_t = (reps,) if isinstance(reps, int) else tuple(reps)
    return _invoke(lambda x: torch.tile(x, reps_t), [a])


def _cum(fn, x, axis, dtype):
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    x = _int_if_bool(x)
    if dtype is not None:
        x = x.to(_torch_dtype(dtype))
    r = fn(x, dim=axis)
    return r.to(x.dtype) if dtype is None else r


@_np_op("cumsum")
def cumsum(a, axis=None, dtype=None, out=None):
    return _invoke(lambda x: _cum(torch.cumsum, x, axis, dtype), [a], out)


@_np_op("copy")
def copy(a):
    return _invoke(lambda x: x.clone(), [a])


def _creation_ctx(ctx, device):
    return ctx or device or current_context()


@_np_op("linspace")
def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None, device=None):
    res = _onp.linspace(start, stop, int(num), endpoint=endpoint,
                        retstep=retstep, dtype=_onp.float64, axis=axis)
    arr, step = res if retstep else (res, None)
    dt = dtype or "float32"
    out = NDArray(arr.astype(_onp.float32) if dt == "float32" else arr,
                  ctx=_creation_ctx(ctx, device), dtype=dt)
    return (out, float(step)) if retstep else out


# ---------------------------------------------------------------------------
# comparisons, logic, bitwise, more ufuncs
# ---------------------------------------------------------------------------

_ufunc2("equal", _cmp(torch.eq))
_ufunc2("not_equal", _cmp(torch.ne))
_ufunc2("less", _cmp(torch.lt))
_ufunc2("less_equal", _cmp(torch.le))
_ufunc2("greater", _cmp(torch.gt))
_ufunc2("greater_equal", _cmp(torch.ge))
_ufunc2("logical_and", torch.logical_and)
_ufunc2("logical_or", torch.logical_or)
_ufunc2("logical_xor", torch.logical_xor)
_ufunc1("logical_not", torch.logical_not)
_ufunc2("bitwise_and", _bitwise2("bitwise_and", torch.bitwise_and))
_ufunc2("bitwise_or", _bitwise2("bitwise_or", torch.bitwise_or))
_ufunc2("bitwise_xor", _bitwise2("bitwise_xor", torch.bitwise_xor))


def _bitwise_not(x):
    if x.is_floating_point():
        raise TypeError("np.bitwise_not is only defined for integers and "
                        "booleans")
    return torch.bitwise_not(x)


_ufunc1("bitwise_not", _bitwise_not)
_ufunc1("invert", _bitwise_not)
_ufunc2("left_shift", _shift("left_shift", torch.bitwise_left_shift))
_ufunc2("right_shift", _shift("right_shift", torch.bitwise_right_shift))
_ufunc2("floor_divide", _int_div(torch.floor_divide,
                                        _floordiv_by_zero))
_ufunc2("fmod", lambda a, b: _int_div(
    torch.fmod, (lambda x: x) if _isbool(a) and _isbool(b)
    else _rem_by_zero)(a, b))  # the reference's bool fmod keeps a
_ufunc2("gcd", _int_only("gcd", torch.gcd))
_ufunc2("lcm", _int_only("lcm", torch.lcm))
_ufunc2("heaviside", _float2(_heaviside))
_ufunc2("logaddexp", _float2(torch.logaddexp))
_ufunc2("fmax", _bool_as(torch.logical_or, torch.fmax))
_ufunc2("fmin", _bool_as(torch.logical_and, torch.fmin))

_ufunc1("expm1", _fl(torch.expm1))
_ufunc1("log1p", _fl(torch.log1p))
_ufunc1("exp2", _fl(torch.exp2))
_ufunc1("cbrt", _cbrt)
_ufunc1("degrees", _fl(torch.rad2deg))
_ufunc1("radians", _fl(torch.deg2rad))
_ufunc1("deg2rad", _fl(torch.deg2rad))
_ufunc1("rad2deg", _fl(torch.rad2deg))
_ufunc1("arcsinh", _fl(torch.asinh))
_ufunc1("arccosh", _fl(torch.acosh))
_ufunc1("arctanh", _fl(torch.atanh))
_ufunc1("isnan", torch.isnan)
_ufunc1("isinf", torch.isinf)
_ufunc1("isfinite", torch.isfinite)
_ufunc1("isposinf", lambda x: torch.isposinf(x) if x.is_floating_point()
        else torch.zeros_like(x, dtype=torch.bool))
_ufunc1("isneginf", lambda x: torch.isneginf(x) if x.is_floating_point()
        else torch.zeros_like(x, dtype=torch.bool))
_ufunc1("fix", _int_identity(torch.trunc))
_ufunc1("positive", lambda x: x.clone())
_ufunc1("conj", lambda x: x.clone())
_ufunc1("conjugate", lambda x: x.clone())


@_np_op("round")
def round(x, decimals=0, out=None, **kw):  # noqa: A001 - numpy name
    def pure(a):
        if _isbool(a):
            raise ValueError("np.round is not supported for booleans")
        if not a.is_floating_point():
            if decimals >= 0:
                return a
            f = 10 ** (-decimals)
            return (torch.round(a.to(torch.float32) / f) * f).to(a.dtype)
        return torch.round(a, decimals=decimals)
    return _invoke(pure, [x], out)


_EXPLICIT["around"] = round
_EXPLICIT["round_"] = round
globals()["around"] = round
globals()["round_"] = round
__all__ += ["around", "round_"]


@_np_op("nan_to_num")
def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    def pure(a):
        if not a.is_floating_point():
            return a.clone()
        return torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)
    return _invoke(pure, [x])


def _nansum_t(x, dim, keepdim=False):
    return _sum_t(_nan_fill(x, 0), dim, keepdim)


def _nanprod_t(x, dim, keepdim=False):
    return _prod_t(_nan_fill(x, 1), dim, keepdim)


_reduction("all", _all_t)
_reduction("any", _any_t)
_reduction("nansum", _nansum_t)
_reduction("nanmax", _nanmax_t)
_reduction("nanmin", _nanmin_t)
_reduction("nanmean", _nanmean_t, float_result=True)
_reduction("nanprod", _nanprod_t)


@_np_op("ptp")
def ptp(a, axis=None, out=None, keepdims=False):
    def pure(x):
        if _isbool(x):
            raise TypeError("np.ptp is not supported for booleans")
        return (_reduce(_amax_t, x, axis, keepdims)
                - _reduce(_amin_t, x, axis, keepdims))
    return _invoke(pure, [a], out)


def _quantile(x, q, axis, keepdims, nan=False):
    """numpy's linear-interpolation quantile, computed in float32 at least
    and returned in the input's float type."""
    dt = x.dtype
    xf = x.to(torch.float32) if dt != torch.float64 else x
    qq = torch.as_tensor(q, dtype=xf.dtype, device=xf.device)
    fn = torch.nanquantile if nan else torch.quantile
    dims = _axis_dims(axis)
    if dims is None:
        r = fn(xf.reshape(-1), qq, dim=0)
        if keepdims:
            r = r.reshape(r.shape + (1,) * x.dim())
    elif len(dims) == 1:
        r = fn(xf, qq, dim=dims[0], keepdim=keepdims)
    else:
        dims = tuple(d % x.dim() for d in dims)
        keep = [d for d in range(x.dim()) if d not in dims]
        moved = xf.permute(keep + list(dims)).reshape(
            [x.shape[d] for d in keep] + [-1])
        r = fn(moved, qq, dim=-1)
        if keepdims:
            r = r.reshape(r.shape[:qq.dim()] + tuple(
                1 if d in dims else x.shape[d] for d in range(x.dim())))
    return r.to(dt)


@_np_op("median")
def median(a, axis=None, out=None, keepdims=False, **kw):
    return _invoke(lambda x: _quantile(_to_float(x), 0.5, axis, keepdims),
                   [a], out)


@_np_op("quantile")
def quantile(a, q, axis=None, out=None, keepdims=False, **kw):
    qv = _onp.asarray(_unwrap(q).cpu() if isinstance(_unwrap(q),
                                                     torch.Tensor)
                      else _unwrap(q), _onp.float32)
    return _invoke(lambda x: _quantile(_to_float(x), qv, axis, keepdims),
                   [a], out)


@_np_op("percentile")
def percentile(a, q, axis=None, out=None, keepdims=False, **kw):
    qv = _onp.asarray(_unwrap(q).cpu() if isinstance(_unwrap(q),
                                                     torch.Tensor)
                      else _unwrap(q), _onp.float32) / 100.0
    return _invoke(lambda x: _quantile(_to_float(x), qv, axis, keepdims),
                   [a], out)


@_np_op("average")
def average(a, axis=None, weights=None, returned=False):
    dims = _axis_dims(axis)
    if weights is None:
        res = _invoke(lambda x: torch.mean(_to_float(x), dim=dims), [a])
        if returned:
            shape = _unwrap(_nd(a)).shape
            axes = range(len(shape)) if dims is None else dims
            cnt = float(_onp.prod([shape[ax] for ax in axes]))
            return res, full_like_scalar(res, cnt)
        return res

    def pure(x, w):
        x, w = _to_float(x), _to_float(w)
        if dims is not None and w.dim() == 1 and x.dim() > 1:
            shape = [1] * x.dim()
            shape[dims[0]] = -1
            w = w.reshape(shape)
        w = torch.broadcast_to(w, x.shape)
        return torch.sum(x * w, dim=dims) / torch.sum(w, dim=dims)
    res = _invoke(pure, [a, weights])
    if returned:
        wsum = _invoke(lambda w: torch.sum(_to_float(w), dim=dims),
                       [weights])
        return res, wsum
    return res


def full_like_scalar(like, value):
    return NDArray(torch.full(tuple(like.shape), value, dtype=torch.float32,
                              device=like._data.device), ctx=like.context)


@_np_op("cumprod")
def cumprod(a, axis=None, dtype=None, out=None):
    return _invoke(lambda x: _cum(torch.cumprod, x, axis, dtype), [a], out)


@_np_op("sort")
def sort(a, axis=-1, kind=None, order=None):
    def pure(x):
        if axis is None:
            return torch.sort(x.reshape(-1), stable=True).values
        return torch.sort(x, dim=axis, stable=True).values
    return _invoke(pure, [a])


@_np_op("argsort")
def argsort(a, axis=-1, kind=None, order=None):
    def pure(x):
        if _isbool(x):
            x = x.to(torch.int32)
        if axis is None:
            x, ax = x.reshape(-1), 0
        else:
            ax = axis
        return torch.argsort(x, dim=ax, stable=True).to(torch.int32)
    return _invoke(pure, [a])


@_np_op("searchsorted")
def searchsorted(a, v, side="left", sorter=None):
    arrays = [a, v] if sorter is None else [a, v, sorter]

    def pure(*ts):
        srt = ts[0] if len(ts) < 3 else ts[0][ts[2].long()]
        s, q = _promoted(srt, ts[1])
        return torch.searchsorted(s, q.contiguous(),
                                  right=side == "right").to(torch.int32)
    return _invoke(pure, arrays)


@_np_op("nonzero")
def nonzero(a):
    like = _like([a])
    return tuple(NDArray(i, ctx=like.context if like is not None else None)
                 for i in _nonzero(_tensor(a)))


@_np_op("count_nonzero")
def count_nonzero(a, axis=None):
    return _invoke(lambda x: torch.count_nonzero(
        x, dim=_axis_dims(axis)).to(torch.int32), [a])


@_np_op("unique")
def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None):
    x = _tensor(ar)
    like = _like([ar])
    flat = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    extras = []
    if return_index:
        n = flat.shape[0] if axis is None else flat.shape[axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((vals.shape[0] if axis is None
                            else vals.shape[axis],), n, dtype=torch.int64,
                           device=x.device)
        first = first.scatter_reduce(0, inv.reshape(-1), pos,
                                     reduce="amin")
        extras.append(first)
    if return_inverse:
        extras.append(inv.reshape(x.shape) if axis is None and False
                      else inv)
    if return_counts:
        extras.append(counts)
    if not extras:
        return _wrap_out(vals, like)
    return tuple([_wrap_out(vals, like)]
                 + [_wrap_out(e.to(torch.int32), like) for e in extras])


@_np_op("bincount")
def bincount(x, weights=None, minlength=0):
    like = _like([x])
    xs = _tensor(x)
    if weights is None:
        return _wrap_out(torch.bincount(xs, minlength=minlength)
                         .to(torch.int32), like)
    w = _tensor(weights, like)
    return _wrap_out(torch.bincount(xs, weights=w, minlength=minlength)
                     .to(w.dtype if w.is_floating_point()
                         else torch.float32), like)


# ---------------------------------------------------------------------------
# shape / manipulation
# ---------------------------------------------------------------------------

@_np_op("ravel")
def ravel(a, order="C"):
    return _invoke(lambda x: x.reshape(-1), [a])


@_np_op("flip")
def flip(m, axis=None):
    return _invoke(lambda x: torch.flip(
        x, tuple(range(x.dim())) if axis is None else _axis_dims(axis)), [m])


@_np_op("flipud")
def flipud(m):
    return _invoke(lambda x: torch.flip(x, (0,)), [m])


@_np_op("fliplr")
def fliplr(m):
    return _invoke(lambda x: torch.flip(x, (1,)), [m])


@_np_op("roll")
def roll(a, shift, axis=None):
    def pure(x):
        if axis is None:
            return torch.roll(x.reshape(-1), shift).reshape(x.shape)
        return torch.roll(x, shift, dims=axis)
    return _invoke(pure, [a])


@_np_op("rot90")
def rot90(m, k=1, axes=(0, 1)):
    return _invoke(lambda x: torch.rot90(x, k, tuple(axes)), [m])


@_np_op("moveaxis")
def moveaxis(a, source, destination):
    return _invoke(lambda x: torch.movedim(x, source, destination), [a])


def _atleast(x, n):
    if n == 1:
        return x.reshape(1) if x.dim() == 0 else x
    if n == 2:
        return x.reshape(1, -1) if x.dim() < 2 else x
    if x.dim() == 0:
        return x.reshape(1, 1, 1)
    if x.dim() == 1:
        return x.reshape(1, -1, 1)
    if x.dim() == 2:
        return x.unsqueeze(-1)
    return x


@_np_op("vstack")
def vstack(tup):
    return _invoke(lambda *ts: torch.cat(
        [_atleast(t, 2) for t in _cat_dtype(ts)], dim=0), list(tup))


@_np_op("hstack")
def hstack(tup):
    def pure(*ts):
        ts = [_atleast(t, 1) for t in _cat_dtype(ts)]
        return torch.cat(ts, dim=0 if ts[0].dim() == 1 else 1)
    return _invoke(pure, list(tup))


@_np_op("dstack")
def dstack(tup):
    return _invoke(lambda *ts: torch.cat(
        [_atleast(t, 3) for t in _cat_dtype(ts)], dim=2), list(tup))


@_np_op("column_stack")
def column_stack(tup):
    return _invoke(lambda *ts: torch.cat(
        [t.reshape(-1, 1) if t.dim() < 2 else t for t in _cat_dtype(ts)],
        dim=1), list(tup))


@_np_op("array_split")
def array_split(ary, indices_or_sections, axis=0):
    return _split(ary, indices_or_sections, axis, False)


@_np_op("atleast_1d")
def atleast_1d(*arys):
    res = [_invoke(lambda x: _atleast(x, 1), [a]) for a in arys]
    return res[0] if len(res) == 1 else res


@_np_op("atleast_2d")
def atleast_2d(*arys):
    res = [_invoke(lambda x: _atleast(x, 2), [a]) for a in arys]
    return res[0] if len(res) == 1 else res


@_np_op("atleast_3d")
def atleast_3d(*arys):
    res = [_invoke(lambda x: _atleast(x, 3), [a]) for a in arys]
    return res[0] if len(res) == 1 else res


@_np_op("pad")
def pad(array, pad_width, mode="constant", **kwargs):
    def pure(x):
        pw = _onp.broadcast_to(_onp.asarray(pad_width, _onp.int64)
                               .reshape(-1, 2)
                               if _onp.ndim(pad_width) == 2
                               else _onp.asarray(pad_width, _onp.int64),
                               (x.dim(), 2))
        flat = []
        for lo, hi in pw[::-1]:
            flat += [int(lo), int(hi)]
        if mode == "constant":
            value = kwargs.get("constant_values", 0)
            return torch.nn.functional.pad(x, flat, mode="constant",
                                           value=float(value))
        tmode = {"edge": "replicate", "reflect": "reflect",
                 "wrap": "circular"}.get(mode)
        if tmode is None:
            raise NotImplementedError(f"np.pad mode {mode!r}")
        y = x.reshape((1, 1) + tuple(x.shape)) if x.dim() <= 3 else x
        out = torch.nn.functional.pad(_to_float(y), flat, mode=tmode)
        return out.reshape(out.shape[2:] if x.dim() <= 3 else out.shape) \
            .to(x.dtype)
    return _invoke(pure, [array])


@_np_op("take")
def take(a, indices, axis=None, mode="raise", out=None):
    # device arrays cannot raise on bad indices: 'raise' behaves as 'clip',
    # as the reference documents
    def pure(x, idx):
        idx = idx.long()
        src = x.reshape(-1) if axis is None else x
        ax = 0 if axis is None else axis % x.dim()
        n = src.shape[ax]
        idx = torch.remainder(idx, n) if mode == "wrap" \
            else torch.clamp(idx, 0, n - 1)
        res = torch.index_select(src, ax, idx.reshape(-1))
        return res.reshape(src.shape[:ax] + idx.shape + src.shape[ax + 1:])
    return _invoke(pure, [a, indices], out)


@_np_op("take_along_axis")
def take_along_axis(arr, indices, axis):
    def pure(x, idx):
        idx = idx.long()
        if axis is None:
            x = x.reshape(-1)
            ax = 0
        else:
            ax = axis
        n = x.shape[ax]
        idx = torch.where(idx < 0, idx + n, idx)
        shape = list(torch.broadcast_shapes(
            tuple(s if d != ax % x.dim() else 1
                  for d, s in enumerate(x.shape)),
            tuple(s if d != ax % x.dim() else 1
                  for d, s in enumerate(idx.shape))))
        xs = list(shape)
        xs[ax % x.dim()] = x.shape[ax]
        ish = list(shape)
        ish[ax % x.dim()] = idx.shape[ax]
        return torch.gather(x.expand(xs), ax,
                            idx.clamp(0, n - 1).expand(ish))
    return _invoke(pure, [arr, indices])


@_np_op("meshgrid")
def meshgrid(*xi, indexing="xy", **kw):
    like = _like(xi)
    outs = torch.meshgrid(*[_tensor(x, like) for x in xi],
                          indexing=indexing)
    return [_wrap_out(o.clone(), like) for o in outs]


@_np_op("diff")
def diff(a, n=1, axis=-1):
    return _invoke(lambda x: torch.diff(_int_if_bool(x), n=n, dim=axis)
                   if not _isbool(x) else torch.diff(x, n=n, dim=axis), [a])


@_np_op("ediff1d")
def ediff1d(ary, to_end=None, to_begin=None):
    def pure(x):
        d = torch.diff(x.reshape(-1))
        parts = []
        if to_begin is not None:
            parts.append(_tensor(to_begin, None).to(d).reshape(-1))
        parts.append(d)
        if to_end is not None:
            parts.append(_tensor(to_end, None).to(d).reshape(-1))
        return torch.cat(parts) if len(parts) > 1 else d
    return _invoke(pure, [ary])


def _interp(x, xp, fp, left=None, right=None, period=None):
    if period is not None:
        raise NotImplementedError("np.interp(period=) is not ported")
    idx = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    idx = idx.clamp(1, xp.shape[0] - 1)
    x0, x1 = xp[idx - 1], xp[idx]
    y0, y1 = fp[idx - 1], fp[idx]
    t = (x - x0) / (x1 - x0)
    y = y0 + t * (y1 - y0)
    lo = fp[0] if left is None else torch.as_tensor(left, dtype=y.dtype)
    hi = fp[-1] if right is None else torch.as_tensor(right, dtype=y.dtype)
    y = torch.where(x < xp[0], lo, y)
    y = torch.where(x > xp[-1], hi, y)
    return torch.where(x == xp[-1], fp[-1], y)


@_np_op("interp")
def interp(x, xp, fp, left=None, right=None, period=None):
    return _invoke(lambda a, b, c: _interp(
        _to_float(a), _to_float(b), _to_float(c), left, right, period),
        [x, xp, fp])


# ---------------------------------------------------------------------------
# linear-algebra-adjacent
# ---------------------------------------------------------------------------

@_np_op("outer")
def outer(a, b, out=None):
    return _invoke(lambda x, y: torch.outer(*_promoted(x.reshape(-1),
                                                       y.reshape(-1))),
                   [a, b], out)


@_np_op("inner")
def inner(a, b):
    def pure(x, y):
        x, y = _promoted(x, y)
        if x.dim() == 0 or y.dim() == 0:
            return x * y
        return torch.tensordot(x, y, dims=([x.dim() - 1], [y.dim() - 1]))
    return _invoke(pure, [a, b])


@_np_op("vdot")
def vdot(a, b):
    return _invoke(lambda x, y: torch.dot(*_promoted(x.reshape(-1),
                                                     y.reshape(-1))), [a, b])


@_np_op("kron")
def kron(a, b):
    return _invoke(lambda x, y: torch.kron(*_promoted(x, y)), [a, b])


@_np_op("cross")
def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    def pure(x, y):
        x, y = _promoted(x, y)
        if axis is not None:
            ax_a = ax_b = ax_c = axis
        else:
            ax_a, ax_b, ax_c = axisa, axisb, axisc
        x = torch.movedim(x, ax_a, -1)
        y = torch.movedim(y, ax_b, -1)
        if x.shape[-1] == 2:
            x = torch.nn.functional.pad(x, (0, 1))
        if y.shape[-1] == 2:
            y = torch.nn.functional.pad(y, (0, 1))
        x, y = torch.broadcast_tensors(x, y)
        r = torch.linalg.cross(x, y, dim=-1)
        if _unwrap(a).shape[ax_a] == 2 and _unwrap(b).shape[ax_b] == 2:
            return r[..., 2]
        return torch.movedim(r, -1, ax_c)
    return _invoke(pure, [a, b])


@_np_op("trace")
def trace(a, offset=0, axis1=0, axis2=1, dtype=None, out=None):
    def pure(x):
        r = torch.sum(torch.diagonal(_int_if_bool(x), offset=offset,
                                     dim1=axis1, dim2=axis2), dim=-1)
        return r.to(_torch_dtype(dtype)) if dtype else r
    return _invoke(pure, [a], out)


@_np_op("diag")
def diag(v, k=0):
    return _invoke(lambda x: torch.diag(x, k), [v])


@_np_op("diagonal")
def diagonal(a, offset=0, axis1=0, axis2=1):
    return _invoke(lambda x: torch.diagonal(x, offset=offset, dim1=axis1,
                                            dim2=axis2).clone(), [a])


@_np_op("tril")
def tril(m, k=0):
    return _invoke(lambda x: torch.tril(x, k), [m])


@_np_op("triu")
def triu(m, k=0):
    return _invoke(lambda x: torch.triu(x, k), [m])


@_np_op("einsum")
def einsum(subscripts, *operands, out=None, **kwargs):
    return _invoke(lambda *ts: torch.einsum(subscripts, *_cat_dtype(ts)),
                   list(operands), out)


@_np_op("maximum_reduce")
def maximum_reduce(a, axis=None, keepdims=False):
    return _invoke(lambda x: _reduce(_amax_t, x, axis, keepdims), [a])


# ---------------------------------------------------------------------------
# creation (float32 default, never float64)
# ---------------------------------------------------------------------------

def _created(arr, dtype, ctx, device):
    return NDArray(_onp.asarray(arr).astype(
        _onp.float32 if dtype is None else _np_dtype(dtype)),
        ctx=_creation_ctx(ctx, device))


def _np_dtype(dtype):
    from ..base import dtype_name

    name = dtype_name(dtype)
    if name == "bfloat16":
        raise TypeError("bfloat16 creation goes through astype")
    return _onp.dtype(name)


@_np_op("eye")
def eye(N, M=None, k=0, dtype=None, ctx=None, device=None):
    return _created(_onp.eye(int(N), None if M is None else int(M), k=k),
                    dtype, ctx, device)


@_np_op("identity")
def identity(n, dtype=None, ctx=None, device=None):
    return _created(_onp.identity(int(n)), dtype, ctx, device)


@_np_op("logspace")
def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None, device=None):
    exps = _onp.linspace(start, stop, int(num), endpoint=endpoint,
                         dtype=_onp.float32, axis=axis)
    return _created(_onp.power(_onp.float32(base), exps), dtype, ctx,
                    device)


@_np_op("tri")
def tri(N, M=None, k=0, dtype=None, ctx=None, device=None):
    return _created(_onp.tri(int(N), None if M is None else int(M), k=k),
                    dtype, ctx, device)


@_np_op("zeros_like")
def zeros_like(a, dtype=None, order="C", ctx=None, device=None):
    return _invoke(lambda x: torch.zeros_like(x, dtype=_torch_dtype(dtype)),
                   [a])


@_np_op("ones_like")
def ones_like(a, dtype=None, order="C", ctx=None, device=None):
    return _invoke(lambda x: torch.ones_like(x, dtype=_torch_dtype(dtype)),
                   [a])


@_np_op("full_like")
def full_like(a, fill_value, dtype=None, order="C", ctx=None, device=None):
    return _invoke(lambda x: torch.full_like(
        x, _unwrap(fill_value), dtype=_torch_dtype(dtype)), [a])


def _isclose(x, y, rtol, atol, equal_nan):
    x, y = _promoted(_to_float(x), _to_float(y))
    return torch.isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)


@_np_op("isclose")
def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return _invoke(lambda x, y: _isclose(x, y, rtol, atol, equal_nan),
                   [a, b])


@_np_op("allclose")
def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    like = _like([a, b])
    return bool(torch.all(_isclose(_tensor(a, like), _tensor(b, like), rtol,
                                   atol, equal_nan)))


@_np_op("array_equal")
def array_equal(a1, a2, equal_nan=False):
    like = _like([a1, a2])
    x, y = _tensor(a1, like), _tensor(a2, like)
    if x.shape != y.shape:
        return False
    eq = x == y
    if equal_nan and x.is_floating_point():
        eq = eq | (torch.isnan(x) & torch.isnan(y))
    return bool(torch.all(eq))


# ---------------------------------------------------------------------------
# the rest of the reference's explicit surface
# ---------------------------------------------------------------------------

def _tape_fn(fn):
    """Bind a torch function of numpy semantics: NDArray arguments ride
    the tape, everything else passes through (lists of arrays included)."""
    def op(*args, **kwargs):
        like = _like(list(args) + list(kwargs.values()))

        def deep(v):
            if isinstance(v, NDArray):
                return v._data
            if isinstance(v, (list, tuple)):
                return type(v)(deep(u) for u in v)
            return v

        kw = {k: deep(v) for k, v in kwargs.items()}
        arr_idx = [i for i, a in enumerate(args) if isinstance(a, NDArray)]
        if not arr_idx:
            return _wrap_out(fn(*[deep(a) for a in args], **kw), like)
        idx_set = set(arr_idx)

        def pure(*tensors):
            it = iter(tensors)
            rebuilt = [next(it) if i in idx_set else deep(args[i])
                       for i in range(len(args))]
            return fn(*rebuilt, **kw)

        return _invoke(pure, [args[i] for i in arr_idx])
    return op


def _tape_op(name, fn):
    return _np_op(name)(_tape_fn(fn))


def _dev(*ts):
    for t in ts:
        if isinstance(t, torch.Tensor):
            return t.device
    return current_context().torch_device()


def _as_t(v, like_t=None):
    if isinstance(v, torch.Tensor):
        return v
    t = _x32(torch.as_tensor(_onp.asarray(v)))
    return t.to(like_t.device) if like_t is not None else t


def _nextafter(a, b):
    a, b = _promoted(_to_float(a), _to_float(b))
    return torch.nextafter(a, b)


def _ldexp(a, b):
    if b.is_floating_point():
        raise ValueError("np.ldexp: the exponent must be an integer")
    a = _to_float(a)
    return a * torch.pow(torch.tensor(2.0, dtype=a.dtype, device=a.device),
                         _int_if_bool(b).to(a.dtype))


def _frexp(x):
    m, e = torch.frexp(_to_float(x))
    return m, e.to(torch.int32)


def _divmod(a, b):
    return (_int_div(torch.floor_divide, _floordiv_by_zero)(a, b),
            _int_div(torch.remainder, _rem_by_zero)(a, b))


def _nanarg(fn, fill):
    def f(x, axis=None, **kw):
        xx = _nan_fill(x, fill)
        if _isbool(xx):
            xx = xx.to(torch.int32)
        if axis is None:
            return fn(xx.reshape(-1)).to(torch.int32)
        return fn(xx, dim=axis).to(torch.int32)
    return f


def _nancum(fn, fill):
    def f(x, axis=None, dtype=None, **kw):
        return _cum(fn, _nan_fill(x, fill), axis, dtype)
    return f


def _isin(element, test_elements, assume_unique=False, invert=False):
    r = torch.isin(element, _as_t(test_elements, element).to(element.dtype))
    return ~r if invert else r


def _digitize(x, bins, right=False):
    b = _as_t(bins, x)
    if b.shape[0] > 1 and bool(b[0] > b[-1]):
        n = b.shape[0]
        return (n - torch.searchsorted(b.flip(0).contiguous(),
                                       x.contiguous(), right=not right)
                ).to(torch.int32)
    return torch.searchsorted(b.contiguous(), x.contiguous(),
                              right=not right).to(torch.int32)


def _broadcast_arrays(*ts):
    ts = [_as_t(t) for t in ts]
    return [t.clone() for t in torch.broadcast_tensors(*ts)]


def _vander(x, N=None, increasing=False):
    return torch.vander(x.reshape(-1), N=N, increasing=increasing)


def _delete(arr, obj, axis=None):
    x = arr.reshape(-1) if axis is None else arr
    ax = 0 if axis is None else axis % arr.dim()
    n = x.shape[ax]
    idx = _onp.arange(n)[obj] if isinstance(obj, slice) \
        else _onp.asarray(obj.cpu() if isinstance(obj, torch.Tensor)
                          else obj).reshape(-1)
    keep = _onp.ones(n, bool)
    keep[_onp.asarray(idx) % builtins.max(n, 1)] = False
    return torch.index_select(x, ax, torch.from_numpy(
        _onp.nonzero(keep)[0]).to(x.device))


def _append(arr, values, axis=None):
    v = _as_t(values, arr)
    if axis is None:
        a, b = _promoted(arr.reshape(-1), v.reshape(-1))
        return torch.cat([a, b])
    a, b = _promoted(arr, v)
    return torch.cat([a, b], dim=axis)


def _resize(a, new_shape):
    shape = (new_shape,) if isinstance(new_shape, int) else tuple(new_shape)
    total = int(_onp.prod(shape)) if shape else 1
    flat = a.reshape(-1)
    if flat.shape[0] == 0:
        return torch.zeros(shape, dtype=a.dtype, device=a.device)
    reps = -(-total // flat.shape[0])
    return flat.repeat(reps)[:total].reshape(shape)


def _compress(condition, a, axis=None):
    c = _as_t(condition, a).to(torch.bool).reshape(-1)
    x = a.reshape(-1) if axis is None else a
    ax = 0 if axis is None else axis % a.dim()
    idx = torch.nonzero(c[:x.shape[ax]]).reshape(-1)
    return torch.index_select(x, ax, idx)


def _extract(condition, arr):
    c = _as_t(condition, arr).to(torch.bool).reshape(-1)
    return arr.reshape(-1)[c]


def _unwrap_phase(p, discont=None, axis=-1, period=2 * math.pi):
    p = _to_float(p)
    dd = torch.diff(p, dim=axis)
    half = period / 2
    disc = half if discont is None else builtins.max(discont, half)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    corr = torch.where(torch.abs(dd) < disc, torch.zeros_like(dd),
                       ddmod - dd)
    first = p.narrow(axis, 0, 1)
    return torch.cat([first, p.narrow(axis, 1, p.shape[axis] - 1)
                      + torch.cumsum(corr, dim=axis)], dim=axis)


def _select(condlist, choicelist, default=0):
    choices = [_as_t(c) for c in choicelist]
    conds = [_as_t(c).to(torch.bool) for c in condlist]
    dev = _dev(*choices, *conds)
    choices = _cat_dtype([c.to(dev) for c in choices])
    out = torch.full(torch.broadcast_shapes(
        *[c.shape for c in choices], *[c.shape for c in conds]),
        float(_unwrap(default)) if not isinstance(_unwrap(default),
                                                  torch.Tensor)
        else 0.0, dtype=choices[0].dtype, device=dev)
    for c, v in reversed(list(zip(conds, choices))):
        out = torch.where(c.to(dev), v, out)
    return out


def _trim_zeros(filt, trim="fb"):
    nz = torch.nonzero(filt.reshape(-1)).reshape(-1)
    if nz.numel() == 0:
        return filt[:0]
    lo = int(nz[0]) if "f" in trim.lower() else 0
    hi = int(nz[-1]) + 1 if "b" in trim.lower() else filt.shape[0]
    return filt[lo:hi]


def _conv_full(a, v, mode, flip):
    a, v = _promoted(a.reshape(-1), v.reshape(-1))
    if a.shape[0] < v.shape[0] and flip:
        a, v = v, a
    dt = a.dtype
    af, vf = _to_float(a), _to_float(v)
    k = vf.flip(0) if flip else vf
    n, m = af.shape[0], k.shape[0]
    full = torch.nn.functional.conv1d(af.reshape(1, 1, -1),
                                      k.reshape(1, 1, -1),
                                      padding=m - 1).reshape(-1)
    if mode == "full":
        r = full
    elif mode == "same":
        start = (m - 1) // 2 if flip else (m - 1) // 2
        r = full[start:start + builtins.max(n, m)]
    elif mode == "valid":
        r = full[m - 1:n]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return r if dt.is_floating_point else r.round().to(dt)


def _convolve(a, v, mode="full"):
    return _conv_full(a, v, mode, True)


def _correlate(a, v, mode="valid"):
    a, v = _promoted(a.reshape(-1), v.reshape(-1))
    n, m = a.shape[0], v.shape[0]
    af, vf = _to_float(a), _to_float(v)
    full = torch.nn.functional.conv1d(af.reshape(1, 1, -1),
                                      vf.reshape(1, 1, -1),
                                      padding=m - 1).reshape(-1)
    if mode == "full":
        r = full
    elif mode == "same":
        start = (builtins.min(n, m) - 1) // 2 + (m - 1 - (builtins.min(n, m)
                                                           - 1))
        r = full[start:start + builtins.max(n, m)] if n >= m else full[
            (m - 1) // 2:(m - 1) // 2 + m]
    elif mode == "valid":
        r = full[m - 1:n] if n >= m else full[n - 1:m].flip(0)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return r if a.is_floating_point() else r.round().to(a.dtype)


def _polyval(p, x):
    p = _as_t(p)
    x = _as_t(x)
    p, x = _promoted(p.to(_dev(x, p)), x)
    y = torch.zeros_like(x)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


def _gradient(f, *varargs, axis=None, edge_order=1):
    f = _to_float(f)
    dims = list(range(f.dim())) if axis is None else list(_axis_dims(axis))
    spacing = [float(v) for v in varargs] if varargs else 1.0
    outs = torch.gradient(f, spacing=spacing if isinstance(spacing, list)
                          and len(spacing) == len(dims) else
                          (spacing[0] if isinstance(spacing, list)
                           else spacing),
                          dim=dims, edge_order=edge_order)
    return outs[0] if len(outs) == 1 else list(outs)


def _histogram(a, bins=10, range=None, weights=None, density=None):
    x = _to_float(a).reshape(-1)
    if isinstance(bins, torch.Tensor) or not isinstance(bins, int):
        edges = _as_t(bins, x).to(x.dtype)
    else:
        lo, hi = (range if range is not None
                  else (float(x.min()), float(x.max())))
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = torch.linspace(lo, hi, bins + 1, dtype=x.dtype,
                               device=x.device)
    nb = edges.shape[0] - 1
    idx = torch.searchsorted(edges.contiguous(), x.contiguous(),
                             right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, nb - 1), idx)
    valid = (idx >= 0) & (idx < nb)
    w = torch.ones_like(x) if weights is None \
        else _as_t(weights, x).reshape(-1).to(x.dtype)
    counts = torch.zeros(nb, dtype=x.dtype, device=x.device).index_add(
        0, idx.clamp(0, nb - 1), torch.where(valid, w, torch.zeros_like(w)))
    if density:
        counts = counts / torch.diff(edges) / counts.sum()
    return counts, edges


def _tri_indices(fn):
    def f(n, k=0, m=None):
        idx = fn(int(n), int(n if m is None else m), int(k))
        return tuple(i.to(torch.int32) for i in idx)
    return f


def _diag_indices(n, ndim=2):
    i = torch.arange(int(n), dtype=torch.int32)
    return tuple(i for _ in builtins.range(ndim))


def _indices(dimensions, dtype=None, sparse=False):
    dt = _torch_dtype(dtype) or torch.int32
    grids = torch.meshgrid(*[torch.arange(int(d), dtype=dt)
                             for d in dimensions], indexing="ij")
    if sparse:
        return tuple(g[tuple(slice(None) if j == i else slice(0, 1)
                             for j in builtins.range(len(dimensions)))]
                     for i, g in enumerate(grids))
    return torch.stack(grids)


def _ix(*args):
    n = len(args)
    out = []
    for i, a in enumerate(args):
        t = _as_t(a)
        if t.dtype == torch.bool:
            t = torch.nonzero(t).reshape(-1).to(torch.int32)
        shape = [1] * n
        shape[i] = -1
        out.append(t.reshape(shape))
    return tuple(out)


def _unravel_index(indices, shape):
    t = _as_t(indices)
    return tuple(i.to(torch.int32) for i in torch.unravel_index(
        t.long(), tuple(shape)))


def _ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    idx = [_as_t(i).long() for i in multi_index]
    dev = _dev(*idx)
    out = torch.zeros_like(idx[0], device=dev)
    for i, d in zip(idx, dims):
        i = i.to(dev)
        if mode == "wrap":
            i = torch.remainder(i, d)
        else:
            i = i.clamp(0, d - 1)
        out = out * int(d) + i
    return out.to(torch.int32)


def _flatnonzero(x):
    return torch.nonzero(x.reshape(-1)).reshape(-1).to(torch.int32)


def _signbit(x):
    if not x.is_floating_point():
        return x < 0 if not _isbool(x) else torch.zeros_like(x)
    return torch.signbit(x)


def _imag(x):
    return torch.zeros_like(x)


def _angle(x, deg=False):
    x = _to_float(x)
    r = torch.where(x < 0, torch.full_like(x, math.pi), torch.zeros_like(x))
    return torch.rad2deg(r) if deg else r


for _nm, _fn in [
    ("signbit", _signbit), ("real", lambda x: x.clone()), ("imag", _imag),
    ("angle", _angle), ("sinc", _fl(torch.sinc)), ("i0", _fl(torch.i0)),
    ("fabs", _fl(torch.abs)), ("flatnonzero", _flatnonzero),
    ("nextafter", _nextafter), ("ldexp", _ldexp),
    ("frexp", _frexp), ("logaddexp2", _float2(_logaddexp2)),
    ("divmod", _divmod), ("nanargmax", _nanarg(torch.argmax, -math.inf)),
    ("nanargmin", _nanarg(torch.argmin, math.inf)),
    ("nancumsum", _nancum(torch.cumsum, 0)),
    ("nancumprod", _nancum(torch.cumprod, 1)),
    ("isin", _isin), ("digitize", _digitize),
    ("broadcast_arrays", _broadcast_arrays),
    ("row_stack", lambda tup: torch.cat(
        [_atleast(t, 2) for t in _cat_dtype([_as_t(t) for t in tup])],
        dim=0)),
    ("vander", _vander), ("delete", _delete), ("append", _append),
    ("resize", _resize), ("compress", _compress), ("extract", _extract),
    ("unwrap", _unwrap_phase), ("select", _select),
    ("trim_zeros", _trim_zeros), ("convolve", _convolve),
    ("correlate", _correlate), ("polyval", _polyval),
    ("gradient", _gradient), ("histogram", _histogram),
    ("tril_indices", _tri_indices(torch.tril_indices)),
    ("triu_indices", _tri_indices(torch.triu_indices)),
    ("diag_indices", _diag_indices), ("indices", _indices),
    ("ix_", _ix), ("unravel_index", _unravel_index),
    ("ravel_multi_index", _ravel_multi_index),
]:
    _tape_op(_nm, _fn)


@_np_op("insert")
def insert(arr, obj, values, axis=None):
    """numpy's ``insert``: a scalar ``obj`` inserts ``values`` (padded to
    the array's rank and moved onto ``axis``) as one block; a sequence
    inserts one slice before each position, in the given order."""
    o = _unwrap(obj)
    pos = _onp.asarray(o.cpu() if isinstance(o, torch.Tensor) else o)

    def pure(a, v):
        x = a.reshape(-1) if axis is None else a
        ax = 0 if axis is None else axis % a.dim()
        n = x.shape[ax]
        v = v.to(x.dtype)
        shape = list(x.shape)
        if pos.ndim == 0:
            p = int(pos) + n if int(pos) < 0 else int(pos)
            v = torch.movedim(v.reshape((1,) * (x.dim() - v.dim())
                                        + tuple(v.shape)), 0, ax)
            shape[ax] = v.shape[ax]
            return torch.cat([x.narrow(ax, 0, p), v.broadcast_to(shape),
                              x.narrow(ax, p, n - p)], dim=ax)
        idx = _onp.where(pos < 0, pos + n, pos).astype(_onp.int64)
        shape[ax] = len(idx)
        v = v.broadcast_to(shape)
        pieces, last = [], 0
        for j in _onp.argsort(idx, kind="stable"):
            pieces += [x.narrow(ax, last, int(idx[j]) - last),
                       v.narrow(ax, int(j), 1)]
            last = int(idx[j])
        pieces.append(x.narrow(ax, last, n - last))
        return torch.cat(pieces, dim=ax)
    return _invoke(pure, [arr, values])


@_np_op("float_power")
def float_power(x1, x2, out=None, **kw):
    # numpy promises float64; the mxnet default float is float32
    return _invoke(_float2(torch.pow), [x1, x2], out)


@_np_op("trapz")
def trapz(y, x=None, dx=1.0, axis=-1):
    arrays = [y] if x is None else [y, x]

    def pure(yy, *maybe_x):
        yy = _to_float(yy)
        if maybe_x:
            return torch.trapezoid(yy, _to_float(maybe_x[0]).to(yy.dtype),
                                   dim=axis)
        return torch.trapezoid(yy, dx=dx, dim=axis)
    return _invoke(pure, arrays)


@_np_op("nanstd")
def nanstd(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
    # int inputs promote to float32; float inputs keep their dtype
    def pure(x):
        r = torch.sqrt(_var(_to_float(x), axis, ddof, keepdims, nan=True))
        return r.to(_torch_dtype(dtype)) if dtype is not None else r
    return _invoke(pure, [a], out)


@_np_op("nanvar")
def nanvar(a, axis=None, dtype=None, out=None, ddof=0, keepdims=False):
    def pure(x):
        r = _var(_to_float(x), axis, ddof, keepdims, nan=True)
        return r.to(_torch_dtype(dtype)) if dtype is not None else r
    return _invoke(pure, [a], out)


@_np_op("geomspace")
def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0,
              ctx=None, device=None):
    out = _onp.geomspace(float(_unwrap(start)), float(_unwrap(stop)),
                         num=num, endpoint=endpoint, axis=axis)
    return _created(out.astype(_onp.float32), dtype, ctx, device)


@_np_op("asarray")
def asarray(a, dtype=None, ctx=None, device=None):
    if isinstance(a, NDArray) and dtype is None:
        return a
    from ..ndarray import array as nd_array

    return nd_array(a, ctx=ctx or device, dtype=dtype)


@_np_op("ascontiguousarray")
def ascontiguousarray(a, dtype=None):
    return asarray(a, dtype=dtype)


@_np_op("empty_like")
def empty_like(a, dtype=None, order="C", ctx=None, device=None):
    return _invoke(lambda x: torch.zeros_like(x, dtype=_torch_dtype(dtype)),
                   [a])


@_np_op("ndim")
def ndim(a):
    return len(a.shape) if hasattr(a, "shape") else _onp.ndim(a)


@_np_op("shape")
def shape(a):
    return tuple(a.shape) if hasattr(a, "shape") else _onp.shape(a)


@_np_op("size")
def size(a, axis=None):
    if not hasattr(a, "shape"):
        return _onp.size(a, axis)
    if axis is None:
        n = 1
        for d in a.shape:
            n *= d
        return n
    return a.shape[axis]


@_np_op("put")
def put(a, ind, v, mode="clip"):
    """In place, by rebinding the array's buffer. ``mode='raise'`` behaves
    as ``'clip'``, as the reference documents."""
    if not isinstance(a, NDArray):
        raise TypeError("np.put needs an mx.np.ndarray")
    flat = a._data.reshape(-1)
    n = flat.shape[0]
    idx = _tensor(ind, a).reshape(-1).long()
    idx = torch.remainder(idx, n) if mode == "wrap" \
        else torch.clamp(idx, -n, n - 1)
    idx = torch.where(idx < 0, idx + n, idx)
    vals = _tensor(v, a).to(flat.dtype).reshape(-1)
    if vals.shape[0] < idx.shape[0]:  # numpy cycles short value vectors
        vals = vals.repeat(-(-idx.shape[0] // (vals.shape[0] or 1)))
    a._set_data(flat.clone().index_put_((idx,), vals[:idx.shape[0]])
                .reshape(a.shape))


@_np_op("place")
def place(a, mask, vals):
    if not isinstance(a, NDArray):
        raise TypeError("np.place needs an mx.np.ndarray")
    m = _tensor(mask, a).to(torch.bool).reshape(-1)
    flat = a._data.reshape(-1)
    v = _tensor(vals, a).to(flat.dtype).reshape(-1)
    n = int(m.sum())
    reps = -(-n // (v.shape[0] or 1))
    vfull = v.repeat(builtins.max(reps, 1))[:flat.shape[0]]
    pos = torch.clamp(torch.cumsum(m.to(torch.int64), 0) - 1, min=0)
    pos = torch.clamp(pos, max=builtins.max(vfull.shape[0] - 1, 0))
    a._set_data(torch.where(m, vfull[pos], flat).reshape(a.shape))


@_np_op("fill_diagonal")
def fill_diagonal(a, val, wrap=False):
    if not isinstance(a, NDArray):
        raise TypeError("np.fill_diagonal needs an mx.np.ndarray")
    x = a._data.clone()
    if x.dim() == 2:
        rows, cols = x.shape
        step = cols + 1
        end = rows * cols if wrap else builtins.min(rows, cols) * cols
        flat = x.reshape(-1)
        idx = torch.arange(0, end, step, device=x.device)
        v = _tensor(val, a).to(x.dtype).reshape(-1)
        flat[idx] = v.repeat(-(-idx.shape[0] // v.shape[0]))[:idx.shape[0]]
        x = flat.reshape(x.shape)
    else:
        n = builtins.min(x.shape)
        i = torch.arange(n, device=x.device)
        x[tuple(i for _ in x.shape)] = _tensor(val, a).to(x.dtype)
    a._set_data(x)


@_np_op("iscomplexobj")
def iscomplexobj(x):
    t = _unwrap(x)
    return bool(t.is_complex()) if isinstance(t, torch.Tensor) \
        else bool(_onp.iscomplexobj(t))


@_np_op("isrealobj")
def isrealobj(x):
    return not iscomplexobj(x)


@_np_op("array_equiv")
def array_equiv(a1, a2):
    like = _like([a1, a2])
    x, y = _tensor(a1, like), _tensor(a2, like)
    try:
        x, y = torch.broadcast_tensors(x, y)
    except RuntimeError:
        return False
    return bool(torch.all(x == y))
