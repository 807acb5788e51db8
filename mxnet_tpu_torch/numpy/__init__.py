"""``mx.np`` — the NumPy-compatible frontend (counterpart of
``mxnet_tpu/numpy/__init__.py``).

Two layers:

- ``_ops.py`` carries the explicit operators with mxnet-numpy semantics:
  ``out=``, ``where=``, 32-bit default types, NDArray returns on the
  autograd tape;
- beyond those, the reference resolves any ``jax.numpy`` callable through
  a delegate. A torch function of the same name does not share numpy's
  semantics (``torch.std`` is unbiased, ``torch.median`` takes the lower
  median, ``torch.split`` takes sizes, indices are int64), so nothing is
  forwarded to torch by name: :data:`_DELEGATES` is an explicit table,
  each entry written with numpy's semantics, and every other name of the
  reference's delegate surface (:data:`_RAISES`) raises
  :class:`MXNetError` naming it. The dtype queries (``result_type``,
  ``promote_types``, ``can_cast``, ``issubdtype``, ``broadcast_shapes``)
  compute no array and answer as the reference's.

The names that are not functions take numpy's values: the dtype names
and the scalar hierarchy, ``dtype``, ``finfo``/``iinfo`` (bfloat16's the
reference's, numpy having no bfloat16), ``s_`` and ``index_exp``.
The names whose reference value is a JAX object (:data:`_JAX_ONLY`: the
index helpers ``r_``/``c_``/``mgrid``/``ogrid``, ``fft``, ``ufunc``,
``jnp``, the narrow float and int types) raise :class:`MXNetError`
naming themselves.
"""
from __future__ import annotations

import math

import numpy as _onp
import torch

from ..base import MXNetError, dtype_name, dtype_torch
from ..context import current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import invoke_fn  # noqa: F401 — the reference's name
from . import linalg, random  # noqa: F401 — mx.np.random / mx.np.linalg
from . import _ops
from ._ops import *  # noqa: F401,F403
from ._ops import _invoke, _like, _nd, _tape_fn, _to_float

__all__ = ["ndarray", "array", "zeros", "ones", "empty", "full", "arange",
           "random", "linalg"]

ndarray = NDArray

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
euler_gamma = _onp.euler_gamma

float32 = _onp.float32
float64 = _onp.float64
float16 = _onp.float16
int8 = _onp.int8
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
bfloat16 = torch.bfloat16
# the rest of numpy's dtype names and its scalar hierarchy, numpy's own
# (``float_``/``complex_``/``int_``/``uint`` as the reference's: 64-bit)
int16, uint16, uint32, uint64 = (_onp.int16, _onp.uint16, _onp.uint32,
                                 _onp.uint64)
int_, uint, float_ = _onp.int64, _onp.uint64, _onp.float64
single, double = _onp.float32, _onp.float64
complex64, complex128 = _onp.complex64, _onp.complex128
csingle, cdouble, complex_ = _onp.complex64, _onp.complex128, _onp.complex128
(generic, number, integer, signedinteger, unsignedinteger, inexact,
 floating, complexfloating, character, flexible, object_) = (
    _onp.generic, _onp.number, _onp.integer, _onp.signedinteger,
    _onp.unsignedinteger, _onp.inexact, _onp.floating, _onp.complexfloating,
    _onp.character, _onp.flexible, _onp.object_)
dtype = _onp.dtype
iinfo = _onp.iinfo
s_ = _onp.s_
index_exp = _onp.index_exp


class _BFloat16Info:
    """``finfo`` of bfloat16, which numpy lacks: the values the reference's
    (``ml_dtypes``') carries, each a float (resolution is 0.01 rounded to
    bfloat16)."""

    bits, precision, maxexp, minexp = 16, 2, 128, -126
    machep, negep, nexp, nmant, iexp = -7, -8, 8, 7, 8
    eps, epsneg = 2.0 ** -7, 2.0 ** -8
    max = float(torch.finfo(torch.bfloat16).max)
    min = -max
    tiny = smallest_normal = 2.0 ** -126
    smallest_subnormal = 2.0 ** -133
    resolution = 0.010009765625
    dtype = "bfloat16"

    def __repr__(self):
        return (f"finfo(resolution={self.resolution}, min={self.min:.5g}, "
                f"max={self.max:.5g}, dtype=bfloat16)")


def finfo(dtype):
    """numpy's ``finfo``; bfloat16 (``torch.bfloat16`` or its name) gets
    the reference's values (:class:`_BFloat16Info`)."""
    if isinstance(dtype, NDArray):
        dtype = dtype.dtype
    if dtype is torch.bfloat16 or (isinstance(dtype, str)
                                   and dtype == "bfloat16"):
        return _BFloat16Info()
    if isinstance(dtype, torch.dtype):
        return _onp.finfo(dtype_name(dtype))
    return _onp.finfo(dtype)


def array(object, dtype=None, ctx=None, device=None):
    from ..ndarray import array as nd_array

    return nd_array(object, ctx=ctx or device, dtype=dtype)


def zeros(shape, dtype=None, order="C", ctx=None, device=None):
    from ..ndarray import zeros as nd_zeros

    return nd_zeros(shape, ctx=ctx or device, dtype=dtype or "float32")


def ones(shape, dtype=None, order="C", ctx=None, device=None):
    from ..ndarray import ones as nd_ones

    return nd_ones(shape, ctx=ctx or device, dtype=dtype or "float32")


def full(shape, fill_value, dtype=None, ctx=None, device=None):
    from ..ndarray import full as nd_full

    return nd_full(shape, fill_value, ctx=ctx or device,
                   dtype=dtype or "float32")


def empty(shape, dtype=None, ctx=None, device=None):
    return zeros(shape, dtype=dtype, ctx=ctx, device=device)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    from ..ndarray import arange as nd_arange

    return nd_arange(start, stop, step, ctx=ctx or device,
                     dtype=dtype or "float32")


# ---------------------------------------------------------------------------
# the delegate table: names beyond the explicit set, in numpy's semantics
# ---------------------------------------------------------------------------

def _x32_np(dt):
    return {_onp.dtype("int64"): _onp.dtype("int32"),
            _onp.dtype("float64"): _onp.dtype("float32")}.get(dt, dt)


def _np_dt(d):
    if isinstance(d, NDArray):
        d = d.dtype
    if isinstance(d, torch.dtype):
        return dtype_name(d)
    return _onp.dtype(d).name if not isinstance(d, str) else d


def _result_type(*args):
    """The promoted dtype, with 32-bit defaults (no 64-bit result)."""
    dt = dtype_torch(_np_dt(args[0]))
    for a in args[1:]:
        dt = torch.promote_types(dt, dtype_torch(_np_dt(a)))
    name = dtype_name(dt)
    return torch.bfloat16 if name == "bfloat16" else _x32_np(
        _onp.dtype(name))


def _promote_types(type1, type2):
    name = dtype_name(torch.promote_types(dtype_torch(_np_dt(type1)),
                                          dtype_torch(_np_dt(type2))))
    return torch.bfloat16 if name == "bfloat16" else _onp.dtype(name)


def _window(fn):
    def window(M):
        m = int(M)
        if m < 1:
            return NDArray(_onp.zeros((0,), _onp.float32),
                           ctx=current_context())
        if m == 1:
            return NDArray(_onp.ones((1,), _onp.float32),
                           ctx=current_context())
        n = torch.arange(m, dtype=torch.float32,
                         device=current_context().torch_device())
        return NDArray(fn(n, m).to(torch.float32))
    return window


def _hanning(n, m):
    return 0.5 - 0.5 * torch.cos(2 * math.pi * n / (m - 1))


def _hamming(n, m):
    return 0.54 - 0.46 * torch.cos(2 * math.pi * n / (m - 1))


def _bartlett(n, m):
    return 1 - torch.abs(2 * n / (m - 1) - 1)


def _blackman(n, m):
    return (0.42 - 0.5 * torch.cos(2 * math.pi * n / (m - 1))
            + 0.08 * torch.cos(4 * math.pi * n / (m - 1)))


def _split_along(axis, min_dim):
    def fn(ary, indices_or_sections):
        if len(ary.shape) < min_dim:
            raise ValueError(f"split along axis {axis} needs at least "
                             f"{min_dim} dimensions")
        ax = 0 if (axis == 1 and len(ary.shape) == 1) else axis
        return _ops.split(ary, indices_or_sections, axis=ax)
    return fn


def _nanq(q_scale):
    def fn(a, q, axis=None, out=None, keepdims=False, **kw):
        qv = _onp.asarray(q, _onp.float32) / q_scale
        return _invoke(lambda x: _ops._quantile(_to_float(x), qv, axis,
                                                keepdims, nan=True), [a],
                       out)
    return fn


def _modf(x, out=None):
    def pure(t):
        t = _to_float(t)
        i = torch.trunc(t)
        return t - i, i
    return _invoke(pure, [x])


def _argwhere(a):
    like = _like([a])
    t = _nd(a)._data
    return NDArray(torch.nonzero(t).to(torch.int32),
                   ctx=like.context if like is not None else None)


def _unstack(x, axis=0):
    n = x.shape[axis]
    return tuple(_invoke(lambda t, i=i: t.select(axis, i), [x])
                 for i in range(n))


def _rollaxis(a, axis, start=0):
    n = len(a.shape)
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    if axis == start:
        return _invoke(lambda t: t.clone(), [a])
    return _ops.moveaxis(a, axis, start)


def _sorted_unique(t):
    return torch.unique(t.reshape(-1), sorted=True)


def _union1d(a, b):
    return _sorted_unique(torch.cat(_ops._cat_dtype([a.reshape(-1),
                                                     b.reshape(-1)])))


def _intersect1d(a, b, assume_unique=False):
    ua, ub = _sorted_unique(a), _sorted_unique(b)
    return ua[torch.isin(ua, ub.to(ua.dtype))]


def _setdiff1d(a, b, assume_unique=False):
    ua = _sorted_unique(a)
    return ua[~torch.isin(ua, b.reshape(-1).to(ua.dtype))]


def _cov(m, y=None, rowvar=True, bias=False, ddof=None, **kw):
    x = _to_float(m)
    if x.dim() == 1:
        x = x.reshape(1, -1)
    if not rowvar:
        x = x.T
    if y is not None:
        yy = _to_float(y)
        yy = yy.reshape(1, -1) if yy.dim() == 1 else yy
        x = torch.cat([x, yy if rowvar else yy.T], dim=0)
    corr = ddof if ddof is not None else (0 if bias else 1)
    return torch.cov(x, correction=corr).squeeze()


def _corrcoef(x, y=None, rowvar=True):
    c = _cov(x, y, rowvar)
    if c.dim() == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c))
    return (c / d[:, None] / d[None, :]).clamp(-1, 1)


def _vecdot(x1, x2, axis=-1):
    return torch.sum(x1 * x2, dim=axis)


_DELEGATES = {
    "acos": _ops.arccos, "acosh": _ops.arccosh, "asin": _ops.arcsin,
    "asinh": _ops.arcsinh, "atan": _ops.arctan, "atan2": _ops.arctan2,
    "atanh": _ops.arctanh, "bitwise_invert": _ops.invert,
    "bitwise_left_shift": _ops.left_shift,
    "bitwise_right_shift": _ops.right_shift, "concat": _ops.concatenate,
    "permute_dims": _ops.transpose, "pow": _ops.power,
    "trapezoid": _ops.trapz,
    "matrix_transpose": lambda x: _ops.swapaxes(x, -1, -2),
    "hsplit": _split_along(1, 1), "vsplit": _split_along(0, 2),
    "dsplit": _split_along(2, 3),
    "diagflat": _tape_fn(lambda v, k=0: torch.diagflat(v, k)),
    "tril_indices_from": lambda arr, k=0: _ops.tril_indices(
        arr.shape[-2], k, arr.shape[-1]),
    "triu_indices_from": lambda arr, k=0: _ops.triu_indices(
        arr.shape[-2], k, arr.shape[-1]),
    "diag_indices_from": lambda arr: _ops.diag_indices(arr.shape[0],
                                                       len(arr.shape)),
    "argwhere": _argwhere, "modf": _modf,
    "iscomplex": lambda x: _invoke(
        lambda t: torch.zeros_like(t, dtype=torch.bool)
        if not t.is_complex() else t.imag != 0, [x]),
    "isreal": lambda x: _invoke(
        lambda t: torch.ones_like(t, dtype=torch.bool)
        if not t.is_complex() else t.imag == 0, [x]),
    "isscalar": lambda x: isinstance(x, (int, float, complex, bool,
                                         _onp.generic)),
    "iterable": lambda y: _onp.iterable(y),
    "result_type": _result_type, "promote_types": _promote_types,
    "can_cast": lambda from_, to, casting="safe": _onp.can_cast(
        _np_dt(from_), _np_dt(to), casting=casting),
    "issubdtype": lambda arg1, arg2: _onp.issubdtype(
        _np_dt(arg1) if not isinstance(arg1, type) else arg1,
        _np_dt(arg2) if not isinstance(arg2, type) else arg2),
    "broadcast_shapes": lambda *shapes: tuple(
        _onp.broadcast_shapes(*shapes)),
    "rollaxis": _rollaxis, "unstack": _unstack,
    "hamming": _window(_hamming), "hanning": _window(_hanning),
    "bartlett": _window(_bartlett), "blackman": _window(_blackman),
    "nanmedian": lambda a, axis=None, out=None, keepdims=False, **kw:
        _nanq(1.0)(a, 0.5, axis=axis, out=out, keepdims=keepdims),
    "nanquantile": _nanq(1.0), "nanpercentile": _nanq(100.0),
    "vecdot": _tape_fn(_vecdot),
    "matvec": _tape_fn(lambda x1, x2: torch.matmul(
        x1, x2.unsqueeze(-1)).squeeze(-1)),
    "vecmat": _tape_fn(lambda x1, x2: torch.matmul(
        x1.unsqueeze(-2), x2).squeeze(-2)),
    "cov": _tape_fn(_cov), "corrcoef": _tape_fn(_corrcoef),
    "histogram_bin_edges": lambda a, bins=10, range=None, weights=None:
        _ops.histogram(a, bins=bins, range=range)[1],
    "astype": lambda x, dtype, copy=False, device=None: x.astype(dtype),
    "union1d": _tape_fn(_union1d),
    "intersect1d": _tape_fn(_intersect1d),
    "setdiff1d": _tape_fn(_setdiff1d),
}
# the rest of the reference's delegate surface: not ported, raises
_RAISES = frozenset("""
apply_along_axis apply_over_axes argpartition array_repr array_str
bitwise_count block choose cumulative_prod cumulative_sum einsum_path
from_dlpack frombuffer fromfile fromfunction fromiter frompyfunc fromstring
get_printoptions histogram2d histogramdd isdtype kaiser lexsort load
mask_indices packbits partition piecewise poly polyadd polyder polydiv
polyfit polyint polymul polysub printoptions put_along_axis roots save
savez set_printoptions setxor1d sort_complex spacing unique_all
unique_counts unique_inverse unique_values unpackbits vectorize
""".split())


# the reference's names whose value is a JAX object: they raise
_JAX_ONLY = frozenset("""
r_ c_ mgrid ogrid fft ufunc jnp ComplexWarning float4_e2m1fn float8_e3m4
float8_e4m3 float8_e4m3b11fnuz float8_e4m3fn float8_e4m3fnuz float8_e5m2
float8_e5m2fnuz float8_e8m0fnu int2 int4 uint2 uint4
""".split())


def __getattr__(name):
    # explicit ops are bound by the star import; only delegates reach here
    fn = _DELEGATES.get(name)
    if fn is not None:
        globals()[name] = fn
        return fn
    if name == "bool":  # numpy's, kept out of the module's globals, where
        return _onp.bool_  # it would shadow the builtin
    if name in _JAX_ONLY:
        raise MXNetError(
            f"mx.np.{name} is not ported: the reference's value is a JAX "
            "object, which has no torch counterpart with its semantics")
    if name in _RAISES:
        raise MXNetError(
            f"mx.np.{name} is not ported: the reference delegates it to "
            "jax.numpy, and no torch function carries numpy's semantics "
            "for it")
    raise AttributeError(
        f"module 'mxnet_tpu_torch.numpy' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list(_DELEGATES) + ["bool"]))

