"""The numpy frontend of the port against the reference: ``mx.np``
(every explicit operator, over int32/int64/float16/float32/bool for the
ufuncs and reductions, dtype and value), the delegate surface (each name
either agrees with the reference or raises), ``mx.np.linalg``,
``mx.np.random`` (shapes, dtypes and ranges; values by distribution) and
``mx.npx``. The cases of ``tests/test_numpy_semantics.py`` run on the port.

Both packages get the same seeded numpy inputs. Tolerances: float32 values
rtol 1e-5 / atol 1e-6, float16 rtol 1e-2 / atol 1e-3, integers and bools
exact; dtypes always exact.
"""
import warnings

import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import numpy as R

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import numpy as T
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ndarray import NDArray

DTYPES = ["int32", "int64", "float16", "float32", "bool"]
BINARY = """add subtract multiply mod remainder power maximum minimum hypot
arctan2 copysign equal not_equal less less_equal greater greater_equal
logical_and logical_or logical_xor bitwise_and bitwise_or bitwise_xor
left_shift right_shift floor_divide fmod gcd lcm heaviside logaddexp fmax
fmin divide true_divide float_power logaddexp2 nextafter ldexp""".split()
UNARY = """sqrt exp log log2 log10 abs absolute sign sin cos tan arcsin arccos
arctan sinh cosh tanh negative reciprocal square rint floor ceil trunc
logical_not bitwise_not invert expm1 log1p exp2 cbrt degrees radians
deg2rad rad2deg arcsinh arccosh arctanh isnan isinf isfinite isposinf
isneginf fix positive conj conjugate round around round_ signbit fabs sinc
i0 real imag angle nan_to_num""".split()
REDUCTIONS = """sum prod mean max min amax amin all any nansum nanmax nanmin
nanmean nanprod std var nanstd nanvar argmax argmin ptp median cumsum
cumprod count_nonzero""".split()

CASES = {
 "clip": "m.clip(A, 0.5, 1.5)",
 "dot": "m.dot(A, m.transpose(B))",
 "matmul": "m.matmul(A, m.transpose(B))",
 "tensordot": "m.tensordot(A, B, axes=([1], [1]))",
 "concatenate": "m.concatenate([A, B], axis=1)",
 "stack": "m.stack([A, B], axis=1)",
 "split": "m.split(A, [1, 3], axis=1)",
 "where": "m.where(m.greater(A, B), A, B)",
 "reshape": "m.reshape(A, (4, 3))",
 "transpose": "m.transpose(A)",
 "swapaxes": "m.swapaxes(A, 0, 1)",
 "expand_dims": "m.expand_dims(A, 1)",
 "squeeze": "m.squeeze(m.expand_dims(A, 0))",
 "broadcast_to": "m.broadcast_to(V4, (3, 4))",
 "repeat": "m.repeat(A, 2, axis=0)",
 "tile": "m.tile(V4, (2, 1))",
 "copy": "m.copy(A)",
 "linspace": "m.linspace(0, 1, 7)",
 "quantile": "m.quantile(A, 0.3, axis=1)",
 "percentile": "m.percentile(A, 70)",
 "average": "m.average(A, axis=1, weights=V4)",
 "sort": "m.sort(A, axis=0)",
 "argsort": "m.argsort(A, axis=1)",
 "searchsorted": "m.searchsorted(S, V4)",
 "nonzero": "m.nonzero(I)",
 "unique": "m.unique(I, return_index=True, return_counts=True)",
 "bincount": "m.bincount(m.ravel(I))",
 "ravel": "m.ravel(A)",
 "flip": "m.flip(A, axis=1)",
 "flipud": "m.flipud(A)",
 "fliplr": "m.fliplr(A)",
 "roll": "m.roll(A, 2)",
 "rot90": "m.rot90(A)",
 "moveaxis": "m.moveaxis(m.expand_dims(A, 0), 0, 2)",
 "vstack": "m.vstack([A, B])",
 "hstack": "m.hstack([A, B])",
 "dstack": "m.dstack([A, B])",
 "column_stack": "m.column_stack([V4, V4])",
 "array_split": "m.array_split(A, 3, axis=1)",
 "atleast_1d": "m.atleast_1d(m.sum(A))",
 "atleast_2d": "m.atleast_2d(V4)",
 "atleast_3d": "m.atleast_3d(A)",
 "pad": "m.pad(A, ((1, 0), (0, 2)))",
 "take": "m.take(A, m.array([0, 2, 5], dtype='int32'))",
 "take_along_axis": "m.take_along_axis(A, m.argsort(A, axis=1), axis=1)",
 "meshgrid": "m.meshgrid(V4, S)",
 "diff": "m.diff(A, axis=1)",
 "ediff1d": "m.ediff1d(V4)",
 "interp": "m.interp(V4, S, m.multiply(S, 2.0))",
 "outer": "m.outer(V4, S)",
 "inner": "m.inner(A, B)",
 "vdot": "m.vdot(A, B)",
 "kron": "m.kron(V4, S)",
 "cross": "m.cross(m.reshape(m.ravel(A)[:6], (2, 3)), m.reshape(m.ravel(B)[:6], (2, 3)))",
 "trace": "m.trace(A)",
 "diag": "m.diag(V4)",
 "diagonal": "m.diagonal(A, 1)",
 "tril": "m.tril(A, -1)",
 "triu": "m.triu(A, 1)",
 "einsum": "m.einsum('ij,kj->ik', A, B)",
 "maximum_reduce": "m.maximum_reduce(A, axis=0)",
 "eye": "m.eye(3, 4, k=1)",
 "identity": "m.identity(3)",
 "logspace": "m.logspace(0, 2, 5)",
 "tri": "m.tri(3, 4)",
 "zeros_like": "m.zeros_like(A)",
 "ones_like": "m.ones_like(I)",
 "full_like": "m.full_like(A, 2.5)",
 "isclose": "m.isclose(A, m.add(A, 1e-7))",
 "allclose": "m.allclose(A, B)",
 "array_equal": "m.array_equal(A, m.copy(A))",
 "flatnonzero": "m.flatnonzero(I)",
 "frexp": "m.frexp(A)",
 "divmod": "m.divmod(I, m.add(I, 1))",
 "nanargmax": "m.nanargmax(A, axis=1)",
 "nanargmin": "m.nanargmin(A)",
 "nancumsum": "m.nancumsum(A, axis=1)",
 "nancumprod": "m.nancumprod(A)",
 "isin": "m.isin(I, m.array([1, 3], dtype='int32'))",
 "digitize": "m.digitize(V4, S)",
 "broadcast_arrays": "m.broadcast_arrays(A, V4)",
 "row_stack": "m.row_stack([V4, V4])",
 "vander": "m.vander(V4, 3)",
 "delete": "m.delete(A, 1, axis=1)",
 "append": "m.append(A, B, axis=0)",
 "resize": "m.resize(V4, (3, 3))",
 "compress": "m.compress(m.array([True, False, True]), A, axis=0)",
 "extract": "m.extract(m.greater(A, 1.0), A)",
 "unwrap": "m.unwrap(m.multiply(A, 3.0))",
 "select": "m.select([m.greater(A, 1.5), m.less(A, 0.8)], [A, B], default=0.0)",
 "trim_zeros": "m.trim_zeros(m.array([0.0, 0.0, 1.0, 2.0, 0.0]))",
 "convolve": "m.convolve(V4, S)",
 "correlate": "m.correlate(S, V4)",
 "polyval": "m.polyval(S, V4)",
 "gradient": "m.gradient(V4)",
 "histogram": "m.histogram(A, bins=4)",
 "tril_indices": "m.tril_indices(4, 1)",
 "triu_indices": "m.triu_indices(4)",
 "diag_indices": "m.diag_indices(3)",
 "indices": "m.indices((2, 3))",
 "ix_": "m.ix_(m.array([0, 1], dtype='int32'), m.array([2, 3], dtype='int32'))",
 "unravel_index": "m.unravel_index(m.array([1, 5, 7], dtype='int32'), (3, 4))",
 "ravel_multi_index": "m.ravel_multi_index((m.array([0, 2], dtype='int32'), m.array([1, 3], dtype='int32')), (3, 4))",
 "insert": "m.insert(A, 1, V4, axis=0)",
 "insert_positions": "m.insert(A, onp.array([0, 2]), V4, axis=0)",
 "insert_flat": "m.insert(A, onp.array([1, 5, 2]), 7.0)",
 "insert_column": "m.insert(A, -1, m.ravel(A[:, 0]), axis=1)",
 "trapz": "m.trapz(A, axis=1)",
 "geomspace": "m.geomspace(1, 100, 5)",
 "asarray": "m.asarray([[1.0, 2.0]])",
 "ascontiguousarray": "m.ascontiguousarray(A)",
 "empty_like": "m.empty_like(A)",
 "ndim": "m.ndim(A)",
 "shape": "m.shape(A)",
 "size": "m.size(A, 1)",
 "put": "_inplace(m, lambda X: m.put(X, m.array([0, 2, 30], dtype='int32'), m.array([9.0, 8.0])))",
 "place": "_inplace(m, lambda X: m.place(X, m.greater(X, 1.0), m.array([7.0, 6.0])))",
 "fill_diagonal": "_inplace(m, lambda X: m.fill_diagonal(X, 5.0))",
 "iscomplexobj": "m.iscomplexobj(A)",
 "isrealobj": "m.isrealobj(A)",
 "array_equiv": "m.array_equiv(V4, m.broadcast_to(V4, (2, 4)))",
}

DELEGATE_CASES = {
 "acos": "m.acos(m.multiply(A, 0.3))", "acosh": "m.acosh(m.add(A, 1.0))",
 "asin": "m.asin(m.multiply(A, 0.3))", "asinh": "m.asinh(A)",
 "atan": "m.atan(A)", "atan2": "m.atan2(A, B)", "atanh": "m.atanh(m.multiply(A, 0.3))",
 "bitwise_invert": "m.bitwise_invert(I)",
 "bitwise_left_shift": "m.bitwise_left_shift(I, m.array(2, dtype='int32'))",
 "bitwise_right_shift": "m.bitwise_right_shift(I, m.array(1, dtype='int32'))",
 "concat": "m.concat([A, B], axis=0)", "permute_dims": "m.permute_dims(A, (1, 0))",
 "pow": "m.pow(A, B)", "trapezoid": "m.trapezoid(A, axis=0)",
 "matrix_transpose": "m.matrix_transpose(A)",
 "hsplit": "m.hsplit(A, 2)", "vsplit": "m.vsplit(A, 3)",
 "dsplit": "m.dsplit(m.reshape(A, (1, 3, 4)), 2)",
 "diagflat": "m.diagflat(V4, 1)",
 "tril_indices_from": "m.tril_indices_from(A)", "triu_indices_from": "m.triu_indices_from(A, 1)",
 "diag_indices_from": "m.diag_indices_from(m.eye(3))",
 "argwhere": "m.argwhere(I)", "modf": "m.modf(m.multiply(A, 1.7))",
 "iscomplex": "m.iscomplex(A)", "isreal": "m.isreal(A)",
 "isscalar": "(m.isscalar(3.0), m.isscalar(A))", "iterable": "(m.iterable([1]), m.iterable(2))",
 "result_type": "str(m.result_type('int32', 'float16'))",
 "promote_types": "str(m.promote_types('float16', 'int32'))",
 "can_cast": "m.can_cast('int32', 'float32')",
 "issubdtype": "m.issubdtype('int32', onp.integer)",
 "broadcast_shapes": "m.broadcast_shapes((3, 1), (1, 4))",
 "rollaxis": "m.rollaxis(m.reshape(A, (1, 3, 4)), 2)", "unstack": "m.unstack(A)",
 "hamming": "m.hamming(6)", "hanning": "m.hanning(6)", "bartlett": "m.bartlett(6)",
 "blackman": "m.blackman(6)",
 "nanmedian": "m.nanmedian(A, axis=1)", "nanquantile": "m.nanquantile(A, 0.25)",
 "nanpercentile": "m.nanpercentile(A, 40, axis=0)",
 "vecdot": "m.vecdot(A, B)", "matvec": "m.matvec(A, V4)", "vecmat": "m.vecmat(m.ravel(A)[:3], A)",
 "cov": "m.cov(A)", "corrcoef": "m.corrcoef(A)",
 "histogram_bin_edges": "m.histogram_bin_edges(A, bins=5)",
 "astype": "m.astype(A, 'int32')",
 "union1d": "m.union1d(I, m.array([7, 1], dtype='int32'))",
 "intersect1d": "m.intersect1d(I, m.array([1, 3, 9], dtype='int32'))",
 "setdiff1d": "m.setdiff1d(I, m.array([1, 3], dtype='int32'))",
}


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _sample(dt, seed):
    r = onp.random.RandomState(seed)
    if dt == "bool":
        return r.rand(2, 3) > 0.5
    if dt.startswith("int"):
        return r.randint(0, 6, (2, 3)).astype(dt)
    return (r.rand(2, 3) * 2 + 0.5).astype(dt)


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in _flat(y)]
    return [x]


def _host(x):
    if hasattr(x, "asnumpy"):
        return onp.asarray(x.asnumpy()), str(x.dtype)
    return onp.asarray(x), type(x).__name__


def _agree(r, t, rtol=1e-5, atol=1e-6):
    rf, tf = _flat(r), _flat(t)
    assert len(rf) == len(tf)
    for x, y in zip(rf, tf):
        if hasattr(y, "asnumpy"):
            assert isinstance(y, NDArray)
        (xn, xd), (yn, yd) = _host(x), _host(y)
        assert xd == yd, (xd, yd)
        assert xn.shape == yn.shape
        if xn.dtype.kind in "USO":
            assert (xn == yn).all(), (xn, yn)
            continue
        onp.testing.assert_allclose(xn.astype(onp.float64),
                                    yn.astype(onp.float64), rtol=rtol,
                                    atol=atol, equal_nan=True)


def _both(fn):
    """``fn(module)`` through the reference and through the port; the
    second element is None when both raised."""
    try:
        r, rerr = fn(R), None
    except Exception as e:  # noqa: BLE001 — compared below
        r, rerr = None, e
    try:
        t, terr = fn(T), None
    except Exception as e:  # noqa: BLE001
        t, terr = None, e
    assert (rerr is None) == (terr is None), (repr(rerr), repr(terr))
    return r, t, rerr is not None


_UFUNC_CASES = ([("binary", n, d) for n in BINARY for d in DTYPES]
                + [("unary", n, d) for n in UNARY for d in DTYPES]
                + [("reduction", n, d) for n in REDUCTIONS for d in DTYPES])


@pytest.mark.parametrize("kind,name,dt", _UFUNC_CASES,
                         ids=[f"{n}-{d}" for _k, n, d in _UFUNC_CASES])
def test_ufunc_and_reduction_parity(kind, name, dt):
    a, b = _sample(dt, 0), _sample(dt, 1)

    def run(m):
        x, y = m.array(a, dtype=dt), m.array(b, dtype=dt)
        return getattr(m, name)(x, y) if kind == "binary" \
            else getattr(m, name)(x)
    r, t, raised = _both(run)
    if raised:
        return
    tol = dict(rtol=1e-2, atol=1e-3) if dt == "float16" else {}
    _agree(r, t, **tol)


_SCALARS = {"int": 2, "float": 1.5, "bool": True}
_SCALAR_CASES = [(n, d, k, side) for n in BINARY for d in DTYPES
                 for k in _SCALARS for side in ("left", "right")]


@pytest.mark.parametrize("name,dt,kind,side", _SCALAR_CASES,
                         ids=[f"{n}-{d}-{k}-{s}"
                              for n, d, k, s in _SCALAR_CASES])
def test_binary_ufunc_scalar_operand_parity(name, dt, kind, side):
    """The binary sweep with a Python int, float or bool on either side:
    the reference's weakly typed scalars set the result dtype."""
    a, c = _sample(dt, 0), _SCALARS[kind]

    def run(m):
        x = m.array(a, dtype=dt)
        return getattr(m, name)(x, c) if side == "left" \
            else getattr(m, name)(c, x)
    r, t, raised = _both(run)
    if raised:
        return
    tol = dict(rtol=1e-2, atol=1e-3) if dt == "float16" else {}
    _agree(r, t, **tol)


def _env(m):
    r = onp.random.RandomState(3)
    a = (r.rand(3, 4) * 2 + 0.5).astype("float32")
    b = (r.rand(3, 4) * 2 + 0.5).astype("float32")
    return dict(m=m, onp=onp, A=m.array(a), B=m.array(b),
                V4=m.array(r.rand(4).astype("float32") * 2),
                S=m.array(onp.sort(r.rand(5).astype("float32")) * 2),
                I=m.array(r.randint(0, 5, (3, 4)).astype("int32")),
                _inplace=_inplace)


def _inplace(m, fn):
    x = m.array((onp.arange(12).reshape(3, 4) / 4.0).astype("float32"))
    fn(x)
    return x


@pytest.mark.parametrize("name", sorted(CASES))
def test_explicit_op_parity(name):
    r = eval(CASES[name], _env(R))
    t = eval(CASES[name], _env(T))
    _agree(r, t)


def test_explicit_surface_equals_reference():
    from mxnet_tpu.numpy import _ops as rops
    from mxnet_tpu_torch.numpy import _ops as tops

    assert set(tops._EXPLICIT) == set(rops._EXPLICIT)
    ufuncs = set(BINARY) | set(UNARY) | set(REDUCTIONS)
    assert set(rops._EXPLICIT) <= ufuncs | set(CASES)


def _reference_delegates():
    """The jax.numpy callables the reference reaches through its delegate:
    every one its package does not define. Read from its source and its
    explicit table, not from the live module, into which the delegate
    caches each name it resolves (which would make the list depend on
    what ran before)."""
    import ast

    import jax.numpy as jnp
    from mxnet_tpu.numpy import _ops as rops

    with open(R.__file__) as f:
        tree = ast.parse(f.read())
    static = set(rops._EXPLICIT) | set(rops.__all__)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            static.add(node.name)
        elif isinstance(node, ast.Assign):
            static.update(t.id for t in node.targets
                          if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            static.update((a.asname or a.name).split(".")[0]
                          for a in node.names)
    return sorted(n for n in dir(jnp) if not n.startswith("_")
                  and n not in static and callable(getattr(jnp, n))
                  and not isinstance(getattr(jnp, n), type))


REF_DELEGATES = _reference_delegates()


@pytest.mark.parametrize("name", REF_DELEGATES)
def test_delegate_name_agrees_or_raises(name):
    """Every name the reference resolves through its jax.numpy delegate
    either agrees with it on seeded inputs or is on the port's list of
    names that raise, and then raises MXNetError naming it."""
    if name in T._RAISES:
        assert name not in DELEGATE_CASES
        with pytest.raises(MXNetError, match=name):
            getattr(T, name)
        return
    src = DELEGATE_CASES[name]
    _agree(eval(src, _env(R)), eval(src, _env(T)))


def test_delegates_and_raises_cover_only_reference_names():
    names = set(REF_DELEGATES)
    assert set(DELEGATE_CASES) | set(T._RAISES) == names
    assert not set(DELEGATE_CASES) & set(T._RAISES)
    with pytest.raises(AttributeError):
        getattr(T, "no_such_numpy_function")


def test_np_autograd_through_delegate():
    x = tmx.nd.array(onp.array([1.0, 2.0, 3.0], onp.float32))
    x.attach_grad()
    with tmx.autograd.record():
        y = T.sum(T.square(x))
        z = T.sum(T.vecdot(x, x))
    y.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [2, 4, 6])
    x.attach_grad()
    with tmx.autograd.record():
        z = T.vecdot(x, T.matrix_transpose(T.reshape(x, (1, 3)))[:, 0])
    z.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [2, 4, 6])


# ----------------------------------------------------------------------------
# tests/test_numpy_semantics.py on the port
# ----------------------------------------------------------------------------

def test_returns_ndarray_and_values():
    a = T.array([[1.0, 2.0], [3.0, 4.0]])
    b = T.array([[10.0, 20.0], [30.0, 40.0]])
    out = T.add(a, b)
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(out.asnumpy(), [[11, 22], [33, 44]])
    onp.testing.assert_allclose(T.subtract(b, a).asnumpy(),
                                [[9, 18], [27, 36]])
    onp.testing.assert_allclose(T.sqrt(T.array([4.0, 9.0])).asnumpy(),
                                [2, 3])


def test_out_parameter_binary_and_reduction():
    a = T.array([1.0, 2.0, 3.0])
    b = T.array([4.0, 5.0, 6.0])
    buf = T.zeros((3,))
    assert T.add(a, b, out=buf) is buf
    onp.testing.assert_allclose(buf.asnumpy(), [5, 7, 9])
    sbuf = T.zeros(())
    assert T.sum(a, out=sbuf) is sbuf
    assert float(sbuf.asnumpy()) == 6.0
    ibuf = T.zeros((3,), dtype="int32")
    T.add(a, b, out=ibuf)
    assert ibuf.dtype == onp.int32
    onp.testing.assert_array_equal(ibuf.asnumpy(), [5, 7, 9])


def test_where_parameter():
    a = T.array([1.0, 2.0, 3.0, 4.0])
    b = T.array([10.0, 10.0, 10.0, 10.0])
    base = T.full((4,), -1.0)
    mask = T.array([True, False, True, False])
    r = T.add(a, b, out=base, where=mask)
    onp.testing.assert_allclose(r.asnumpy(), [11, -1, 13, -1])
    with pytest.raises(ValueError):
        T.add(a, b, where=mask)
    u = T.full((4,), 7.0)
    r2 = T.sqrt(T.array([4.0, 9.0, 16.0, 25.0]), out=u, where=mask)
    onp.testing.assert_allclose(r2.asnumpy(), [2, 7, 4, 7])


def test_float32_dtype_rules():
    i = T.array([1, 2, 3], dtype="int32")
    j = T.array([2, 2, 2], dtype="int32")
    d = T.divide(i, j)
    assert d.dtype == onp.float32
    onp.testing.assert_allclose(d.asnumpy(), [0.5, 1.0, 1.5])
    assert T.true_divide(i, j).dtype == onp.float32
    assert T.mean(i).dtype == onp.float32
    assert T.std(i).dtype == onp.float32
    assert T.var(i).dtype == onp.float32
    assert T.sum(i).dtype == onp.int32
    assert T.array([1.5]).dtype == onp.float32
    assert T.zeros((2,)).dtype == onp.float32
    assert T.linspace(0, 1, 5).dtype == onp.float32


def test_reductions_axis_keepdims():
    x = T.array([[1.0, 2.0], [3.0, 4.0]])
    onp.testing.assert_allclose(T.sum(x, axis=0).asnumpy(), [4, 6])
    onp.testing.assert_allclose(T.sum(x, axis=1, keepdims=True).asnumpy(),
                                [[3], [7]])
    onp.testing.assert_allclose(float(T.mean(x).asnumpy()), 2.5)
    onp.testing.assert_allclose(T.max(x, axis=1).asnumpy(), [2, 4])
    onp.testing.assert_allclose(T.var(x, axis=0, ddof=1).asnumpy(), [2, 2])
    am = T.argmax(x, axis=1)
    assert am.dtype == onp.int32
    onp.testing.assert_array_equal(am.asnumpy(), [1, 1])


def test_shape_manipulation():
    x = T.arange(0, 6)
    r = T.reshape(x, (2, 3))
    assert r.shape == (2, 3)
    assert T.transpose(r).shape == (3, 2)
    e = T.expand_dims(x, 0)
    assert e.shape == (1, 6)
    assert T.squeeze(e).shape == (6,)
    parts = T.split(r, 3, axis=1)
    assert len(parts) == 3 and parts[0].shape == (2, 1)
    assert [p.shape[0] for p in T.split(x, [2, 4])] == [2, 2, 2]
    assert T.concatenate([r, r], axis=0).shape == (4, 3)
    assert T.stack([x, x], axis=0).shape == (2, 6)
    assert T.broadcast_to(T.array([1.0, 2.0]), (3, 2)).shape == (3, 2)
    onp.testing.assert_allclose(T.tile(T.array([1.0]), 3).asnumpy(),
                                [1, 1, 1])


def test_where_and_nonzero_form():
    c = T.array([True, False, True])
    x = T.array([1.0, 2.0, 3.0])
    y = T.array([-1.0, -2.0, -3.0])
    onp.testing.assert_allclose(T.where(c, x, y).asnumpy(), [1, -2, 3])
    idx = T.where(c)
    assert isinstance(idx, tuple)
    onp.testing.assert_array_equal(idx[0].asnumpy(), [0, 2])


def test_matmul_dot_tensordot():
    a = T.array([[1.0, 2.0], [3.0, 4.0]])
    b = T.array([[5.0, 6.0], [7.0, 8.0]])
    want = onp.array([[19, 22], [43, 50]])
    onp.testing.assert_allclose(T.matmul(a, b).asnumpy(), want)
    onp.testing.assert_allclose(T.dot(a, b).asnumpy(), want)
    onp.testing.assert_allclose(
        T.tensordot(a, b, axes=([1], [0])).asnumpy(), want)


def test_autograd_records_np_ops():
    x = T.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with tmx.autograd.record():
        y = T.sum(T.multiply(x, x))
    y.backward()
    onp.testing.assert_allclose(x.grad.asnumpy(), [2, 4, 6])


def test_cbrt_and_sort_are_explicit():
    out = T.cbrt(T.array([8.0, 27.0]))
    onp.testing.assert_allclose(out.asnumpy(), [2, 3], rtol=1e-6)
    assert isinstance(out, NDArray)
    onp.testing.assert_allclose(T.sort(T.array([3.0, 1.0, 2.0])).asnumpy(),
                                [1, 2, 3])


def test_unary_and_clip_misc():
    x = T.array([-2.0, 0.5, 3.0])
    onp.testing.assert_allclose(T.clip(x, 0.0, 1.0).asnumpy(), [0, 0.5, 1])
    onp.testing.assert_allclose(T.sign(x).asnumpy(), [-1, 1, 1])
    onp.testing.assert_allclose(T.negative(x).asnumpy(), [2, -0.5, -3])
    r = T.reciprocal(T.array([2, 4], dtype="int32"))
    assert r.dtype == onp.float32
    onp.testing.assert_allclose(r.asnumpy(), [0.5, 0.25])
    cs = T.cumsum(T.array([[1.0, 2.0], [3.0, 4.0]]), axis=1)
    onp.testing.assert_allclose(cs.asnumpy(), [[1, 3], [3, 7]])
    cp = T.copy(x)
    assert cp is not x
    onp.testing.assert_allclose(cp.asnumpy(), x.asnumpy())


def test_expanded_explicit_op_set():
    from mxnet_tpu_torch.numpy._ops import _EXPLICIT

    expected = [
        "equal", "less", "greater_equal", "logical_and", "logical_not",
        "bitwise_xor", "floor_divide", "fmod", "expm1", "log1p", "cbrt",
        "arcsinh", "isnan", "isfinite", "round", "all", "any", "median",
        "percentile", "cumprod", "sort", "argsort", "nonzero", "unique",
        "bincount", "ravel", "flip", "roll", "vstack", "hstack", "pad",
        "take", "meshgrid", "diff", "outer", "inner", "kron", "trace",
        "diag", "tril", "triu", "einsum", "eye", "identity", "zeros_like",
        "ones_like", "isclose", "allclose", "searchsorted",
    ]
    assert not [n for n in expected if n not in _EXPLICIT]
    assert len(_EXPLICIT) >= 230, len(_EXPLICIT)


_EXPANDED = {
    "equal": ("m.equal(a, b)", "onp.equal(a_np, b_np)"),
    "fmod": ("m.fmod(a, b)", "onp.fmod(a_np, b_np)"),
    "logaddexp": ("m.logaddexp(a, b)", "onp.logaddexp(a_np, b_np)"),
    "log1p_abs": ("m.log1p(m.abs(a))", "onp.log1p(onp.abs(a_np))"),
    "sort": ("m.sort(a, axis=1)", "onp.sort(a_np, axis=1)"),
    "flip": ("m.flip(a, axis=0)", "onp.flip(a_np, axis=0)"),
    "roll": ("m.roll(a, 1, axis=1)", "onp.roll(a_np, 1, axis=1)"),
    "outer": ("m.outer(a[0], b[0])", "onp.outer(a_np[0], b_np[0])"),
    "kron": ("m.kron(a[0], b[0])", "onp.kron(a_np[0], b_np[0])"),
    "tril": ("m.tril(a)", "onp.tril(a_np)"),
    "diff": ("m.diff(a, axis=1)", "onp.diff(a_np, axis=1)"),
    "cumprod": ("m.cumprod(a, axis=1)", "onp.cumprod(a_np, axis=1)"),
    "einsum": ("m.einsum('ij,ij->i', a, b)",
               "onp.einsum('ij,ij->i', a_np, b_np)"),
    "pad": ("m.pad(a, ((1, 0), (0, 1)))", "onp.pad(a_np, ((1, 0), (0, 1)))"),
}


@pytest.mark.parametrize("name", sorted(_EXPANDED))
def test_expanded_ops_match_numpy(name):
    """tests/test_numpy_semantics.py's expanded-op spot checks, each a case
    of its own: the port against numpy (rtol 1e-5) and the reference."""
    a_np = onp.array([[4.0, -1.0, 2.0], [0.5, 3.0, -2.0]], onp.float32)
    b_np = onp.array([[1.0, 2.0, 2.0], [0.5, -3.0, 4.0]], onp.float32)
    src, want = _EXPANDED[name]
    got = eval(src, {"m": T, "a": T.array(a_np), "b": T.array(b_np)})
    ref = eval(src, {"m": R, "a": R.array(a_np), "b": R.array(b_np)})
    assert isinstance(got, NDArray)
    onp.testing.assert_allclose(
        got.asnumpy(), eval(want, {"onp": onp, "a_np": a_np, "b_np": b_np}),
        rtol=1e-5)
    _agree(ref, got)


def test_expanded_index_dtypes_are_int32():
    a = T.array([3.0, 1.0, 2.0])
    assert T.argsort(a).dtype == onp.int32
    assert T.nonzero(T.array([0.0, 1.0, 2.0]))[0].dtype == onp.int32
    u, idx = T.unique(T.array([2.0, 1.0, 2.0]), return_index=True)
    assert idx.dtype == onp.int32
    onp.testing.assert_allclose(u.asnumpy(), [1.0, 2.0])
    onp.testing.assert_array_equal(idx.asnumpy(), [1, 0])


def test_expanded_float32_never_float64():
    ints = T.array([1, 2, 3, 4], dtype="int32")
    assert T.median(ints).dtype == onp.float32
    assert T.percentile(ints, 50).dtype == onp.float32
    assert T.interp(T.array([1.5]), T.array([1, 2]),
                    T.array([10, 20])).dtype == onp.float32


def test_comparison_where_out():
    a = T.array([1.0, 5.0, 3.0])
    b = T.array([2.0, 4.0, 3.0])
    base = T.array([True, True, True])
    r = T.less(a, b, out=base, where=T.array([True, False, True])._data)
    assert r is base
    onp.testing.assert_array_equal(base.asnumpy(), [True, True, False])


def test_promoted_ops_basic():
    a = T.array([[3.0, 1.0], [2.0, 4.0]])
    assert isinstance(T.fabs(-a), T.ndarray)
    assert T.float_power(T.array([2, 3], dtype="int32"), 2).dtype == \
        T.float32
    h, edges = T.histogram(a, bins=4)
    assert isinstance(h, T.ndarray) and isinstance(edges, T.ndarray)
    assert T.shape(a) == (2, 2) and T.ndim(a) == 2 and T.size(a) == 4
    assert T.nanstd(T.array([1, 2, 3], dtype="int32")).dtype == T.float32
    r, _c = T.tril_indices(3)
    assert isinstance(r, T.ndarray)
    b = T.array([1.0, 2.0, 3.0, 4.0])
    T.put(b, T.array([0, 2], dtype="int32"), T.array([9.0, 8.0]))
    onp.testing.assert_allclose(b.asnumpy(), [9.0, 2.0, 8.0, 4.0])
    m = T.eye(3)
    T.fill_diagonal(m, 5.0)
    onp.testing.assert_allclose(m.asnumpy().diagonal(), [5, 5, 5])
    assert T.array_equiv(T.array([1, 2]), T.array([[1, 2], [1, 2]]))
    g = T.gradient(T.array([1.0, 2.0, 4.0, 8.0]))
    assert isinstance(g, T.ndarray)


def test_promoted_ops_nested_and_modes():
    a = T.array([1.0, 2.0, 3.0])
    b = T.array([4.0, 5.0, 6.0])
    s = T.select([T.array([True, False, True])], [a], default=0.0)
    onp.testing.assert_allclose(s.asnumpy(), [1.0, 0.0, 3.0])
    rs = T.row_stack([a, b])
    assert isinstance(rs, T.ndarray) and rs.shape == (2, 3)
    arr = T.array([1.0, 2.0, 3.0, 4.0])
    T.put(arr, T.array([10], dtype="int32"), T.array([9.0]))
    onp.testing.assert_allclose(arr.asnumpy(), [1, 2, 3, 9])
    arr2 = T.array([0.0, 0.0, 0.0])
    T.put(arr2, T.array([0, 1, 2], dtype="int32"), T.array([7.0, 8.0]))
    onp.testing.assert_allclose(arr2.asnumpy(), [7, 8, 7])
    assert T.nanstd(T.array([1.0, 2.0], dtype="float16")).dtype == \
        onp.float16
    assert T.iscomplexobj(T.array([1.0])) is False
    assert T.isrealobj(T.array([1.0])) is True
    assert isinstance(T.array_equiv(a, a), bool)


def test_np_random_namespace():
    tmx.random.seed(42)
    u = T.random.uniform(0, 2, (3, 4))
    assert isinstance(u, T.ndarray) and u.shape == (3, 4)
    assert u.dtype == onp.float32
    a = u.asnumpy()
    assert (a >= 0).all() and (a < 2).all()
    tmx.random.seed(42)
    onp.testing.assert_array_equal(T.random.uniform(0, 2, (3, 4)).asnumpy(),
                                   a)
    r = T.random.randint(5, size=(10,))
    assert r.dtype == onp.int32 and (r.asnumpy() < 5).all()
    n = T.random.normal(1.0, 0.0, (4,))
    onp.testing.assert_allclose(n.asnumpy(), onp.ones(4), rtol=1e-6)
    assert T.random.randn(2, 3).shape == (2, 3)
    assert (T.random.choice(4, size=(6,)).asnumpy() < 4).all()
    x = T.arange(0, 8)
    T.random.shuffle(x)
    assert sorted(x.asnumpy().tolist()) == list(range(8))
    m = T.random.multinomial(10, [0.25, 0.25, 0.5])
    assert int(m.asnumpy().sum()) == 10
    assert (T.random.exponential(2.0, (100,)).asnumpy() >= 0).all()


_RANDOM_DRAWS = {
    "uniform": ("m.random.uniform(1.0, 3.0, (N,))", 2.0, 1.0 / 3.0),
    "normal": ("m.random.normal(1.0, 2.0, (N,))", 1.0, 4.0),
    "exponential": ("m.random.exponential(2.0, (N,))", 2.0, 4.0),
    "gamma": ("m.random.gamma(3.0, 2.0, (N,))", 6.0, 12.0),
    "beta": ("m.random.beta(2.0, 3.0, (N,))", 0.4, 0.04),
    "chisquare": ("m.random.chisquare(4.0, (N,))", 4.0, 8.0),
    "gumbel": ("m.random.gumbel(0.5, 2.0, (N,))", 0.5 + 2.0 * 0.5772156649,
               (onp.pi * 2.0) ** 2 / 6),
    "laplace": ("m.random.laplace(1.0, 0.5, (N,))", 1.0, 0.5),
    "logistic": ("m.random.logistic(1.0, 0.5, (N,))", 1.0,
                 (onp.pi * 0.5) ** 2 / 3),
    "lognormal": ("m.random.lognormal(0.0, 0.5, (N,))", onp.exp(0.125),
                  (onp.exp(0.25) - 1) * onp.exp(0.25)),
    "pareto": ("m.random.pareto(5.0, (N,))", 0.25, 5.0 / (16 * 3)),
    "power": ("m.random.power(3.0, (N,))", 0.75, 3.0 / 80),
    "rayleigh": ("m.random.rayleigh(2.0, (N,))", 2.0 * onp.sqrt(onp.pi / 2),
                 (4 - onp.pi) / 2 * 4),
    "weibull": ("m.random.weibull(2.0, (N,))", 0.886226925, 0.214601837),
    "randint": ("m.random.randint(2, 7, size=(N,))", 4.0, 2.0),
    "choice": ("m.random.choice(5, size=(N,))", 2.0, 2.0),
    "multivariate_normal": ("m.random.multivariate_normal([1.0, -1.0], "
                            "[[1.0, 0.0], [0.0, 4.0]], size=(N // 2,))"
                            "[:, 1]", -1.0, 4.0),
}


@pytest.mark.parametrize("name", sorted(_RANDOM_DRAWS))
def test_np_random_draws_match_reference_by_distribution(name):
    """Shapes and dtypes equal to the reference's; the sample mean and
    variance of 20000 draws within 5 standard errors of the distribution's
    (and of the reference's own draws)."""
    src, mean, var = _RANDOM_DRAWS[name]
    n = 20000
    jmx.random.seed(5)
    tmx.random.seed(5)
    r = eval(src, {"m": R, "N": n})
    t = eval(src, {"m": T, "N": n})
    assert r.shape == t.shape and str(r.dtype) == str(t.dtype)
    for x in (r.asnumpy().astype(onp.float64), t.asnumpy().astype(onp.float64)):
        se = onp.sqrt(var / x.size)
        assert abs(x.mean() - mean) < 5 * se + 1e-6, (x.mean(), mean)
        assert abs(x.var() - var) < 0.1 * var + 1e-6, (x.var(), var)


def test_np_random_param_broadcast_independent_draws():
    tmx.random.seed(0)
    e = T.random.exponential(T.array([1.0, 2.0, 4.0]))
    assert e.shape == (3,)
    ratios = e.asnumpy() / onp.array([1.0, 2.0, 4.0])
    assert len(set(onp.round(ratios, 6))) > 1, "correlated draws"
    assert T.random.gamma(T.array([1.0, 2.0])).shape == (2,)
    n = T.random.normal(T.array([0.0, 100.0]), 1.0)
    assert n.shape == (2,) and abs(float(n.asnumpy()[1]) - 100) < 10


def test_np_random_out_and_size_validation():
    buf = T.zeros((4,))
    r = T.random.uniform(0, 1, (4,), out=buf)
    assert r is buf and buf.asnumpy().any()
    with pytest.raises(ValueError, match="broadcast"):
        T.random.normal(T.zeros((3, 1)), 1.0, size=(4,))
    with pytest.raises(NotImplementedError):
        T.random.exponential(1.0, (3,), out=T.zeros((3,)))
    w = T.linalg.eigvals(T.array([[0.0, 1.0], [-1.0, 0.0]]))
    vals = sorted(onp.asarray(w.asnumpy()).imag.tolist())
    onp.testing.assert_allclose(vals, [-1.0, 1.0], atol=1e-5)


def test_np_linalg_namespace():
    a = T.array([[4.0, 1.0], [1.0, 3.0]])
    assert abs(float(T.linalg.norm(T.array([3.0, 4.0])).asnumpy())
               - 5.0) < 1e-6
    L = T.linalg.cholesky(a)
    onp.testing.assert_allclose(L.asnumpy() @ L.asnumpy().T, a.asnumpy(),
                                rtol=1e-5)
    inv = T.linalg.inv(a)
    onp.testing.assert_allclose(inv.asnumpy() @ a.asnumpy(), onp.eye(2),
                                atol=1e-5)
    assert abs(float(T.linalg.det(a).asnumpy()) - 11.0) < 1e-4
    w, v = T.linalg.eigh(a)
    assert isinstance(w, T.ndarray) and isinstance(v, T.ndarray)
    b = T.array([1.0, 2.0])
    x = T.linalg.solve(a, b)
    onp.testing.assert_allclose(a.asnumpy() @ x.asnumpy(), b.asnumpy(),
                                rtol=1e-5)
    sgn, logd = T.linalg.slogdet(a)
    onp.testing.assert_allclose(float(sgn.asnumpy())
                                * onp.exp(float(logd.asnumpy())), 11.0,
                                rtol=1e-4)
    q, r = T.linalg.qr(a)
    onp.testing.assert_allclose(q.asnumpy() @ r.asnumpy(), a.asnumpy(),
                                rtol=1e-5)


_LINALG = {
    "norm": "m.linalg.norm(P)", "norm_axis": "m.linalg.norm(P, axis=1)",
    "norm_ord1": "m.linalg.norm(P, ord=1)",
    "svd_values": "m.linalg.svd(P, compute_uv=False)",
    "cholesky": "m.linalg.cholesky(SPD)", "inv": "m.linalg.inv(SPD)",
    "det": "m.linalg.det(SPD)", "slogdet": "m.linalg.slogdet(SPD)",
    "eigvalsh": "m.linalg.eigvalsh(SPD)",
    "solve": "m.linalg.solve(SPD, VEC)",
    "lstsq": "m.linalg.lstsq(TALL, m.ravel(TALL[:, 0]) * 2.0)",
    "matrix_rank": "m.linalg.matrix_rank(P)",
    "matrix_power": "m.linalg.matrix_power(SPD, 3)",
    "pinv": "m.linalg.pinv(TALL)",
    "multi_dot": "m.linalg.multi_dot([SPD, P, m.transpose(P)])",
    "tensorinv": "m.linalg.tensorinv(m.reshape(m.add(m.eye(4), m.multiply(P, 0.1)), (4, 2, 2)), ind=1)",
    "tensorsolve": "m.linalg.tensorsolve(m.add(m.eye(4), m.multiply(P, 0.1)), m.ravel(P[0]))",
}


@pytest.mark.parametrize("name", sorted(_LINALG))
def test_np_linalg_matches_reference(name):
    def env(m):
        r = onp.random.RandomState(7)
        p = r.rand(4, 4).astype("float32")
        return dict(m=m, P=m.array(p),
                    SPD=m.array((p @ p.T + 4 * onp.eye(4)).astype("float32")),
                    VEC=m.array(r.rand(4).astype("float32")),
                    TALL=m.array(r.rand(6, 3).astype("float32")))
    _agree(eval(_LINALG[name], env(R)), eval(_LINALG[name], env(T)),
           rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------------
# mx.npx
# ----------------------------------------------------------------------------

def test_npx_explicit_surface():
    npx = tmx.npx
    x = T.array([[-1.0, 2.0], [3.0, -4.0]])
    onp.testing.assert_allclose(npx.relu(x).asnumpy(), [[0, 2], [3, 0]])
    s = npx.softmax(x, axis=-1)
    onp.testing.assert_allclose(s.asnumpy().sum(-1), [1, 1], rtol=1e-6)
    onp.testing.assert_allclose(npx.log_softmax(x).asnumpy(),
                                onp.log(s.asnumpy()), rtol=1e-5)
    assert npx.gelu(x).shape == x.shape
    oh = npx.one_hot(T.array([0, 1], dtype="int32"), depth=3)
    onp.testing.assert_allclose(oh.asnumpy(), [[1, 0, 0], [0, 1, 0]])
    tk = npx.topk(T.array([[1.0, 3.0, 2.0]]), k=2, ret_typ="indices")
    onp.testing.assert_allclose(tk.asnumpy(), [[1, 2]])
    pk = npx.pick(T.array([[1.0, 2.0], [3.0, 4.0]]), T.array([1.0, 0.0]))
    onp.testing.assert_allclose(pk.asnumpy(), [2, 3])
    onp.testing.assert_array_equal(npx.shape_array(x).asnumpy(), [2, 2])


_NPX = {
    "relu": "npx.relu(X)", "sigmoid": "npx.sigmoid(X)",
    "softmax": "npx.softmax(X, axis=0)",
    "softmax_temperature": "npx.softmax(X, temperature=2.0)",
    "log_softmax": "npx.log_softmax(X)", "gelu": "npx.gelu(X)",
    "leaky_relu": "npx.leaky_relu(X, slope=0.1)",
    "activation": "npx.activation(X, act_type='tanh')",
    "masked_softmax": "npx.masked_softmax(X, M)",
    "masked_log_softmax": "npx.masked_log_softmax(X, M)",
    "layer_norm": "npx.layer_norm(X, G, Z)",
    "l2_normalization": "npx.l2_normalization(X)",
    "fully_connected": "npx.fully_connected(X, W, Z3, num_hidden=3)",
    "convolution": "npx.convolution(IMG, CW, kernel=(3, 3), num_filter=3, pad=(1, 1))",
    "pooling": "npx.pooling(IMG, kernel=(2, 2), stride=(2, 2), pool_type='avg')",
    "one_hot": "npx.one_hot(np.array([0, 2], dtype='int32'), depth=3)",
    "pick": "npx.pick(X, np.array([1.0, 0.0, 3.0]))",
    "topk": "npx.topk(X, k=2, ret_typ='value')",
    "sequence_mask": "npx.sequence_mask(X, np.array([1.0, 3.0, 2.0, 0.0]))",
    "arange_like": "npx.arange_like(X, axis=1)",
    "broadcast_like": "npx.broadcast_like(np.ones((1, 4)), X)",
    "gather_nd": "npx.gather_nd(X, np.array([[0, 2], [1, 3]], dtype='int32'))",
    "shape_array": "npx.shape_array(X)", "reshape_like": "npx.reshape_like(X, np.ones((4, 3)))",
    "slice": "npx.slice(X, begin=(0, 1), end=(2, 4))",
    "smooth_l1": "npx.smooth_l1(X, scalar=2.0)",
    "registered_fallback": "npx.broadcast_add(X, X)",
}


@pytest.mark.parametrize("name", sorted(_NPX))
def test_npx_matches_reference(name):
    def env(mod):
        r = onp.random.RandomState(11)
        np_ = mod.np
        return dict(npx=mod.npx, np=np_,
                    X=np_.array(r.randn(3, 4).astype("float32")),
                    M=np_.array((r.rand(3, 4) > 0.3).astype("int32")),
                    G=np_.array(r.rand(4).astype("float32")),
                    Z=np_.array(onp.zeros(4, "float32")),
                    Z3=np_.array(onp.zeros(3, "float32")),
                    W=np_.array(r.rand(3, 4).astype("float32")),
                    IMG=np_.array(r.rand(1, 2, 6, 6).astype("float32")),
                    CW=np_.array(r.rand(3, 2, 3, 3).astype("float32")))
    _agree(eval(_NPX[name], env(jmx)), eval(_NPX[name], env(tmx)),
           rtol=1e-5, atol=1e-5)


def test_npx_masked_softmax():
    npx = tmx.npx
    x = T.array([[1.0, 2.0, 3.0]])
    m = T.array([[1, 1, 0]], dtype="int32")
    s = npx.masked_softmax(x, m).asnumpy()
    assert s[0, 2] == 0.0
    onp.testing.assert_allclose(s[0, :2].sum(), 1.0, rtol=1e-6)
    ls = npx.masked_log_softmax(x, m).asnumpy()
    onp.testing.assert_allclose(onp.exp(ls[0, :2]).sum(), 1.0, rtol=1e-5)
    assert ls[0, 2] < -1e29


def test_npx_nn_layers():
    npx = tmx.npx
    rng = onp.random.RandomState(0)
    x = T.array(rng.rand(2, 3).astype(onp.float32))
    w = T.array(rng.rand(4, 3).astype(onp.float32))
    b = T.array(onp.zeros(4, onp.float32))
    out = npx.fully_connected(x, w, b, num_hidden=4)
    onp.testing.assert_allclose(out.asnumpy(), x.asnumpy() @ w.asnumpy().T,
                                rtol=1e-5)
    img = T.array(rng.rand(1, 2, 6, 6).astype(onp.float32))
    cw = T.array(rng.rand(3, 2, 3, 3).astype(onp.float32))
    assert npx.convolution(img, cw, kernel=(3, 3), num_filter=3,
                           pad=(1, 1)).shape == (1, 3, 6, 6)
    assert npx.pooling(img, kernel=(2, 2), stride=(2, 2)).shape == \
        (1, 2, 3, 3)
    gamma = T.array(onp.ones(2, onp.float32))
    beta = T.array(onp.zeros(2, onp.float32))
    assert npx.layer_norm(T.array(rng.rand(2, 2).astype(onp.float32)),
                          gamma, beta).shape == (2, 2)


def test_npx_set_np_roundtrip():
    npx = tmx.npx
    assert not npx.is_np_array()
    npx.set_np()
    assert npx.is_np_array() and npx.is_np_shape()
    npx.reset_np()
    assert not npx.is_np_array()


def test_np_creation_and_math():
    a = tmx.np.array([[1, 2], [3, 4]])
    b = tmx.np.ones((2, 2))
    c = tmx.np.matmul(a, b)
    onp.testing.assert_allclose(c.asnumpy(), [[3, 3], [7, 7]])
    assert tmx.np.mean(a).asnumpy() == 2.5
    assert tmx.np.concatenate([a, b], axis=0).shape == (4, 2)
    assert tmx.np.arange(5).shape == (5,)
    assert float(tmx.np.pi) == pytest.approx(onp.pi)


def test_util_counts_cuda_devices():
    import torch

    assert tmx.util.get_gpu_count() == torch.cuda.device_count()
    assert tmx.util.is_np_array() is False
    assert tmx.util.use_np(len) is len


# ---------------------------------------------------------------------------
# the names that are not functions (queue C's C1)
# ---------------------------------------------------------------------------

def test_every_reference_name_resolves_or_raises_naming_itself():
    """Every public name of the reference's ``mx.np`` resolves on the port
    or raises MXNetError naming itself; none raises AttributeError."""
    missing, unnamed = [], []
    for name in sorted(n for n in dir(R) if not n.startswith("_")):
        try:
            getattr(T, name)
        except MXNetError as e:
            if name not in str(e):
                unnamed.append(name)
        except AttributeError:
            missing.append(name)
    assert not missing and not unnamed, (missing, unnamed)


_DTYPE_NAMES = ("bool", "int16", "uint16", "uint32", "uint64", "int_",
                "uint", "float_", "single", "double", "complex64",
                "complex128", "csingle", "cdouble", "complex_")
_SCALAR_TYPES = ("generic", "number", "integer", "signedinteger",
                 "unsignedinteger", "inexact", "floating", "complexfloating",
                 "character", "flexible", "object_")


@pytest.mark.parametrize("name", _DTYPE_NAMES)
def test_dtype_names_take_numpy_values(name):
    assert onp.dtype(getattr(T, name)) == onp.dtype(getattr(R, name))
    if name in ("bool", "int16", "single"):  # what both arrays can hold
        with tmx.cpu():
            z = T.zeros(2, dtype=getattr(T, name))
        assert onp.dtype(z.dtype) == onp.dtype(
            R.zeros(2, dtype=getattr(R, name)).dtype)


@pytest.mark.parametrize("name", _SCALAR_TYPES)
def test_scalar_hierarchy_is_numpys(name):
    assert getattr(T, name) is getattr(R, name) is getattr(onp, name)


@pytest.mark.parametrize("dt", ["float32", "float16", "float64",
                                "bfloat16"])
def test_finfo_iinfo_dtype_and_index_helpers(dt):
    got, want = T.finfo(getattr(T, dt)), R.finfo(getattr(R, dt))
    for attr in ("eps", "epsneg", "max", "min", "tiny", "resolution",
                 "bits", "precision", "maxexp", "minexp", "nmant"):
        assert float(getattr(got, attr)) == float(getattr(want, attr)), attr
    assert T.finfo(dt).eps == got.eps
    for it in ("int8", "int16", "int32", "uint8"):
        assert T.iinfo(getattr(T, it)).max == R.iinfo(getattr(R, it)).max
    assert T.dtype("float32") == R.dtype("float32")
    assert T.s_[1:3] == R.s_[1:3] and T.index_exp[2] == R.index_exp[2]
    with tmx.cpu():
        got = T.arange(6)[T.s_[1:3]].asnumpy()
    onp.testing.assert_array_equal(got, [1.0, 2.0])


@pytest.mark.parametrize("name", sorted(T._JAX_ONLY))
def test_jax_valued_names_raise_naming_themselves(name):
    assert hasattr(R, name)
    with pytest.raises(MXNetError, match=name):
        getattr(T, name)
