"""Repairs of the port's numpy front end and sign against the reference,
one group per fault of the last re-anchor (``ROADMAP.md`` queue C):

- C1 ``np.linalg.norm`` of a vector with ``ord``; C2 ``matrix_rank`` of a
  vector; C3 ``matrix_power`` of integer matrices; C4 ``lstsq``'s
  residuals;
- C5 ``np.pad`` in every mode, on 4-D inputs, wider than the axis, with
  per-axis values;
- C6 (Python scalars on either side of ``divmod``/``nextafter``/``ldexp``/
  ``logaddexp2``) is the scalar sweep of ``tests/test_torch_numpy.py``;
- C7 ``sign`` of NaN and -0.0 in ``nd``, ``np`` and the sign-based
  updates (FTRL, signSGD, Signum; the registered ops and both update
  engines);
- C8 ``np.clip`` of integer arrays with float bounds;
- C9 the inputs the reference refuses, refused with its exception type,
  and ``gcd``/``lcm`` with a Python bool.

The same numpy inputs go through both packages on the CPU. Tolerances:
rtol 1e-5 / atol 1e-6 on float results, dtypes and shapes equal, integer
results and signs of zeros exact.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _host(x):
    if isinstance(x, (tuple, list)):
        return [_host(v) for v in x]
    return onp.asarray(x.asnumpy()) if hasattr(x, "asnumpy") \
        else onp.asarray(x)


def _same(r, t, rtol=1e-5, atol=1e-6):
    r, t = _host(r), _host(t)
    if isinstance(r, list):
        assert isinstance(t, list) and len(r) == len(t)
        for a, b in zip(r, t):
            _same(a, b, rtol, atol)
        return
    assert r.dtype == t.dtype, (r.dtype, t.dtype)
    assert r.shape == t.shape, (r.shape, t.shape)
    if r.dtype.kind in "iub":
        onp.testing.assert_array_equal(r, t)
    else:
        onp.testing.assert_allclose(r, t, rtol=rtol, atol=atol,
                                    equal_nan=True)


def _both(fn):
    return fn(jmx), fn(tmx)


_V = onp.array([1.5, -2.0, 0.3, 0.5, -1.11939], onp.float32)
_M = onp.arange(9, dtype=onp.int32).reshape(3, 3)


# ---------------------------------------------------------------------------
# C1-C4: np.linalg
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("order", [1, 2, 3, -1, 0, onp.inf, -onp.inf, None])
def test_vector_norm_with_ord(order, keep):
    _same(*_both(lambda m: m.np.linalg.norm(m.np.array(_V), ord=order,
                                            keepdims=keep)))


def test_vector_norm_matrix_order_raises_value_error():
    for m in (jmx, tmx):
        with pytest.raises(ValueError):
            m.np.linalg.norm(m.np.array(_V), ord="fro")


@pytest.mark.parametrize("vec", [_V, onp.zeros(4, onp.float32),
                                 onp.array([0, 3, 0], onp.int32)],
                         ids=["nonzero", "zero", "int"])
def test_matrix_rank_of_a_vector(vec):
    _same(*_both(lambda m: m.np.linalg.matrix_rank(
        m.np.array(vec, dtype=str(vec.dtype)))))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("dt", ["int32", "float32"])
def test_matrix_power_keeps_integer_dtype(n, dt):
    _same(*_both(lambda m: m.np.linalg.matrix_power(
        m.np.array(_M.astype(dt), dtype=dt), n)))


def test_matrix_power_of_a_batch_of_integer_matrices():
    a = onp.random.RandomState(0).randint(-3, 4, (2, 3, 3)).astype("int32")
    _same(*_both(lambda m: m.np.linalg.matrix_power(
        m.np.array(a, dtype="int32"), 4)))


_LSTSQ = {
    "rank_deficient_vector": (onp.ones((4, 3)), onp.arange(4.0)),
    "rank_deficient_matrix": (onp.ones((4, 3)),
                              onp.arange(8.0).reshape(4, 2)),
    "full_rank_tall": (onp.random.RandomState(1).rand(5, 3),
                       onp.random.RandomState(2).rand(5)),
    "wide": (onp.ones((2, 3)), onp.arange(2.0)),
}


@pytest.mark.parametrize("name", sorted(_LSTSQ))
def test_lstsq_returns_residuals(name):
    a, b = (v.astype(onp.float32) for v in _LSTSQ[name])
    _same(*_both(lambda m: m.np.linalg.lstsq(m.np.array(a), m.np.array(b),
                                             rcond=None)),
          rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# C5: np.pad
# ---------------------------------------------------------------------------

_R = onp.random.RandomState(0)
_X2 = _R.rand(3, 4).astype(onp.float32)
_X4 = _R.rand(2, 3, 2, 3).astype(onp.float32)
_I2 = _R.randint(-5, 9, (3, 4)).astype(onp.int32)
_X1 = onp.array([1.0, 2.0, 3.0], onp.float32)

_PAD = {
    "constant": (_X2, ((1, 2), (0, 3)), "constant", {}),
    "constant_per_axis": (_X2, ((1, 2), (2, 1)), "constant",
                          {"constant_values": ((1, 2), (3, 4))}),
    "constant_int_float_value": (_I2, 2, "constant",
                                 {"constant_values": 1.7}),
    "edge_4d": (_X4, 1, "edge", {}),
    "reflect_4d": (_X4, ((1, 1), (0, 2), (1, 0), (2, 2)), "reflect", {}),
    "reflect_wider_than_axis": (_X1, 4, "reflect", {}),
    "reflect_wider_2d": (_X2, ((5, 7), (9, 3)), "reflect", {}),
    "reflect_odd": (_X2, ((5, 2), (3, 6)), "reflect",
                    {"reflect_type": "odd"}),
    "reflect_length_1": (onp.array([[5.0]], onp.float32), 3, "reflect", {}),
    "symmetric": (_X2, ((5, 2), (3, 6)), "symmetric", {}),
    "symmetric_odd": (_X2, ((5, 2), (3, 9)), "symmetric",
                      {"reflect_type": "odd"}),
    "wrap_wider_than_axis": (_X1, 5, "wrap", {}),
    "wrap_4d": (_X4, ((3, 1), (4, 2), (0, 5), (1, 1)), "wrap", {}),
    "linear_ramp": (_X2, ((2, 3), (1, 4)), "linear_ramp",
                    {"end_values": ((1, -2), (3, 0.5))}),
    "linear_ramp_int": (_I2, ((2, 3), (1, 4)), "linear_ramp",
                        {"end_values": ((10, -7), (3, 5))}),
    "maximum": (_X2, ((2, 1), (1, 2)), "maximum", {}),
    "minimum_stat_length": (_X2, ((2, 1), (1, 2)), "minimum",
                            {"stat_length": ((1, 2), (2, 3))}),
    "mean": (_X2, 2, "mean", {}),
    "mean_int": (_I2, 2, "mean", {}),
    "median": (_X2, ((2, 1), (1, 2)), "median", {}),
    "median_int_stat_length": (_I2, ((2, 1), (1, 2)), "median",
                               {"stat_length": 2}),
}


@pytest.mark.parametrize("name", sorted(_PAD))
def test_pad_mode(name):
    a, width, mode, kw = _PAD[name]
    _same(*_both(lambda m: m.np.pad(m.np.array(a, dtype=str(a.dtype)),
                                    width, mode=mode, **kw)))


def test_pad_empty_has_the_reference_shape_and_dtype():
    r, t = _both(lambda m: m.np.pad(m.np.array(_I2, dtype="int32"),
                                    ((1, 2), (3, 0)), mode="empty"))
    r, t = _host(r), _host(t)
    assert (r.shape, r.dtype) == (t.shape, t.dtype)
    onp.testing.assert_array_equal(r[1:4, 3:], t[1:4, 3:])


def test_pad_records_gradients():
    x = tmx.np.array(_X2)
    x.attach_grad()
    with tmx.autograd.record():
        y = tmx.np.pad(x, ((2, 3), (4, 1)), mode="reflect").sum()
    y.backward()
    jx = jmx.np.array(_X2)
    jx.attach_grad()
    with jmx.autograd.record():
        jy = jmx.np.pad(jx, ((2, 3), (4, 1)), mode="reflect").sum()
    jy.backward()
    _same(jx.grad, x.grad)


# ---------------------------------------------------------------------------
# C7: sign of NaN and -0.0, and the sign-based updates
# ---------------------------------------------------------------------------

_SIGNED = onp.array([onp.nan, -0.0, 2.0, -3.0, 0.0], onp.float32)


def _signbits_equal(r, t):
    r, t = _host(r), _host(t)
    onp.testing.assert_array_equal(onp.signbit(r), onp.signbit(t))


@pytest.mark.parametrize("front", ["nd", "np"])
def test_sign_keeps_nan_and_negative_zero(front):
    def run(m):
        mod = getattr(m, front)
        return mod.sign(mod.array(_SIGNED))
    r, t = _both(run)
    _same(r, t)
    _signbits_equal(r, t)
    assert onp.isnan(_host(t)[0])


def _nan_grad():
    g = onp.random.RandomState(4).randn(6).astype(onp.float32)
    g[[1, 4]] = onp.nan
    g[2] = -0.0
    return g


_UPDATE_OPS = {
    "ftrl_update": (lambda nd, w, g, s: nd.ftrl_update(
        w, g, s[0], s[1], lr=0.1, lamda1=0.01)),
    "signsgd_update": (lambda nd, w, g, s: nd.signsgd_update(
        w, g, lr=0.05, wd=0.01)),
    "signum_update": (lambda nd, w, g, s: nd.signum_update(
        w, g, s[0], lr=0.05, momentum=0.9, wd_lh=0.001)),
}


@pytest.mark.parametrize("op", sorted(_UPDATE_OPS))
def test_sign_based_update_ops_with_nan_gradients(op):
    w = onp.random.RandomState(5).randn(6).astype(onp.float32)
    z = onp.random.RandomState(6).randn(6).astype(onp.float32)
    n = onp.abs(onp.random.RandomState(7).randn(6)).astype(onp.float32)

    def run(m):
        st = (m.nd.array(z), m.nd.array(n))
        out = _UPDATE_OPS[op](m.nd, m.nd.array(w), m.nd.array(_nan_grad()),
                              st)
        return out if isinstance(out, (list, tuple)) else [out]
    _same(*_both(run))


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "eager"])
@pytest.mark.parametrize("name,kw", [("signum", {"momentum": 0.0}),
                                     ("signum", {"momentum": 0.9}),
                                     ("ftrl", {})],
                         ids=["signsgd", "signum", "ftrl"])
def test_sign_based_optimizers_with_nan_gradients(name, kw, fused):
    prev = os.environ.get("MXNET_FUSED_UPDATE")
    os.environ["MXNET_FUSED_UPDATE"] = fused
    try:
        def run(m):
            opt = m.optimizer.create(name, learning_rate=0.05, **kw)
            up = m.optimizer.Updater(opt)
            w = m.nd.array(onp.random.RandomState(5).randn(6)
                           .astype(onp.float32))
            for _ in range(2):
                up.update_batch([0], [m.nd.array(_nan_grad())], [w])
            return w
        _same(*_both(run))
    finally:
        if prev is None:
            os.environ.pop("MXNET_FUSED_UPDATE", None)
        else:
            os.environ["MXNET_FUSED_UPDATE"] = prev


# ---------------------------------------------------------------------------
# C8: clip
# ---------------------------------------------------------------------------

_CLIP = {
    "int_float_bounds": ("int32", -1.5, 2.5),
    "int_int_bounds": ("int32", -1, 2),
    "int_none_float": ("int32", None, 2.5),
    "int_float_none": ("int32", -0.5, None),
    "float16_float_bounds": ("float16", -1.5, 2.5),
    "float32_int_bounds": ("float32", -1, 2),
    "int_array_bounds": ("int32", "array", "array"),
}


@pytest.mark.parametrize("name", sorted(_CLIP))
def test_clip_promotes_with_its_bounds(name):
    dt, lo, hi = _CLIP[name]
    x = onp.arange(-3, 4).astype(dt)

    def run(m):
        a, b = lo, hi
        if lo == "array":  # host arrays: the reference takes no ndarray
            a = onp.full(7, -1.5, onp.float32)
            b = onp.full(7, 2.25, onp.float32)
        return m.np.clip(m.np.array(x, dtype=dt), a, b)
    _same(*_both(run))


# ---------------------------------------------------------------------------
# C9: what the reference refuses, and gcd/lcm with a Python bool
# ---------------------------------------------------------------------------

_A3 = (onp.random.RandomState(0).rand(2, 3, 3) + 3 * onp.eye(3)).astype(
    onp.float32)
_I3 = onp.array([1, 2, 3], onp.int32)
_F6 = onp.arange(6, dtype=onp.float32)

_REFUSED = {
    "solve_batched_vector": (lambda m: m.np.linalg.solve(
        m.np.array(_A3), m.np.array(onp.ones((2, 3), onp.float32))),
        ValueError),
    "power_int_negative": (lambda m: m.np.power(
        m.np.array(_I3, dtype="int32"), -1), TypeError),
    "round_int_negative_decimals": (lambda m: m.np.round(
        m.np.array(_I3 * 15, dtype="int32"), decimals=-1),
        NotImplementedError),
    "around_int_negative_decimals": (lambda m: m.np.around(
        m.np.array(_I3 * 15, dtype="int32"), decimals=-1),
        NotImplementedError),
    "insert_list_index": (lambda m: m.np.insert(m.np.array(_F6), [1, 3],
                                                9.0), TypeError),
    "delete_list_index": (lambda m: m.np.delete(m.np.array(_F6), [1, 3]),
                          TypeError),
    "polyval_list": (lambda m: m.np.polyval([1.0, 2.0], m.np.array(_F6)),
                     TypeError),
    "digitize_list": (lambda m: m.np.digitize(m.np.array(_F6), [1.0, 3.0]),
                      TypeError),
    "compress_list": (lambda m: m.np.compress([True, False, True],
                                              m.np.array(_F6)), TypeError),
}


@pytest.mark.parametrize("name", sorted(_REFUSED))
def test_refuses_what_the_reference_refuses(name):
    fn, exc = _REFUSED[name]
    for m in (jmx, tmx):
        with pytest.raises(exc):
            fn(m)


_ACCEPTED = {
    "solve_matrix_rhs": lambda m: m.np.linalg.solve(
        m.np.array(_A3), m.np.array(onp.ones((2, 3, 2), onp.float32))),
    "solve_vector": lambda m: m.np.linalg.solve(
        m.np.array(_A3[0]), m.np.array(onp.ones(3, onp.float32))),
    "solve_broadcast_rhs": lambda m: m.np.linalg.solve(
        m.np.array(_A3), m.np.array(onp.ones((3, 2), onp.float32))),
    "power_int_array_exponent": lambda m: m.np.power(
        m.np.array(_I3, dtype="int32"),
        m.np.array(onp.array([-1, 2, 1], onp.int32), dtype="int32")),
    "power_float_negative": lambda m: m.np.power(
        m.np.array(_F6 + 1), -1),
    "round_int_positive_decimals": lambda m: m.np.round(
        m.np.array(_I3, dtype="int32"), decimals=1),
    "insert_array_index": lambda m: m.np.insert(
        m.np.array(_F6), m.np.array(onp.array([1, 3], onp.int32),
                                    dtype="int32"), 9.0),
    "delete_slice": lambda m: m.np.delete(m.np.array(_F6), slice(1, 3)),
    "gcd_python_bool": lambda m: m.np.gcd(m.np.array(_I3, dtype="int32"),
                                          True),
    "lcm_python_bool": lambda m: m.np.lcm(False,
                                          m.np.array(_I3, dtype="int32")),
    "gcd_bool_array_int": lambda m: m.np.gcd(
        m.np.array(onp.array([True, False]), dtype="bool"), 2),
}


@pytest.mark.parametrize("name", sorted(_ACCEPTED))
def test_accepts_what_the_reference_accepts(name):
    _same(*_both(_ACCEPTED[name]))


def test_gcd_of_bool_array_and_python_bool_raises_in_both():
    for m in (jmx, tmx):
        with pytest.raises(ValueError):
            m.np.gcd(m.np.array(onp.array([True, False]), dtype="bool"),
                     True)
