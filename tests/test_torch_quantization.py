"""The port's int8 quantization (``mxnet_tpu_torch/ops/quantization.py``,
``mxnet_tpu_torch/contrib/quantization.py``) against the JAX package's, on
the CPU.

The ops take the same inputs in both packages: quantize, requantize and
dequantize agree bitwise, and the int8 products' int32 accumulators
exactly (the port's CPU route is an f64 product, exact below 2^53). The
reference's 17 cases of ``tests/test_quantization.py`` run on both
packages with their own assertions, their outputs held to each other.
``quantize_model`` of a CNN built with the ``sym`` API gives the
reference's graph (node names and ops, arguments) and its int8 weights
bitwise; ResNet-18 v1 traced at 32 x 32 differs by design (the port's
BatchNorm statistics are auxiliary states) and is held by value. Whole
int8 graphs agree with the reference's int8 outputs to 1% of the largest
|f32| output, a fifth of the reference's own int8-vs-f32 bound (0.05,
``tests/test_quantization.py``): f32 drift between the packages can move
a value across a rounding boundary of a later quantize, never more.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.ops.registry import get_op as jget
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.ops import quantization as tq
from mxnet_tpu_torch.ops.registry import get_op as tget

torch.set_num_threads(1)

INT8_GRAPH_TOL = 0.01  # of the largest |f32| output; the reference's: 0.05
# the ops this file holds to the reference (test_torch_ops.py's census)
COVERED = {f"_contrib_{n}" for n in (
    "quantize", "quantize_v2", "dequantize", "requantize",
    "quantized_fully_connected", "quantized_conv", "quantized_pooling",
    "quantized_flatten")}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref(name, *arrays, **kw):
    out = jget(name).fn(*[None if a is None else jnp.asarray(a)
                          for a in arrays], **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _port(name, *arrays, **kw):
    out = tget(name).fn(*[None if a is None else torch.from_numpy(
        np.array(a)) for a in arrays], **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _both_same(name, *arrays, **kw):
    got, want = _port(name, *arrays, **kw), _ref(name, *arrays, **kw)
    for g, w in zip(got if isinstance(got, tuple) else [got],
                    want if isinstance(want, tuple) else [want]):
        _same(g, w)
    return got


# ---------------------------------------------------------------------------
# the ops, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_dequantize_bitwise(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(4096) * [0.1, 3.0, 40.0][seed]).astype(np.float32)
    x[:4] = [0.0, -0.0, x.max() * 2, -x.max() * 2]  # clipped at +-127
    lo = np.array([x.min() * 0.7], np.float32)
    hi = np.array([x.max() * 0.9], np.float32)
    q, mn, mx = _both_same("_contrib_quantize", x, lo, hi)
    assert q.dtype == np.int8
    _both_same("_contrib_dequantize", q, mn, mx)
    q2 = _both_same("_contrib_quantize_v2", x)
    _both_same("_contrib_dequantize", *q2)
    _both_same("_contrib_quantize_v2", x, min_calib_range=float(lo[0]),
               max_calib_range=float(hi[0]))
    # half-to-even ties: x * scale lands on k + 0.5
    ties = (np.arange(-20, 20) + 0.5).astype(np.float32)
    q3 = _both_same("_contrib_quantize", ties, np.array([-127.0],
                                                        np.float32),
                    np.array([127.0], np.float32))
    np.testing.assert_array_equal(q3[0], np.round(ties).astype(np.int8))


def test_requantize_and_int32_dequantize_bitwise():
    rng = np.random.RandomState(3)
    acc = rng.randint(-2 ** 26, 2 ** 26, 5000).astype(np.int32)
    lo, hi = np.array([-41.3], np.float32), np.array([41.3], np.float32)
    _both_same("_contrib_dequantize", acc, lo, hi)
    _both_same("_contrib_requantize", acc, lo, hi)
    _both_same("_contrib_requantize", acc, lo, hi, min_calib_range=-0.2,
               max_calib_range=0.3)


def _int8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("k,rows,n", [(147, 4, 10), (576, 33, 64),
                                      (4608, 3, 7)])
@pytest.mark.parametrize("bias", [False, True])
def test_quantized_fully_connected_exact(k, rows, n, bias):
    rng = np.random.RandomState(k + rows)
    x, w = _int8(rng, rows, k), _int8(rng, n, k)
    b = _int8(rng, n) if bias else None
    r = [np.array([v], np.float32) for v in (-3.1, 3.1, -0.7, 0.7)]
    kw = dict(num_hidden=n, no_bias=not bias)
    if bias:
        kw.update(min_bias=np.array([-0.4], np.float32),
                  max_bias=np.array([0.4], np.float32))
    acc = _both_same("_contrib_quantized_fully_connected", x, w, b, *r,
                     **kw)[0]
    assert acc.dtype == np.int32
    if not bias:  # the integer product, exactly
        np.testing.assert_array_equal(
            acc, x.astype(np.int64) @ w.astype(np.int64).T)


def test_quantized_fully_connected_flatten_false():
    rng = np.random.RandomState(4)
    x, w = _int8(rng, 2, 3, 16), _int8(rng, 5, 16)
    r = [np.array([v], np.float32) for v in (-1.0, 1.0, -1.0, 1.0)]
    _both_same("_contrib_quantized_fully_connected", x, w, None, *r,
               num_hidden=5, no_bias=True, flatten=False)


@pytest.mark.parametrize("case", [
    dict(shape=(2, 3, 11, 11), w=(8, 3, 7, 7), kw=dict(
        kernel=(7, 7), stride=(2, 2), pad=(3, 3))),
    dict(shape=(1, 512, 5, 5), w=(16, 512, 3, 3), kw=dict(
        kernel=(3, 3), pad=(1, 1))),
    dict(shape=(2, 8, 9, 9), w=(6, 4, 3, 3), kw=dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_group=2)),
    dict(shape=(1, 4, 9, 9), w=(5, 4, 3, 3), kw=dict(
        kernel=(3, 3), pad=(2, 2), dilate=(2, 2))),
], ids=["stem-k147", "k4608", "groups", "dilate"])
def test_quantized_conv_exact(case):
    rng = np.random.RandomState(5)
    x, w = _int8(rng, *case["shape"]), _int8(rng, *case["w"])
    r = [np.array([v], np.float32) for v in (-2.0, 2.0, -0.3, 0.3)]
    kw = dict(case["kw"], num_filter=case["w"][0], no_bias=True)
    acc = _both_same("_contrib_quantized_conv", x, w, None, *r, **kw)[0]
    assert acc.dtype == np.int32
    # the card's route (im2col + integer product) on the same int8 values
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    stride, pad, dil = (kw.get(k, d) for k, d in (("stride", (1, 1)),
                                                   ("pad", (0, 0)),
                                                   ("dilate", (1, 1))))
    g = kw.get("num_group", 1)
    f, cg = w.shape[:2]
    outs = []
    for i in range(g):
        cols, (ho, wo) = tq._im2col_int8(xt[:, i * cg:(i + 1) * cg],
                                         w.shape[2:], stride, pad, dil)
        wg = wt[i * (f // g):(i + 1) * (f // g)].reshape(f // g, -1)
        outs.append((cols.long() @ wg.long().t()).to(torch.int32))
    im2col = torch.cat(outs, 1).reshape(x.shape[0], ho, wo, f) \
        .permute(0, 3, 1, 2)
    np.testing.assert_array_equal(im2col.numpy(), acc)


def test_quantized_pooling_and_flatten_bitwise():
    rng = np.random.RandomState(6)
    x = _int8(rng, 2, 3, 6, 6)
    r = [np.array([-1.5], np.float32), np.array([1.5], np.float32)]
    for kw in (dict(kernel=(2, 2), stride=(2, 2)),
               dict(kernel=(3, 3), stride=(1, 1), pool_type="avg"),
               dict(kernel=(1, 1), global_pool=True, pool_type="avg")):
        p = _both_same("_contrib_quantized_pooling", x, *r, **kw)
        _both_same("_contrib_quantized_flatten", *p)


# ---------------------------------------------------------------------------
# the reference's 17 cases, on both packages
# ---------------------------------------------------------------------------

def _fn(M):
    ops = tget if M is tmx else jget
    conv = (lambda a: torch.from_numpy(np.array(a))) if M is tmx \
        else jnp.asarray

    def call(name, *args, **kw):
        out = ops(name).fn(*[None if a is None else conv(a) for a in args],
                           **kw)
        if isinstance(out, tuple):
            return tuple(np.asarray(o) for o in out)
        return np.asarray(out)
    return call


def _reset():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}


def _twin(M, build, seed=0):
    """``build(M)`` with the reference's initialized weights: the
    reference net is built first under ``seed``; the port net copies its
    parameters by name."""
    _reset()
    jmx.random.seed(seed)
    ref = build(jmx)
    ref.initialize()
    if M is jmx:
        return ref
    net = build(tmx)
    net.initialize()
    rp = ref.collect_params()
    for name, p in net.collect_params().items():
        p.set_data(rp[name].data().asnumpy())
    return net


def case_quantize_dequantize_roundtrip(M):
    f = _fn(M)
    x = (np.random.RandomState(0).rand(64) * 10 - 5).astype(np.float32)
    q, mn, mx_ = f("_contrib_quantize", x, np.float32(-5).reshape(1),
                   np.float32(5).reshape(1))
    assert q.dtype == np.int8
    back = f("_contrib_dequantize", q, mn, mx_)
    assert float(np.abs(back - x).max()) <= 5 / 127 * 0.5 + 1e-6
    return [q, back]


def case_quantize_v2_online_range(M):
    q, mn, mx_ = _fn(M)("_contrib_quantize_v2",
                        np.array([-2.0, 0.0, 4.0], np.float32))
    assert float(mx_[0]) == pytest.approx(4.0)
    np.testing.assert_array_equal(q, [-64, 0, 127])
    return [q, mn, mx_]


def case_quantized_fc_close_to_f32(M):
    f = _fn(M)
    rng = np.random.RandomState(1)
    x = (rng.rand(4, 16) - 0.5).astype(np.float32)
    w = (rng.rand(8, 16) - 0.5).astype(np.float32)
    ref = x @ w.T
    qx, mn_d, mx_d = f("_contrib_quantize_v2", x)
    qw, mn_w, mx_w = f("_contrib_quantize_v2", w)
    acc, mn_o, mx_o = f("_contrib_quantized_fully_connected", qx, qw, None,
                        mn_d, mx_d, mn_w, mx_w, no_bias=True, num_hidden=8)
    assert acc.dtype == np.int32
    out = f("_contrib_dequantize", acc, mn_o, mx_o)
    assert float(np.abs(out - ref).max()) < 0.1
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.999
    return [acc, out]


def case_quantized_conv_close_to_f32(M):
    f = _fn(M)
    rng = np.random.RandomState(2)
    x = (rng.rand(2, 3, 8, 8) - 0.5).astype(np.float32)
    w = (rng.rand(4, 3, 3, 3) - 0.5).astype(np.float32)
    ref = f("Convolution", x, w, None, kernel=(3, 3), pad=(1, 1),
            num_filter=4, no_bias=True)
    qx, mn_d, mx_d = f("_contrib_quantize_v2", x)
    qw, mn_w, mx_w = f("_contrib_quantize_v2", w)
    acc, mn_o, mx_o = f("_contrib_quantized_conv", qx, qw, None, mn_d, mx_d,
                        mn_w, mx_w, kernel=(3, 3), pad=(1, 1), num_filter=4,
                        no_bias=True)
    out = f("_contrib_dequantize", acc, mn_o, mx_o)
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.999
    return [acc, out]


def case_requantize_and_pooling_flatten(M):
    f = _fn(M)
    rng = np.random.RandomState(3)
    x = (rng.rand(2, 2, 4, 4) - 0.5).astype(np.float32)
    qx, mn, mx_ = f("_contrib_quantize_v2", x)
    p, pmn, pmx = f("_contrib_quantized_pooling", qx, mn, mx_,
                    kernel=(2, 2), stride=(2, 2))
    assert p.shape == (2, 2, 2, 2) and p.dtype == qx.dtype
    fl, _, _ = f("_contrib_quantized_flatten", p, pmn, pmx)
    assert fl.shape == (2, 8)
    acc = rng.randint(-1000, 1000, (8,)).astype(np.int32)
    scale = np.float32(1000 / (2.0 ** 31 - 1))
    m = np.float32(scale * np.float32(2.0 ** 31 - 1)).reshape(1)
    q8, _, _ = f("_contrib_requantize", acc, -m, m)
    assert q8.dtype == np.int8
    return [p, fl, q8]


def _mlp(M, sizes=((16, 8), (4, 16)), act="relu"):
    net = M.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(M.gluon.nn.Dense(sizes[0][0], in_units=sizes[0][1]))
        if act:
            net.add(M.gluon.nn.Activation(act))
        net.add(M.gluon.nn.Dense(sizes[1][0], in_units=sizes[1][1]))
    return net


def case_quantize_net_gluon(M):
    rng = np.random.RandomState(4)
    net = _twin(M, _mlp)
    calib = [M.nd.array((rng.rand(8, 8) - 0.5).astype(np.float32))
             for _ in range(4)]
    x = M.nd.array((rng.rand(8, 8) - 0.5).astype(np.float32))
    ref = net(x).asnumpy()
    qnet = M.contrib.quantization.quantize_net(net, calib_data=calib,
                                               calib_mode="naive")
    assert len(qnet._quantized_layers) == 2
    out = qnet(x).asnumpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() / (np.abs(ref).max() or 1.0) < 0.05
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.99
    return [ref, out]


def case_quantize_net_validation(M):
    _reset()
    qn = M.contrib.quantization.quantize_net
    net = M.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    with pytest.raises(ValueError):
        qn(net, calib_mode="naive")
    with pytest.raises(NotImplementedError, match="ROADMAP item 5"):
        qn(net, calib_mode="entropy")
    with pytest.raises(ValueError, match="naive"):
        qn(net, calib_mode="bogus")
    return []


def case_calib_mode_error_paths_unified(M):
    _reset()
    Q = M.contrib.quantization
    net = M.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    fc = M.sym.FullyConnected(M.sym.Variable("data"), num_hidden=2,
                              name="fc")
    arg = {"fc_weight": np.ones((2, 3), np.float32),
           "fc_bias": np.zeros(2, np.float32)}
    for entry in (lambda m: Q.quantize_net(net, calib_mode=m),
                  lambda m: Q.quantize_model(fc, arg, calib_mode=m)):
        with pytest.raises(NotImplementedError) as ei:
            entry("entropy")
        for mode in Q.SUPPORTED_CALIB_MODES:
            assert mode in str(ei.value)
        assert "ROADMAP item 5" in str(ei.value)
        with pytest.raises(ValueError) as ei:
            entry("minmax2")
        for mode in Q.SUPPORTED_CALIB_MODES:
            assert mode in str(ei.value)
    return []


def case_quantize_net_calib_none_and_checkpoint(M, tmp_path):
    rng = np.random.RandomState(5)

    def build(MM):
        return _mlp(MM, ((8, 4), (2, 8)), act=None)

    net = _twin(M, build)
    x = M.nd.array((rng.rand(4, 4) - 0.5).astype(np.float32))
    ref = net(x).asnumpy()
    before = set(net._collect_params_with_prefix())
    qnet = M.contrib.quantization.quantize_net(net, calib_mode="none")
    assert len(qnet._quantized_layers) == 2
    out = qnet(x).asnumpy()
    assert np.corrcoef(out.ravel(), ref.ravel())[0, 1] > 0.99
    assert set(qnet._collect_params_with_prefix()) == before
    f = os.path.join(str(tmp_path), f"q-{M.__name__}.params")
    qnet.save_parameters(f)
    fresh = build(M)
    fresh.load_parameters(f)
    np.testing.assert_allclose(fresh(x).asnumpy(), ref, rtol=1e-6)
    return [ref, out]


def case_quantize_net_activation_flatten_and_root(M):
    rng = np.random.RandomState(6)
    qn = M.contrib.quantization.quantize_net
    nn = M.gluon.nn

    def one(MM):
        n = nn.HybridSequential() if MM is M else MM.gluon.nn \
            .HybridSequential()
        with n.name_scope():
            n.add(MM.gluon.nn.Dense(8, in_units=4, activation="relu"))
        return n

    net = _twin(M, one)
    x = M.nd.array((rng.rand(4, 4) - 0.5).astype(np.float32))
    ref = net(x).asnumpy()
    assert (ref >= 0).all()
    out = qn(net, calib_mode="none")(x).asnumpy()
    assert (out >= 0).all(), "activation dropped by quantization"

    def flat(MM):
        n = MM.gluon.nn.HybridSequential()
        with n.name_scope():
            n.add(MM.gluon.nn.Dense(8, in_units=4, flatten=False))
        return n

    net2 = _twin(M, flat)
    x3 = M.nd.array((rng.rand(2, 3, 4) - 0.5).astype(np.float32))
    ref2 = net2(x3).asnumpy()
    out2 = qn(net2, calib_mode="none")(x3).asnumpy()
    assert out2.shape == ref2.shape == (2, 3, 8)
    assert np.corrcoef(out2.ravel(), ref2.ravel())[0, 1] > 0.99

    root = _twin(M, lambda MM: MM.gluon.nn.Dense(2, in_units=3))
    xr = M.nd.array(rng.rand(2, 3).astype(np.float32))
    refr = root(xr).asnumpy()
    q = qn(root, calib_mode="none")
    assert q._quantized_layers
    outr = q(xr).asnumpy()
    assert np.corrcoef(outr.ravel(), refr.ravel())[0, 1] > 0.99
    return [out, out2, outr]


def _warns_no_dense(M):
    """The warning when nothing was quantized: the reference's hybridized
    net replays a compiled trace that its calibration hooks never see;
    the port's cached op runs the eager forward, so the hooks fire and
    both layers quantize. Both packages warn on an empty calibration."""
    import warnings as w

    rng = np.random.RandomState(7)
    net = _twin(M, lambda MM: _mlp(MM, ((4, 4), (4, 4)), act=None))
    net.hybridize()
    x = M.nd.array(rng.rand(4, 4).astype(np.float32))
    net(x)
    with w.catch_warnings(record=True) as rec:
        w.simplefilter("always")
        q = M.contrib.quantization.quantize_net(net, calib_data=[x],
                                                calib_mode="naive")
    hybrid_warned = any("no Dense layer was quantized" in str(r.message)
                        for r in rec)
    net2 = _twin(M, lambda MM: _mlp(MM, ((4, 4), (4, 4)), act=None))
    with w.catch_warnings(record=True) as rec:
        w.simplefilter("always")
        M.contrib.quantization.quantize_net(net2, calib_data=[],
                                            calib_mode="naive")
    assert any("no Dense layer was quantized" in str(r.message)
               for r in rec)
    return hybrid_warned, q._quantized_layers


def test_quantize_net_warns_when_nothing_quantized():
    warned, layers = _warns_no_dense(jmx)
    assert warned and layers == []
    warned, layers = _warns_no_dense(tmx)
    assert not warned and len(layers) == 2


def _fc_args(M, rng, spec):
    return {k: M.nd.array(rng.uniform(lo, hi, shp).astype(np.float32))
            for k, (lo, hi, shp) in spec.items()}


def _eval(sym, feed):
    out = sym.eval(**feed)
    return (out[0] if isinstance(out, (list, tuple)) else out).asnumpy()


def case_quantize_model_symbolic_fc(M):
    S = M.sym
    rng = np.random.RandomState(0)
    net = S.FullyConnected(S.Variable("data"), num_hidden=16, name="fc1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.FullyConnected(net, num_hidden=4, name="fc2")
    args = _fc_args(M, rng, {"fc1_weight": (-0.5, 0.5, (16, 8)),
                             "fc1_bias": (-0.1, 0.1, (16,)),
                             "fc2_weight": (-0.5, 0.5, (4, 16)),
                             "fc2_bias": (-0.1, 0.1, (4,))})
    x = rng.uniform(0, 1, (32, 8)).astype(np.float32)
    qsym, qargs, _ = M.contrib.quantization.quantize_model(
        net, args, {}, calib_mode="naive",
        calib_data=M.io.NDArrayIter(x, batch_size=8), data_names=("data",))
    assert qargs["fc1_weight_quantize"].dtype == np.int8
    assert "fc1_weight" not in qargs
    ops = [n._op for n in qsym._base()._topo() if n._op]
    for op in ("_contrib_quantize_v2", "_contrib_quantized_fully_connected",
               "_contrib_dequantize"):
        assert op in ops
    ref0 = _eval(net, dict(data=M.nd.array(x), **args))
    out0 = _eval(qsym, dict(data=M.nd.array(x), **qargs))
    assert np.abs(out0 - ref0).max() / np.abs(ref0).max() < 0.05
    return [qargs["fc1_weight_quantize"].asnumpy(), ref0, out0]


def case_quantize_model_symbolic_conv(M):
    S = M.sym
    rng = np.random.RandomState(1)
    net = S.Convolution(S.Variable("data"), kernel=(3, 3), num_filter=4,
                        pad=(1, 1), name="conv1")
    net = S.Activation(net, act_type="relu", name="reluc")
    args = _fc_args(M, rng, {"conv1_weight": (-0.3, 0.3, (4, 3, 3, 3)),
                             "conv1_bias": (-0.1, 0.1, (4,))})
    x = rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    qsym, qargs, _ = M.contrib.quantization.quantize_model(
        net, args, {}, calib_mode="none")
    ref0 = _eval(net, dict(data=M.nd.array(x), **args))
    out0 = _eval(qsym, dict(data=M.nd.array(x), **qargs))
    assert np.abs(out0 - ref0).max() / np.abs(ref0).max() < 0.05
    return [ref0, out0]


def case_quantize_model_excluded_and_graph(M):
    S, Q = M.sym, M.contrib.quantization
    net = S.FullyConnected(S.Variable("data"), num_hidden=4, name="fcx",
                           no_bias=True)
    args = {"fcx_weight": M.nd.array(np.eye(4, 6, dtype=np.float32))}
    qsym, _, _ = Q.quantize_model(net, args, {}, calib_mode="none",
                                  excluded_sym_names=["fcx"])
    assert [n._op for n in qsym._base()._topo() if n._op] == \
        ["FullyConnected"]
    _, gargs, _, collector = Q.quantize_graph(net, args, {})
    assert collector is None
    assert "fcx_weight_quantize" in gargs
    return [gargs["fcx_weight_quantize"].asnumpy()]


def case_quantize_model_tied_weights(M):
    S = M.sym
    rng = np.random.RandomState(2)
    w_shared = M.nd.array(rng.uniform(-0.5, 0.5, (8, 8)).astype(np.float32))
    wvar = S.Variable("shared_weight")
    h = S.FullyConnected(S.Variable("data"), wvar, num_hidden=8,
                         no_bias=True, name="fca")
    out = S.FullyConnected(h, wvar, num_hidden=8, no_bias=True, name="fcb")
    args = {"shared_weight": w_shared}
    x = rng.uniform(0, 1, (4, 8)).astype(np.float32)
    qsym, qargs, _ = M.contrib.quantization.quantize_model(
        out, args, {}, calib_mode="none")
    assert "shared_weight_quantize" in qargs
    assert "shared_weight" not in qargs
    ref0 = _eval(out, dict(data=M.nd.array(x), **args))
    got0 = _eval(qsym, dict(data=M.nd.array(x), **qargs))
    assert np.abs(got0).max() > 0
    assert np.abs(got0 - ref0).max() / np.abs(ref0).max() < 0.08
    return [ref0, got0]


def case_quantize_graph_honors_calib_mode(M):
    S = M.sym
    net = S.FullyConnected(S.Variable("data"), num_hidden=4, name="fcg",
                           no_bias=True)
    args = {"fcg_weight": M.nd.array(np.eye(4, 6, dtype=np.float32))}
    with pytest.raises(NotImplementedError):
        M.contrib.quantization.quantize_graph(net, args, {},
                                              calib_mode="entropy")
    with pytest.raises(ValueError):
        M.contrib.quantization.quantize_graph(net, args, {},
                                              calib_mode="naive")
    return []


def case_quantize_model_ragged_final_calib_batch(M):
    S = M.sym
    rng = np.random.RandomState(5)
    net = S.FullyConnected(S.Variable("data"), num_hidden=4, name="fcr")
    args = {"fcr_weight": M.nd.array(rng.uniform(-0.5, 0.5, (4, 6))
                                     .astype(np.float32)),
            "fcr_bias": M.nd.array(np.zeros(4, np.float32))}
    xs = [rng.uniform(0, 1, (n, 6)).astype(np.float32) for n in (8, 8, 3)]
    xs[2][0, 0] = 7.5  # the extreme value lives in the ragged batch only
    qsym, _, _ = M.contrib.quantization.quantize_model(
        net, args, {}, calib_mode="naive",
        calib_data=[M.nd.array(x) for x in xs], data_names=("data",))
    attrs = {n._name: n._attrs for n in qsym._base()._topo()
             if n._op == "_contrib_quantize_v2"}
    (a,) = attrs.values()
    assert float(a["max_calib_range"]) >= 7.5, a
    return [np.array([float(a["min_calib_range"]),
                      float(a["max_calib_range"])])]


def case_quantized_artifact_serves(M):
    """The int8 artifact as a deployment input: the reference serves it
    through its InferenceEngine (batch serving, queue item A13, is not
    ported), the port through an Executor bound for prediction; ragged 5
    rows pad to a batch of 8 and are sliced back, as the engine does."""
    S = M.sym
    rng = np.random.RandomState(6)
    net = S.FullyConnected(S.Variable("data"), num_hidden=8, name="fq1")
    net = S.Activation(net, act_type="relu", name="relu")
    net = S.FullyConnected(net, num_hidden=3, name="fq2")
    args = _fc_args(M, rng, {"fq1_weight": (-0.5, 0.5, (8, 6)),
                             "fq1_bias": (-0.1, 0.1, (8,)),
                             "fq2_weight": (-0.5, 0.5, (3, 8)),
                             "fq2_bias": (0.0, 0.0, (3,))})
    x = rng.uniform(0, 1, (32, 6)).astype(np.float32)
    qsym, qargs, qaux = M.contrib.quantization.quantize_model(
        net, args, {}, calib_mode="naive",
        calib_data=M.io.NDArrayIter(x, batch_size=8), data_names=("data",))
    ref0 = _eval(net, dict(data=M.nd.array(x[:5]), **args))
    if M is jmx:
        from mxnet_tpu.serve import InferenceEngine

        engine = InferenceEngine(qsym, qargs, qaux, max_batch_size=8,
                                 lint="off")
        out = engine.predict(x[:5])
        assert engine.num_programs == 1
    else:
        padded = np.concatenate([x[:5], np.zeros((3, 6), np.float32)])
        exe = qsym.bind(M.cpu(), args={**qargs, "data": M.nd.array(padded)},
                        aux_states=qaux, grad_req="null")
        out = exe.forward(is_train=False)[0].asnumpy()[:5]
    assert np.abs(out - ref0).max() / np.abs(ref0).max() < 0.05
    return [out]


_CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
          if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reference_quantization_case(case, tmp_path):
    import inspect

    fn = _CASES[case]
    kw = {"tmp_path": tmp_path} if "tmp_path" in \
        inspect.signature(fn).parameters else {}
    want = fn(jmx, **kw)
    got = fn(tmx, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * max(
                1.0, float(np.abs(w).max())))


# ---------------------------------------------------------------------------
# whole int8 graphs
# ---------------------------------------------------------------------------

def _cnn(S):
    """A small CNN built with the sym API, the same names in both."""
    data = S.Variable("data")
    c1 = S.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                       name="conv1")
    a1 = S.Activation(c1, act_type="relu", name="relu1")
    p1 = S.Pooling(a1, kernel=(2, 2), stride=(2, 2), pool_type="max",
                   name="pool1")
    c2 = S.Convolution(p1, kernel=(3, 3), num_filter=16, stride=(2, 2),
                       name="conv2", no_bias=True)
    a2 = S.Activation(c2, act_type="relu", name="relu2")
    f1 = S.FullyConnected(a2, num_hidden=10, name="fc1")
    return f1


def _cnn_args(rng):
    return {"conv1_weight": rng.randn(8, 3, 3, 3).astype(np.float32) * 0.3,
            "conv1_bias": rng.randn(8).astype(np.float32) * 0.1,
            "conv2_weight": rng.randn(16, 8, 3, 3).astype(np.float32) * 0.2,
            "fc1_weight": rng.randn(10, 16 * 2 * 2).astype(np.float32) * 0.1,
            "fc1_bias": rng.randn(10).astype(np.float32) * 0.1}


def _graph_err(got, want, f32):
    """max |port - reference| of the int8 outputs over max |f32|."""
    return float(np.abs(got - want).max() / np.abs(f32).max())


@pytest.mark.parametrize("calib_mode", ["none", "naive"])
def test_quantize_model_sym_cnn_matches_reference(calib_mode):
    rng = np.random.RandomState(8)
    args = _cnn_args(rng)
    x = rng.rand(8, 3, 12, 12).astype(np.float32)
    out = {}
    for M in (jmx, tmx):
        a = {k: M.nd.array(v) for k, v in args.items()}
        kw = {}
        if calib_mode == "naive":
            kw = dict(calib_data=M.io.NDArrayIter(x, batch_size=4),
                      num_calib_examples=8)
        with M.name.NameManager():  # auto-names independent of other tests
            net = _cnn(M.sym)
            qsym, qargs, _ = M.contrib.quantization.quantize_model(
                net, a, {}, calib_mode=calib_mode, **kw)
        topo = [(n._op, n._name) for n in qsym._base()._topo()]
        attrs = [{k: str(v) for k, v in n._attrs.items()}
                 for n in qsym._base()._topo()]
        f32 = _eval(net, dict(data=M.nd.array(x), **a))
        int8 = _eval(qsym, dict(data=M.nd.array(x), **qargs))
        out[M] = (topo, attrs, qsym.list_arguments(),
                  {k: v.asnumpy() for k, v in qargs.items()}, f32, int8)
    (jt, ja, jargs, jq, jf, ji), (tt, ta, targs, tq_, tf, ti) = out[jmx], \
        out[tmx]
    assert tt == jt and targs == jargs and ta == ja
    assert set(tq_) == set(jq)
    for k in jq:
        _same(tq_[k], jq[k])
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
    assert _graph_err(ti, ji, jf) <= INT8_GRAPH_TOL
    assert np.abs(ji - jf).max() / np.abs(jf).max() < 0.05


@pytest.mark.parametrize("calib_mode", ["none", "naive"])
def test_quantize_model_traced_resnet18_matches_reference(calib_mode,
                                                          tmp_path):
    from mxnet_tpu.gluon.model_zoo import get_model as jget_model
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    rng = np.random.RandomState(9)
    x = rng.rand(4, 3, 32, 32).astype(np.float32)
    path = str(tmp_path / "r18.params")
    _reset()
    jmx.random.seed(0)
    jnet = jget_model("resnet18_v1", classes=10)
    jnet.initialize()
    jnet(jmx.nd.array(x))
    jnet.save_parameters(path)
    tnet = get_model("resnet18_v1", classes=10)
    tnet.load_parameters(path, ctx=tmx.cpu())
    res = {}
    for M, net in ((jmx, jnet), (tmx, tnet)):
        with M.name.NameManager():
            sym = net(M.sym.var("data"))
        params = {p.name: p.data() for p in net.collect_params().values()}
        aux_names = set(sym.list_auxiliary_states())
        args = {k: v for k, v in params.items() if k not in aux_names}
        aux = {k: v for k, v in params.items() if k in aux_names}
        kw = {}
        if calib_mode == "naive":
            kw = dict(calib_data=M.io.NDArrayIter(x, batch_size=2),
                      num_calib_examples=4)
        qsym, qargs, qaux = M.contrib.quantization.quantize_model(
            sym, args, aux, calib_mode=calib_mode, **kw)
        n_q = sum(n._op in ("_contrib_quantized_conv",
                            "_contrib_quantized_fully_connected")
                  for n in qsym._base()._topo())
        f32 = _eval(sym, dict(data=M.nd.array(x), **args, **aux))
        int8 = _eval(qsym, dict(data=M.nd.array(x), **qargs, **qaux))
        res[M] = (n_q, f32, int8)
    (jn, jf, ji), (tn, tf, ti) = res[jmx], res[tmx]
    assert tn == jn == 21  # 20 convolutions and the fc
    np.testing.assert_allclose(tf, jf, rtol=1e-4, atol=1e-4 * np.abs(
        jf).max())
    assert _graph_err(ti, ji, jf) <= INT8_GRAPH_TOL
    assert np.isfinite(ti).all()


def test_int8_matmul_route_pads_and_counts(monkeypatch):
    """The card route's padding and counting, driven with a CPU stand-in
    for ``torch._int_mm`` (which checks the shapes it is given)."""
    calls = []

    def fake_int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 \
            and b.shape[1] % 8 == 0
        calls.append((tuple(a.shape), tuple(b.shape)))
        return (a.long() @ b.long()).to(torch.int32)

    class _Cuda(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(torch, "_int_mm", fake_int_mm)
    rng = np.random.RandomState(10)
    for m, k, n in ((3, 147, 10), (17, 576, 64), (40, 4608, 7)):
        a = torch.from_numpy(_int8(rng, m, k))
        b = torch.from_numpy(_int8(rng, k, n))
        before = tq.int8_matmul.launches
        got = tq.int8_matmul(a.as_subclass(_Cuda), b.as_subclass(_Cuda))
        assert tq.int8_matmul.launches == before + 1
        np.testing.assert_array_equal(
            np.asarray(got), tq.int8_matmul_plain(a, b).numpy())
    assert calls[0] == ((24, 152), (152, 16))
