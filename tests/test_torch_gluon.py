"""The port's Gluon core (mxnet_tpu_torch.gluon: Parameter, Block,
HybridBlock/CachedOp, nn, the losses, Trainer, utils; initializer; amp)
against the JAX package, on the CPU.

The cases of tests/test_gluon.py whose modules this slice ports, each run
through both packages: the same numpy inputs, and the same parameters,
carried by name (``collect_params()`` names are equal when both packages
build the same blocks from the same counter state). f32 results are held
at the reference's own tolerances (rtol 1e-4 / 1e-5 and tighter where the
ops are the same); random draws (Dropout, the initializers) by
distribution, since torch's generators do not give JAX's bits.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    """Port arrays on the CPU; both packages' block-name counters start
    from the same (empty) state."""
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with tmx.cpu():
        yield


def _carry(ref, port):
    """Copy ``ref``'s parameters into ``port`` by name; the names must be
    the same list."""
    rp, pp = ref.collect_params(), port.collect_params()
    assert list(rp.keys()) == list(pp.keys())
    for name, p in rp.items():
        pp[name].set_data(p.data().asnumpy())


def _pair(build, shape=None):
    """(ref, port) built by ``build(nn)``, initialized, the port holding
    the reference's values; ``shape`` resolves deferred shapes first."""
    ref, port = build(jnn), build(tnn)
    ref.initialize()
    port.initialize()
    if shape is not None:
        ref(jnd.zeros(shape))
        port(tnd.zeros(shape))
    _carry(ref, port)
    return ref, port


def _np(x):
    return x.asnumpy()


# ---------------------------------------------------------------------------
# layers, deferred init, hybridize (test_gluon.py :13 :24 :58 :73 :224)
# ---------------------------------------------------------------------------

def test_dense_forward_and_shapes():
    ref, port = _pair(lambda nn: nn.Dense(4, in_units=3))
    x = np.random.RandomState(0).rand(2, 3).astype(np.float32)
    out = port(tnd.array(x))
    assert out.shape == (2, 4)
    np.testing.assert_allclose(_np(out), _np(ref(jnd.array(x))), rtol=1e-5,
                               atol=1e-6)
    w, b = _np(port.weight.data()), _np(port.bias.data())
    np.testing.assert_allclose(_np(out), x @ w.T + b, rtol=1e-4, atol=1e-5)


def test_dense_deferred_init():
    for nn, nd in ((jnn, jnd), (tnn, tnd)):
        layer = nn.Dense(4)
        layer.initialize()
        assert layer.weight.shape == (4, 0)
        out = layer(nd.ones((2, 7)))
        assert layer.weight.shape == (4, 7) and out.shape == (2, 4)
    layer = tnn.Dense(4)
    layer.initialize()
    with pytest.raises(tmx.gluon.parameter.DeferredInitializationError):
        layer.weight.data()


def test_sequential_mlp_training_converges():
    """A Gluon MLP fits a toy classification problem with Trainer and
    autograd in both packages from the same start: losses agree step by
    step, and the port reaches the reference's accuracy."""
    rng = np.random.RandomState(0)
    n, d = 256, 10
    X = rng.randn(n, d).astype(np.float32)
    y = (X @ rng.randn(d, 3).astype(np.float32)).argmax(1).astype(np.float32)

    def build(nn):
        net = nn.HybridSequential()
        net.add(nn.Dense(32, activation="relu"), nn.Dense(3))
        return net

    ref, port = _pair(build, shape=(1, d))
    runs = []
    for pkg, nd, ag, net in ((jmx, jnd, jag, ref), (tmx, tnd, tag, port)):
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.5})
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        xb, yb = nd.array(X), nd.array(y)
        losses = []
        for _ in range(60):
            with ag.record():
                loss = loss_fn(net(xb), yb)
            loss.backward()
            tr.step(n)
            losses.append(float(loss.mean().asscalar()))
        acc = (net(xb).asnumpy().argmax(1) == y).mean()
        runs.append((losses, acc))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    assert runs[1][1] > 0.9 and abs(runs[1][1] - runs[0][1]) <= 1 / n


def _mlp(nn, act="tanh", hidden=16, out=5):
    net = nn.HybridSequential()
    net.add(nn.Dense(hidden, activation=act), nn.Dense(out))
    return net


def test_hybridize_parity_and_caching():
    ref, port = _pair(_mlp, shape=(1, 8))
    x = np.random.RandomState(1).rand(4, 8).astype(np.float32)
    eager = _np(port(tnd.array(x)))
    np.testing.assert_allclose(eager, _np(ref(jnd.array(x))), rtol=1e-5,
                               atol=1e-6)
    port.hybridize()
    assert port._cached_op is None
    hybrid = _np(port(tnd.array(x)))
    np.testing.assert_array_equal(hybrid, eager)
    np.testing.assert_array_equal(_np(port(tnd.array(x))), hybrid)
    assert len(port._cached_op._cache) == 1  # one entry per signature
    assert port[0]._active and port[0]._cached_op is None  # ran inline
    port(tnd.array(x[:2]))
    assert len(port._cached_op._cache) == 2
    port(tnd.array(x[:2]))
    assert len(port._cached_op._cache) == 2
    with tag.record():  # train mode is part of the key
        port(tnd.array(x))
    assert len(port._cached_op._cache) == 3
    port.hybridize()  # drops the cache
    assert port._cached_op is None


def test_hybridize_first_call_with_deferred_shapes_runs_eagerly():
    net = _mlp(tnn)
    net.initialize()
    net.hybridize()
    x = tnd.array(np.random.RandomState(2).rand(3, 6).astype(np.float32))
    first = _np(net(x))
    assert net._cached_op is None
    np.testing.assert_array_equal(_np(net(x)), first)
    assert len(net._cached_op._cache) == 1


def test_hybridize_grad_parity():
    x = np.random.RandomState(2).rand(4, 6).astype(np.float32)
    ref, port = _pair(lambda nn: _mlp(nn, "relu", 8, 2), shape=(1, 6))
    with jag.record():
        loss = (ref(jnd.array(x)) ** 2).sum()
    loss.backward()
    want = {p.name: _np(p.grad()) for p in ref.collect_params().values()}
    grads = []
    for hybrid in (False, True):
        if hybrid:
            port.hybridize()
        with tag.record():
            loss = (port(tnd.array(x)) ** 2).sum()
        loss.backward()
        grads.append({p.name: _np(p.grad())
                      for p in port.collect_params().values()})
    for k in want:
        np.testing.assert_array_equal(grads[1][k], grads[0][k], err_msg=k)
        np.testing.assert_allclose(grads[0][k], want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_cached_op_writes_back_aux_updates():
    """A parameter the forward rebinds (aux state, as BatchNorm's running
    statistics) is written back after a hybridized call."""
    class Counter(tmx.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.seen = self.params.get("seen", shape=(1,), init="zeros",
                                        grad_req="null")

        def hybrid_forward(self, F, x, seen):
            with tag.pause():
                self.seen.data()._set_data((seen + 1)._data)
            return x * 2

    net = Counter()
    net.initialize()
    net.hybridize()
    for _ in range(3):
        net(tnd.ones((2,)))
    assert float(_np(net.seen.data())[0]) == 3.0


def test_embedding_layer():
    ref, port = _pair(lambda nn: nn.Embedding(10, 4))
    idx = np.array([1.0, 3.0, 3.0], np.float32)
    outs, grads = [], []
    for nd, ag, emb in ((jnd, jag, ref), (tnd, tag, port)):
        assert emb(nd.array(idx)).shape == (3, 4)
        with ag.record():
            loss = (emb(nd.array(idx)) * 2).sum()
        loss.backward()
        outs.append(_np(emb(nd.array(idx))))
        grads.append(_np(emb.weight.grad()))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(grads[1], grads[0])
    assert grads[1][3].sum() == 16 and grads[1][0].sum() == 0


@pytest.mark.parametrize("name,kw", [
    ("Activation", {"activation": "relu"}), ("LeakyReLU", {"alpha": 0.1}),
    ("ELU", {}), ("SELU", {}), ("GELU", {}), ("Swish", {"beta": 1.5}),
    ("SiLU", {}), ("PReLU", {}), ("Flatten", {}),
    ("LayerNorm", {"in_channels": 6})])
def test_layer_matches_reference(name, kw):
    ref, port = _pair(lambda nn: getattr(nn, name)(**kw), shape=(2, 3, 6))
    x = np.random.RandomState(3).randn(2, 3, 6).astype(np.float32)
    want = _np(ref(jnd.array(x)))
    np.testing.assert_allclose(_np(port(tnd.array(x))), want, rtol=1e-5,
                               atol=1e-6)


def test_lambda_and_sequential():
    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    seq = tnn.Sequential()
    seq.add(tnn.Lambda("relu"), tnn.HybridLambda(lambda F, v: v * 3))
    assert len(seq) == 2 and isinstance(seq[1], tnn.HybridLambda)
    np.testing.assert_allclose(_np(seq(tnd.array(x))),
                               np.maximum(x, 0) * 3, rtol=1e-6)


def test_dropout_train_vs_eval():
    """By distribution: the reference's and the port's masks differ bit
    for bit, their rates agree."""
    zero_share = []
    for nn, nd, ag in ((jnn, jnd, jag), (tnn, tnd, tag)):
        do = nn.Dropout(0.5)
        do.initialize()
        x = nd.ones((100, 100))
        with ag.record():
            out_train = do(x).asnumpy()
        out_eval = do(x).asnumpy()
        assert (out_eval == 1).all()
        assert set(np.unique(out_train)) <= {0.0, 2.0}
        zero_share.append((out_train == 0).mean())
    assert abs(zero_share[1] - 0.5) < 0.03
    assert abs(zero_share[1] - zero_share[0]) < 0.05


# ---------------------------------------------------------------------------
# Parameter and the initializers
# ---------------------------------------------------------------------------

def test_parameter_grad_req_add_and_zero_grad():
    p = tmx.gluon.Parameter("w", shape=(3,), grad_req="add")
    p.initialize(init="ones")
    for _ in range(2):
        with tag.record():
            loss = (p.data() * 2).sum()
        loss.backward()
    np.testing.assert_array_equal(_np(p.grad()), [4, 4, 4])
    p.zero_grad()
    np.testing.assert_array_equal(_np(p.grad()), [0, 0, 0])
    p.grad_req = "write"
    for _ in range(2):
        with tag.record():
            loss = (p.data() * 2).sum()
        loss.backward()
    np.testing.assert_array_equal(_np(p.grad()), [2, 2, 2])


def test_parameter_set_data_cast_and_constant():
    p = tmx.gluon.Parameter("w", shape=(2, 2))
    p.initialize()
    p.set_data(np.arange(4, dtype=np.float32).reshape(2, 2))
    np.testing.assert_array_equal(_np(p.data()), [[0, 1], [2, 3]])
    p.cast("bfloat16")
    assert p.data()._data.dtype == torch.bfloat16 and p.grad() is not None
    c = tmx.gluon.Constant("c", [1.0, 2.0])
    c.initialize()
    assert c.grad_req == "null"
    np.testing.assert_array_equal(_np(c.data()), [1, 2])
    with pytest.raises(ValueError, match="deferred init not allowed"):
        tmx.gluon.Parameter("v", shape=(0, 3)).initialize()


@pytest.mark.parametrize("name,kw,mean,std", [
    ("uniform", {"scale": 0.5}, 0.0, 0.5 / np.sqrt(3)),
    ("normal", {"sigma": 0.2}, 0.0, 0.2),
    ("xavier", {}, 0.0, np.sqrt(3 / 150) / np.sqrt(3)),
    ("msraprelu", {}, 0.0, np.sqrt(2 / 1.0625 / 150))])
def test_random_initializers_by_distribution(name, kw, mean, std):
    """The port's draws and the reference's have the same moments."""
    tmx.random.seed(5)
    jmx.random.seed(5)
    got = tmx.init.create(name, **kw).init_array("w", (100, 200), "float32")
    want = jmx.init.create(name, **kw).init_array("w", (100, 200),
                                                  "float32")
    for a in (_np(got), _np(want)):
        assert abs(a.mean() - mean) < 0.05 * std + 1e-4
        assert abs(a.std() - std) < 0.05 * std
    assert got.context == tmx.cpu()


@pytest.mark.parametrize("init", [
    "zeros", "ones", ("constant", {"value": 0.3}), "bilinear",
    ("lstmbias", {"forget_bias": 2.0})])
def test_deterministic_initializers_match_reference(init):
    name, kw = init if isinstance(init, tuple) else (init, {})
    shape = (2, 1, 4, 4) if name == "bilinear" else (8, 3)
    got = tmx.init.create(name, **kw).init_array("w", shape, "float32")
    want = jmx.init.create(name, **kw).init_array("w", shape, "float32")
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


def test_initializer_name_dispatch_mixed_load_orthogonal():
    init = tmx.init.Uniform(0.1)
    for name, val in (("fc_bias", 0.0), ("ln_gamma", 1.0), ("bn_beta", 0.0),
                      ("bn_running_var", 1.0)):
        a = tnd.zeros((3,))
        init(tmx.init.InitDesc(name), a)
        np.testing.assert_array_equal(_np(a), [val] * 3)
    mixed = tmx.init.Mixed([".*bias", ".*"], [tmx.init.One(),
                                              tmx.init.Constant(7.0)])
    a = tnd.zeros((2,))
    mixed("x_weight", a)
    np.testing.assert_array_equal(_np(a), [7, 7])
    load = tmx.init.Load({"arg:w": np.full((2,), 3.0, np.float32)},
                         default_init=tmx.init.Zero())
    a, b = tnd.zeros((2,)), tnd.ones((4,))
    load("w", a)
    load("other", b)
    np.testing.assert_array_equal(_np(a), [3, 3])
    np.testing.assert_array_equal(_np(b), [0] * 4)
    q = _np(tmx.init.Orthogonal(scale=1.0).init_array("w", (4, 6),
                                                      "float32"))
    np.testing.assert_allclose(q @ q.T, np.eye(4), atol=1e-5)
    with pytest.raises(ValueError, match="unknown initializer"):
        tmx.init.create("nope")


# ---------------------------------------------------------------------------
# Trainer (test_gluon.py :192 :210)
# ---------------------------------------------------------------------------

TRAINER_OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
                ("adam", {"learning_rate": 0.01}),
                ("adamw", {"learning_rate": 0.01, "wd": 0.01}),
                ("lamb", {"learning_rate": 0.01}),
                ("rmsprop", {"learning_rate": 0.01})]


def _train(pkg, nd, ag, net, opt, kw, steps=3, trainer=None):
    tr = trainer or pkg.gluon.Trainer(net.collect_params(), opt, kw)
    x = nd.array(np.arange(32, dtype=np.float32).reshape(8, 4) / 32)
    for _ in range(steps):
        with ag.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(8)
    return tr


@pytest.mark.parametrize("opt,kw", TRAINER_OPTS,
                         ids=[o for o, _ in TRAINER_OPTS])
def test_trainer_optimizers(opt, kw):
    ref, port = _pair(lambda nn: nn.Dense(1, in_units=4))
    _train(jmx, jnd, jag, ref, opt, kw)
    _train(tmx, tnd, tag, port, opt, kw)
    for name, p in ref.collect_params().items():
        got = _np(port.collect_params()[name].data())
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, _np(p.data()), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _adam_oracle(w0, b0, steps, lr, beta1=0.9, beta2=0.999, eps=1e-8):
    """f64 numpy Adam on ``_train``'s Dense(2, in_units=4) loop: for each
    step t, (weights after it, {name: (m_t, v_t)}, the coefficient
    lr * sqrt(1 - beta2^t) / (1 - beta1^t) in f64 and as the reference
    computes it in f32 from f32 betas)."""
    x = np.arange(32, dtype=np.float64).reshape(8, 4) / 32
    p = {"weight": w0.astype(np.float64), "bias": b0.astype(np.float64)}
    st = {k: (np.zeros_like(v), np.zeros_like(v)) for k, v in p.items()}
    out = []
    for t in range(1, steps + 1):
        y = x @ p["weight"].T + p["bias"]
        g = {"weight": 2 * y.T @ x / 8, "bias": 2 * y.sum(0) / 8}
        coef = lr * np.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)
        f32 = np.float32
        coef32 = f32(lr) * np.sqrt(f32(1) - f32(beta2) ** f32(t)) / (
            f32(1) - f32(beta1) ** f32(t))
        for k in p:
            m = beta1 * st[k][0] + (1 - beta1) * g[k]
            v = beta2 * st[k][1] + (1 - beta2) * g[k] ** 2
            st[k] = (m, v)
            p[k] = p[k] - coef * m / (np.sqrt(v) + eps)
        out.append(({k: v.copy() for k, v in p.items()}, dict(st), coef,
                    float(coef32)))
    return out


def test_trainer_save_load_states_across_packages(tmp_path):
    """A .states file written by either package loads in the other, and
    both then take the same next step.

    The port computes Adam's coefficient lr sqrt(1 - b2^t) / (1 - b1^t) in
    f64; the reference in f32 from f32 betas (1 - 0.999 loses precision in
    f32: 6.4e-6 relatively low at t = 1). So the port is held to an f64
    numpy Adam at rtol 1e-5 / atol 1e-7, and to the reference at the bound
    that coefficient implies: per element, 2 * sum_t |dcoef_t| *
    |m_t / (sqrt(v_t) + eps)| (the oracle's moments; the factor 2 covers
    the moments' own drift) on top of atol 1e-7, rtol 1e-5."""
    ref, port = _pair(lambda nn: nn.Dense(2, in_units=4))
    names = list(ref.collect_params().keys())
    start = [_np(p.data()) for p in ref.collect_params().values()]
    lr = 0.01
    kw = {"learning_rate": lr}
    oracle = _adam_oracle(start[0], start[1], 3, lr)
    bound = {k: sum(2 * abs(c - c32) * np.abs(st[k][0])
                    / (np.sqrt(st[k][1]) + 1e-8)
                    for _w, st, c, c32 in oracle) for k in ("weight",
                                                             "bias")}

    def hold(pkg_params, step, to_oracle):
        for name, short in zip(names, ("weight", "bias")):
            got = _np(pkg_params[name].data())
            if to_oracle:
                np.testing.assert_allclose(
                    got, oracle[step][0][short], rtol=1e-5, atol=1e-7,
                    err_msg=name)
            else:
                want = _np(ref.collect_params()[name].data())
                assert np.all(np.abs(got - want) <= 1e-7 + bound[short]
                              + 1e-5 * np.abs(want)), (name, got, want)

    jtr = _train(jmx, jnd, jag, ref, "adam", kw, steps=2)
    ttr = _train(tmx, tnd, tag, port, "adam", kw, steps=2)
    hold(port.collect_params(), 1, to_oracle=True)
    hold(port.collect_params(), 1, to_oracle=False)
    jfile, tfile = str(tmp_path / "ref.states"), str(tmp_path / "port.states")
    jtr.save_states(jfile)
    ttr.save_states(tfile)
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".")]
    mine, theirs = (pickle.loads(open(f, "rb").read())
                    for f in (tfile, jfile))
    assert set(mine) == set(theirs)
    for k in theirs:
        for a, b, want in zip(mine[k], theirs[k],
                              oracle[1][1][("weight", "bias")[k]]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(a, want, rtol=1e-5, atol=1e-7)
    # swap: each package resumes from the other's file
    ttr.load_states(jfile)
    jtr.load_states(tfile)
    for opt in (ttr.optimizer, jtr.optimizer):
        opt._index_update_count = {0: 2, 1: 2}
        opt.num_update = 2
    _train(jmx, jnd, jag, ref, "adam", kw, steps=1, trainer=jtr)
    _train(tmx, tnd, tag, port, "adam", kw, steps=1, trainer=ttr)
    hold(port.collect_params(), 2, to_oracle=True)
    hold(port.collect_params(), 2, to_oracle=False)


def test_trainer_settings_and_rejections():
    net = tnn.Dense(1, in_units=2)
    net.initialize()
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.3})
    assert tr.learning_rate == 0.3
    tr.set_learning_rate(0.1)
    assert tr.learning_rate == 0.1
    # every store name is accepted (the distributed stores are ported);
    # the update on the store cannot take the global-norm clip
    clipped = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                kvstore="dist_sync", update_on_kvstore=True,
                                clip_global_norm=1.0)
    with pytest.raises(ValueError, match="update_on_kvstore"):
        clipped.allreduce_grads()
    mon = tr.attach_health_monitor()  # the health plane is ported
    assert mon.param_names == [p.name for p in tr._params]
    assert tr.attach_health_monitor(None) is None
    state = tr.get_checkpoint_state()
    assert set(state) == {"arrays", "optimizer"}
    assert state["optimizer"]["num_update"] == 0
    with pytest.raises(RuntimeError, match="has no grad"):
        frozen = tnn.Dense(1, in_units=2)
        frozen.initialize()
        frozen.weight.data()._grad = None
        tmx.gluon.Trainer(frozen.collect_params(), "sgd").step(1)


def test_trainer_clip_global_norm():
    """The Trainer's clip_global_norm rescales the step's gradients to
    the given global norm before the update."""
    w0 = np.zeros((2,), np.float32)
    p = tmx.gluon.Parameter("w", shape=(2,))
    p.initialize()
    p.set_data(w0)
    tr = tmx.gluon.Trainer([p], "sgd", {"learning_rate": 1.0},
                           clip_global_norm=1.0)
    with tag.record():
        loss = (p.data() * tnd.array([3.0, 4.0])).sum()
    loss.backward()
    tr.step(1)
    np.testing.assert_allclose(_np(p.data()), [-0.6, -0.8], rtol=1e-5)


def test_block_symbolic_side_raises():
    """What of the symbolic side still waits raises naming its queue item
    (the linters A15; the reference's StableHLO artifact by design), an
    ONNX export without example inputs raises before it writes a file;
    ``optimize_for`` hybridizes, as the reference's does; a block called
    on a Symbol traces."""
    net = tnn.Dense(2, in_units=2)
    net.initialize()
    for call, item in ((lambda: net.lint(), "A15"),
                       (lambda: tblock.load_stablehlo("x"), "json")):
        with pytest.raises(MXNetError, match=item):
            call()
    with pytest.raises(ValueError, match="example_inputs"):
        net.export("x", format="onnx")
    net.optimize_for()
    assert net._active
    net.hybridize(False)
    out = net(tmx.symbol.var("data"))
    assert out.list_arguments() == ["data", "dense0_weight", "dense0_bias"]


# ---------------------------------------------------------------------------
# losses (test_gluon.py :237 :332)
# ---------------------------------------------------------------------------

def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LOSSES = {
    "L2Loss": ({}, lambda: [_rand(0, 4, 5), _rand(1, 4, 5)]),
    "L1Loss": ({}, lambda: [_rand(0, 4, 5), _rand(1, 4, 5)]),
    "SoftmaxCrossEntropyLoss": (
        {}, lambda: [_rand(0, 4, 5), np.array([0, 1, 2, 3], np.float32)]),
    "SigmoidBinaryCrossEntropyLoss": (
        {}, lambda: [_rand(0, 4, 5),
                     (_rand(1, 4, 5) > 0).astype(np.float32)]),
    "SigmoidBCELoss_from_sigmoid": (
        {"from_sigmoid": True},
        lambda: [1 / (1 + np.exp(-_rand(0, 4, 5))),
                 (_rand(1, 4, 5) > 0).astype(np.float32)]),
    "KLDivLoss": ({"from_logits": False},
                  lambda: [_rand(0, 4, 5),
                           np.full((4, 5), 0.2, np.float32)]),
    "HuberLoss": ({"rho": 0.5}, lambda: [_rand(0, 4, 5), _rand(1, 4, 5)]),
    "HingeLoss": ({}, lambda: [_rand(0, 4, 5), np.sign(_rand(1, 4, 5))]),
    "SquaredHingeLoss": ({}, lambda: [_rand(0, 4, 5),
                                      np.sign(_rand(1, 4, 5))]),
    "LogisticLoss": ({"label_format": "binary"},
                     lambda: [_rand(0, 4, 5),
                              (_rand(1, 4, 5) > 0).astype(np.float32)]),
    "TripletLoss": ({}, lambda: [_rand(0, 4, 5), _rand(1, 4, 5),
                                 _rand(2, 4, 5)]),
    "CosineEmbeddingLoss": ({}, lambda: [_rand(0, 4, 5), _rand(1, 4, 5),
                                         np.array([1, -1, 1, -1],
                                                  np.float32)]),
    "PoissonNLLLoss": ({}, lambda: [_rand(0, 4, 3),
                                    np.abs(np.round(3 * _rand(1, 4, 3)))]),
    "PoissonNLLLoss_full": ({"from_logits": False, "compute_full": True},
                            lambda: [np.abs(_rand(0, 4, 3)) + 0.1,
                                     np.abs(np.round(3 * _rand(1, 4, 3)))]),
    "SDMLLoss": ({}, lambda: [_rand(0, 6, 8), _rand(1, 6, 8)]),
    "CTCLoss": ({}, lambda: [_rand(0, 2, 7, 5),
                             np.array([[1, 2, 2, -1], [3, 1, -1, -1]],
                                      np.float32)]),
}


def _ctc_grad_oracle(pred, label):
    """d(sum of per-sequence CTC losses)/d(pred) by
    ``torch.nn.functional.ctc_loss``: pred (N, T, C), label (N, L) padded
    with values <= 0, blank 0."""
    import torch

    x = torch.tensor(pred, dtype=torch.float64, requires_grad=True)
    lab = torch.tensor(label).to(torch.int64)
    lens = (lab > 0).sum(dim=1)
    logp = torch.log_softmax(x.transpose(0, 1), dim=-1)
    torch.nn.functional.ctc_loss(
        logp, lab[lab > 0], torch.full((x.shape[0],), x.shape[1]), lens,
        blank=0, reduction="sum").backward()
    return x.grad.numpy().astype(np.float32)


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_reference(case):
    """Each loss's value and its gradient with respect to the prediction
    (rtol 1e-5; CTC's dynamic program 1e-4, its gradient against torch's
    CTC)."""
    kw, make = LOSSES[case]
    name = case.split("_")[0]
    if name == "SigmoidBCELoss":
        name = "SigmoidBinaryCrossEntropyLoss"
    inputs = make()
    outs = []
    for mod, nd, ag in ((jloss, jnd, jag), (tloss, tnd, tag)):
        fn = getattr(mod, name)(**kw)
        arrays = [nd.array(a) for a in inputs]
        arrays[0].attach_grad()
        with ag.record():
            out = fn(*arrays)
        out.backward()
        outs.append((out.asnumpy(), arrays[0].grad.asnumpy()))
    tol = 1e-4 if name == "CTCLoss" else 1e-5
    (want, want_g), (got, got_g) = outs
    if name == "CTCLoss":
        # the reference's gradient is NaN (its log of a dead pair's zero
        # sum): the port's is held to torch's own CTC instead
        want_g = _ctc_grad_oracle(*inputs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got_g, want_g, rtol=tol, atol=tol)


def test_loss_weighting_and_batch_axis():
    pred, label = _rand(0, 3, 4, 2), _rand(1, 3, 4, 2)
    sw = np.abs(_rand(2, 3, 1, 1))
    for kw in ({"weight": 0.5}, {"batch_axis": 1}):
        want = jloss.L2Loss(**kw)(jnd.array(pred), jnd.array(label),
                                  jnd.array(sw)).asnumpy()
        got = tloss.L2Loss(**kw)(tnd.array(pred), tnd.array(label),
                                 tnd.array(sw)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_poisson_nll_and_sdml_losses():
    """test_gluon.py's own properties of the two, on the port."""
    rng = np.random.RandomState(0)
    pred = tnd.array(rng.randn(4, 3).astype(np.float32))
    lbl = tnd.array(rng.randint(0, 5, (4, 3)).astype(np.float32))
    got = float(tloss.PoissonNLLLoss(from_logits=True)(pred, lbl)
                .asscalar())
    expect = np.mean(np.exp(_np(pred)) - _np(lbl) * _np(pred))
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    emb = tnd.array(rng.rand(6, 8).astype(np.float32))
    same = float(tloss.SDMLLoss()(emb, emb).asscalar())
    diff = float(tloss.SDMLLoss()(emb, tnd.array(_np(emb)[::-1].copy()))
                 .asscalar())
    assert same < diff


def test_loss_takes_plain_tensors_on_the_tape():
    """ShardedTrainer's use: torch tensors in, a torch tensor out, on
    torch's tape while grad mode is on."""
    pred = torch.from_numpy(_rand(0, 2, 3, 5)).requires_grad_()
    label = torch.tensor([[0, 1, 4], [2, 2, 9]])
    out = tloss.SoftmaxCrossEntropyLoss()(pred, label)
    assert isinstance(out, torch.Tensor) and out.shape == (2,)
    out.sum().backward()
    assert pred.grad is not None and pred.grad.abs().sum() > 0
    with torch.no_grad():
        assert not tloss.SoftmaxCrossEntropyLoss()(pred, label).requires_grad


# ---------------------------------------------------------------------------
# utils and amp
# ---------------------------------------------------------------------------

def test_slice_modules_load_neither_jax_nor_reference():
    import subprocess
    import sys

    code = ("import sys, mxnet_tpu_torch as mx\n"
            "mx.gluon.Trainer, mx.gluon.nn.Dense, mx.init.Xavier\n"
            "mx.optimizer.FusedUpdateEngine, mx.amp.LossScaler\n"
            "mx.models.transformer_lm, mx.gluon.utils.split_data\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] == 'mxnet_tpu')\n"
            "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_utils_split_clip_sha1(tmp_path):
    from mxnet_tpu_torch.gluon import utils as tu

    x = tnd.array(np.arange(12, dtype=np.float32).reshape(6, 2))
    parts = tu.split_data(x, 3)
    assert [p.shape for p in parts] == [(2, 2)] * 3
    with pytest.raises(ValueError, match="not divisible"):
        tu.split_data(x, 4)
    assert tu.split_and_load(x, [tmx.cpu()])[0].shape == (6, 2)
    arrays = [tnd.array([3.0, 0.0]), tnd.array([0.0, 4.0])]
    assert tu.clip_global_norm(arrays, 1.0) == pytest.approx(5.0)
    np.testing.assert_allclose(_np(arrays[0]), [0.6, 0.0], rtol=1e-6)
    f = tmp_path / "blob"
    f.write_bytes(b"abc")
    assert tu.check_sha1(str(f), "a9993e364706816aba3e25717850c26c9cd0d89d")
    with pytest.raises(MXNetError, match="network"):
        tu.download("file:///nowhere")


def test_amp_convert_and_loss_scaler():
    from mxnet_tpu_torch import amp

    net = tnn.HybridSequential()
    net.add(tnn.Dense(4, in_units=3), tnn.LayerNorm(in_channels=4))
    net.initialize()
    amp.init("bfloat16")
    try:
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd")
        assert amp.init_trainer(tr) is None  # bf16: no loss scaling
        amp.convert_hybrid_block(net)
        dtypes = {p.name: p.data()._data.dtype
                  for p in net.collect_params().values()}
        assert dtypes[net[0].weight.name] == torch.bfloat16
        assert dtypes[net[1].gamma.name] == torch.float32
        amp.init("float16")
        scaler = amp.init_trainer(tr)
        assert isinstance(scaler, amp.LossScaler)
        assert tr._amp_loss_scaler is scaler
    finally:
        amp._TARGET["dtype"] = None
    s = amp.LossScaler(scale_window=2)
    s.loss_scale = 8.0
    s.update_scale(True)
    assert s.loss_scale == 4.0
    s.update_scale(False)
    s.update_scale(False)
    assert s.loss_scale == 8.0
    assert float(amp.scale_loss(tnd.array([1.0]), s).asscalar()) == 8.0
    assert _np(amp.unscale([tnd.array([8.0])], s)[0])[0] == 1.0
