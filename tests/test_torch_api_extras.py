"""The port's ``registry``, ``engine``, ``visualization``, ``subgraph``
(``fold_bn``, ``Symbol.optimize_for``) and ``monitor`` against the JAX
package, on the CPU.

The cases of ``tests/test_api_surface.py`` (registry, engine, viz,
subgraph) and ``tests/test_np_sparse_cf.py`` (the two monitor cases) run
through both packages, plus the cross-package contract, each case with
its tolerance: ``print_summary`` text equal; ``fold_bn``'s folded
parameters bitwise equal to the reference's and the folded graph's
predict forward within the reference test's rtol 1e-4 / atol 1e-5 of the
unfolded one; ``Monitor`` stats of the same net within rtol 1e-6 of the
reference's, hybridized too.
"""
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.ndarray import ndarray as tnd_mod

torch.set_num_threads(1)

PKGS = {"jax": jmx, "torch": mx}


@pytest.fixture(autouse=True)
def _on_cpu():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with mx.cpu():
        yield


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_registry_module(pkg):
    reg_mod = PKGS[pkg].registry

    class Base:
        pass

    reg = reg_mod.get_register_func(Base, "thing")
    alias = reg_mod.get_alias_func(Base, "thing")
    create = reg_mod.get_create_func(Base, "thing")

    @alias("a1", "a2")
    class Foo(Base):
        def __init__(self, x=1, y=None):
            self.x, self.y = x, y

    reg(Foo)
    assert isinstance(create("foo"), Foo)
    assert isinstance(create("a2"), Foo)
    assert create("foo, x=3").x == 3
    assert create("foo, x=2.5, y=abc").x == 2.5
    assert create("foo, x=2.5, y=abc").y == "abc"
    inst = Foo()
    assert create(inst) is inst
    with pytest.raises(ValueError):
        create("nope")
    with pytest.raises(TypeError):
        create(3)

    class NotSub:
        pass

    with pytest.raises(TypeError):
        reg(NotSub)
    assert reg.__name__ == "register_thing"
    assert create.__name__ == "create_thing"


# ------------------------------------------------------------------ engine

def test_engine_bulk_scope():
    prev = tnd_mod._MX_SYNC
    tnd_mod._MX_SYNC = True
    try:
        with mx.engine.bulk(16):
            assert tnd_mod._MX_SYNC is False
            x = nd.ones((2,)) + 1
        assert tnd_mod._MX_SYNC is True
        np.testing.assert_allclose(x.asnumpy(), [2, 2])
    finally:
        tnd_mod._MX_SYNC = prev


def test_engine_bulk_restores_after_error():
    prev = tnd_mod._MX_SYNC
    with pytest.raises(RuntimeError):
        with mx.engine.bulk():
            raise RuntimeError("boom")
    assert tnd_mod._MX_SYNC is prev


def test_engine_set_bulk_size_returns_previous():
    first = mx.engine.set_bulk_size(10)
    assert first >= 0
    assert mx.engine.set_bulk_size(first) == 10


# ------------------------------------------------------------------- viz

def _fc_graph(S):
    data = S.sym.Variable("data")
    return S.sym.FullyConnected(data, S.sym.Variable("fc1_weight"),
                                S.sym.Variable("fc1_bias"), num_hidden=8,
                                name="fc1")


def _conv_graph(S):
    data = S.sym.Variable("data")
    conv = S.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                             no_bias=True, name="conv0")
    bn = S.sym.BatchNorm(conv, fix_gamma=False, eps=1e-3, name="bn0")
    act = S.sym.Activation(bn, act_type="relu", name="relu0")
    pool = S.sym.Pooling(act, kernel=(2, 2), stride=(2, 2), pool_type="max",
                         name="pool0")
    flat = S.sym.Flatten(pool, name="flat0")
    return S.sym.FullyConnected(flat, num_hidden=3, name="fc0")


@pytest.mark.parametrize("graph,shape", [
    (_fc_graph, {"data": (1, 16)}),
    (_fc_graph, None),
    (_conv_graph, {"data": (2, 3, 8, 8)}),
], ids=["fc", "fc-no-shape", "conv-bn"])
def test_print_summary_text_equals_reference(capsys, graph, shape):
    want = jmx.viz.print_summary(graph(jmx), shape=shape)
    got = mx.viz.print_summary(graph(mx), shape=shape)
    assert got == want
    if graph is _fc_graph and shape is not None:
        assert "fc1" in got and "Total params" in got
        assert "136" in got  # 16*8 + 8


def test_plot_network_needs_graphviz():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="print_summary"):
            mx.viz.plot_network(_fc_graph(mx))
    else:
        dot = mx.viz.plot_network(_fc_graph(mx))
        assert "fc1" in dot.source


# --------------------------------------------------------------- subgraph

def _fold_case(S, no_bias=True):
    rng = np.random.RandomState(0)
    data = S.sym.Variable("data")
    conv = S.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                             no_bias=no_bias, name="conv0")
    bn = S.sym.BatchNorm(conv, fix_gamma=False, eps=1e-3, name="bn0")
    out = S.sym.Activation(bn, act_type="relu", name="relu0")
    args = {"conv0_weight": rng.rand(4, 3, 3, 3).astype(np.float32),
            "bn0_gamma": rng.rand(4).astype(np.float32) + 0.5,
            "bn0_beta": rng.rand(4).astype(np.float32)}
    if not no_bias:
        args["conv0_bias"] = rng.rand(4).astype(np.float32)
    aux = {"bn0_moving_mean": rng.rand(4).astype(np.float32),
           "bn0_moving_var": rng.rand(4).astype(np.float32) + 0.5}
    x = rng.rand(2, 3, 8, 8).astype(np.float32)
    return out, ({k: S.nd.array(v) for k, v in args.items()},
                 {k: S.nd.array(v) for k, v in aux.items()},
                 S.nd.array(x))


@pytest.mark.parametrize("no_bias", [True, False], ids=["no-bias", "bias"])
def test_fold_bn_pass(no_bias):
    out, (args, aux, x) = _fold_case(mx, no_bias)
    exe = out.bind(args={**args, "data": x}, aux_states=aux)
    ref = exe.forward(is_train=False)[0].asnumpy()
    folded = out.optimize_for("fold_bn", args, aux)
    new_args, new_aux = folded._optimized_args, folded._optimized_aux
    assert folded._folded_bn == ["bn0"]
    assert "bn0_gamma" not in new_args and not new_aux
    assert "conv0_bias" in new_args
    assert "BatchNorm" not in {n._op for n in folded._topo()}
    exe2 = folded.bind(args={**new_args, "data": x}, aux_states=new_aux)
    got = exe2.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("no_bias", [True, False], ids=["no-bias", "bias"])
def test_fold_bn_params_bitwise_equal_reference(no_bias):
    jout, (jargs, jaux, _) = _fold_case(jmx, no_bias)
    tout, (targs, taux, _) = _fold_case(mx, no_bias)
    jf = jout.optimize_for("fold_bn", jargs, jaux)
    tf = tout.optimize_for("fold_bn", targs, taux)
    assert tf._folded_bn == jf._folded_bn
    assert sorted(tf._optimized_args) == sorted(jf._optimized_args)
    for k, v in jf._optimized_args.items():
        np.testing.assert_array_equal(tf._optimized_args[k].asnumpy(),
                                      v.asnumpy())
    assert tf.tojson() == jf.tojson()
    assert tf.list_arguments() == jf.list_arguments()


@pytest.mark.parametrize("backend", ["MKLDNN", "TensorRT", "default",
                                     "fold_bn"])
def test_subgraph_backend_aliases(backend):
    out, (args, aux, _) = _fold_case(mx)
    assert out.optimize_for(backend, args, aux)._folded_bn == ["bn0"]
    assert mx.subgraph.list_passes() == jmx.subgraph.list_passes()


def test_subgraph_unknown_backend_raises():
    out, (args, aux, _) = _fold_case(mx)
    with pytest.raises(ValueError, match="unknown subgraph"):
        out.optimize_for("nope", args, aux)


def test_fold_bn_leaves_shared_conv_unfolded():
    # a convolution with two consumers is not folded (the partitioner's
    # single-consumer constraint), in both packages
    def graph(S):
        data = S.sym.Variable("data")
        conv = S.sym.Convolution(data, kernel=(1, 1), num_filter=2,
                                 no_bias=True, name="c")
        bn = S.sym.BatchNorm(conv, name="b")
        return S.sym.Group([bn, S.sym.Activation(conv, act_type="relu",
                                                 name="r")])

    rng = np.random.RandomState(1)
    vals = {"c_weight": rng.rand(2, 3, 1, 1), "b_gamma": rng.rand(2),
            "b_beta": rng.rand(2)}
    auxv = {"b_moving_mean": rng.rand(2), "b_moving_var": rng.rand(2) + 1}
    for S in (jmx, mx):
        args = {k: S.nd.array(v.astype(np.float32)) for k, v in vals.items()}
        aux = {k: S.nd.array(v.astype(np.float32)) for k, v in auxv.items()}
        assert graph(S).optimize_for("fold_bn", args, aux)._folded_bn == []


def test_fold_bn_on_traced_gluon_net():
    """A Gluon conv + BatchNorm net traced to a Symbol folds every BN, and
    the folded predict forward agrees with the unfolded one."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Conv2D(4, 3, padding=1, use_bias=False),
            mx.gluon.nn.BatchNorm(), mx.gluon.nn.Activation("relu"),
            mx.gluon.nn.Conv2D(5, 3, padding=1, use_bias=False),
            mx.gluon.nn.BatchNorm())
    net.initialize()
    rng = np.random.RandomState(2)
    x = nd.array(rng.rand(2, 3, 6, 6).astype(np.float32))
    net(x)
    for p in net.collect_params().values():  # non-trivial statistics
        if "running" in p.name or "gamma" in p.name or "beta" in p.name:
            p.set_data(nd.array(rng.rand(*p.shape).astype(np.float32) + 0.5))
    want = net(x).asnumpy()
    out = net(mx.sym.var("data", shape=x.shape))
    params = net.collect_params().values()
    args = {p.name: p.data() for p in params if p.grad_req != "null"}
    aux = {p.name: p.data() for p in params if p.grad_req == "null"}
    folded = out.optimize_for("fold_bn", args, aux)
    assert len(folded._folded_bn) == 2
    assert "BatchNorm" not in {n._op for n in folded._topo()}
    assert not folded._optimized_aux
    exe = folded.bind(args={**folded._optimized_args, "data": x})
    got = exe.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_hybridblock_optimize_for_hybridizes():
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    assert not net._active
    net.optimize_for("fold_bn")
    assert net._active


# ----------------------------------------------------------------- monitor

def _mlp_pair():
    """The same two-layer MLP in both packages (same names, weights)."""
    nets = {}
    for key, S in PKGS.items():
        net = S.gluon.nn.HybridSequential()
        net.add(S.gluon.nn.Dense(4, in_units=3),
                S.gluon.nn.Dense(2, in_units=4))
        net.initialize()
        nets[key] = net
    for jp, tp in zip(nets["jax"].collect_params().values(),
                      nets["torch"].collect_params().values()):
        tp.set_data(jp.data().asnumpy())
    return nets


def test_monitor_gluon():
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(4, in_units=3), mx.gluon.nn.Dense(2, in_units=4))
    net.initialize()
    mon = mx.monitor.Monitor(interval=1)
    mon.install_gluon(net)
    mon.tic()
    net(nd.ones((2, 3)))
    stats = mon.toc()
    assert len(stats) >= 2
    assert all(np.isfinite(v) for _, _, v in stats)


def test_monitor_inside_hybridized_net():
    """The port's CachedOp runs the eager forward on every call, so the
    taps fire on every hybridized call."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(4, in_units=3), mx.gluon.nn.Dense(2, in_units=4))
    net.initialize()
    mon = mx.monitor.Monitor(interval=1)
    mon.install_gluon(net)
    net.hybridize()
    for i in range(3):
        mon.tic()
        out = net(nd.ones((2, 3)) * (i + 1))
        out.wait_to_read()
        stats = mon.toc()
        assert len(stats) >= 2, f"call {i}: no stats"
        assert all(np.isfinite(np.asarray(v)) for _, _, v in stats)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["plain", "hybridized"])
@pytest.mark.parametrize("sort", [False, True], ids=["order", "sorted"])
def test_monitor_stats_match_reference(hybridize, sort):
    nets = _mlp_pair()
    x = np.random.RandomState(3).randn(5, 3).astype(np.float32)
    got = {}
    for key, S in PKGS.items():
        mon = S.monitor.Monitor(interval=2, sort=sort)
        mon.install_gluon(nets[key])
        if hybridize:
            nets[key].hybridize()
        runs = []
        for _ in range(4):
            mon.tic()
            nets[key](S.nd.array(x))
            runs.append(mon.toc())
        got[key] = runs
    for jrun, trun in zip(got["jax"], got["torch"]):
        assert [(s, t) for s, t, _ in trun] == [(s, t) for s, t, _ in jrun]
        for (_, _, tv), (_, _, jv) in zip(trun, jrun):
            np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-6)
    # interval 2: batches 0 and 2 report, 1 and 3 do not
    assert [len(r) for r in got["torch"]] == [3, 0, 3, 0]


def test_monitor_pattern_and_custom_stat():
    nets = _mlp_pair()
    x = np.ones((2, 3), np.float32)
    got = {}
    for key, S in PKGS.items():
        mon = S.monitor.Monitor(1, stat_func=lambda a: a.max(),
                                pattern=".*dense1.*")
        mon.install_gluon(nets[key])
        mon.tic()
        nets[key](S.nd.array(x))
        got[key] = mon.toc()
    assert [t for _, t, _ in got["torch"]] == ["dense1_output0"]
    assert [t for _, t, _ in got["jax"]] == ["dense1_output0"]
    np.testing.assert_allclose(got["torch"][0][2], np.asarray(got["jax"][0][2]),
                               rtol=1e-6)


def test_monitor_toc_fetches_once(monkeypatch):
    """Every watched stat reaches the host in one batched fetch."""
    from mxnet_tpu_torch import monitor as mon_mod

    calls = []
    real = mon_mod._fetch
    monkeypatch.setattr(mon_mod, "_fetch",
                        lambda ts: calls.append(len(ts)) or real(ts))
    net = mx.gluon.nn.HybridSequential()
    for _ in range(4):
        net.add(mx.gluon.nn.Dense(3, in_units=3))
    net.initialize()
    mon = mx.monitor.Monitor(1)
    mon.install_gluon(net)
    mon.tic()
    net(nd.ones((2, 3)))
    stats = mon.toc()
    assert calls == [5] and len(stats) == 5


def test_monitor_fetch_keeps_shapes_and_dtypes():
    from mxnet_tpu_torch.monitor import _fetch

    ts = [torch.tensor(1.5), torch.arange(6, dtype=torch.int32).reshape(2, 3),
          torch.tensor([0.25, -2.0], dtype=torch.bfloat16),
          torch.tensor([7.0], dtype=torch.float64)]
    out = _fetch(ts)
    assert out[0].shape == () and out[0] == 1.5
    assert out[1].dtype == np.int32
    np.testing.assert_array_equal(out[1], np.arange(6).reshape(2, 3))
    assert out[2].dtype == np.float32
    np.testing.assert_array_equal(out[2], [0.25, -2.0])
    assert out[3].dtype == np.float64 and out[3][0] == 7.0


def test_monitor_uninstall_and_toc_print(caplog):
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    mon = mx.monitor.Monitor(1)
    mon.install_gluon(net)
    with caplog.at_level(logging.INFO):
        mon.tic()
        net(nd.ones((1, 3)))
        mon.toc_print()
    assert "dense0_output0" in caplog.text
    mon.uninstall_gluon()
    mon.tic()
    net(nd.ones((1, 3)))
    assert mon.toc() == []


def test_monitor_executor_outputs_match_reference():
    """toc(exe) reads an Executor's outputs; install(exe) only sets the
    attribute, as in the reference."""
    got = {}
    rng = np.random.RandomState(4)
    vals = {"data": rng.rand(2, 5), "fc_weight": rng.rand(3, 5),
            "fc_bias": rng.rand(3)}
    for key, S in PKGS.items():
        out = S.sym.FullyConnected(S.sym.Variable("data"), num_hidden=3,
                                   name="fc")
        exe = out.bind(args={k: S.nd.array(v.astype(np.float32))
                             for k, v in vals.items()})
        mon = S.monitor.Monitor(1)
        assert mon.install(exe) is exe and exe._monitor is mon
        mon.tic()
        exe.forward(is_train=False)
        got[key] = mon.toc(exe)
    assert [t for _, t, _ in got["torch"]] == ["fc_output"]
    np.testing.assert_allclose(got["torch"][0][2], np.asarray(got["jax"][0][2]),
                               rtol=1e-6)


def test_module_fit_accepts_monitor_and_ignores_it():
    """The reference's fit takes monitor= and never reads it; so does the
    port's: the same fit with and without a monitor ends at the same
    weights, and the monitor saw nothing."""
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module

    rng = np.random.RandomState(0)
    x = rng.randn(16, 4).astype(np.float32)
    y = rng.randint(0, 3, 16).astype(np.float32)
    out = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    w0 = {"fc_weight": nd.array(rng.randn(3, 4).astype(np.float32)),
          "fc_bias": nd.zeros((3,))}
    finals = []
    for monitor in (None, mx.monitor.Monitor(1)):
        mod = Module(out, context=mx.cpu())
        mod.fit(NDArrayIter(x, y, batch_size=4), num_epoch=1,
                arg_params=dict(w0), monitor=monitor,
                optimizer_params={"learning_rate": 0.1})
        finals.append(mod.get_params()[0]["fc_weight"].asnumpy())
        if monitor is not None:
            assert monitor.step == 0 and monitor.queue == []
    np.testing.assert_array_equal(finals[0], finals[1])


@pytest.mark.parametrize("name,target", [
    ("viz", "visualization"), ("mon", "monitor"), ("recordio", "io.recordio"),
    ("registry", "registry"), ("engine", "engine"), ("subgraph", "subgraph"),
    ("image", "image"), ("native", "native")])
def test_lazy_module_names_match_reference(name, target):
    import importlib

    mod = getattr(mx, name)
    assert mod is importlib.import_module("mxnet_tpu_torch." + target)
    assert getattr(jmx, name).__name__ == "mxnet_tpu." + target
    assert mx.gluon.data.DataLoader and mx.gluon.contrib.estimator.Estimator


# ---------------------------------------------------------------------------
# the top-level, context and base surfaces (queue C's C2)
# ---------------------------------------------------------------------------

# deliberate differences: the TPU's names; the module of queue item
# A15(g), which raises naming it
_SURFACE_DELIBERATE = {"tpu", "num_tpus"}
_SURFACE_LATER = {"platform"}


@pytest.mark.parametrize("where", ["top", "context", "base"])
def test_reference_surface_resolves_on_the_port(where):
    """Every public name of ``mxnet_tpu`` (its lazy submodules included)
    and every name of the ``__all__`` of ``mxnet_tpu.context`` and
    ``mxnet_tpu.base`` resolves on the port,
    but the listed deliberate ones; A15(g)'s module raises naming it."""
    import importlib

    from mxnet_tpu_torch.base import MXNetError

    if where == "top":
        # a fresh import's names (what other tests imported since would
        # show too) and the lazy submodules of its __getattr__
        import subprocess
        import sys

        out = subprocess.run(
            [sys.executable, "-c", "import mxnet_tpu; print(' '.join("
             "n for n in dir(mxnet_tpu) if not n.startswith('_')))"],
            capture_output=True, text=True, check=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout.split()
        src = importlib.import_module("mxnet_tpu")
        lazy = jmx.__getattr__.__code__.co_consts
        names = sorted(set(out) | {c for c in lazy if isinstance(c, str)
                                   and c.isidentifier()
                                   and hasattr(src, c)})
        dst = mx
    else:  # the module's declared public names (its imports are not)
        src = importlib.import_module(f"mxnet_tpu.{where}")
        names = sorted(src.__all__)
        dst = importlib.import_module(f"mxnet_tpu_torch.{where}")
    missing = []
    for name in names:
        if name in _SURFACE_DELIBERATE or (where == "top"
                                           and name in _SURFACE_LATER):
            continue
        if not hasattr(dst, name):
            missing.append(name)
    assert not missing, missing
    if where == "top":
        for name in _SURFACE_LATER:
            with pytest.raises(MXNetError, match="A15"):
                getattr(mx, name)


def test_c2_values_match_the_reference():
    assert mx.num_gpus() == torch.cuda.device_count()
    assert mx.context.num_gpus() == mx.num_gpus()
    assert mx.base.numeric_types == jmx.base.numeric_types
    assert mx.base.string_types == jmx.base.string_types
    assert mx.base.integer_types == jmx.base.integer_types
    assert mx.lr_scheduler.FactorScheduler.__name__ == "FactorScheduler"
    assert mx.NDArray is nd.NDArray
    ctx = mx.cpu_pinned(0)
    assert ctx == mx.context.cpu_pinned() and ctx.device_type == "cpu_pinned"
    assert str(ctx) == str(jmx.cpu_pinned(0))
    a = nd.array([1.0, 2.0], ctx=ctx)
    assert a.astorch().device.type == "cpu"
    # pinned where a card exists to pin for; plain host memory else
    assert a.astorch().is_pinned() == torch.cuda.is_available()
    mx.base.set_env("MXNET_TEST_SET_ENV", 3)
    try:
        assert mx.base.get_env("MXNET_TEST_SET_ENV", typ=int) == 3
    finally:
        import os

        os.environ.pop("MXNET_TEST_SET_ENV")
