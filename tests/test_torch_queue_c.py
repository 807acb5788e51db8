"""Queue C's repairs: the reference's own test inputs through both packages.

Each named case of ``tests/test_decode.py`` and ``tests/test_obs.py`` that
the faults broke runs twice: as the reference wrote it, and as a port copy
(the function's source and its module's helpers compiled with every
``mxnet_tpu`` name read as ``mxnet_tpu_torch``, in a namespace whose
module-level imports are the port's). Both must hold the reference's
assertions. The telemetry the port dropped (C4) is held to the names and
counts the reference records for the same scenario."""
import importlib
import inspect
import re
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch
import test_decode as ref_decode
import test_obs as ref_obs

torch.set_num_threads(1)

_REF_NAME = re.compile(r"\bmxnet_tpu\b(?!_torch)")
_PORTED = {}


def _port_module(module):
    """``module``'s source compiled as the port's: every ``mxnet_tpu``
    import reads ``mxnet_tpu_torch`` (module-level and inside functions,
    logger names included). Cached per module."""
    if module.__name__ not in _PORTED:
        src = _REF_NAME.sub("mxnet_tpu_torch", inspect.getsource(module))
        ns = {"__name__": f"port_of_{module.__name__}",
              "__file__": module.__file__}
        exec(compile(src, module.__file__, "exec"), ns)
        _PORTED[module.__name__] = ns
    return _PORTED[module.__name__]


def _run(pkg, module, name, *args):
    """Run the reference test ``name`` of ``module`` on ``pkg`` ("ref" or
    "port"). The port copy runs in a ``cpu()`` scope: the port's default
    device is the card."""
    if pkg == "ref":
        return getattr(module, name)(*args)
    with mxnet_tpu_torch.cpu():
        return _port_module(module)[name](*args)


def _pkgs():
    return [mxnet_tpu, mxnet_tpu_torch]


@pytest.fixture(autouse=True)
def _obs_clean():
    for pkg in _pkgs():
        pkg.obs.disable()
        pkg.obs.reset()
        pkg.chaos.rpc.reset()
    yield
    for pkg in _pkgs():
        pkg.obs.disable()
        pkg.obs.reset()
        pkg.chaos.rpc.reset()


def _obs(pkg):
    return (mxnet_tpu if pkg == "ref" else mxnet_tpu_torch).obs


def test_port_copy_imports_only_the_port():
    ns = _port_module(ref_decode)
    assert ns["DecodeScheduler"] is mxnet_tpu_torch.serve.DecodeScheduler
    assert ns["mx"] is mxnet_tpu_torch
    assert ns["obs"] is mxnet_tpu_torch.obs
    fake = ns["_FakeDecodeEngine"]()
    assert type(fake.pool) is mxnet_tpu_torch.serve.kvcache.PagePool
    assert not hasattr(fake, "device")  # the reference's contract


# ---------------------------------------------------------------------------
# C1: the duck-typed engine of tests/test_decode.py:183-227
# ---------------------------------------------------------------------------

C1_CASES = ["test_continuous_batching_join_leave",
            "test_priority_lane_admitted_first",
            "test_shed_discipline_aggregate_equals_by_reason",
            "test_deadline_expires_mid_generation",
            "test_cancel_reclaims_pages_and_batch_keeps_running",
            "test_page_exhaustion_queues_then_sheds_running_stream",
            "test_wire_draining_refuses_streams"]


@pytest.mark.parametrize("pkg", ["ref", "port"])
@pytest.mark.parametrize("name", C1_CASES)
def test_c1_scheduler_case_on_both_packages(name, pkg):
    _run(pkg, ref_decode, name)


def test_c1_fleet_relay_on_the_port():
    """The eighth case. Its reference run is ``tests/test_decode.py``'s own
    (a timing flake of the reference under load, so not run twice here)."""
    _run("port", ref_decode,
         "test_fleet_stream_relay_failover_and_merged_timeline")


def test_c1_dead_loop_refuses_submissions_naming_why():
    from mxnet_tpu_torch.serve import DecodeScheduler, ServeError

    fake = _port_module(ref_decode)["_FakeDecodeEngine"](slots=1)

    def broken_step(*a, **k):
        raise RuntimeError("engine lost its card")

    fake.step = broken_step
    sched = DecodeScheduler(fake, max_new_tokens=4)
    try:
        with pytest.raises(ServeError, match="engine lost its card"):
            list(sched.generate([1, 2], max_new_tokens=4))
        sched._thread.join(5)
        assert not sched._thread.is_alive()
        with pytest.raises(ServeError, match="died.*engine lost its card"):
            sched.submit([3])
        assert not sched.ready()
        fake.pool.assert_baseline()
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# C2: DecodeEngine under a cpu() scope (tests/test_decode.py:74-88)
# ---------------------------------------------------------------------------

ENGINE = dict(slots=4, page_size=8, num_pages=16, prompt_buckets=[8, 16])


@pytest.fixture(scope="module")
def lm_pair():
    from mxnet_tpu.models import transformer as jt

    mxnet_tpu.random.seed(11)
    lm = jt.transformer_lm(vocab_size=97, units=32, hidden_size=64,
                           num_layers=2, num_heads=4, max_length=64,
                           dropout=0.0)
    lm.initialize()
    lm(mxnet_tpu.nd.zeros((1, 8)))
    return lm, jt.decode_config(lm), jt.decode_params(lm)


def test_c2_engine_takes_the_enclosing_scope(lm_pair):
    from mxnet_tpu.serve import DecodeEngine as JaxEngine
    from mxnet_tpu_torch.models import transformer as tt
    from mxnet_tpu_torch.serve import DecodeEngine

    lm, cfg, params = lm_pair
    ref = JaxEngine(lm, **ENGINE)
    with mxnet_tpu_torch.cpu():
        port_lm = tt.from_numpy_params(cfg, params, device="cpu")
        eng = DecodeEngine(port_lm, **ENGINE)
        eng2 = DecodeEngine(cfg, params, **ENGINE)
    assert eng.device == eng2.device == torch.device("cpu")
    assert eng.warmup() == ref.warmup()
    prompt = np.arange(1, 10, dtype=np.int32)
    for e in (eng, eng2):
        t_ref, t = ref.pool.alloc("s", 2), e.pool.alloc("s", 2)
        assert e.prefill(prompt, t) == ref.prefill(prompt, t_ref)
        ref.pool.free("s")
        e.pool.free("s")


def test_c2_explicit_device_wins_and_no_scope_still_raises(lm_pair):
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.serve import DecodeEngine

    _lm, cfg, params = lm_pair
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    with mxnet_tpu_torch.cpu():
        with pytest.raises(MXNetError, match="CUDA is not available"):
            DecodeEngine(cfg, params, device="cuda", **ENGINE)
    with pytest.raises(MXNetError, match="no CUDA device"):
        DecodeEngine(cfg, params, **ENGINE)


# ---------------------------------------------------------------------------
# C3: the checkpoint writer's telemetry (tests/test_obs.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c3_checkpoint_write_durations_recorded(pkg, tmp_path):
    _obs(pkg).enable()
    _run(pkg, ref_obs, "test_checkpoint_write_durations_recorded",
         tmp_path, None)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c3_checkpoint_writer_error_counted(pkg, tmp_path, monkeypatch,
                                            caplog):
    _run(pkg, ref_obs, "test_checkpoint_writer_error_logged_counted_and_reraised",
         tmp_path, monkeypatch, caplog)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c3_two_batch_resnet_fit_trace(pkg, tmp_path):
    _obs(pkg).enable()
    _run(pkg, ref_obs,
         "test_two_batch_resnet_fit_trace_is_valid_and_phase_complete",
         tmp_path, None)


def _names(pkg, kind):
    """What ``pkg`` recorded: span and event names, or metric names."""
    if kind == "events":
        return [e[1] for e in pkg.obs.trace.events()]
    return pkg.obs.metrics.snapshot()


def test_c3_module_fit_checkpoint_span_and_saves_match(tmp_path):
    """An epoch-end save through ``Module.fit`` opens one ``checkpoint``
    span and one ``checkpoint.write`` in both packages."""
    got = {}
    for pkg in _pkgs():
        pkg.obs.enable()
        sym = ref_obs._tiny_resnet() if pkg is mxnet_tpu else \
            _port_module(ref_obs)["_tiny_resnet"]()
        rng = np.random.RandomState(7)
        X = rng.randn(8, 3, 8, 8).astype(np.float32)
        y = rng.randint(0, 2, 8).astype(np.float32)
        with pkg.cpu():
            it = pkg.io.NDArrayIter(X, y, batch_size=4)
            mod = pkg.mod.Module(sym, context=pkg.cpu())
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.05},
                    checkpoint=str(tmp_path / pkg.__name__))
        names = _names(pkg, "events")
        snap = _names(pkg, "metrics")
        got[pkg.__name__] = (names.count("checkpoint"),
                             names.count("checkpoint.write"),
                             snap["counters"].get("checkpoint.saves"),
                             snap["histograms"]["checkpoint.write_seconds"]
                             ["count"])
        pkg.obs.disable()
    assert got["mxnet_tpu_torch"] == got["mxnet_tpu"] == (1, 1, 1, 1)


# ---------------------------------------------------------------------------
# C4: the other dropped metrics, events and spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c4_page_pool_gauge_tracks_usage(pkg):
    _run(pkg, ref_decode, "test_page_pool_gauge_tracks_usage")


def test_c4_pages_exhausted_counted_as_the_reference():
    counts = []
    for pkg in _pkgs():
        pkg.obs.enable()
        pool = pkg.serve.kvcache.PagePool(4, 4)
        pool.alloc("a", 3)
        for _ in range(2):
            with pytest.raises(pkg.serve.PagesExhausted):
                pool.alloc("b", 1)
        snap = pkg.obs.metrics.snapshot()
        counts.append((snap["counters"]["decode.pages_exhausted"],
                       snap["gauges"]["decode.kv_pages_used"]))
    assert counts[0] == counts[1] == (2, 3)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c4_fused_update_retrace_metrics(pkg):
    _obs(pkg).enable()
    _run(pkg, ref_obs, "test_fused_update_compile_execute_and_retrace_metrics",
         None)


def test_c4_trainer_step_opens_allreduce_and_update_spans():
    got = []
    for pkg in _pkgs():
        with pkg.cpu():
            net = pkg.gluon.nn.Dense(4)
            net.initialize()
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.1})
            x = pkg.nd.ones((2, 3))
            pkg.obs.enable()
            for _ in range(2):
                with pkg.autograd.record():
                    loss = (net(x) * net(x)).sum()
                loss.backward()
                trainer.step(2)
        names = _names(pkg, "events")
        got.append([n for n in names if n in ("allreduce", "update")])
        pkg.obs.disable()
    assert got[1] == got[0] == ["allreduce", "update"] * 2


def test_c4_serve_cache_hit_counted_apart(tmp_path):
    """A warm engine's first runs are hits: ``serve.cache_hit`` and
    ``serve.deserialize_seconds``, no ``serve.compile`` (the reference's
    ``serve/engine.py:676-677``)."""
    from mxnet_tpu_torch import progcache, serve, sym

    data = sym.Variable("data")
    net = sym.softmax(sym.FullyConnected(data, num_hidden=8, name="fc1"),
                      name="prob")
    rng = np.random.RandomState(0)
    arg = {"fc1_weight": rng.randn(8, 4).astype(np.float32),
           "fc1_bias": rng.randn(8).astype(np.float32)}
    d = str(tmp_path / "progcache")
    try:
        kw = dict(max_batch_size=4, lint="off", ctx=mxnet_tpu_torch.cpu(),
                  progcache_dir=d)
        cold = serve.InferenceEngine(net, arg, {}, **kw)
        x = rng.rand(3, 4).astype(np.float32)
        ref = cold.predict(x)
        mxnet_tpu_torch.obs.enable()
        warm = serve.InferenceEngine(net, arg, {}, **kw)
        np.testing.assert_array_equal(warm.predict(x), ref)
        warm.predict(x)
        snap = mxnet_tpu_torch.obs.metrics.snapshot()
    finally:
        progcache.reset()
    assert snap["counters"]["serve.cache_hit"] == 1
    assert "serve.compile" not in snap["counters"]
    assert snap["histograms"]["serve.deserialize_seconds"]["count"] == 1
    assert snap["histograms"]["serve.execute_seconds"]["count"] == 1


def _ps_pair(pkg):
    return (importlib.import_module(f"{pkg.__name__}.kvstore.ps_server"),
            importlib.import_module(f"{pkg.__name__}.kvstore.ps_client"))


def test_c4_ps_snapshot_span_and_wal_replay_event(tmp_path):
    got = []
    for pkg in _pkgs():
        server, client = _ps_pair(pkg)
        d = str(tmp_path / pkg.__name__)
        pkg.obs.enable()
        srv = server.PSServer(host="127.0.0.1", port=0, num_workers=1,
                              snapshot_dir=d, snapshot_period=0)
        srv.start()
        cli = client.PSClient("127.0.0.1", srv.port, timeout=5)
        cli.init("w", np.ones(3, np.float32))
        srv.snapshot_now()
        cli.push("w", np.full(3, 0.5, np.float32))
        cli.close()
        srv.stop()
        # a restart replays the push logged after the snapshot
        srv = server.PSServer(host="127.0.0.1", port=0, num_workers=1,
                              snapshot_dir=d, snapshot_period=0)
        srv.start()
        srv.stop()
        evs = pkg.obs.trace.events()
        got.append((sum(e[1] == "elastic.ps_snapshot" for e in evs),
                    [e[6] for e in evs if e[1] == "elastic.ps_wal_replayed"]))
        pkg.obs.disable()
    assert got[1] == got[0]
    assert got[0][0] >= 1 and got[0][1] and got[0][1][0]["records"] >= 1


def test_c4_async_gate_blocks_counted():
    """A pull two steps ahead of the committed floor waits at the gate
    until the lagging rank commits: one ``kvstore.async.gate_blocks``."""
    got = []
    for pkg in _pkgs():
        server, client = _ps_pair(pkg)
        pkg.obs.enable()
        srv = server.PSServer(host="127.0.0.1", port=0, num_workers=2)
        srv.start()
        try:
            fast = client.PSClient("127.0.0.1", srv.port, timeout=10)
            slow = client.PSClient("127.0.0.1", srv.port, timeout=10)
            fast.init("w", np.ones(2, np.float32))
            fast.push_clock(0, 1)
            slow.push_clock(1, 0)
            threading.Timer(0.3, slow.push_clock, (1, 1)).start()
            fast.pull_stale("w", 0, 1, 0, timeout=5.0)
            fast.close()
            slow.close()
        finally:
            srv.stop()
        got.append(pkg.obs.metrics.snapshot()["counters"]
                   .get("kvstore.async.gate_blocks"))
        pkg.obs.disable()
    assert got[1] == got[0] == 1


def test_c4_barrier_timeout_event_names_the_missing():
    got = []
    for pkg in _pkgs():
        server, client = _ps_pair(pkg)
        pkg.obs.enable()
        srv = server.PSServer(host="127.0.0.1", port=0, num_workers=2,
                              barrier_timeout=0.2)
        srv.start()
        try:
            cli = client.PSClient("127.0.0.1", srv.port, timeout=5)
            with pytest.raises(Exception):
                cli.barrier()
            cli.close()
        finally:
            srv.stop()
        got.append([{k: v for k, v in e[6].items()
                     if k in ("expected", "arrived", "missing_ranks")}
                    for e in pkg.obs.trace.events()
                    if e[1] == "kvstore.barrier_timeout"])
        pkg.obs.disable()
    assert got[1] == got[0] == [{"expected": 2, "arrived": 1,
                                 "missing_ranks": []}]


def test_c4_hier_fallback_event(monkeypatch):
    got = []
    for pkg in _pkgs():
        dist = importlib.import_module(f"{pkg.__name__}.kvstore.dist")
        elastic = importlib.import_module(f"{pkg.__name__}.kvstore.elastic")

        def tree(*a, **k):
            raise elastic.ElasticError("stage timed out")

        class _Session:
            _joined = type("J", (), {"num_parts": 4, "part_index": 0})()

            def allreduce(self, key, flat):
                return flat * 4, 4

        kv = object.__new__(dist.DistKVStore)
        kv._elastic, kv._hier_group, kv._hier_rounds = _Session(), 2, {}
        monkeypatch.setattr(dist, "hierarchical_allreduce", tree)
        pkg.obs.enable()
        out, n = kv._elastic_reduce("g", np.ones(2, np.float32))
        assert n == 4 and out.tolist() == [4.0, 4.0]
        got.append(([e[6] for e in pkg.obs.trace.events()
                     if e[1] == "kvstore.hier.fallback"],
                    pkg.obs.metrics.snapshot()["counters"]
                    ["kvstore.hier.fallbacks"]))
        pkg.obs.disable()
    assert got[1] == got[0] == ([{"key": "g", "round": 0}], 1)


# ---------------------------------------------------------------------------
# C5: numpy tokens into lm_prefill; eager_ops into the registry
# ---------------------------------------------------------------------------

def test_c5_prefill_takes_numpy_tokens(lm_pair):
    from mxnet_tpu.models.transformer import lm_prefill as jax_prefill
    from mxnet_tpu_torch.models import transformer as tt

    _lm, cfg, params = lm_pair
    toks = np.random.RandomState(5).randint(1, 97, size=(2, 8))
    ref, _k, _v = jax_prefill(cfg, params, toks.astype(np.int32))
    with mxnet_tpu_torch.cpu():
        port_params = tt.decode_params(
            tt.from_numpy_params(cfg, params, device="cpu"))
    logits, _k, _v = tt.lm_prefill(cfg, port_params, toks.astype(np.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    ids = tt.embed_ids(np.array([-1, 3, 200]), 97)
    assert ids.tolist() == [96, 3, 96]


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c5_prefill_matches_training_forward(pkg, lm_pair):
    if pkg == "ref":
        return _run(pkg, ref_decode, "test_prefill_matches_training_forward",
                    lm_pair[0])
    from mxnet_tpu_torch.models import transformer as tt

    with mxnet_tpu_torch.cpu():
        lm = tt.from_numpy_params(lm_pair[1], lm_pair[2], device="cpu")
        _run(pkg, ref_decode, "test_prefill_matches_training_forward", lm)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_c5_dispatch_counting_is_a_registry_delta(pkg):
    _run(pkg, ref_obs, "test_dispatch_counting_unchanged_when_disabled")


def test_c5_nested_regions_count_each_operator_once():
    from mxnet_tpu_torch import profiler

    reg = mxnet_tpu_torch.obs.metrics.registry
    before = reg.counter("dispatch.eager_ops").value
    with mxnet_tpu_torch.cpu():
        with profiler.count_dispatches() as outer:
            a = mxnet_tpu_torch.nd.ones((4, 4))
            with profiler.count_dispatches() as inner:
                (a * a).asnumpy()
    assert inner.eager_ops >= 1 and outer.eager_ops > inner.eager_ops
    assert reg.counter("dispatch.eager_ops").value - before == outer.eager_ops


class _Info:
    active, epoch, part_index, num_parts = True, 0, 0, 1
    generation, active_count, changed = 0, 1, False


class _StubElastic:
    """An elastic session of one co-starting rank (the membership plane
    answered in process)."""

    def ensure_joined(self):
        return _Info()

    def epoch_end(self, epoch):
        return _Info()


class _StubStore:
    elastic = _StubElastic()
    type = "dist_sync"
    rank, num_workers = 0, 1


def test_c4_elastic_cold_start_opens_bcast_params_span():
    got = []
    for pkg in _pkgs():
        sym = ref_obs._tiny_resnet() if pkg is mxnet_tpu else \
            _port_module(ref_obs)["_tiny_resnet"]()
        rng = np.random.RandomState(7)
        X = rng.randn(8, 3, 8, 8).astype(np.float32)
        y = rng.randint(0, 2, 8).astype(np.float32)
        pkg.obs.enable()
        with pkg.cpu():
            it = pkg.io.NDArrayIter(X, y, batch_size=4)
            mod = pkg.mod.Module(sym, context=pkg.cpu())
            mod.fit(it, num_epoch=1, optimizer="sgd", kvstore=_StubStore(),
                    optimizer_params={"learning_rate": 0.05})
        got.append([e[1] for e in pkg.obs.trace.events()].count(
            "elastic.bcast_params"))
        pkg.obs.disable()
    assert got[1] == got[0] == 1
