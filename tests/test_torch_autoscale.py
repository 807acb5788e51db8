"""The port's autoscaler (``mxnet_tpu_torch/serve/autoscale.py``) and the
windowed burn it reads (``obs/slo.py``) against the reference, on the CPU.

The policy and burn-window cases of ``tests/test_autoscale.py`` run on the
port. The controller cases drive ``Autoscaler.tick`` with injected signal
windows against a local pool with ``factory=`` and against a sharded
pool with the default factory (``ReplicaPool.sharded``: groups of 2 CPU
ranks on a ``{"dp": 4, "tp": 2}`` plan, one started,
``tests/test_autoscale.py:218-305``), and the live signal window is read
from a router under traffic with ``obs`` on. One parametrised case
feeds the same random windows, from a numpy seed, to both packages'
``AutoscalePolicy`` and requires identical decision streams.
"""
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import obs, serve
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.obs.slo import SLOMonitor
from mxnet_tpu_torch.serve.autoscale import Autoscaler, AutoscalePolicy
from mxnet_tpu_torch.serve.fleet import LocalReplica, ReplicaPool, Router

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _sig(ready=2, burn=0.0, queue_depth=0, occupancy=0.0, joining=0):
    return {"ready": ready, "burn": burn, "queue_depth": queue_depth,
            "occupancy": occupancy, "joining": joining}


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------

def test_policy_scale_out_on_budget_burn():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=4, burn_out=1.0)
    d = pol.decide(_sig(ready=2, burn=2.5), now=100.0)
    assert d["action"] == "scale_out" and "burn" in d["reason"]


def test_policy_scale_out_on_queue_depth_and_occupancy():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=4,
                          queue_out=8, occupancy_out=0.9, cooldown_s=0.0)
    d = pol.decide(_sig(queue_depth=20), now=0.0)
    assert d["action"] == "scale_out" and "queue" in d["reason"]
    d = pol.decide(_sig(occupancy=0.97), now=10.0)
    assert d["action"] == "scale_out" and "occupancy" in d["reason"]


def test_policy_below_floor_is_immediate_even_in_cooldown():
    pol = AutoscalePolicy(min_replicas=2, max_replicas=4, cooldown_s=60.0)
    assert pol.decide(_sig(ready=2, burn=9.0), 0.0)["action"] == "scale_out"
    d = pol.decide(_sig(ready=1, burn=0.0), 1.0)
    assert d["action"] == "scale_out" and "floor" in d["reason"]
    assert pol.decide(_sig(ready=1, joining=1), 2.0)["action"] == "hold"


def test_policy_scale_out_cooldown_and_max_clamp():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=3, cooldown_s=5.0)
    assert pol.decide(_sig(ready=1, burn=9.0), 0.0)["action"] == "scale_out"
    d = pol.decide(_sig(ready=2, burn=9.0), 2.0)
    assert d["action"] == "hold" and "cooldown" in d["reason"]
    assert pol.decide(_sig(ready=2, burn=9.0), 6.0)["action"] == "scale_out"
    d = pol.decide(_sig(ready=3, burn=9.0), 20.0)
    assert d["action"] == "hold" and "max" in d["reason"]


def test_policy_scale_in_requires_consecutive_quiet_windows():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=4, hysteresis=3,
                          scale_in_cooldown_s=0.0)
    for i in range(2):
        d = pol.decide(_sig(ready=3), float(i))
        assert d["action"] == "hold" and "hysteresis" in d["reason"]
    assert pol.decide(_sig(ready=3), 2.0)["action"] == "scale_in"


def test_policy_quiet_streak_resets_on_any_non_quiet_window():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=4, hysteresis=2,
                          occupancy_in=0.3, scale_in_cooldown_s=0.0)
    assert pol.decide(_sig(ready=3), 0.0)["action"] == "hold"
    assert pol.decide(_sig(ready=3, occupancy=0.5), 1.0)["action"] == "hold"
    assert pol.decide(_sig(ready=3), 2.0)["action"] == "hold"
    assert pol.decide(_sig(ready=3), 3.0)["action"] == "scale_in"


def test_policy_scale_in_cooldown_and_floor():
    pol = AutoscalePolicy(min_replicas=2, max_replicas=4, hysteresis=1,
                          scale_in_cooldown_s=30.0, cooldown_s=0.0)
    assert pol.decide(_sig(ready=2, burn=9.0), 0.0)["action"] == "scale_out"
    d = pol.decide(_sig(ready=4), 10.0)
    assert d["action"] == "hold" and "cooldown" in d["reason"]
    assert pol.decide(_sig(ready=4), 31.0)["action"] == "scale_in"
    for i in range(5):
        d = pol.decide(_sig(ready=2), 100.0 + i)
        assert d["action"] == "hold" and "floor" in d["reason"]


def test_policy_no_flapping_on_oscillating_load():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=8, hysteresis=3,
                          cooldown_s=2.0, scale_in_cooldown_s=5.0)
    actions = [pol.decide(_sig(ready=4, burn=3.0 if i % 2 == 0 else 0.0),
                          float(i))["action"] for i in range(20)]
    assert "scale_in" not in actions
    assert actions.count("scale_out") >= 1


def test_policy_undo_action_restores_cooldown():
    pol = AutoscalePolicy(min_replicas=1, max_replicas=4, cooldown_s=5.0)
    assert pol.decide(_sig(ready=1, burn=9.0), 0.0)["action"] == "scale_out"
    assert pol.decide(_sig(ready=2, burn=9.0), 6.0)["action"] == "scale_out"
    pol.undo_action()
    assert pol.decide(_sig(ready=2, burn=9.0), 7.0)["action"] == "scale_out"


def test_policy_validation():
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=0)
    with pytest.raises(ValueError):
        AutoscalePolicy(min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        AutoscalePolicy(hysteresis=0)


_POLICY_KW = [
    {},
    {"min_replicas": 2, "max_replicas": 5, "hysteresis": 2,
     "cooldown_s": 1.0, "scale_in_cooldown_s": 3.0},
    {"min_replicas": 1, "max_replicas": 3, "burn_out": 2.0, "queue_out": 4,
     "occupancy_out": 0.8, "burn_in": 0.5, "queue_in": 1,
     "occupancy_in": 0.4, "hysteresis": 1, "cooldown_s": 0.0,
     "scale_in_cooldown_s": 0.0},
]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kw", range(len(_POLICY_KW)))
def test_policy_decision_streams_equal_the_reference(seed, kw):
    """The same random windows through both packages' policies: the same
    action and reason at every step, undos included."""
    from mxnet_tpu.serve.autoscale import AutoscalePolicy as JPolicy

    rng = np.random.RandomState(seed)
    pols = (JPolicy(**_POLICY_KW[kw]), AutoscalePolicy(**_POLICY_KW[kw]))
    now = 0.0
    for _ in range(120):
        now += float(rng.choice([0.2, 0.5, 1.0, 4.0]))
        sig = {"ready": int(rng.randint(0, 7)),
               "joining": int(rng.choice([0, 0, 0, 1])),
               "burn": float(rng.choice([0.0, 0.1, 0.3, 1.5, 4.0])),
               "queue_depth": float(rng.choice([0, 0, 2, 9, 20])),
               "occupancy": float(rng.choice([0.0, 0.2, 0.5, 0.95]))}
        got = [p.decide(dict(sig), now) for p in pols]
        assert got[0] == got[1]
        if got[0]["action"] != "hold" and rng.rand() < 0.2:
            for p in pols:
                p.undo_action()


# ---------------------------------------------------------------------------
# windowed error-budget burn
# ---------------------------------------------------------------------------

def _snap(completed=0, misses=0, fleet=True):
    if fleet:
        return {"counters": {"fleet.request_deadline_exceeded": misses},
                "histograms": {"fleet.request_latency_seconds":
                               {"count": completed}}}
    return {"counters": {"serve.shed_deadline": misses},
            "histograms": {"serve.latency_seconds": {"count": completed}}}


def test_burn_window_is_windowed_not_cumulative():
    mon = SLOMonitor(deadline_target=0.99)
    w = mon.burn_window(_snap(0, 0), _snap(90, 10))
    assert w["completed"] == 90 and w["misses"] == 10
    assert w["attainment"] == pytest.approx(0.9)
    assert w["burn"] == pytest.approx(10.0)
    w = mon.burn_window(_snap(90, 10), _snap(190, 10))
    assert w["misses"] == 0 and w["burn"] == 0.0
    w = mon.burn_window(_snap(190, 10), _snap(190, 10))
    assert w["burn"] == 0.0 and w["attainment"] == 1.0


def test_burn_window_prefers_router_histogram_and_none_prev():
    mon = SLOMonitor(deadline_target=0.99)
    w = mon.burn_window(None, _snap(50, 50, fleet=False))
    assert w["completed"] == 50 and w["misses"] == 50
    cur = _snap(100, 1)
    cur["counters"]["serve.shed_deadline"] = 999
    cur["histograms"]["serve.latency_seconds"] = {"count": 5}
    w = mon.burn_window(None, cur)
    assert w["completed"] == 100 and w["misses"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burn_window_equals_the_reference(seed):
    from mxnet_tpu.obs.slo import SLOMonitor as JMonitor

    rng = np.random.RandomState(seed)
    prev = None
    for _ in range(20):
        cur = _snap(int(rng.randint(0, 500)), int(rng.randint(0, 40)),
                    fleet=bool(rng.rand() < 0.7))
        target = float(rng.choice([0.9, 0.99, 0.999]))
        assert JMonitor(target).burn_window(prev, cur) == \
            SLOMonitor(target).burn_window(prev, cur)
        prev = cur


# ---------------------------------------------------------------------------
# controller wiring (a local pool, injected and live signals)
# ---------------------------------------------------------------------------

def test_signals_count_nonready_members_as_joining():
    class FakePool:
        _make_server = None

        def stats(self):
            return {"ready": 1, "generation": 3, "members": {
                "0": {"state": "ready", "queue_depth": 2,
                      "occupancy": 0.4},
                "1": {"state": "dead", "queue_depth": 0, "occupancy": 0.0},
                "2": {"state": "quarantined", "queue_depth": 0,
                      "occupancy": 0.0},
                "3": {"state": "removed", "queue_depth": 0,
                      "occupancy": 0.0}}}

    sig = Autoscaler(FakePool(), router=None, factory=lambda: None).signals()
    assert sig["ready"] == 1 and sig["joining"] == 2
    assert sig["queue_depth"] == 2


def _factory():
    rng = np.random.RandomState(0)
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, no_bias=True, name="fc")
    arg = {"fc_weight": rng.randn(16, 4).astype(np.float32)}

    def make():
        eng = serve.InferenceEngine(net, arg, max_batch_size=4, lint="off",
                                    ctx=tmx.cpu())
        srv = serve.ServeServer(eng, port=0, max_linger_ms=0.0)
        srv.start()
        return srv
    return make


def _pool_and_router():
    make = _factory()
    pool = ReplicaPool.local(make, 1, probe_interval=0.1,
                             backoff_base=0.05).start()
    return pool, Router(pool), (lambda: LocalReplica(make))


def test_non_sharded_pool_needs_a_factory():
    pool, router, _new = _pool_and_router()
    try:
        with pytest.raises(ValueError, match="factory"):
            Autoscaler(pool, router)
    finally:
        pool.stop()


def test_autoscaler_tick_scales_pool_out_and_in():
    pool, router, new = _pool_and_router()
    try:
        scaler = Autoscaler(pool, router, factory=new,
                            policy=AutoscalePolicy(
                                min_replicas=1, max_replicas=4,
                                hysteresis=2, cooldown_s=0.0,
                                scale_in_cooldown_s=0.0),
                            drain_timeout=10.0)
        d = scaler.tick(signals=_sig(ready=1, burn=5.0))
        assert d["action"] == "scale_out"
        _wait(lambda: len(pool.ready_members()) == 2, 60, "the join")
        assert scaler.events[-1]["action"] == "scale_out"
        assert pool.stats()["generation"] >= 2
        d = scaler.tick(signals=_sig(ready=1, burn=5.0, joining=1))
        assert d["action"] == "hold" and "join in flight" in d["reason"]
        scaler.tick(signals=_sig(ready=2))
        d = scaler.tick(signals=_sig(ready=2))
        assert d["action"] == "scale_in"
        scaler._leave_thread.join(timeout=30)
        assert len(pool.ready_members()) == 1
        assert pool.members()[1].state == "removed"
        assert [e["action"] for e in scaler.events] == \
            ["scale_out", "scale_in"]
        x = np.ones((2, 4), np.float32)
        outs, _ = router.infer([x])
        assert outs[0].shape == (2, 16)
    finally:
        router.close(timeout=5)
        pool.stop()


def test_autoscaler_live_signals_read_the_router_and_pool():
    obs.reset()
    obs.enable()
    pool, router, new = _pool_and_router()
    try:
        scaler = Autoscaler(pool, router, factory=new)
        sig = scaler.signals()
        assert sig["ready"] == 1 and sig["joining"] == 0
        assert sig["burn"] == 0.0
        x = np.ones((1, 4), np.float32)
        for _ in range(5):
            router.infer([x])
        real = router._attempt

        def expired(*a):  # a replica that answers STATUS_DEADLINE
            router._attempt = real
            return False, serve.DeadlineExceeded("deadline expired")

        router._attempt = expired
        with pytest.raises(serve.DeadlineExceeded):
            router.infer([x], deadline_ms=5000)
        sig = scaler.signals()
        assert sig["window_completed"] == 5 and sig["window_misses"] == 1
        assert sig["burn"] == pytest.approx((1 / 6) / 0.01, rel=1e-3)
        pool._members[0].queue_depth = 42
        pool._members[0].occupancy = 0.85
        sig = scaler.signals()
        assert sig["queue_depth"] == 42
        assert sig["occupancy"] == pytest.approx(0.85)
        assert sig["window_completed"] == 0
        d = scaler.tick(signals=None)
        assert d["action"] in ("hold", "scale_out")
        snap = obs.metrics.snapshot()
        assert snap["gauges"]["autoscale.ready"] == 1
    finally:
        router.close(timeout=5)
        pool.stop()
        obs.disable()
        obs.reset()


def test_autoscaler_thread_starts_and_stops():
    pool, router, new = _pool_and_router()
    try:
        scaler = Autoscaler(pool, router, factory=new, interval=0.05,
                            policy=AutoscalePolicy(min_replicas=1,
                                                   max_replicas=2))
        scaler.start()
        _wait(lambda: scaler.last_decision is not None, 10,
              "the first control-loop window")
        scaler.stop()
        assert scaler._thread is None
    finally:
        router.close(timeout=5)
        pool.stop()


# ---------------------------------------------------------------------------
# a sharded pool: the default factory takes the spare slices
# ---------------------------------------------------------------------------

@pytest.fixture
def sharded(tmp_path):
    """tests/test_autoscale.py:_tiny_pool_and_router: the one-fc net with
    its rows sharded over tp, 1 of 4 replica groups started."""
    import functools

    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.tools import mesh_worker as W

    path = str(tmp_path / "fc.npz")
    np.savez(path, fc_weight=np.random.RandomState(0).randn(16, 4).astype(
        np.float32))
    plan = par.make_mesh({"dp": 4, "tp": 2},
                         devices=[torch.device("cpu")] * 8)
    pool = ReplicaPool.sharded(
        functools.partial(W.mlp_server, "fc", path, 4, warmup=False),
        mesh=plan, start=1, probe_interval=0.1, backoff_base=0.05,
        env={"OMP_NUM_THREADS": "1"})
    pool.start()
    router = Router(pool)
    yield pool, router
    router.close(timeout=5)
    pool.stop()


def test_sharded_autoscaler_tick_scales_pool_out_and_in(sharded):
    pool, router = sharded
    scaler = Autoscaler(pool, router, policy=AutoscalePolicy(
        min_replicas=1, max_replicas=4, hysteresis=2, cooldown_s=0.0,
        scale_in_cooldown_s=0.0), drain_timeout=10.0)
    # pressure window → join (quarantine → activate at a boundary)
    d = scaler.tick(signals=_sig(ready=1, burn=5.0))
    assert d["action"] == "scale_out"
    _wait(lambda: len(pool.ready_members()) == 2, 90, "the join")
    assert scaler.events[-1]["action"] == "scale_out"
    assert pool.spare_slices == 2
    # a second pressure window while a join is in flight holds
    d = scaler.tick(signals=_sig(ready=1, burn=5.0, joining=1))
    assert d["action"] == "hold" and "join in flight" in d["reason"]
    # quiet windows × hysteresis → leave (drain-then-remove)
    scaler.tick(signals=_sig(ready=2))
    d = scaler.tick(signals=_sig(ready=2))
    assert d["action"] == "scale_in"
    scaler._leave_thread.join(timeout=30)
    assert len(pool.ready_members()) == 1
    assert pool.spare_slices == 3
    assert [e["action"] for e in scaler.events] == ["scale_out", "scale_in"]


def test_sharded_autoscaler_live_signals_read_pool_numbers(sharded):
    """``Autoscaler.signals()`` assembles the window from the same member
    records the supervisor exports — queue depth, occupancy, membership."""
    pool, router = sharded
    scaler = Autoscaler(pool, router)
    sig = scaler.signals()
    assert sig["ready"] == 1 and sig["joining"] == 0
    assert sig["burn"] == 0.0
    pool._members[0].queue_depth = 42
    pool._members[0].occupancy = 0.85
    sig = scaler.signals()
    assert sig["queue_depth"] == 42
    assert sig["occupancy"] == pytest.approx(0.85)
    d = scaler.tick(signals=None)  # live window, quiet burn → hold/out
    assert d["action"] in ("hold", "scale_out")
