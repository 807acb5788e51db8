"""The port's serving fleet (``mxnet_tpu_torch/serve/fleet.py``) against
the reference's contracts and the reference itself, on the CPU.

The cases of ``tests/test_fleet.py`` run here on the port: the circuit
breaker, capped backoff, failover and pool restart, breaker trips,
hedging, the two-phase fleet reload under traffic, prepare rollback,
exactly-once commits, a kill between commits, the ``FleetServer`` front,
shed reasons and lazy connects. The reference's chaos-env kill mid-reply
becomes a ``ProcReplica`` child (``MXNET_SERVE_PLATFORM=cpu``) killed with
SIGKILL through ``pool.kill``. The hedge racer's trace context and the
subprocess flagship's merged trace are in ``tests/test_torch_obs_serve.py``
and ``tests/test_torch_obs_fleet.py``.

Then the two packages together, over the byte-identical wire: a reference
``Router``/``ReplicaPool`` in front of port replicas and a port ``Router``
in front of reference replicas, replies and version stamps equal through a
fleet reload; and a port ``FleetServer`` relaying greedy streams from two
port decode replicas of a small LM carrying the reference's parameters,
token for token the reference ``DecodeEngine``'s, failing over before the
first token and leaking no page.

Tolerances: the ``y = scale * x`` replicas are held exactly (bitwise);
outputs of the reference's engine against the port's at rtol 1e-5 /
atol 1e-6 (different backends); tokens exactly. Waits poll a condition
with a deadline, never a bare sleep.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd, serve
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.base import MXNetError, capped_backoff
from mxnet_tpu_torch.model import save_checkpoint
from mxnet_tpu_torch.serve import (DeadlineExceeded, Draining,
                                   DynamicBatcher, RequestRejected,
                                   ServeClient, ServeError, ServeServer)
from mxnet_tpu_torch.serve.fleet import (CircuitBreaker, FleetServer,
                                         LocalReplica, ProcReplica,
                                         ReplicaPool, Router)

torch.set_num_threads(1)

X = np.arange(8, dtype=np.float32).reshape(2, 4)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def _save_linear_ckpt(tmpdir, scales=(1.0,)):
    """One checkpoint per scale: y = x @ (scale * I), so every reply tells
    which generation computed it."""
    prefix = os.path.join(str(tmpdir), "lin")
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=4, no_bias=True, name="fc")
    for epoch, scale in enumerate(scales):
        save_checkpoint(prefix, epoch, net,
                        {"fc_weight": nd.array(
                            np.eye(4, dtype=np.float32) * scale)}, {})
    return prefix


def _linear_factory(scale=1.0, delay=0.0):
    def factory():
        data = sym.Variable("data")
        net = sym.FullyConnected(data, num_hidden=4, no_bias=True, name="fc")
        arg = {"fc_weight": np.eye(4, dtype=np.float32) * scale}
        engine = serve.InferenceEngine(net, arg, max_batch_size=8,
                                       lint="off", ctx=tmx.cpu())
        if delay:
            real = engine.infer

            def slow_infer(inputs, n_valid=None):
                time.sleep(delay)
                return real(inputs, n_valid=n_valid)

            engine.infer = slow_infer
        srv = ServeServer(engine, port=0, max_linger_ms=0.0)
        srv.start()
        return srv
    return factory


def _ckpt_factory(prefix, epoch=0):
    def factory():
        engine = serve.load(prefix, epoch=epoch, max_batch_size=8,
                            lint="off", ctx=tmx.cpu())
        srv = ServeServer(engine, port=0, max_linger_ms=0.0)
        srv.start()
        return srv
    return factory


def _local_pool(n=2, scale=1.0, **kw):
    kw.setdefault("probe_interval", 0.1)
    kw.setdefault("backoff_base", 0.05)
    kw.setdefault("backoff_cap", 0.5)
    kw.setdefault("ready_timeout", 60.0)
    return ReplicaPool.local(_linear_factory(scale), n, **kw).start()


# ---------------------------------------------------------------------------
# 1. circuit breaker and backoff
# ---------------------------------------------------------------------------

def test_breaker_trip_and_halfopen_recovery():
    br = CircuitBreaker(threshold=3, cooldown=0.1)
    assert br.state == "closed" and br.allow()
    assert not br.failure() and not br.failure()
    assert br.failure()  # the third consecutive failure trips it
    assert br.state == "open" and br.trips == 1
    assert not br.allow()
    _wait(lambda: br.allow(), 5.0, "the half-open probe")
    assert not br.allow()    # half-open admits exactly one probe
    assert br.failure()      # a failed probe re-opens (a trip)
    assert br.state == "open"
    _wait(lambda: br.allow(), 5.0, "the second half-open probe")
    br.success()
    assert br.state == "closed" and br.allow()
    snap = br.snapshot()
    assert snap["trips"] == 2 and snap["open_seconds"] > 0


def test_breaker_shed_replies_reset_streak():
    br = CircuitBreaker(threshold=2, cooldown=1.0)
    br.failure()
    br.success()
    assert not br.failure()
    assert br.state == "closed"


def test_breaker_release_frees_the_half_open_slot():
    br = CircuitBreaker(threshold=1, cooldown=0.05)
    assert br.failure()
    _wait(lambda: br.allow(), 5.0, "the half-open probe")
    assert not br.allow()
    br.release()  # the probe ended with no verdict (a client deadline)
    assert br.allow()


def test_capped_backoff_bounds():
    for attempt in range(8):
        d = capped_backoff(attempt, 0.2, 2.0)
        cap = min(2.0, 0.2 * 2 ** attempt)
        assert cap / 2 <= d <= cap
    draws = {round(capped_backoff(3, 0.2, 2.0), 6) for _ in range(16)}
    assert len(draws) > 1


# ---------------------------------------------------------------------------
# 2/3. router failover and pool supervision
# ---------------------------------------------------------------------------

def test_failover_on_replica_death_and_pool_restart():
    # a probe interval slow enough that the corpse is still listed ready
    # when the next requests arrive: the router must absorb the death
    pool = _local_pool(2, probe_interval=2.0)
    try:
        router = Router(pool, breaker_cooldown=0.2)
        outs, ver = router.infer([X])
        np.testing.assert_array_equal(outs[0], X)
        assert ver == 0
        pool.kill(0)
        for _ in range(4):
            outs, _ = router.infer([X], deadline_ms=5000)
            np.testing.assert_array_equal(outs[0], X)
        assert router.failovers >= 1
        m0 = pool.members()[0]
        _wait(lambda: m0.restarts >= 1 and m0.state == "ready", 30,
              "the restart of replica 0")
        assert len(pool.ready_members()) == 2
        for _ in range(6):
            outs, _ = router.infer([X])
            np.testing.assert_array_equal(outs[0], X)
        assert pool.members()[0].state == "ready"
        assert pool.stats()["restarts"] >= 1
    finally:
        pool.stop()


def test_restart_frees_the_dead_incarnation_without_a_gc_pause(monkeypatch):
    # a full collection holds the GIL while it walks the heap (about 1 s in
    # a test process), stalling the surviving replica and the router past
    # their RPC timeouts: a restart runs none, and the dead incarnation's
    # engine goes by reference counting alone
    import gc
    import weakref

    collects = []
    monkeypatch.setattr(gc, "collect", lambda *a, **k: collects.append(a))
    pool = _local_pool(2, probe_interval=0.1)
    was = gc.isenabled()
    gc.disable()
    try:
        dead = weakref.ref(pool.members()[0].handle.server._engine)
        pool.kill(0)
        m0 = pool.members()[0]
        _wait(lambda: m0.restarts >= 1 and m0.state == "ready", 30,
              "the restart of replica 0")
        assert dead() is None
        assert collects == []
    finally:
        if was:
            gc.enable()
        pool.stop()


def test_breaker_trips_after_consecutive_failures():
    pool = _local_pool(2, backoff_base=5.0, backoff_cap=5.0,
                       probe_interval=5.0)  # the corpse stays listed
    try:
        router = Router(pool, breaker_threshold=2, breaker_cooldown=30.0)
        pool.kill(1)
        for _ in range(6):
            router.infer([X], deadline_ms=5000)
        st = router.stats()
        assert st["replicas"]["1"]["breaker"]["state"] == "open"
        assert st["breaker_trips"] >= 1
        assert st["replicas"]["1"]["errors"] >= 2
    finally:
        pool.stop()


def test_breaker_trips_on_a_replica_that_stalls_past_the_deadline():
    # the RPC's timeout is the request's budget plus a grace, so a stalled
    # replica always fails after the deadline: the failure must still
    # count against its breaker, and the router then routes around it
    replicas = [LocalReplica(_linear_factory(delay=1.0)),
                LocalReplica(_linear_factory())]
    pool = ReplicaPool(replicas, probe_interval=0.2,
                       ready_timeout=60).start()
    try:
        router = Router(pool, breaker_threshold=2, breaker_cooldown=30.0)
        router._rr = 0  # the stalled replica is first on every other call
        for _ in range(4):
            try:
                router.infer([X], deadline_ms=100)
            except DeadlineExceeded:
                # the stalled attempt used up the budget; the replica's
                # batch ends before the next attempt, which so stalls too
                time.sleep(0.5)
        st = router.stats()["replicas"]["0"]
        assert st["breaker"]["state"] == "open"
        assert st["errors"] == 2 and router.stats()["breaker_trips"] >= 1
        for _ in range(4):  # routed around the open breaker, in budget
            outs, _ = router.infer([X], deadline_ms=500)
            np.testing.assert_array_equal(outs[0], X)
    finally:
        pool.stop()


def test_hedging_slow_primary_fast_secondary():
    replicas = [LocalReplica(_linear_factory(delay=0.8)),
                LocalReplica(_linear_factory())]
    pool = ReplicaPool(replicas, probe_interval=0.2,
                       ready_timeout=60).start()
    try:
        router = Router(pool, hedge_ms=60.0)
        router._rr = 0  # the slow replica is the primary
        t0 = time.monotonic()
        outs, _ = router.infer([X], deadline_ms=10000)
        dt = time.monotonic() - t0
        np.testing.assert_array_equal(outs[0], X)
        assert router.hedges == 1
        assert router.hedge_wins == 1
        assert dt < 0.8  # did not wait out the slow primary
    finally:
        pool.stop()


def test_no_ready_replicas_is_a_shed_not_an_error():
    pool = _local_pool(1, backoff_base=5.0, backoff_cap=5.0)
    try:
        router = Router(pool)
        pool.kill(0)
        _wait(lambda: not pool.ready_members(), 10, "the death verdict")
        with pytest.raises(RequestRejected):
            router.infer([X])
        assert not router.ready()
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# 4. fleet-atomic two-phase reload
# ---------------------------------------------------------------------------

def _assert_version_coherent(seen):
    """Every reply matches its version's generation (scale 1 + version),
    and versions flip once: old, ..., old, new, ..., new."""
    for ver, scale in seen:
        assert np.isclose(scale, 1.0 + ver), (ver, scale)
    vers = [v for v, _ in seen]
    if 1 in vers:
        first = vers.index(1)
        assert all(v == 1 for v in vers[first:]), "mixed-version serving"


def test_fleet_reload_atomic_under_concurrent_traffic(tmp_path):
    prefix = _save_linear_ckpt(tmp_path, scales=(1.0, 2.0))
    pool = ReplicaPool.local(_ckpt_factory(prefix, epoch=0), 3,
                             probe_interval=0.1, ready_timeout=60).start()
    try:
        router = Router(pool)
        one = np.ones((1, 4), np.float32)
        stop = threading.Event()
        seen, errors, lock = [], [], threading.Lock()

        def load():
            while not stop.is_set():
                try:
                    outs, ver = router.infer([one], deadline_ms=3000)
                except ServeError as e:  # collected, then checked
                    errors.append(repr(e))
                    continue
                with lock:
                    seen.append((ver, float(outs[0][0, 0])))

        threads = [threading.Thread(target=load) for _ in range(4)]
        for t in threads:
            t.start()
        _wait(lambda: len(seen) > 10, 30, "traffic before the reload")
        new_version = router.reload(prefix, epoch=1)
        n = len(seen)
        _wait(lambda: len(seen) > n + 10, 30, "traffic after the reload")
        stop.set()
        for t in threads:
            t.join()
        assert new_version == 1 == router.version
        assert not errors, errors[:3]
        _assert_version_coherent(seen)
        assert all(m.version == 1 for m in pool.ready_members())
        assert pool.target == (prefix, 1, "ckpt", 1)
    finally:
        pool.stop()


def test_fleet_reload_prepare_failure_rolls_back(tmp_path):
    prefix = _save_linear_ckpt(tmp_path, scales=(1.0,))
    pool = ReplicaPool.local(_ckpt_factory(prefix, epoch=0), 2,
                             probe_interval=0.2, ready_timeout=60).start()
    try:
        router = Router(pool)
        with pytest.raises(ServeError, match="prepare failed"):
            router.reload(os.path.join(str(tmp_path), "nope"))
        assert router.version == 0
        outs, ver = router.infer([X])
        assert ver == 0
        np.testing.assert_array_equal(outs[0], X)
        for m in pool.ready_members():
            cli = ServeClient(*m.addr)
            assert cli.stats()["engine"]["staged_version"] is None
            cli.close()
    finally:
        pool.stop()


def test_commit_token_exactly_once(tmp_path):
    prefix = _save_linear_ckpt(tmp_path, scales=(1.0, 2.0))
    srv = _ckpt_factory(prefix, epoch=0)()
    try:
        cli = ServeClient("127.0.0.1", srv.port)
        token = (77, 1)
        assert cli.prepare_reload(prefix, epoch=1, version=5,
                                  token=token) == 5
        assert cli.commit_reload(token) == 5
        assert cli.commit_reload(token) == 5  # a retried commit re-acks
        with pytest.raises(ServeError):
            cli.commit_reload((77, 2))  # unknown token, nothing staged
        cli.close()
    finally:
        srv.stop()


def test_kill_during_phase2_no_mixed_versions(tmp_path):
    """One replica dies between its peers' commits: it serves nothing, the
    reload completes, the pool restarts it onto the committed target, and
    no reply carries the stale generation."""
    prefix = _save_linear_ckpt(tmp_path, scales=(1.0, 2.0))
    pool = ReplicaPool.local(_ckpt_factory(prefix, epoch=0), 3,
                             probe_interval=0.1, backoff_base=0.05,
                             backoff_cap=0.5, ready_timeout=60).start()
    try:
        router = Router(pool)
        victim = pool.members()[1]
        fired = []

        def kill_mid_commit(member):
            if member is victim and not fired:
                fired.append(True)
                pool.kill(victim.idx)

        router._commit_hook = kill_mid_commit
        assert router.reload(prefix, epoch=1) == 1 and fired
        for _ in range(12):
            outs, ver = router.infer([np.ones((1, 4), np.float32)],
                                     deadline_ms=5000)
            assert ver == 1 and np.isclose(float(outs[0][0, 0]), 2.0)
        _wait(lambda: victim.state == "ready" and victim.version == 1, 30,
              "the victim's rejoin at the committed version")
        for _ in range(8):
            outs, ver = router.infer([np.ones((1, 4), np.float32)])
            assert ver == 1 and np.isclose(float(outs[0][0, 0]), 2.0)
    finally:
        pool.stop()


# ---------------------------------------------------------------------------
# 5. FleetServer front, shed reasons, lazy connect, later items
# ---------------------------------------------------------------------------

def test_fleet_server_front_stats_and_ready(tmp_path):
    pool = _local_pool(2)
    front = None
    try:
        router = Router(pool, hedge_ms=250.0)
        front = FleetServer(router, port=0)
        front.start()
        cli = ServeClient("127.0.0.1", front.port)
        np.testing.assert_array_equal(cli.infer(X), X)
        assert cli.ready_version() == (True, 0)
        fleet = cli.stats()["batcher"]  # the router mounts the batcher slot
        assert fleet["ready_replicas"] == 2 and fleet["fleet_version"] == 0
        assert set(fleet["replicas"]) == {"0", "1"}
        for rep in fleet["replicas"].values():
            assert rep["state"] == "ready"
            assert rep["breaker"]["state"] == "closed"
        pool.kill(1)
        np.testing.assert_array_equal(cli.infer(X, deadline_ms=5000), X)
        assert cli.stats()["batcher"]["failovers"] >= 1
        # the front's part, its replicas' deduped by pid (one process)
        assert [p["role"] for p in cli.telemetry()["parts"]] == ["fleet"]
        cli.close()
    finally:
        if front is not None:
            front.stop()
        pool.stop()


def test_fleet_server_reload_over_the_wire(tmp_path):
    prefix = _save_linear_ckpt(tmp_path, scales=(1.0, 2.0))
    pool = ReplicaPool.local(_ckpt_factory(prefix, epoch=0), 2,
                             probe_interval=0.1, ready_timeout=60).start()
    front = FleetServer(Router(pool), port=0)
    front.start()
    try:
        cli = ServeClient("127.0.0.1", front.port)
        assert cli.reload(prefix, epoch=1) == 1
        out, ver = cli.infer(X, return_version=True)
        assert ver == 1
        np.testing.assert_array_equal(out, 2 * X)
        cli.close()
    finally:
        front.stop()
        pool.stop()


def test_shed_by_reason_counters():
    class SlowEngine:
        max_batch_size = 4
        buckets = [1, 2, 4]

        def infer(self, inputs, n_valid=None):
            time.sleep(0.2)
            return [np.asarray(inputs[0]) * 2.0], 0

    b = DynamicBatcher(SlowEngine(), max_queue=1, max_linger_ms=0.0)
    try:
        one = np.ones((1, 4), np.float32)
        with pytest.raises(DeadlineExceeded):
            b.submit(one, deadline_ms=1e-9)  # dead on arrival
        b.submit(one)  # occupies the worker
        _wait(lambda: b.queue_depth() == 0, 5, "the worker to take it")
        b.submit(one)  # fills the queue (watermark 1)
        with pytest.raises(RequestRejected):
            b.submit(one)
        b.drain(timeout=10)
        with pytest.raises(Draining):
            b.submit(one)
        reasons = b.stats()["shed_by_reason"]
        assert reasons["deadline"] >= 1
        assert reasons["queue_full"] >= 1
        assert reasons["draining"] >= 1
    finally:
        b.close(timeout=5)


def test_client_lazy_connect_is_nonfatal():
    cli = ServeClient("127.0.0.1", 1, timeout=0.5, retries=2,
                      retry_interval=0.01)
    assert not cli.health()
    cli.close()


def test_sharded_pool_and_telemetry_name_their_items(tmp_path):
    # a sharded pool's factory runs in every rank of a group: a closure
    # cannot reach them
    with pytest.raises(MXNetError, match="picklable"):
        ReplicaPool.sharded(lambda sub: None, groups=2)
    pool = _local_pool(1)
    try:
        with pytest.raises(ServeError, match="not a sharded pool"):
            pool.new_sharded_handle()
        assert pool.spare_slices == 0
        assert pool.stats()["spare_slices"] == 0
        parts = Router(pool).collect_telemetry()  # ported: one part
        assert [p["role"] for p in parts] == ["replica0"]
    finally:
        pool.stop()
    prefix = _save_linear_ckpt(tmp_path)
    ProcReplica(prefix, obs_dir=str(tmp_path))  # ported: no raise
    # ported: the child's program cache is pinned, restarts included
    rep = ProcReplica(prefix, progcache_dir=str(tmp_path))
    assert rep._progcache_dir == str(tmp_path)
    for kw in ({"env": {"MXNET_CHAOS_KILL_REPLICA0": "serve:post_recv@1"}},):
        with pytest.raises(MXNetError, match="A15"):
            ProcReplica(prefix, **kw)


# ---------------------------------------------------------------------------
# 6. a subprocess replica on the CPU, killed with SIGKILL
# ---------------------------------------------------------------------------

def test_proc_replica_sigkill_fails_over_within_deadline(tmp_path):
    prefix = _save_linear_ckpt(tmp_path, scales=(1.0,))
    log = os.path.join(str(tmp_path), "child.log")
    replicas = [ProcReplica(prefix, env={"MXNET_SERVE_PLATFORM": "cpu"},
                            log_path=log),
                LocalReplica(_ckpt_factory(prefix, epoch=0))]
    pool = ReplicaPool(replicas, probe_interval=2.0, backoff_base=0.1,
                       backoff_cap=1.0, ready_timeout=120).start()
    try:
        assert len(pool.ready_members()) == 2, open(log).read()[-2000:]
        router = Router(pool, breaker_cooldown=0.3)
        router._rr = 0
        outs, _ = router.infer([X], deadline_ms=20000)  # the child answers
        np.testing.assert_array_equal(outs[0], X)
        assert pool.members()[0].rpcs == 1
        child = replicas[0].proc.pid
        pool.kill(0)  # a real SIGKILL
        assert replicas[0].proc.wait(timeout=30) == -9
        t0 = time.monotonic()
        deadline_ms = 20000.0
        for _ in range(4):
            outs, _ = router.infer([X], deadline_ms=deadline_ms)
            np.testing.assert_array_equal(outs[0], X)
        assert (time.monotonic() - t0) * 1e3 < deadline_ms
        assert router.failovers >= 1
        m0 = pool.members()[0]
        _wait(lambda: m0.restarts >= 1 and m0.state == "ready", 120,
              "the child's restart")
        assert replicas[0].proc.pid != child
    finally:
        pool.stop()
    assert not replicas[0].alive()


# ---------------------------------------------------------------------------
# 7. the two packages behind one another's routers
# ---------------------------------------------------------------------------

def _mixed_checkpoints(tmp_path):
    """Two generations of one MLP, written by the port's save_checkpoint
    (the .params bytes are the reference's)."""
    prefix = os.path.join(str(tmp_path), "mlp")
    rng = np.random.RandomState(0)
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=3, name="fc2")
    for epoch in (0, 1):
        arg = {"fc1_weight": rng.randn(8, 5).astype(np.float32),
               "fc1_bias": rng.randn(8).astype(np.float32),
               "fc2_weight": rng.randn(3, 8).astype(np.float32),
               "fc2_bias": rng.randn(3).astype(np.float32)}
        save_checkpoint(prefix, epoch, net,
                        {k: nd.array(v) for k, v in arg.items()}, {})
    return prefix


def _port_server(prefix):
    def factory():
        eng = serve.load(prefix, epoch=0, max_batch_size=4, lint="off",
                         ctx=tmx.cpu())
        srv = ServeServer(eng, port=0, max_linger_ms=0.0)
        srv.start()
        return srv
    return factory


def _ref_server(prefix):
    from mxnet_tpu import serve as jserve

    def factory():
        eng = jserve.load(prefix, epoch=0, max_batch_size=4, lint="off")
        srv = jserve.ServeServer(eng, port=0, max_linger_ms=0.0)
        srv.start()
        return srv
    return factory


def _drive(router, xs, prefix):
    """Three replies, a fleet reload, three more: [(version, output)]."""
    out = []
    for i, x in enumerate(xs):
        if i == len(xs) // 2:
            assert router.reload(prefix, epoch=1) == 1
        outs, ver = router.infer([x], deadline_ms=30000)
        out.append((ver, outs[0]))
    return out


def _expected(prefix, xs):
    """The port engine's outputs of both generations, in process."""
    eng = serve.load(prefix, epoch=0, max_batch_size=4, lint="off",
                     ctx=tmx.cpu())
    want = {0: [eng.predict(x) for x in xs]}
    eng.reload(*serve.load_params(prefix, epoch=1))
    want[1] = [eng.predict(x) for x in xs]
    return want


def _check_mixed(got, want):
    assert [v for v, _ in got] == [0, 0, 0, 1, 1, 1]
    for i, (ver, out) in enumerate(got):
        np.testing.assert_allclose(out, want[ver][i], rtol=1e-5, atol=1e-6)


_XS = [np.random.RandomState(i).rand(n, 5).astype(np.float32)
       for i, n in enumerate((1, 3, 2, 4, 1, 2))]


def test_reference_router_over_port_replicas(tmp_path):
    from mxnet_tpu.serve import fleet as jfleet

    prefix = _mixed_checkpoints(tmp_path)
    want = _expected(prefix, _XS)
    pool = jfleet.ReplicaPool([jfleet.LocalReplica(_port_server(prefix))
                               for _ in range(2)], probe_interval=0.1,
                              ready_timeout=60).start()
    try:
        router = jfleet.Router(pool)
        got = _drive(router, _XS, prefix)
        assert all(m.version == 1 for m in pool.ready_members())
        pool.kill(0)  # the reference's router fails over between ports
        outs, ver = router.infer([_XS[0]], deadline_ms=30000)
        assert ver == 1
        np.testing.assert_allclose(outs[0], want[1][0], rtol=1e-5,
                                   atol=1e-6)
    finally:
        pool.stop()
    _check_mixed(got, want)


def test_port_router_over_reference_replicas(tmp_path):
    prefix = _mixed_checkpoints(tmp_path)
    want = _expected(prefix, _XS)
    pool = ReplicaPool([LocalReplica(_ref_server(prefix)) for _ in range(2)],
                       probe_interval=0.1, ready_timeout=60).start()
    try:
        router = Router(pool)
        got = _drive(router, _XS, prefix)
        assert all(m.version == 1 for m in pool.ready_members())
    finally:
        pool.stop()
    _check_mixed(got, want)


def test_port_front_and_reference_front_agree(tmp_path):
    """The same requests through a port FleetServer (port replicas) and a
    reference FleetServer (reference replicas), read by one client: equal
    replies and version stamps through a reload over the wire."""
    from mxnet_tpu.serve import fleet as jfleet

    prefix = _mixed_checkpoints(tmp_path)
    fronts, pools = [], []
    try:
        for fl, factory in ((jfleet, _ref_server(prefix)),
                            (__import__("mxnet_tpu_torch.serve.fleet",
                                        fromlist=["x"]),
                             _port_server(prefix))):
            pool = fl.ReplicaPool([fl.LocalReplica(factory)
                                   for _ in range(2)], probe_interval=0.1,
                                  ready_timeout=60).start()
            pools.append(pool)
            front = fl.FleetServer(fl.Router(pool), port=0)
            front.start()
            fronts.append(front)
        seqs = []
        for front in fronts:
            cli = ServeClient("127.0.0.1", front.port)
            seq = []
            for i, x in enumerate(_XS):
                if i == len(_XS) // 2:
                    assert cli.reload(prefix, epoch=1) == 1
                seq.append(cli.infer(x, return_version=True))
            cli.close()
            seqs.append(seq)
    finally:
        for f in fronts:
            f.stop()
        for p in pools:
            p.stop()
    (ref, port) = seqs
    assert [v for _, v in ref] == [v for _, v in port] == [0, 0, 0, 1, 1, 1]
    for (a, _), (b, _) in zip(ref, port):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# 8. streams through a fleet front
# ---------------------------------------------------------------------------

_DECODE = dict(slots=4, page_size=8, num_pages=16, prompt_buckets=[8, 16])


@pytest.fixture(scope="module")
def ref_lm():
    import mxnet_tpu as jmx
    from mxnet_tpu.models import transformer as jt

    jmx.random.seed(20261017)
    lm = jt.transformer_lm(vocab_size=97, units=32, hidden_size=64,
                           num_layers=2, num_heads=4, max_length=64,
                           dropout=0.0)
    lm.initialize()
    lm(jmx.nd.zeros((1, 8)))
    return lm, jt.decode_config(lm), jt.decode_params(lm)


def test_fleet_streams_equal_reference_tokens_and_leak_no_page(ref_lm):
    from mxnet_tpu import serve as jserve
    from mxnet_tpu_torch.models.transformer import from_numpy_params

    lm, cfg, params = ref_lm
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 7 % 97
               for n in (3, 9, 13, 5)]
    jeng = jserve.DecodeEngine(lm, **_DECODE)
    jsched = jserve.DecodeScheduler(jeng, max_new_tokens=5)
    want = [list(jsched.generate(p, max_new_tokens=5)) for p in prompts]
    jsched.close()

    def factory():
        net = from_numpy_params(cfg, params, device="cpu")
        eng = serve.DecodeEngine(net, device="cpu", **_DECODE)
        eng.warmup()
        srv = ServeServer(decode=serve.DecodeScheduler(eng,
                                                       max_new_tokens=5),
                          port=0)
        srv.start()
        return srv

    pool = ReplicaPool.local(factory, 2, probe_interval=5.0,
                             ready_timeout=60).start()
    front = FleetServer(Router(pool), port=0)
    front.start()
    try:
        got = [None] * len(prompts)

        def stream(i):
            cli = ServeClient("127.0.0.1", front.port)
            got[i] = list(cli.generate(prompts[i], max_new_tokens=5))
            cli.close()

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert got == want
        # a replica killed while still listed ready: the next streams fail
        # over to its peer before any token is sent
        router = front._router
        pool.kill(0)
        router._rr = 0
        before = router.failovers
        cli = ServeClient("127.0.0.1", front.port)
        for p, w in zip(prompts[:2], want[:2]):
            assert list(cli.generate(p, max_new_tokens=5)) == w
        # a client that hangs up mid-stream: the relay closes the
        # replica's stream and its pages come back
        gen = cli.generate(prompts[2], max_new_tokens=5)
        next(gen)
        gen.close()
        cli.close()
        assert router.failovers > before
        live = pool.members()[1].handle.server._decode.engine
        _wait(lambda: live.pool.used() == 0, 30, "the pages to come back")
    finally:
        front.stop()
        pool.stop()
    live.pool.assert_baseline()


def test_server_cli_platform_pin_and_later_flags(monkeypatch, tmp_path):
    from mxnet_tpu_torch.serve import server as tsrv

    monkeypatch.setenv("MXNET_SERVE_PLATFORM", "cpu")
    assert tsrv._serve_context() == tmx.cpu()
    monkeypatch.setenv("MXNET_SERVE_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        tsrv._serve_context()
    # --progcache-dir arms the process-global cache (no longer a raise);
    # the missing artifact is what stops this server
    from mxnet_tpu_torch import progcache

    d = os.path.join(str(tmp_path), "programs")
    monkeypatch.setenv("MXNET_SERVE_PLATFORM", "cpu")
    monkeypatch.setenv("MXNET_PROGCACHE_DIR", "")
    monkeypatch.delenv("MXNET_PROGCACHE", raising=False)
    try:
        with pytest.raises(ServeError, match="nowhere"):
            tsrv.main(["/nowhere/model", "--progcache-dir", d])
        assert progcache.cache().root == d and os.path.isdir(d)
    finally:
        progcache.reset()


def _session_pids(sid):
    """The live processes of session ``sid``."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    fields = f.read().rpartition(")")[2].split()
            except OSError:
                continue
            if int(fields[3]) == sid and fields[0] not in ("Z", "X"):
                out.append(int(d))
    return out


def test_server_cli_tp2_serves_and_its_kill_reaches_every_rank(tmp_path):
    """``python -m mxnet_tpu_torch.serve.server <ckpt> --tp 2`` outside a
    job starts its own second rank; its replies equal the unsharded
    engine's (the CLI replicates the parameters), and the replica's kill
    reaches both ranks."""
    prefix = _mixed_checkpoints(tmp_path)
    log = os.path.join(str(tmp_path), "tp.log")
    rep = ProcReplica(prefix, args=["--tp", "2", "--epoch", "0",
                                    "--max-batch-size", "4"],
                      env={"MXNET_SERVE_PLATFORM": "cpu",
                           "OMP_NUM_THREADS": "1"}, log_path=log)
    pool = ReplicaPool([rep], probe_interval=0.2, backoff_base=0.1,
                       ready_timeout=120).start()
    x = np.random.RandomState(4).rand(3, 5).astype(np.float32)
    try:
        assert len(pool.ready_members()) == 1, open(log).read()[-2000:]
        assert len(_session_pids(rep.proc.pid)) == 2
        cli = ServeClient(*pool.members()[0].addr)
        try:
            got = np.asarray(cli.infer(x))
            stats = cli.stats(include_metrics=False)["engine"]
        finally:
            cli.close()
        want = serve.load(prefix, epoch=0, max_batch_size=4, lint="off",
                          ctx=tmx.cpu()).predict(x)
        np.testing.assert_array_equal(got, want)
        assert stats["mesh"] == {"tp": 2} and stats["mesh_devices"] == 2
        sid = rep.proc.pid
        pool.kill(0)
        _wait(lambda: not _session_pids(sid), 30, "both ranks' death")
    finally:
        pool.stop()
