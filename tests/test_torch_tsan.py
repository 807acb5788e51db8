"""The port's lock-order sanitizer and stall watchdog
(``mxnet_tpu_torch/tsan.py``) against the reference's: the cases of
``tests/test_tsan.py`` run on the port, a seeded inversion gives the same
violation records in both packages, and the port's batcher, router and
PS server run sanitized with no violation."""
import socket
import threading
import time

import numpy as np
import pytest

from mxnet_tpu import tsan as jtsan
from mxnet_tpu_torch import tsan


@pytest.fixture(autouse=True)
def _clean_state():
    for t in (tsan, jtsan):
        t.reset()
        t.set_strict(False)
    yield
    for t in (tsan, jtsan):
        t.disarm_watchdog()
        t.reset()
        t.set_strict(False)


# ---------------------------------------------------------------------------
# lock-order cycle detection
# ---------------------------------------------------------------------------

def test_seeded_inversion_detected():
    a, b = tsan.SanLock("A"), tsan.SanLock("B")
    with a:
        with b:
            pass
    with b:
        with a:  # closes B -> A on top of the recorded A -> B
            pass
    viols = tsan.violations()
    assert len(viols) == 1
    assert viols[0]["cycle"][0] == viols[0]["cycle"][-1]
    assert set(viols[0]["cycle"]) == {"A", "B"}


def test_seeded_inversion_raises_in_strict_mode():
    tsan.set_strict(True)
    a, b = tsan.SanLock("A"), tsan.SanLock("B")
    with a:
        with b:
            pass
    with pytest.raises(tsan.LockOrderViolation, match="A"):
        with b:
            with a:
                pass


def test_repeat_inversion_keeps_raising_in_strict_mode():
    # the first offender may be a daemon thread whose raise nobody saw —
    # a REPEAT of the same bad ordering must raise again
    tsan.set_strict(True)
    a, b = tsan.SanLock("A"), tsan.SanLock("B")
    with a:
        with b:
            pass
    for _ in range(2):
        with pytest.raises(tsan.LockOrderViolation):
            with b:
                with a:
                    pass


def test_consistent_order_is_clean():
    a, b = tsan.SanLock("A"), tsan.SanLock("B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert not tsan.violations()


def test_rlock_reentrancy_is_not_a_violation():
    r = tsan.SanRLock("R")
    with r:
        with r:
            with r:
                pass
    assert not tsan.violations()
    assert r._depth == 0 and r._owner is None  # fully released


def test_three_lock_cycle_detected():
    a, b, c = (tsan.SanLock(n) for n in "ABC")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    with c:
        with a:
            pass
    viols = tsan.violations()
    assert viols and set(viols[0]["cycle"]) == {"A", "B", "C"}


def test_condition_wait_notify_roundtrip():
    cv = tsan.SanCondition("CV")
    state = []

    def waiter():
        with cv:
            while not state:
                cv.wait(timeout=5)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        state.append(1)
        cv.notify_all()
    t.join(timeout=5)
    assert not t.is_alive() and not tsan.violations()


# ---------------------------------------------------------------------------
# deadlock watchdog
# ---------------------------------------------------------------------------

def test_watchdog_names_lock_held_across_blocked_socket_read():
    # the seeded blocked-under-lock socket read, caught at runtime: a
    # thread blocks in recv() while holding a tracked lock; the watchdog
    # dump attributes the held lock and shows recv in the stack
    lk = tsan.SanLock("WIRE_LOCK")
    a_sock, b_sock = socket.socketpair()
    dumps = []
    wd = tsan.Watchdog(stall_s=0.25, interval=0.05, sink=dumps.append)
    wd.start()

    def reader():
        with lk:
            try:
                a_sock.recv(1)  # nothing ever sent: stalls under the lock
            except OSError:
                pass

    t = threading.Thread(target=reader, name="wire-reader")
    t.start()
    deadline = time.monotonic() + 5
    while not dumps and time.monotonic() < deadline:
        time.sleep(0.05)
    b_sock.send(b"x")  # unblock
    t.join(timeout=5)
    wd.stop()
    a_sock.close()
    b_sock.close()
    assert dumps, "watchdog produced no stall dump"
    text = dumps[0]
    assert "HOLDS WIRE_LOCK" in text
    assert "wire-reader" in text
    assert "recv" in text


def test_watchdog_dumps_stalled_condition_wait_with_held_lock():
    held = tsan.SanLock("HELD_ELSEWHERE")
    cv = tsan.SanCondition("STALLED_CV")
    released = []
    dumps = []
    wd = tsan.Watchdog(stall_s=0.25, interval=0.05, sink=dumps.append)
    wd.start()

    def waiter():
        with held:
            with cv:
                while not released:
                    cv.wait(timeout=10)

    t = threading.Thread(target=waiter, name="stalled-waiter")
    t.start()
    deadline = time.monotonic() + 5
    while not dumps and time.monotonic() < deadline:
        time.sleep(0.05)
    with cv:
        released.append(1)
        cv.notify_all()
    t.join(timeout=5)
    wd.stop()
    assert dumps, "watchdog produced no stall dump"
    text = dumps[0]
    assert "WAITING on condition STALLED_CV" in text
    assert "HOLDS HELD_ELSEWHERE" in text


def test_manual_dump_runs_without_tracked_state():
    text = tsan.dump_stacks("unit-test")
    assert "watchdog stack dump" in text and "MainThread" in text


# ---------------------------------------------------------------------------
# factories + plane integration
# ---------------------------------------------------------------------------

def test_factories_plain_when_disabled(monkeypatch):
    monkeypatch.delenv("MXNET_TSAN", raising=False)
    assert type(tsan.lock("x")) is type(threading.Lock())
    assert not isinstance(tsan.condition("x"), tsan.SanCondition)


def test_factories_instrumented_when_enabled(monkeypatch):
    monkeypatch.setenv("MXNET_TSAN", "1")
    monkeypatch.setenv("MXNET_TSAN_STALL_S", "0")  # no auto-watchdog in test
    assert isinstance(tsan.lock("x"), tsan.SanLock)
    assert isinstance(tsan.rlock("x"), tsan.SanRLock)
    assert isinstance(tsan.condition("x"), tsan.SanCondition)


def test_batcher_runs_sanitized(monkeypatch):
    # the serve plane creates its primitives through the factories: under
    # MXNET_TSAN=1 a real submit/execute/drain cycle runs on instrumented
    # locks and records no ordering violations
    monkeypatch.setenv("MXNET_TSAN", "1")
    monkeypatch.setenv("MXNET_TSAN_STALL_S", "0")
    import numpy as np

    from mxnet_tpu_torch.serve.batcher import DynamicBatcher

    class _Engine:
        max_batch_size = 8

        def infer(self, inputs, n_valid=None):
            return [np.asarray(inputs[0]) * 2], 1

    b = DynamicBatcher(_Engine(), max_linger_ms=0.0)
    assert isinstance(b._cv, tsan.SanCondition)
    futs = [b.submit([np.ones((1, 2), np.float32)]) for _ in range(8)]
    for f in futs:
        outs, version = f.result(timeout=10)
        assert version == 1 and outs[0].shape == (1, 2)
    b.close()
    assert b.stopped_clean is True
    assert not tsan.violations()


def test_batcher_stats_expose_stopped_clean():
    import numpy as np

    from mxnet_tpu_torch.serve.batcher import DynamicBatcher

    class _Engine:
        max_batch_size = 4

        def infer(self, inputs, n_valid=None):
            return [np.asarray(inputs[0])], 1

    b = DynamicBatcher(_Engine(), max_linger_ms=0.0)
    assert b.stats()["stopped_clean"] is None  # not closed yet
    b.close()
    assert b.stats()["stopped_clean"] is True


# ---------------------------------------------------------------------------
# parity with the reference, and the port's planes sanitized
# ---------------------------------------------------------------------------

def _records(t, strict):
    """A seeded two-lock inversion and a three-lock cycle through ``t``."""
    t.set_strict(strict)
    a, b, c = (t.SanLock(n) for n in ("ps.global", "ps.key", "ps.seq"))
    raised = []
    with a:
        with b:
            pass
    try:
        with b:
            with a:
                pass
    except t.LockOrderViolation as e:
        raised.append(str(e).splitlines()[0])
    t.set_strict(False)
    with b:
        with c:
            pass
    with c:
        with a:  # c -> a closes a -> b -> c
            pass
    return ([(v["cycle"], v["holding"], v["acquiring"])
             for v in t.violations()], raised)


@pytest.mark.parametrize("strict", [False, True])
def test_seeded_inversion_records_equal_the_reference(strict):
    mine = _records(tsan, strict)
    ref = _records(jtsan, strict)
    assert mine == ref
    assert mine[0][0] == (["ps.global", "ps.key", "ps.global"], "ps.key",
                          "ps.global")
    assert bool(mine[1]) is strict


def test_rlock_condition_roundtrip_matches_the_reference():
    """An RLock re-entered under a condition wait, in both packages: the
    same (empty) violation log and the same released state."""
    for t in (tsan, jtsan):
        r = t.SanRLock("R")
        cv = t.SanCondition("CV", lock=r)
        with r:
            with cv:
                cv.wait(timeout=0.01)
        assert r._owner is None and r._depth == 0
        assert t.violations() == []


def test_router_runs_sanitized(monkeypatch):
    """A two-replica router over CPU engines, every lock instrumented
    (breakers, pool, connection pool, router, batchers, servers): a kill,
    a failover and a restart record no ordering violation."""
    monkeypatch.setenv("MXNET_TSAN", "1")
    monkeypatch.setenv("MXNET_TSAN_STALL_S", "0")
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import serve, symbol as sym
    from mxnet_tpu_torch.serve import ServeServer
    from mxnet_tpu_torch.serve.fleet import ReplicaPool, Router

    def factory():
        with tmx.cpu():
            net = sym.FullyConnected(sym.Variable("data"), num_hidden=4,
                                     no_bias=True, name="fc")
            engine = serve.InferenceEngine(
                net, {"fc_weight": np.eye(4, dtype=np.float32)},
                max_batch_size=8, lint="off", ctx=tmx.cpu())
        srv = ServeServer(engine, port=0, max_linger_ms=0.0)
        srv.start()
        return srv

    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    pool = ReplicaPool.local(factory, 2, probe_interval=0.1,
                             backoff_base=0.05, backoff_cap=0.5,
                             ready_timeout=60.0).start()
    try:
        router = Router(pool, breaker_cooldown=0.2)
        assert isinstance(router._lock, tsan.SanLock)
        assert isinstance(pool._lock, tsan.SanRLock)
        for _ in range(4):
            np.testing.assert_array_equal(router.infer([x])[0][0], x)
        pool.kill(0)
        for _ in range(4):
            np.testing.assert_array_equal(
                router.infer([x], deadline_ms=5000)[0][0], x)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                len(pool.ready_members()) < 2:
            time.sleep(0.05)
        assert len(pool.ready_members()) == 2
    finally:
        pool.stop()
    assert tsan.violations() == []


def test_ps_server_runs_sanitized(monkeypatch):
    """The PS server's global, per-key, seq, barrier and telemetry locks
    instrumented through a push/pull/barrier session: no violation."""
    monkeypatch.setenv("MXNET_TSAN", "1")
    monkeypatch.setenv("MXNET_TSAN_STALL_S", "0")
    from mxnet_tpu_torch.kvstore.ps_client import PSClient
    from mxnet_tpu_torch.kvstore.ps_server import PSServer

    srv = PSServer(host="127.0.0.1", port=0, num_workers=1)
    srv.start()
    try:
        assert isinstance(srv._global_lock, tsan.SanLock)
        assert isinstance(srv._barrier_cv, tsan.SanCondition)
        cli = PSClient("127.0.0.1", srv.port, timeout=5)
        cli.init("w", np.zeros(4, np.float32))
        for i in range(3):
            cli.push("w", np.full(4, float(i + 1), np.float32))
        cli.barrier(timeout=10.0)
        np.testing.assert_array_equal(cli.pull("w"),
                                      np.full(4, 6.0, np.float32))
        assert isinstance(srv._locks["w"], tsan.SanLock)
    finally:
        srv.stop()
    assert tsan.violations() == []
