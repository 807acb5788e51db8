"""The elastic plane of the port (mxnet_tpu_torch.kvstore.elastic, the
PSServer's membership, barrier, snapshot and WAL paths) through the
in-process cases of the JAX package's ``tests/test_elastic.py``, on the
CPU, plus its worker-death flagship (slow, subprocesses).

Each case runs the port's server, sessions and state machine as the
reference's test runs its own, with the same known values and time bounds:

1. membership: cold-start joins are active, later joins quarantined until
   the next epoch boundary; K missed heartbeats declare a worker dead and
   bump the generation;
2. generation-scoped collectives: a dead rank releases barriers, reduce
   rounds and epoch rendezvous over the survivors; a stale member's push
   is rejected; retries are idempotent;
3. PS durability: snapshots and the push WAL make exactly-once survive a
   restart;
4. bounded staleness and hierarchical reduction (``tests/test_async.py``'s
   in-process cases): clocks max-merge and survive a restart, the gate
   admits, blocks, times out at its bound and releases, scoped rounds and
   the group tree sum exactly;
5. the flagship (slow): SIGKILL 1 of 3 elastic ``dist_sync`` workers
   mid-epoch: the survivors finish over recut shards, the worker rejoins
   at the next boundary from the shared checkpoint, and the final loss is
   within the reference's tolerance (0.25x) of a clean run.
"""
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.kvstore import elastic as el
from mxnet_tpu_torch.kvstore import ps_client as tpc
from mxnet_tpu_torch.kvstore.elastic import ElasticState, ElasticWorkerSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a 1 s liveness window, as the reference's: heartbeats every 0.2 s
_HB, _MISS = 0.2, 5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _server(**kw):
    from mxnet_tpu_torch.kvstore.ps_server import PSServer

    kw.setdefault("host", "127.0.0.1")
    kw.setdefault("port", 0)
    kw.setdefault("hb_interval", _HB)
    kw.setdefault("miss_k", _MISS)
    srv = PSServer(**kw)
    srv.start()
    return srv


def _session(srv, rank, **kw):
    kw.setdefault("hb_interval", _HB)
    return ElasticWorkerSession("127.0.0.1", srv.port, rank=rank, **kw)


def test_cold_start_joins_active_then_quarantined():
    st = ElasticState(hb_interval=0.05, miss_k=3)
    assert st.join(1, 0)[0] == "active"
    assert st.join(2, 1)[0] == "active"
    # any reduce marks the fleet as started → later joins quarantine
    st.reduce(1, "g", 0, np.zeros(1, np.float32), timeout=0.01)
    assert st.join(3, 2)[0] == "quarantined"
    st.close()


def test_missed_heartbeats_declare_dead_and_bump_generation():
    st = ElasticState(hb_interval=0.05, miss_k=2)
    st.join(1, 0)
    st.join(2, 1)
    gen0 = st.generation
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        st.heartbeat(1)  # keep member 1 alive; member 2 goes silent
        with st.cv:
            if st.members[2].state == "dead":
                break
        time.sleep(0.02)
    with st.cv:
        assert st.members[2].state == "dead"
        assert st.members[1].state == "active"
        assert st.active_count() == 1
    assert st.generation > gen0
    st.close()


def test_rejoin_quarantined_then_activated_with_recut_assignment():
    srv = _server()
    s1 = _session(srv, rank=0)
    s1.ensure_joined()
    # training started → a (re)joiner is quarantined mid-epoch
    out, n = s1.allreduce("g", np.ones(2, np.float32))
    assert n == 1
    s2 = _session(srv, rank=1)
    info2 = s2.ensure_joined()
    assert not info2.active
    got = {}
    t = threading.Thread(
        target=lambda: got.update(info=s2.await_activation(timeout=30)))
    t.start()
    time.sleep(0.2)
    info1 = s1.epoch_end(0)  # the boundary activates the joiner
    t.join(timeout=30)
    assert not t.is_alive()
    assert got["info"].active and got["info"].num_parts == 2
    assert info1.num_parts == 2 and info1.changed
    assert {info1.part_index, got["info"].part_index} == {0, 1}
    assert got["info"].generation == info1.generation  # committed generation
    s1.close()
    s2.close()
    srv.stop()


def test_stale_member_push_rejected():
    """A zombie (declared dead after missed heartbeats but still running)
    must get a structured stale rejection, not silently mix its gradient
    into the live generation."""
    srv = _server()
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined()
    s2.ensure_joined()
    s2._hb.stop()  # zombie: alive but silent
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        with srv._elastic.cv:
            if srv._elastic.members[s2.cid].state == "dead":
                break
        time.sleep(0.05)
    with pytest.raises(el.StaleMemberError):
        s2.allreduce("g", np.ones(2, np.float32))
    s1.close()
    srv.stop()


# ---------------------------------------------------------------------------
# generation-scoped collectives released over survivors
# ---------------------------------------------------------------------------

def test_dead_rank_releases_reduce_over_survivors():
    srv = _server()
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined(wait_for_expected=False)
    s2.ensure_joined(wait_for_expected=False)
    # one full round with both, so requirement is {s1, s2}
    res = {}
    for name, s, v in (("a", s1, 1.0), ("b", s2, 2.0)):
        threading.Thread(
            target=lambda s=s, name=name, v=v: res.update(
                {name: s.allreduce("g", np.full(2, v, np.float32))})
        ).start()
    deadline = time.monotonic() + 10
    while len(res) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert np.allclose(res["a"][0], 3.0) and res["a"][1] == 2
    # kill s2 (heartbeats stop = SIGKILL to the server's eyes)
    s2._hb.stop()
    t0 = time.monotonic()
    out, n = s1.allreduce("g", np.full(2, 5.0, np.float32), timeout=30)
    dt = time.monotonic() - t0
    assert n == 1 and np.allclose(out, 5.0)
    assert dt < 10, f"release took {dt:.1f}s — timed out, not released"
    s1.close()
    srv.stop()


def test_dead_rank_releases_barrier_without_timeout():
    srv = _server(barrier_timeout=60.0)
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined(wait_for_expected=False)
    s2.ensure_joined(wait_for_expected=False)
    s2._hb.stop()
    t0 = time.monotonic()
    s1.barrier(timeout=30.0)  # must release well under barrier_timeout
    assert time.monotonic() - t0 < 10
    s1.close()
    srv.stop()


def test_dead_rank_releases_epoch_rendezvous():
    srv = _server()
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined(wait_for_expected=False)
    s2.ensure_joined(wait_for_expected=False)
    res = {}
    ts = [threading.Thread(
        target=lambda s=s, n=n: res.update(
            {n: s.allreduce("g", np.ones(1, np.float32), timeout=30)}))
        for n, s in (("a", s1), ("b", s2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert res["a"][1] == 2  # both contributed → fleet is "started"
    s2._hb.stop()  # dies while s1 waits at the boundary
    info = s1.epoch_end(0, timeout=30)
    assert info.num_parts == 1 and info.part_index == 0
    s1.close()
    srv.stop()


def test_reduce_retry_idempotent_under_dropped_reply(monkeypatch):
    """A lost reduce ack retries the SAME (cid, round): the server must
    serve the cached released round, not fold the contribution twice.
    (The reference drops the reply with its chaos plane, queue item A15 of
    the port; here the client's first reduce receive fails instead.)"""
    srv = _server()
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined(wait_for_expected=False)
    s2.ensure_joined(wait_for_expected=False)
    real_recv, dropped = tpc._recv_msg, []

    def lossy_recv(sock):
        reply = real_recv(sock)
        if reply[0] == el.OP_REDUCE and not dropped:
            dropped.append(reply)
            raise ConnectionError("reply dropped")
        return reply

    monkeypatch.setattr(tpc, "_recv_msg", lossy_recv)
    res = {}
    ts = [threading.Thread(
        target=lambda s=s, name=name, v=v: res.update(
            {name: s.allreduce("g", np.full(3, v, np.float32),
                               timeout=30)}))
        for name, s, v in (("a", s1, 1.0), ("b", s2, 2.0))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert dropped
    assert np.allclose(res["a"][0], 3.0) and np.allclose(res["b"][0], 3.0)
    assert res["a"][1] == 2 and res["b"][1] == 2
    s1.close()
    s2.close()
    srv.stop()


def test_reduce_sums_exact_when_many_ranks_share_the_reply():
    """More ranks than cores reduce at once under a short switch interval:
    every round's sum is exact for every rank. The server answers each
    contributor from the one released array (no copy), and each rank's
    request and result ride views of its own buffers."""
    n, size, rounds = 12, 1 << 16, 4
    srv = _server()
    ss = [_session(srv, rank=r) for r in range(n)]
    for s in ss:
        s.ensure_joined(wait_for_expected=False)
    want = [float(sum(r + 1 + k for r in range(n))) for k in range(rounds)]
    bad, errors = [], []

    def rank_loop(r):
        try:
            for k in range(rounds):
                got, count = ss[r].allreduce(
                    "g", np.full(size, r + 1 + k, np.float32), timeout=60)
                if count != n or not (got == want[k]).all():
                    bad.append((r, k, count))
                got[:] = -1.0  # the caller owns its result
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=rank_loop, args=(r,), daemon=True)
              for r in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        for s in ss:
            s.close()
        srv.stop()
    assert not errors, errors
    assert not bad, bad


# ---------------------------------------------------------------------------
# structured barrier timeout (satellite)
# ---------------------------------------------------------------------------

def test_barrier_timeout_names_missing_ranks():
    srv = _server(barrier_timeout=1.0)
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined(wait_for_expected=False)
    s2.ensure_joined(wait_for_expected=False)
    # s2 is alive and heartbeating but never arrives at the barrier
    with pytest.raises(TimeoutError) as ei:
        s1.barrier(timeout=20.0)
    msg = str(ei.value)
    assert "rank 1" in msg and "last heartbeat" in msg, msg
    assert "1/2 arrived" in msg, msg
    s1.close()
    s2.close()
    srv.stop()


def test_barrier_timeout_detail_without_membership_reports_counts():
    """Legacy fleets (no heartbeats) can't name ranks — the structured
    error still reports arrived/expected instead of a generic shrug."""
    from mxnet_tpu_torch.kvstore.ps_client import PSClient

    srv = _server(num_workers=2, barrier_timeout=0.5)
    cli = PSClient("127.0.0.1", srv.port, timeout=5, retries=1)
    with pytest.raises(TimeoutError) as ei:
        cli.barrier(timeout=10.0)
    assert "1/2 arrived" in str(ei.value), str(ei.value)
    srv.stop()


# ---------------------------------------------------------------------------
# PS durability: snapshots + WAL (satellite / acceptance)
# ---------------------------------------------------------------------------

def test_ps_warm_restart_restores_weights_seq_and_optimizer(tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kvstore.ps_client import PSClient
    from mxnet_tpu_torch.kvstore.ps_server import (OP_PUSH_SEQ, PSServer,
                                             _pack_array)

    srv = PSServer(host="127.0.0.1", port=0, snapshot_dir=str(tmp_path),
                   snapshot_period=0)
    srv.start()
    cli = PSClient("127.0.0.1", srv.port, timeout=5, retries=3,
                   retry_interval=0.05)
    cli.init("w", np.ones(4, np.float32))
    cli.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0))
    cli.push("w", np.full(4, 2.0, np.float32))  # seq 1: w -= 0.1*2 → 0.8
    cid = cli._client_id
    srv.snapshot_now()
    cli.push("w", np.full(4, 2.0, np.float32))  # seq 2: WAL-only → 0.6
    srv.stop()

    srv2 = PSServer(host="127.0.0.1", port=0, snapshot_dir=str(tmp_path),
                    snapshot_period=0)
    srv2.start()
    cli2 = PSClient("127.0.0.1", srv2.port, timeout=5, retries=3,
                    retry_interval=0.05)
    np.testing.assert_allclose(cli2.pull("w"), 0.6, rtol=1e-6)
    # the lost-ack replay: same (cid, seq) must be deduped after restart
    payload = struct.pack("<QQ", cid, 2) + _pack_array(
        np.full(4, 2.0, np.float32))
    _, _, reply = cli2._rpc(OP_PUSH_SEQ, "w", payload)
    assert bytes(reply[:1]) == b"\x00"
    np.testing.assert_allclose(cli2.pull("w"), 0.6, rtol=1e-6)
    # and the restored server optimizer keeps applying updates
    cli2.push("w", np.full(4, 1.0, np.float32))
    np.testing.assert_allclose(cli2.pull("w"), 0.5, rtol=1e-6)
    srv2.stop()


def test_ps_wal_torn_tail_record_is_ignored_and_truncated(tmp_path):
    from mxnet_tpu_torch.kvstore.elastic import PushWAL

    wal = PushWAL(str(tmp_path))
    wal.rotate(0)
    wal.append(0, 7, 1, "w", b"payload-1")
    wal.append(0, 7, 2, "w", b"payload-2")
    wal.close()
    # SIGKILL mid-append: truncate the last record's tail
    path = os.path.join(str(tmp_path), "wal-00000000.bin")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    seen = []
    wal2 = PushWAL(str(tmp_path))
    n = wal2.replay(lambda kind, cid, seq, key, payload: seen.append(seq))
    assert n == 1 and seen == [1]
    # the warm-restarted server reopens the SAME file for appending —
    # replay must have truncated the torn bytes, or an acked record
    # written behind them would be unreachable at the NEXT restart
    wal2.rotate(0)
    wal2.append(0, 7, 3, "w", b"payload-3")
    wal2.close()
    seen2 = []
    wal3 = PushWAL(str(tmp_path))
    wal3.replay(lambda kind, cid, seq, key, payload: seen2.append(seq))
    assert seen2 == [1, 3], seen2
    wal3.close()


def test_ps_wal_replays_births_before_pushes(tmp_path):
    """The live handlers append a key's birth (kind 2) and its pushes on
    different locks, so an acked push can land in the log AHEAD of the
    birth record — replay must apply births first or that acked push is
    silently dropped."""
    from mxnet_tpu_torch.kvstore.elastic import PushWAL
    from mxnet_tpu_torch.kvstore.ps_server import PSServer, _pack_array

    wal = PushWAL(str(tmp_path))
    wal.rotate(0)
    wal.append(0, 7, 1, "w", _pack_array(np.ones(3, np.float32)))
    wal.append(2, 0, 0, "w", _pack_array(np.full(3, 5.0, np.float32)))
    wal.close()
    srv = PSServer(host="127.0.0.1", port=0, snapshot_dir=str(tmp_path),
                   snapshot_period=0)
    np.testing.assert_allclose(srv._weights["w"], 6.0)
    srv.stop()


def test_zombie_barrier_arrival_rejected_not_counted():
    """A declared-dead-but-running worker's barrier arrival must not count
    toward the LIVE quorum (it would release a round a live member never
    reached) — it gets the structured stale rejection, and the live member
    still releases alone."""
    srv = _server(barrier_timeout=30.0)
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined(wait_for_expected=False)
    s2.ensure_joined(wait_for_expected=False)
    s2._hb.stop()
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        with srv._elastic.cv:
            if srv._elastic.members[s2.cid].state == "dead":
                break
        time.sleep(0.05)
    with pytest.raises(el.StaleMemberError):
        s2.barrier(timeout=10.0)
    t0 = time.monotonic()
    s1.barrier(timeout=20.0)  # quorum is {s1} alone — must release
    assert time.monotonic() - t0 < 10
    s1.close()
    srv.stop()


def test_elastic_fleet_survives_ps_warm_restart(tmp_path):
    """With durable snapshots on, MEMBERSHIP rides the snapshot: after a
    PS bounce the restored members just keep heartbeating and the next
    reduce retries idempotently against the fresh tables — the fleet must
    NOT collapse into stale rejections."""
    from mxnet_tpu_torch.kvstore.ps_server import PSServer

    srv = _server(snapshot_dir=str(tmp_path), snapshot_period=0)
    port = srv.port
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined(wait_for_expected=False)
    s2.ensure_joined(wait_for_expected=False)
    res = {}
    ts = [threading.Thread(
        target=lambda s=s, n=n: res.update(
            {n: s.allreduce("g", np.ones(2, np.float32), timeout=30)}))
        for n, s in (("a", s1), ("b", s2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert res["a"][1] == 2
    srv.snapshot_now()
    srv.stop()
    srv2 = None
    deadline = time.monotonic() + 10
    while srv2 is None:
        try:
            srv2 = PSServer(host="127.0.0.1", port=port, hb_interval=_HB,
                            miss_k=_MISS, snapshot_dir=str(tmp_path),
                            snapshot_period=0)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
    srv2.start()
    res2 = {}
    ts = [threading.Thread(
        target=lambda s=s, n=n: res2.update(
            {n: s.allreduce("g2", np.full(2, 2.0, np.float32),
                            timeout=30)}))
        for n, s in (("a", s1), ("b", s2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert res2["a"][1] == 2 and np.allclose(res2["a"][0], 4.0), res2
    s1.close()
    s2.close()
    srv2.stop()


def test_epoch_rendezvous_resyncs_a_behind_server():
    """Workers resuming from shared checkpoints at epoch N against a
    fresh/unsnapshotted server (epoch 0) must not wedge: the fleet's
    epoch is authoritative and the server jumps forward."""
    srv = _server()
    s1 = _session(srv, rank=0)
    s2 = _session(srv, rank=1)
    s1.ensure_joined(wait_for_expected=False)
    s2.ensure_joined(wait_for_expected=False)
    got = {}
    ts = [threading.Thread(
        target=lambda s=s, n=n: got.update({n: s.epoch_end(5, timeout=20)}))
        for n, s in (("a", s1), ("b", s2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=40)
    assert got["a"].epoch == 6 and got["b"].epoch == 6, got
    s1.close()
    s2.close()
    srv.stop()


def test_dead_member_heartbeat_does_not_refresh_liveness():
    """A zombie's continuing heartbeats must not reset last_hb once it is
    declared dead — that would defeat the prune GC forever."""
    st = ElasticState(hb_interval=0.05, miss_k=2)
    st.join(1, 0)
    with st.cv:
        st.members[1].state = "dead"
        stamp = st.members[1].last_hb
    time.sleep(0.05)
    status, _gen, _count = st.heartbeat(1)
    assert status == el.ST_STALE
    with st.cv:
        assert st.members[1].last_hb == stamp
    st.close()


def test_barrier_waits_for_live_members_not_arrival_count():
    """A member that arrives at the barrier and THEN dies must not stand
    in for a live member that never arrived — release requires the live
    cid set to be a subset of the arrived cids, not a raw count."""
    srv = _server(barrier_timeout=60.0)
    ss = [_session(srv, rank=r) for r in range(3)]
    for s in ss:
        s.ensure_joined(wait_for_expected=False)
    done = {}
    t1 = threading.Thread(target=lambda: done.update(
        a=ss[0].barrier(timeout=40)))
    t1.start()
    ss[0]._hb.stop()  # arrives, then dies

    def _pump_live(until):
        # keep s2/s3 deterministically alive from the test thread: on a
        # loaded box their Heartbeater threads can starve past the window
        # and a legitimate quorum shrink would mask the regression
        while time.monotonic() < until:
            srv._elastic.heartbeat(ss[1].cid)
            srv._elastic.heartbeat(ss[2].cid)
            with srv._elastic.cv:
                dead = srv._elastic.members[ss[0].cid].state == "dead"
            if dead:
                return True
            time.sleep(0.05)
        return False

    assert _pump_live(time.monotonic() + 15), "victim never declared dead"
    t2 = threading.Thread(target=lambda: done.update(
        b=ss[1].barrier(timeout=40)))
    t2.start()
    until = time.monotonic() + 1.5
    while time.monotonic() < until:
        srv._elastic.heartbeat(ss[1].cid)
        srv._elastic.heartbeat(ss[2].cid)
        time.sleep(0.05)
    # live quorum is {s2, s3}: s1's (dead) arrival + s2 must NOT release
    assert "b" not in done, "barrier released while a live member missing"
    ss[2].barrier(timeout=40)
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert not t1.is_alive() and not t2.is_alive()
    for s in ss[1:]:
        s.close()
    srv.stop()


def test_set_partition_trims_to_equal_batch_counts():
    """Recut shards must be EQUAL-sized (drop-last over the remainder):
    elastic sync is lockstep, and unequal per-rank batch counts would
    wedge the longer ranks in reduce rounds nobody else joins."""
    from mxnet_tpu_torch.io import NDArrayIter

    x = np.arange(10, dtype=np.float32).reshape(10, 1)
    sizes = []
    for part in range(4):
        it = NDArrayIter({"data": x}, batch_size=1)
        it.set_partition(part, 4)
        sizes.append(it.num_data)
    assert sizes == [2, 2, 2, 2], sizes
    # a PRE-SHARDED iterator (classic part_index= construction) must be
    # trimmed too: the unchanged-(part, nparts) call may not short-circuit
    # around the equal-size cut
    sizes = []
    for part in range(3):
        it = NDArrayIter({"data": x}, batch_size=1, part_index=part,
                         num_parts=3)
        it.set_partition(part, 3)
        sizes.append(it.num_data)
    assert sizes == [3, 3, 3], sizes


def test_epoch_jump_clears_collective_tables():
    """Mixed-epoch arrivals against a behind server: the forward jump is a
    boundary resync and must clear the released-round cache — a lower-
    epoch waiter released by the jump restarts its round numbering and
    must not be answered with pre-jump cached sums."""
    # wide liveness window: this unit never heartbeats and exercises the
    # jump semantics, not death declaration
    st = ElasticState(hb_interval=1.0, miss_k=60)
    st.join(1, 0)
    st.join(2, 1)
    done = {}
    ts = [threading.Thread(
        target=lambda cid=cid, v=v: done.update({cid: st.reduce(
            cid, "g", 0, np.full(2, v, np.float32), timeout=10)}))
        for cid, v in ((1, 1.0), (2, 2.0))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert np.allclose(done[1][3], 3.0)
    got = {}
    t1 = threading.Thread(target=lambda: got.update(
        a=st.epoch_end(1, 1, timeout=15)))
    t1.start()
    time.sleep(0.2)
    # cid 2 jumps the epoch to 5; cid 1's lower-epoch wait exits released
    # (cid 2's own boundary-5 wait can't complete — that's the documented
    # mixed-epoch desync, surfaced as a timeout, not silent corruption)
    got["b"] = st.epoch_end(2, 5, timeout=2)
    t1.join(timeout=30)
    assert not t1.is_alive()
    with st.cv:
        assert not st._completed and not st._rounds
    # a post-jump round 0 must gather fresh, not serve the pre-jump cache
    ts = [threading.Thread(
        target=lambda cid=cid, v=v: done.update({cid: st.reduce(
            cid, "g", 0, np.full(2, v, np.float32), timeout=10)}))
        for cid, v in ((1, 5.0), (2, 6.0))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert np.allclose(done[1][3], 11.0), done[1]
    st.close()


def test_fleet_takeover_clears_cached_reduce_rounds():
    """A joiner activated by fleet takeover restarts round numbering at 0;
    the dead fleet's released-round cache must not answer its round 0 with
    a stale gradient sum."""
    st = ElasticState(hb_interval=0.05, miss_k=3)
    st.join(1, 0)
    st.join(2, 1)
    done = {}
    ts = [threading.Thread(
        target=lambda cid=cid, v=v: done.update({cid: st.reduce(
            cid, "g", 0, np.full(2, v, np.float32), timeout=10)}))
        for cid, v in ((1, 10.0), (2, 20.0))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert np.allclose(done[1][3], 30.0)  # old fleet's round 0 = 30
    st.join(3, 2)  # started fleet → quarantined
    st.leave(1)
    st.leave(2)  # last active leaves → takeover activates cid 3
    with st.cv:
        assert st.members[3].state == "active"
    status, _gen, n, out = st.reduce(3, "g", 0, np.full(2, 5.0, np.float32),
                                     timeout=10)
    assert status == el.ST_OK and n == 1 and np.allclose(out, 5.0), \
        (status, n, out)
    st.close()


# ---------------------------------------------------------------------------
# half-open detection: keepalive + idle ping (satellite)
# ---------------------------------------------------------------------------

def test_idle_ping_recovers_from_restarted_server():
    """A server restarted behind an idle connection is detected by the
    ping-before-reuse probe at the NEXT rpc — the stale socket is dropped
    and the rpc reconnect-retries instead of writing into a dead pipe."""
    from mxnet_tpu_torch.kvstore.ps_client import PSClient
    from mxnet_tpu_torch.kvstore.ps_server import PSServer

    srv = PSServer(host="127.0.0.1", port=0)
    srv.start()
    port = srv.port
    cli = PSClient("127.0.0.1", port, timeout=5, retries=4,
                   retry_interval=0.1, idle_ping=0.05)
    cli.init("w", np.zeros(2, np.float32))
    srv.stop()
    srv2 = None
    deadline = time.monotonic() + 10
    while srv2 is None:  # the old listener may take a beat to release
        try:
            srv2 = PSServer(host="127.0.0.1", port=port)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
    srv2.start()
    time.sleep(0.1)  # connection is now idle past the ping threshold
    t0 = time.monotonic()
    cli.init("w", np.zeros(2, np.float32))  # must reconnect, not hang
    assert time.monotonic() - t0 < 5
    np.testing.assert_array_equal(cli.pull("w"), np.zeros(2, np.float32))
    srv2.stop()


def test_sockets_carry_keepalive():
    from mxnet_tpu_torch.kvstore.ps_client import PSClient
    from mxnet_tpu_torch.kvstore.ps_server import PSServer

    srv = PSServer(host="127.0.0.1", port=0)
    srv.start()
    cli = PSClient("127.0.0.1", srv.port, timeout=5)
    assert cli._sock.getsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE) == 1
    srv.stop()


# ---------------------------------------------------------------------------
# iterator shard recut (io/)
# ---------------------------------------------------------------------------

def test_ndarray_iter_set_partition_recuts_at_boundary():
    from mxnet_tpu_torch.io import NDArrayIter

    x = np.arange(12, dtype=np.float32).reshape(12, 1)
    it = NDArrayIter({"data": x}, batch_size=2, part_index=1, num_parts=3)
    assert it.num_data == 4
    got = np.concatenate([b.data[0].asnumpy().ravel() for b in it])
    np.testing.assert_array_equal(got, [4, 5, 6, 7])
    # survivor absorbs a dead rank's shard: recut 3 → 2 parts
    it.set_partition(0, 2)
    it.reset()
    assert it.num_data == 6
    got = np.concatenate([b.data[0].asnumpy().ravel() for b in it])
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 4, 5])
    # positioning contract still holds after a recut
    state = it.get_checkpoint_state()
    assert len(state["order"]) == 6


def test_prefetching_iter_delegates_set_partition():
    from mxnet_tpu_torch.io import NDArrayIter, PrefetchingIter

    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    it = PrefetchingIter(NDArrayIter({"data": x}, batch_size=2))
    it.set_partition(0, 2)
    it.reset()
    got = np.concatenate([b.data[0].asnumpy().ravel() for b in it])
    np.testing.assert_array_equal(got, [0, 1, 2, 3])
    it.close()


# ---------------------------------------------------------------------------
# bounded-staleness clocks and hierarchical reduction (the in-process cases
# of tests/test_async.py; its straggler policy's cases are in
# tests/test_torch_fleetstats.py)
# ---------------------------------------------------------------------------

def _client(srv):
    return tpc.PSClient("127.0.0.1", srv.port, timeout=10.0, retries=3,
                        retry_interval=0.2)


def _run_threads(fns, timeout=60.0):
    errs = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "worker thread hung"
    if errs:
        raise errs[0]


def test_clock_push_pull_and_max_merge():
    srv = _server(async_staleness=4)
    cli = _client(srv)
    try:
        assert cli.push_clock(0, 3) == (3, 3, 0)
        cli.push_clock(1, 1)
        assert cli.pull_clock() == (1, {0: 3, 1: 1})
        _floor, maxc, _ = cli.push_clock(0, 2)  # older: a no-op
        assert maxc == 3 and cli.pull_clock()[1][0] == 3
        st = srv.stats(include_metrics=False)["async"]
        assert st["staleness"] == 4 and st["clock_floor"] == 1
        assert st["clock_max"] == 3 and st["clocks"] == {"0": 3, "1": 1}
    finally:
        cli.close()
        srv.stop()


def test_clock_survives_warm_restart(tmp_path):
    snap = str(tmp_path / "ps_state")
    srv = _server(snapshot_dir=snap, snapshot_period=3600)
    cli = _client(srv)
    try:
        cli.init("w", np.zeros(2, np.float32))
        cli.push("w", np.full(2, 1.5, np.float32))
        cli.push_clock(0, 5)
        cli.push_clock(1, 2)
    finally:
        cli.close()
        srv.stop()
    srv2 = _server(snapshot_dir=snap, snapshot_period=3600)
    cli2 = _client(srv2)
    try:
        assert cli2.pull_clock() == (2, {0: 5, 1: 2})
        np.testing.assert_allclose(cli2.pull("w"), [1.5, 1.5])
    finally:
        cli2.close()
        srv2.stop()


def test_pull_stale_gate_admits_blocks_times_out_and_releases():
    srv = _server(async_staleness=1)
    a, b = _client(srv), _client(srv)
    try:
        a.init("w", np.full(2, 7.0, np.float32))
        a.push_clock(0, 3)
        b.push_clock(1, 2)  # floor 2: step 3 <= 2 + 1 admits at once
        w, floor, maxc = a.pull_stale("w", 0, 3, 1, timeout=5.0)
        assert (floor, maxc) == (2, 3)
        np.testing.assert_allclose(w, [7.0, 7.0])
        a.push_clock(0, 5)  # 5 > 2 + 1: gated
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            a.pull_stale("w", 0, 5, 1, timeout=0.5)
        assert 0.3 <= time.perf_counter() - t0 < 5.0  # answered at the bound
        got = {}
        th = threading.Thread(target=lambda: got.update(
            res=a.pull_stale("w", 0, 5, 1, timeout=30.0)))
        th.start()
        time.sleep(0.4)
        assert "res" not in got
        b.push_clock(1, 4)  # the straggler commits: floor 4 releases it
        th.join(timeout=10.0)
        assert not th.is_alive() and got["res"][1] == 4
    finally:
        a.close()
        b.close()
        srv.stop()


def test_scoped_reduce_completes_at_expected_subset():
    srv = _server()
    ss = [_session(srv, rank=r) for r in range(3)]
    try:
        for s in ss:
            s.ensure_joined(wait_for_expected=False)
        res = {}

        def call(i):
            res[i] = ss[i].allreduce_scoped(
                "sk", np.full(3, float(i + 1), np.float32), 2, 0,
                timeout=30.0)

        _run_threads([lambda i=i: call(i) for i in (0, 1)], timeout=40.0)
        for i in (0, 1):
            np.testing.assert_allclose(res[i][0], [3.0, 3.0, 3.0])
            assert res[i][1] == 2
    finally:
        for s in ss:
            s.close()
        srv.stop()


@pytest.mark.parametrize("compressed", [False, True])
def test_hierarchical_allreduce(compressed):
    """The three-stage group tree over 4 members in groups of 2 sums
    exactly; compressed, stage 1 rides the 2-bit framing (every value is
    exactly +-threshold, so one round is lossless)."""
    from mxnet_tpu_torch.kvstore import dist as kv_dist
    from mxnet_tpu_torch.kvstore.compression import GradientCompression

    srv = _server()
    ss = [_session(srv, rank=r, expected=4) for r in range(4)]
    infos, results = {}, {}
    try:
        _run_threads([lambda s=s, r=r: infos.__setitem__(r, s.ensure_joined())
                      for r, s in enumerate(ss)], timeout=40.0)
        assert all(infos[r].num_parts == 4 for r in range(4))
        vals = [0.5, 0.5, -0.5, 0.5] if compressed else [1.0, 2.0, 3.0, 4.0]

        def run(r):
            j = infos[r]
            gc = GradientCompression(threshold=0.5)
            packer = ((lambda f: gc.pack_wire("ck", f)) if compressed
                      else None)
            results[r] = kv_dist.hierarchical_allreduce(
                ss[r], "hk", np.full(6, vals[r], np.float32), 2, 0,
                j.part_index, j.num_parts, packer=packer)

        _run_threads([lambda r=r: run(r) for r in range(4)], timeout=60.0)
        for r in range(4):
            out, n = results[r]
            np.testing.assert_allclose(out, [sum(vals)] * 6)
            assert n == 4
    finally:
        for s in ss:
            s.close()
        srv.stop()


def test_lr_comp_scale_math():
    from mxnet_tpu_torch.kvstore import dist as kv_dist

    kv = object.__new__(kv_dist.DistKVStore)
    kv._async_staleness, kv._lr_comp = 4, True
    kv._clock_max, kv._async_step = 10, 7
    assert kv._lr_comp_scale() == pytest.approx(1.0 / 4.0)  # lag 3
    kv._async_step = 12
    assert kv._lr_comp_scale() == 1.0
    kv._async_step, kv._lr_comp = 7, False
    assert kv._lr_comp_scale() == 1.0
    kv._lr_comp, kv._async_staleness = True, None
    assert kv._lr_comp_scale() == 1.0


# ---------------------------------------------------------------------------
# the flagship (slow, subprocesses)
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Tail:
    """Line collector with marker waits over a process's stdout."""

    def __init__(self, proc):
        self.proc = proc
        self.lines = []
        self._cv = threading.Condition()
        self._t = threading.Thread(target=self._pump, daemon=True)
        self._t.start()

    def _pump(self):
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self._cv.notify_all()

    def wait_for(self, pred, timeout):
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                for ln in self.lines:
                    if pred(ln):
                        return ln
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self.proc.poll() is not None:
                    for ln in self.lines:
                        if pred(ln):
                            return ln
                    return None
                self._cv.wait(timeout=min(remaining, 0.5))

    def text(self):
        with self._cv:
            return "\n".join(self.lines)


def _spawn_ps(port):
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.kvstore.ps_server",
         "--port", str(port)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    tail = _Tail(proc)
    assert tail.wait_for(lambda l: "listening" in l, 90), tail.text()
    return proc


def _spawn_worker(rank, n, ps_port, ckpt, epochs, step_delay):
    env = dict(os.environ)
    env.update({"MXNET_ELASTIC": "1", "MXNET_ELASTIC_HEARTBEAT_S": "0.2",
                "MXNET_ELASTIC_MISS_K": "3", "MXNET_PS_ADDR": "127.0.0.1",
                "MXNET_PS_PORT": str(ps_port), "DMLC_NUM_WORKER": str(n),
                "DMLC_WORKER_ID": str(rank), "DMLC_ROLE": "worker"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.dist_worker",
         "elastic", "--device", "cpu", "--ckpt-dir", str(ckpt),
         "--epochs", str(epochs), "--step-delay", str(step_delay)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, _Tail(proc)


def _final_loss(tail):
    ln = tail.wait_for(lambda l: l.startswith("FINAL_LOSS"), 1)
    return float(ln.split()[1]) if ln else None


@pytest.mark.slow
def test_flagship_worker_death_rebalance_and_rejoin(tmp_path):
    """SIGKILL 1 of 3 elastic dist_sync workers mid-epoch: the survivors
    finish the epoch (released, not timed out), recut 3 -> 2 at the
    boundary, the restarted worker rejoins at the next one (3 parts again)
    from the shared checkpoint, and the final loss is within 0.25x of an
    uninjected run's."""
    epochs, delay = 6, 0.4
    port = _free_port()
    ps = _spawn_ps(port)
    procs = {}
    try:
        for r in range(3):
            procs[r] = _spawn_worker(r, 3, port, tmp_path / "ckpt", epochs,
                                     delay)
        victim, vtail = procs[2]
        assert vtail.wait_for(
            lambda l: l.startswith("CHAOS_STEP 2"), 120), vtail.text()
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=30)
        assert victim.returncode == -signal.SIGKILL
        _w0, t0 = procs[0]
        assert t0.wait_for(
            lambda l: l.startswith("EPOCH_START 1 parts=2"), 120), t0.text()
        procs[2] = _spawn_worker(2, 3, port, tmp_path / "ckpt", epochs,
                                 delay)
        _, rtail = procs[2]
        assert rtail.wait_for(
            lambda l: l.startswith("EPOCH_START") and "parts=3" in l,
            240), rtail.text()
        assert t0.wait_for(
            lambda l: l.startswith("EPOCH_START") and "parts=3" in l,
            240), t0.text()
        for r, (proc, _tail) in procs.items():
            proc.wait(timeout=300)
        assert all(p.returncode == 0 for p, _ in procs.values()), \
            {r: t.text()[-3000:] for r, (_p, t) in procs.items()}
        losses = {r: _final_loss(t) for r, (_p, t) in procs.items()}
        assert all(v is not None for v in losses.values()), losses
        assert len({round(v, 6) for v in losses.values()}) == 1, losses
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
        ps.terminate()
        ps.wait(timeout=10)
    port2 = _free_port()
    ps2 = _spawn_ps(port2)
    clean = {}
    try:
        for r in range(3):
            clean[r] = _spawn_worker(r, 3, port2, tmp_path / "ckpt_clean",
                                     epochs, delay)
        for proc, tail in clean.values():
            proc.wait(timeout=300)
            assert proc.returncode == 0, tail.text()[-3000:]
        clean_loss = _final_loss(clean[0][1])
    finally:
        for proc, _ in clean.values():
            if proc.poll() is None:
                proc.kill()
        ps2.terminate()
        ps2.wait(timeout=10)
    injected = losses[0]
    assert abs(injected - clean_loss) <= 0.25 * max(clean_loss, 1.0), \
        (injected, clean_loss)
