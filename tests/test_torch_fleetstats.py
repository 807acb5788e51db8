"""The training-fleet plane of the port (``mxnet_tpu_torch/obs/fleetstats.py``,
``chaos/slow.py``, the PS server's ``OP_TELEMETRY``/STATS and straggler
policy, the heartbeat piggyback, the fit loop's phases, ``train_report``,
``fleet_report --ps`` and ``elastic_bench``) through the cases of the JAX
package's ``tests/test_fleetstats.py`` and the policy and ramp cases of
``tests/test_async.py``, on the CPU, plus parity with the reference:

1. the detector as a pure function (lag, recovery, the flap guard, each
   blame, no false positive), the aggregator's ingest and judging;
2. windowed step accounting (sealing, shipping once, the veto);
3. hot keys; the PS wire: heartbeat-piggybacked parts in a 3-worker
   in-process fleet, ``OP_TELEMETRY`` exactly once under a dropped reply
   (a socket proxy drops it: the reference's ``chaos.rpc`` is not
   ported), STATS' sections, push/pull and reduce-wait accounting, one
   trace id across ``kvstore.rpc`` and ``kvstore.server.rpc``;
4. the merged timeline with a corpse lane; ``chaos.slow``; the async
   straggler policy; the fit loop's phase spans; the tools' legs;
5. parity: the detector's verdicts, ``categorize``/``summarize_windows``,
   ``chaos.slow`` schedules and the hot-key table equal the reference's
   on the same inputs;
6. the flagship (slow): a 3-worker elastic fit in subprocesses with rank
   1's forward slowed: the server names rank 1 and blames compute, the
   uninjected twin gets no verdict.
"""
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu.chaos import slow as jslow
from mxnet_tpu.obs import fleetstats as jfs
from mxnet_tpu_torch import obs
from mxnet_tpu_torch.chaos import slow as chaos_slow
from mxnet_tpu_torch.kvstore.elastic import ElasticWorkerSession
from mxnet_tpu_torch.kvstore.ps_client import PSClient
from mxnet_tpu_torch.kvstore.ps_server import (OP_TELEMETRY, PSServer,
                                               _recv_exact)
from mxnet_tpu_torch.obs import fleetstats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    with tmx.cpu():
        yield
    chaos_slow.reset()
    jslow.reset()
    obs.disable()
    obs.reset()


def _win(step_time, forward=0.0, data=0.0, reduce=0.0, steps=10):
    return {"steps": steps, "step_time": step_time,
            "phases": {"forward": forward, "data_wait": data,
                       "elastic.sync_grads": reduce}}


def _mk_server(**kw):
    srv = PSServer(host="127.0.0.1", port=0, **kw)
    srv.start()
    return srv


def _client(srv, **kw):
    kw.setdefault("timeout", 10)
    kw.setdefault("retries", 3)
    kw.setdefault("retry_interval", 0.1)
    return PSClient("127.0.0.1", srv.port, **kw)


# ---------------------------------------------------------------------------
# 1. the detector as a pure function
# ---------------------------------------------------------------------------

def test_detector_flags_lagging_rank_with_compute_blame():
    d = fleetstats.StragglerDetector(factor=1.5, k=3)
    evs = []
    for i in range(6):
        evs += d.observe(i, {
            0: _win(1.0, forward=0.2, reduce=0.75),
            1: _win(1.0, forward=0.22, reduce=0.73),
            2: _win(1.0, forward=0.9, reduce=0.05)})
    fired = [e for e in evs if e["kind"] == "straggler"]
    assert len(fired) == 1  # once, not per window
    v = fired[0]
    assert v["rank"] == 2 and v["blame"] == "compute"
    assert v["window"] == 2  # k=3 consecutive windows: 0, 1, 2
    assert 2 in d.flagged


def test_detector_lockstep_blindness_needs_own_time():
    """Under lockstep every rank's raw step time is the slowest's: the
    slow rank's own time lags, the fast ranks' inflation is reduce-wait."""
    d = fleetstats.StragglerDetector(factor=1.5, k=2)
    evs = []
    for i in range(4):
        evs += d.observe(i, {
            0: _win(1.0, forward=0.1, reduce=0.85),
            1: _win(1.0, forward=0.12, reduce=0.83),
            2: _win(1.0, forward=0.95, reduce=0.02)})
    assert {e["rank"] for e in evs if e["kind"] == "straggler"} == {2}


def test_detector_data_wait_blame():
    d = fleetstats.StragglerDetector(factor=1.5, k=2)
    evs = []
    for i in range(3):
        evs += d.observe(i, {
            0: _win(0.3, forward=0.2, data=0.05),
            1: _win(0.3, forward=0.2, data=0.05),
            2: _win(0.9, forward=0.2, data=0.65)})
    fired = [e for e in evs if e["kind"] == "straggler"]
    assert fired and fired[0]["rank"] == 2
    assert fired[0]["blame"] == "data_wait"


def test_detector_reduce_wait_blame():
    """A rank whose own work is normal but whose step time and reduce-wait
    both lag (its RPC path is slow) is blamed on the reduce plane."""
    d = fleetstats.StragglerDetector(factor=1.5, k=2)
    evs = []
    for i in range(3):
        evs += d.observe(i, {
            0: _win(1.0, forward=0.8, reduce=0.15),
            1: _win(1.0, forward=0.82, reduce=0.13),
            2: _win(2.2, forward=0.8, reduce=1.35)})
    fired = [e for e in evs if e["kind"] == "straggler"]
    assert fired and fired[0]["rank"] == 2
    assert fired[0]["blame"] == "reduce_wait"


def test_detector_no_false_positive_on_uniform_fleet():
    d = fleetstats.StragglerDetector(factor=1.5, k=2)
    rng = np.random.RandomState(3)
    for i in range(20):
        per = {r: _win(0.1 * (1 + 0.1 * rng.rand()),
                       forward=0.08, reduce=0.01) for r in range(4)}
        assert d.observe(i, per) == []
    assert d.flagged == {}


def test_detector_recover_and_flap_hysteresis():
    d = fleetstats.StragglerDetector(factor=1.5, k=2)
    lag = {0: _win(1.0, forward=0.9), 1: _win(0.3, forward=0.25),
           2: _win(0.3, forward=0.26)}
    ok = {0: _win(0.3, forward=0.25), 1: _win(0.3, forward=0.25),
          2: _win(0.3, forward=0.26)}
    # above the recovery threshold, below the factor
    mid = {0: _win(0.4, forward=0.35), 1: _win(0.3, forward=0.25),
           2: _win(0.3, forward=0.26)}
    i, evs = 0, []
    for w in (lag, lag):
        evs += d.observe(i, w)
        i += 1
    assert 0 in d.flagged
    for w in (mid, lag, mid, lag):  # flapping must not clear the verdict
        evs += d.observe(i, w)
        i += 1
    assert 0 in d.flagged
    assert not [e for e in evs if e["kind"] == "recovered"]
    evs += d.observe(i, ok)  # one clean window is not enough (k=2)
    i += 1
    assert 0 in d.flagged
    evs += d.observe(i, ok)  # two are
    rec = [e for e in evs if e["kind"] == "recovered"]
    assert rec and rec[0]["rank"] == 0 and rec[0]["was_blamed"] == "compute"
    assert 0 not in d.flagged


def _part(rank, w, st, **extra):
    return json.dumps({
        "rank": rank, "pid": 100 + rank,
        "windows": [{"w": w, "steps": 4, "step_time": st,
                     "phases": {"forward": st}}], **extra}).encode()


def test_judging_not_throttled_after_clean_leave():
    """A departed member keeps its cached telemetry, but its corpse does
    not count toward the reports a window waits for."""
    agg = fleetstats.FleetAggregator(
        detector=fleetstats.StragglerDetector(factor=1.5, k=1),
        member_ranks=lambda: [0, 1])  # rank 2 left; its cache remains
    agg.add_part(3, _part(2, 0, 0.1))
    for w in (0, 1):
        agg.add_part(1, _part(0, w, 0.1))
        agg.add_part(2, _part(1, w, 0.1))
    assert agg._judged_to == 1  # judged now, not after STALE_S


def test_detector_needs_two_ranks():
    d = fleetstats.StragglerDetector(factor=1.5, k=1)
    assert d.observe(0, {0: _win(9.0, forward=9.0)}) == []


def test_aggregator_survives_garbage_windows():
    obs.enable()
    agg = fleetstats.FleetAggregator(
        detector=fleetstats.StragglerDetector(factor=1.5, k=1))
    good = {"w": 0, "steps": 4, "step_time": 0.1,
            "phases": {"forward": 0.09}}
    bad = [{"w": 1, "steps": 4, "step_time": None},
           {"w": 1, "steps": 4, "step_time": 0.1,
            "phases": ["not", "a", "dict"]},
           {"steps": 4}]
    assert agg.add_part(1, json.dumps(
        {"rank": 0, "windows": [good] + bad}).encode())
    assert agg.add_part(2, json.dumps(
        {"rank": 1, "windows": [good]}).encode())
    assert list(agg._members[1].windows) == [0]
    assert obs.metrics.registry.get("train.fleet.bad_parts").value >= 3
    assert not agg.add_part(3, b"\xff\xfe garbage")
    s = fleetstats.summarize_windows(agg._members[1].windows.values())
    assert s["steps"] == 4 and s["phases"]["compute"] > 0


# ---------------------------------------------------------------------------
# 2. windowed step accounting
# ---------------------------------------------------------------------------

def test_step_accounting_windows_seal_and_ship_once():
    obs.enable()
    acc = fleetstats.StepAccounting(rank=5, window=3, own_spans=False,
                                    ship_interval_s=9999)
    for step in range(1, 8):  # 7 steps: windows 0, 1 sealed, 2 partial
        with acc.phase("forward"):
            pass
        with acc.phase("data_wait"):
            pass
        acc.step_complete(step)
    assert [w["w"] for w in acc.windows] == [0, 1]
    w0 = acc.windows[0]
    assert w0["steps"] == 3 and w0["step_time"] > 0
    assert set(w0["phases"]) == {"forward", "data_wait"}
    part = json.loads(acc.wire_part().decode())
    assert part["rank"] == 5
    assert [w["w"] for w in part["windows"]] == [0, 1]
    assert acc.wire_part() is None
    acc.flush()
    part2 = json.loads(acc.wire_part().decode())
    assert [w["w"] for w in part2["windows"]] == [2]
    assert part2["windows"][0]["steps"] == 1
    assert obs.metrics.registry.get("train.step.seconds").count == 7
    assert obs.metrics.registry.get("train.step.forward_seconds").count == 7


def test_step_accounting_zero_cost_when_off():
    acc = fleetstats.StepAccounting(rank=0, window=2, own_spans=False)
    with acc.phase("forward"):
        pass
    acc.step_complete(1)
    assert not acc.windows and acc.wire_part() is None
    assert obs.metrics.registry.get("train.step.seconds") is None


def test_fleet_veto_disables_accounting(monkeypatch):
    obs.enable()
    monkeypatch.setenv("MXNET_OBS_FLEET", "0")
    acc = fleetstats.StepAccounting(rank=0, window=1, own_spans=False)
    with acc.phase("forward"):
        pass
    acc.step_complete(1)
    assert not acc.windows


def test_hot_key_table_bounded_and_hot_keys_surface():
    t = fleetstats.HotKeyTable(capacity=8)
    rng = np.random.RandomState(0)
    for i in range(2000):
        key = (("hot0" if i % 2 == 0 else "hot1") if i % 3 != 2
               else f"cold{i}")
        t.record(key, nbytes=64, apply_s=0.001 * rng.rand())
        assert len(t) <= 8
    snap = t.snapshot(n=2)
    assert {r["key"] for r in snap} == {"hot0", "hot1"}
    assert all(r["pushes"] > 100 for r in snap)
    assert all("push_rate" in r and "apply_ms_avg" in r for r in snap)


# ---------------------------------------------------------------------------
# 3. the PS wire
# ---------------------------------------------------------------------------

def test_heartbeat_piggyback_caches_parts_and_detects_straggler():
    """Three in-process workers, each with its own accounting on its
    session's heartbeats: the server flags the slow one and blames its
    compute, and STATS and OP_TELEMETRY carry the fleet."""
    obs.enable()
    srv = _mk_server(hb_interval=0.05, miss_k=4)
    srv.fleet.detector = fleetstats.StragglerDetector(factor=1.5, k=2)
    verdicts = []
    srv.fleet.on_straggler(verdicts.append)
    accs = [fleetstats.StepAccounting(rank=r, window=2, own_spans=False,
                                      ship_interval_s=0.02)
            for r in range(3)]
    sessions = []
    try:
        sessions = [ElasticWorkerSession(
            "127.0.0.1", srv.port, rank=r, hb_interval=0.05,
            part_provider=accs[r].wire_part) for r in range(3)]
        for s in sessions:
            s.ensure_joined(wait_for_expected=False)

        def _loop(r):
            for step in range(1, 13):
                with accs[r].phase("forward"):
                    time.sleep(0.03 if r == 2 else 0.005)
                accs[r].step_complete(step)
            accs[r].flush()

        ts = [threading.Thread(target=_loop, args=(r,), daemon=True)
              for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not verdicts:
            time.sleep(0.05)
        fired = [v for v in verdicts if v["kind"] == "straggler"]
        assert fired, srv.fleet.stats()
        assert fired[0]["rank"] == 2 and fired[0]["blame"] == "compute"
        cli = _client(srv)
        st = cli.stats()
        assert "metrics" in st and "counters" in st["metrics"]
        assert st["fleet"]["stragglers"][0]["rank"] == 2
        assert set(st["fleet"]["ranks"]) == {"0", "1", "2"}
        assert any(m["state"] == "active" for m in st["membership"])
        assert st["metrics"]["counters"].get(
            "train.straggler.verdicts", 0) >= 1
        assert st["metrics"]["gauges"].get("train.straggler.rank2") == 1
        assert any(k.startswith("kvstore.member")
                   and k.endswith("last_hb_age_s")
                   for k in st["metrics"]["gauges"])
        tel = cli.telemetry()
        roles = {p.get("role") for p in tel["parts"]}
        assert {"ps_server", "rank0", "rank1", "rank2"} <= roles
        rank2 = next(p for p in tel["parts"] if p.get("role") == "rank2")
        assert rank2["windows"]
        cli.close()
    finally:
        for s in sessions:
            s.close()
        srv.stop()


class _DropFirstReply:
    """A TCP proxy in front of a PS server that drops the first reply of
    ``opcode`` (it closes the client's connection instead of relaying it),
    the lost reply the reference injects with its ``chaos.rpc``."""

    def __init__(self, port, opcode):
        self._target = ("127.0.0.1", port)
        self._opcode = opcode
        self.dropped = 0
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self.port = self._lsock.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            threading.Thread(target=self._pump, args=(conn,),
                             daemon=True).start()

    @staticmethod
    def _frame(sock):
        head = _recv_exact(sock, 4)
        return head + _recv_exact(sock, struct.unpack("<I", head)[0])

    def _pump(self, conn):
        up = socket.create_connection(self._target)
        try:
            while True:
                up.sendall(self._frame(conn))
                reply = self._frame(up)
                if reply[4] == self._opcode and not self.dropped:
                    self.dropped += 1
                    return  # the reply never reaches the client
                conn.sendall(reply)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()
            up.close()

    def close(self):
        self._lsock.close()


def _marker_spans(part):
    return [s for s in part["spans"] if s.get("name") == "kvstore.server.rpc"
            and (s.get("args") or {}).get("key") == "uniq_marker_key"]


def test_ps_telemetry_exactly_once_under_a_dropped_reply():
    obs.enable()
    srv = _mk_server()
    proxy = _DropFirstReply(srv.port, OP_TELEMETRY)
    try:
        cli = PSClient("127.0.0.1", proxy.port, timeout=10, retries=4,
                       retry_interval=0.05)
        cli.init("uniq_marker_key", np.zeros(4, np.float32))
        time.sleep(0.1)  # the server-side span lands in the ring
        tel = cli.telemetry()  # first reply dropped: the token retried
        assert proxy.dropped == 1
        assert obs.metrics.registry.get("kvstore.rpc.retries").value >= 1
        server_part = next(p for p in tel["parts"]
                           if p.get("role") == "ps_server")
        # the drained INIT span came through exactly once despite the retry
        assert len(_marker_spans(server_part)) == 1
        tel2 = cli.telemetry()  # a fresh collection does not see it again
        server_part2 = next(p for p in tel2["parts"]
                            if p.get("role") == "ps_server")
        assert not _marker_spans(server_part2)
        cli.close()
    finally:
        proxy.close()
        srv.stop()


def test_rpc_spans_share_one_trace_id_across_the_wire():
    """A context-suffixed key hits the same tables as its plain form, and
    both halves of each RPC carry the caller's trace id."""
    obs.enable()
    srv = _mk_server(num_workers=1)
    try:
        cli = _client(srv)
        w = np.ones((4, 3), np.float32)
        root = obs.context.new_root()
        with obs.context.use(root):
            cli.init("w", w)
            cli.push("w", np.full((4, 3), 0.5, np.float32))
            out = cli.pull("w")
        np.testing.assert_allclose(out, w + 0.5)
        cli.push("w", np.full((4, 3), 0.5, np.float32))  # no context
        np.testing.assert_allclose(cli.pull("w"), w + 1.0)
        cli.close()
    finally:
        srv.stop()
    evs = obs.trace.drain()
    traced = {(e["name"], (e.get("args") or {}).get("key"))
              for e in evs
              if (e.get("args") or {}).get("trace_id") == root.trace_id}
    assert ("kvstore.rpc", "w") in traced
    assert ("kvstore.server.rpc", "w") in traced  # the plain key
    client = {e["args"]["span_id"] for e in evs if e["name"] == "kvstore.rpc"
              and (e.get("args") or {}).get("trace_id") == root.trace_id}
    server = [e["args"]["parent_id"] for e in evs
              if e["name"] == "kvstore.server.rpc"
              and (e.get("args") or {}).get("trace_id") == root.trace_id]
    assert server and set(server) <= client


def test_member_prune_and_leave_remove_gauges_and_cached_parts():
    obs.enable()
    srv = _mk_server(hb_interval=0.05, miss_k=3)
    try:
        acc = fleetstats.StepAccounting(rank=0, window=1, own_spans=False,
                                        ship_interval_s=0.02)
        s = ElasticWorkerSession("127.0.0.1", srv.port, rank=0,
                                 hb_interval=0.05,
                                 part_provider=acc.wire_part)
        assert s.ensure_joined(wait_for_expected=False).active
        with acc.phase("forward"):
            pass
        acc.step_complete(1)
        acc.flush()
        cid = s.cid
        gname = f"kvstore.member{cid}.last_hb_age_s"
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if obs.metrics.registry.get(gname) is not None \
                    and srv.fleet._members.get(cid) is not None:
                break
            time.sleep(0.05)
        assert obs.metrics.registry.get(gname) is not None
        assert srv.fleet._members.get(cid) is not None
        s.close()  # leave: the gauge goes, the cached telemetry stays
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline \
                and obs.metrics.registry.get(gname) is not None:
            time.sleep(0.05)
        assert obs.metrics.registry.get(gname) is None
        assert srv.fleet._members.get(cid) is not None
        srv._elastic._forget_member(cid, pruned=True)  # the prune drops it
        assert srv.fleet._members.get(cid) is None
    finally:
        srv.stop()


def test_push_split_metrics_and_hot_keys(tmp_path):
    obs.enable()
    srv = _mk_server(snapshot_dir=str(tmp_path), snapshot_period=0)
    try:
        cli = _client(srv)
        cli.init("w_hot", np.zeros(128, np.float32))
        cli.init("w_cold", np.zeros(128, np.float32))
        g = np.ones(128, np.float32)
        for _ in range(6):
            cli.push("w_hot", g)
        cli.push("w_cold", g)
        cli.pull("w_hot")
        st = cli.stats()
        hot = st["hot_keys"]
        assert hot[0]["key"] == "w_hot" and hot[0]["pushes"] == 6
        assert hot[0]["bytes"] == 6 * (len(g.tobytes()) + 6)
        hists = st["metrics"]["histograms"]
        assert hists["kvstore.server.push.apply_seconds"]["count"] == 7
        assert hists["kvstore.server.push.wal_seconds"]["count"] == 7
        assert hists["kvstore.server.pull.serialize_seconds"]["count"] >= 1
        cli.close()
    finally:
        srv.stop()


def test_session_close_ships_the_last_windows_on_a_final_beat():
    """A clean close sends one beat more with the windows sealed since the
    last beat (the fit's flush): a worker that exits right after its fit
    loses none of them. A silenced heartbeater sends nothing more."""
    obs.enable()
    srv = _mk_server(hb_interval=5.0, miss_k=3)
    try:
        accs = [fleetstats.StepAccounting(rank=r, window=2, own_spans=False,
                                          ship_interval_s=60.0)
                for r in range(2)]
        ss = [ElasticWorkerSession("127.0.0.1", srv.port, rank=r,
                                   hb_interval=5.0,
                                   part_provider=accs[r].wire_part)
              for r in range(2)]
        for s in ss:
            assert s.ensure_joined(wait_for_expected=False).active
        deadline = time.monotonic() + 10  # the first beats' empty parts
        while time.monotonic() < deadline and any(
                srv.fleet._members.get(s.cid) is None for s in ss):
            time.sleep(0.02)
        for acc in accs:
            for step in (1, 2):
                with acc.phase("forward"):
                    pass
                acc.step_complete(step)
            acc.flush()
            assert acc._ship  # sealed; the next beat is 5 s away
        ss[1]._hb.stop()  # silenced, as a liveness test makes a zombie
        assert accs[1]._ship
        ss[0].close()
        assert not accs[0]._ship
        deadline = time.monotonic() + 10  # ingested after the ack
        while time.monotonic() < deadline \
                and not srv.fleet._members[ss[0].cid].windows:
            time.sleep(0.02)
        assert list(srv.fleet._members[ss[0].cid].windows) == [0]
        assert not srv.fleet._members[ss[1].cid].windows
        ss[1].close()
    finally:
        srv.stop()


def test_reduce_wait_by_rank_recorded():
    obs.enable()
    srv = _mk_server(hb_interval=0.05, miss_k=4)
    sessions = []
    try:
        sessions = [ElasticWorkerSession("127.0.0.1", srv.port, rank=r,
                                         hb_interval=0.05,
                                         part_provider=None)
                    for r in range(2)]
        for s in sessions:
            s.ensure_joined(wait_for_expected=False)
        arr = np.ones(16, np.float32)
        results = {}

        def _contrib(r, delay):
            time.sleep(delay)
            results[r] = sessions[r].allreduce("k", arr, timeout=30)

        ts = [threading.Thread(target=_contrib, args=(0, 0.0), daemon=True),
              threading.Thread(target=_contrib, args=(1, 0.3), daemon=True)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert results[0][0][0] == 2.0
        h0 = obs.metrics.registry.get("kvstore.reduce_wait.rank0_seconds")
        h1 = obs.metrics.registry.get("kvstore.reduce_wait.rank1_seconds")
        # rank 0 arrived first and waited; rank 1 arrived last
        assert h0.sum > h1.sum
        c = obs.metrics.registry.get("kvstore.reduce_last_arriver.rank1")
        assert c is not None and c.value == 1
        names = {e[1] for e in obs.trace.events()}
        assert {"elastic.member_joined", "elastic.generation_bump",
                "elastic.allreduce"} <= names
    finally:
        for s in sessions:
            s.close()
        srv.stop()


def test_stats_widen_and_clock_bounds_follow_the_policy():
    srv = _mk_server(async_staleness=2)
    try:
        cli = _client(srv)
        cli.init("w", np.zeros(2, np.float32))
        assert cli.push_clock(0, 3) == (3, 3, 0)  # no widening yet
        srv._policy_on_straggler({"kind": "straggler", "rank": 1,
                                  "window": 2, "blame": "compute"})
        floor, maxc, widen = cli.push_clock(1, 1)
        assert (floor, maxc, widen) == (1, 3, 2)
        st = cli.stats(include_metrics=False)
        assert st["async"]["widen"] == 2
        assert st["async"]["staleness_widen"] == {"1": 2}
        assert st["fleet"] == {"ranks": {}, "stragglers": [],
                               "verdicts": []}
        cli.close()
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# 4. the merged timeline, chaos.slow, the policy, the fit loop, the tools
# ---------------------------------------------------------------------------

def test_merged_timeline_includes_corpse_lane(tmp_path):
    from mxnet_tpu_torch.tools import train_report

    obs.enable()
    srv = _mk_server(hb_interval=0.05, miss_k=4)
    sessions = []
    try:
        accs = [fleetstats.StepAccounting(
            rank=r, window=1, own_spans=False, ship_interval_s=0.02)
            for r in range(2)]
        sessions = [ElasticWorkerSession(
            "127.0.0.1", srv.port, rank=r, hb_interval=0.05,
            part_provider=accs[r].wire_part) for r in range(2)]
        for s in sessions:
            s.ensure_joined(wait_for_expected=False)
        for step in (1, 2):
            for acc in accs:
                with acc.phase("forward"):
                    time.sleep(0.002)
                acc.step_complete(step)
        for acc in accs:
            acc.flush()
        time.sleep(0.4)
        tel = fleetstats.collect("127.0.0.1", srv.port)
        # a SIGKILLed rank's corpse: a clock anchor, a forward span and a
        # torn last line
        corpse = tmp_path / "rank9.jsonl"
        corpse.write_text(
            json.dumps({"ph": "M", "name": "clock", "pid": 994242,
                        "wall_epoch": time.time() - 1.0}) + "\n"
            + json.dumps({"ph": "X", "name": "forward", "ts": 0.1,
                          "dur": 0.05, "tid": 1, "pid": 994242}) + "\n"
            + '{"ph": "X", "name": "upda')
        doc_path = tmp_path / "pulled.json"
        doc_path.write_text(json.dumps(tel, default=float))
        out = train_report.main([
            "--input", str(doc_path), "--jsonl", str(corpse),
            "--trace", str(tmp_path / "merged.json"), "--json"])
        merged = json.loads((tmp_path / "merged.json").read_text())
        names = {e["args"]["name"] for e in merged["traceEvents"]
                 if e.get("name") == "process_name"}
        assert "ps_server" in names and {"rank0", "rank1"} <= names
        assert any(n.startswith("jsonl:rank9") for n in names)
        corpse_spans = [e for e in merged["traceEvents"]
                        if e.get("pid") == 994242 and e.get("ph") == "X"]
        assert any(e["name"] == "forward" for e in corpse_spans)
        assert out["torn_records"] == 1
        assert all(p.get("wall_epoch") is not None for p in tel["parts"])
        assert "Training fleet" in out["report"]
        assert "rank" in out["report"]
    finally:
        for s in sessions:
            s.close()
        srv.stop()


def test_fleet_report_ps_pulls_the_training_plane(capsys):
    from mxnet_tpu_torch.tools import fleet_report

    obs.enable()
    srv = _mk_server()
    try:
        cli = _client(srv)
        cli.init("w", np.zeros(2, np.float32))
        cli.close()
        out = fleet_report.main(["--connect", f"127.0.0.1:{srv.port}",
                                 "--ps", "--json"])
    finally:
        srv.stop()
    assert [p["role"] for p in out["parts"]] == ["ps_server"]
    assert out["parts"][0]["spans"] >= 1
    assert "slo" not in out
    assert json.loads(capsys.readouterr().out)["parts"] == out["parts"]


def test_chaos_slow_parse_and_counted_occurrences():
    rules = chaos_slow.parse_env("1:forward@2-3,7:0.01;0:data_wait::0.02")
    assert rules[0].rank == 1 and rules[0].phase == "forward"
    assert rules[0].occurrences == {2, 3, 7}
    assert rules[1].occurrences is None and rules[1].seconds == 0.02
    with pytest.raises(ValueError):
        chaos_slow.parse_env("garbled")
    chaos_slow.configure([chaos_slow.Rule(1, "forward", {2}, 0.05)])
    chaos_slow.set_rank(1)
    assert chaos_slow.maybe_delay("forward") == 0.0   # occurrence 1
    t0 = time.monotonic()
    assert chaos_slow.maybe_delay("forward") == 0.05  # occurrence 2
    assert time.monotonic() - t0 >= 0.05
    assert chaos_slow.maybe_delay("forward") == 0.0
    assert chaos_slow.maybe_delay("backward") == 0.0
    chaos_slow.set_rank(0)
    assert chaos_slow.maybe_delay("forward") == 0.0


def test_chaos_slow_fires_inside_fleetstats_phase(monkeypatch):
    obs.enable()
    monkeypatch.setenv("MXNET_CHAOS_SLOW", "3:forward::0.03")
    chaos_slow.configure(chaos_slow.parse_env("3:forward::0.03"))
    chaos_slow.set_rank(3)
    acc = fleetstats.StepAccounting(rank=3, window=1, own_spans=False)
    t0 = time.monotonic()
    with acc.phase("forward"):
        pass
    assert time.monotonic() - t0 >= 0.03
    acc.step_complete(1)
    acc.flush()
    assert acc.windows[0]["phases"]["forward"] >= 0.03
    assert any(e[1] == "chaos.slow" for e in obs.trace.events())
    assert obs.metrics.registry.get("chaos.slow.injected").value == 1


def test_chaos_package_exports_slow_and_names_the_rest():
    """The chaos package exports all five injectors, the reference's
    ``__all__``; each of the other three is the module of its name."""
    import importlib

    from mxnet_tpu import chaos as jchaos
    from mxnet_tpu_torch import chaos

    assert chaos.slow is chaos_slow
    assert sorted(chaos.__all__) == sorted(jchaos.__all__)
    for name in ("rpc", "proc", "platform"):
        assert getattr(chaos, name) is importlib.import_module(
            f"mxnet_tpu_torch.chaos.{name}")


def _verdict(rank, blame, kind="straggler"):
    return {"kind": kind, "rank": rank, "window": 3, "streak": 2,
            "ratio": 2.4, "blame": blame}


def test_policy_widens_on_compute_blame_capped_then_narrows():
    srv = _mk_server(async_staleness=2)
    try:
        srv._policy_on_straggler(_verdict(2, "compute"))
        assert srv._staleness_widen[2] == 2  # MXNET_ASYNC_WIDEN's default
        for _ in range(20):
            srv._policy_on_straggler(_verdict(2, "compute"))
        # capped at MXNET_ASYNC_MAX_STALENESS (16) - the base (2)
        assert srv._staleness_widen[2] == 14
        srv._policy_on_straggler(_verdict(2, "compute", kind="recovered"))
        assert 2 not in srv._staleness_widen
    finally:
        srv.stop()


def test_policy_widen_opens_the_gate():
    srv = _mk_server(async_staleness=1)
    cli = _client(srv, retry_interval=0.2)
    try:
        cli.init("w", np.zeros(2, np.float32))
        cli.push_clock(0, 4)
        cli.push_clock(1, 1)  # 4 > 1 + 1: gated
        with pytest.raises(TimeoutError):
            cli.pull_stale("w", 0, 4, 1, timeout=0.4)
        srv._policy_on_straggler(_verdict(1, "compute"))  # 4 <= 1 + 1 + 2
        w, floor, _ = cli.pull_stale("w", 0, 4, 1, timeout=5.0)
        assert floor == 1
        np.testing.assert_allclose(w, [0.0, 0.0])
    finally:
        cli.close()
        srv.stop()


def test_policy_data_wait_blame_requests_shard_recut():
    srv = _mk_server(async_staleness=2, hb_interval=0.2, miss_k=5)
    s = ElasticWorkerSession("127.0.0.1", srv.port, rank=0, hb_interval=0.2)
    try:
        s.ensure_joined(wait_for_expected=False)
        el = srv._elastic
        salt0 = el.shard_salt
        srv._policy_on_straggler(_verdict(0, "data_wait"))
        assert el.shard_salt == salt0 + 1
        srv._policy_on_straggler(_verdict(0, "compute"))  # no recut
        assert el.shard_salt == salt0 + 1
    finally:
        s.close()
        srv.stop()


def test_policy_registered_only_in_async_mode():
    sync, asyn = _mk_server(), _mk_server(async_staleness=2)
    try:
        assert sync.fleet._callbacks == []
        assert asyn.fleet._callbacks == [asyn._policy_on_straggler]
    finally:
        sync.stop()
        asyn.stop()


def test_straggler_callback_errors_are_contained():
    obs.enable()
    agg = fleetstats.FleetAggregator(
        detector=fleetstats.StragglerDetector(factor=1.5, k=1),
        member_ranks=lambda: [0, 1])
    seen = []

    def boom(v):
        raise RuntimeError("policy bug")

    agg.on_straggler(boom)
    agg.on_straggler(seen.append)

    def part(rank, st):
        return json.dumps({"rank": rank, "pid": 100 + rank, "windows": [
            {"w": 0, "steps": 4, "step_time": st,
             "phases": {"forward": st * 0.9}}]}).encode()

    agg.add_part(1, part(0, 0.1))
    agg.add_part(2, part(1, 0.5))
    assert seen and seen[0]["rank"] == 1 and seen[0]["kind"] == "straggler"
    m = obs.metrics.registry.get("train.straggler.callback_errors")
    assert m is not None and m.value >= 1


def test_chaos_slow_ramp_parse_and_schedule():
    (r,) = chaos_slow.parse_env("1:forward@5-10:0.1+0.02")
    assert r.rank == 1 and r.phase == "forward"
    assert r.occurrences == set(range(5, 11))
    assert r.seconds == pytest.approx(0.1) and r.ramp == pytest.approx(0.02)
    assert r.delay_for(5) == pytest.approx(0.1)
    assert r.delay_for(8) == pytest.approx(0.16)
    r2 = chaos_slow.parse_env("0:update@3:1e+3")[0]  # an exponent, no ramp
    assert r2.seconds == pytest.approx(1000.0) and r2.ramp == 0.0
    r3 = chaos_slow.parse_env("0:data_wait:0.1+0.1")[0]
    assert r3.delay_for(3) == pytest.approx(0.3)


def test_chaos_slow_ramp_applies_in_maybe_delay():
    chaos_slow.configure(
        [chaos_slow.Rule(0, "forward", {1, 2, 3}, 0.0, ramp=0.01)])
    chaos_slow.set_rank(0)
    assert chaos_slow.maybe_delay("forward") == pytest.approx(0.0)
    assert chaos_slow.maybe_delay("forward") == pytest.approx(0.01)
    assert chaos_slow.maybe_delay("forward") == pytest.approx(0.02)
    assert chaos_slow.maybe_delay("forward") == 0.0  # past the window


def _tiny_module(mx, sym, steps=5):
    rng = np.random.RandomState(0)
    x = rng.randn(4 * steps, 8).astype(np.float32)
    y = rng.randint(0, 3, 4 * steps).astype(np.float32)
    net = sym.SoftmaxOutput(sym.FullyConnected(
        sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    return net, mx.io.NDArrayIter(x, y, batch_size=4)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_fit_phase_spans_and_windows(pkg):
    """``Module.fit`` emits the same phase spans in both packages and folds
    them into windows of the fit's accounting, with ``train.step.*``
    histograms."""
    import mxnet_tpu as jmx
    from mxnet_tpu import obs as jobs

    if pkg == "ref":
        mx, o, fs, ctx = jmx, jobs, jfs, jmx.cpu()
    else:
        mx, o, fs, ctx = tmx, obs, fleetstats, tmx.cpu()
    net, it = _tiny_module(mx, mx.sym)
    o.enable()
    fs.reset()
    window, fs._ACC.window = fs._ACC.window, 2
    try:
        mod = mx.mod.Module(net, context=ctx)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1})
        names = [e[1] for e in o.trace.events()]
        windows = list(fs._ACC.windows)
        steps = o.metrics.registry.get("train.step.seconds").count
    finally:
        fs._ACC.window = window
        fs.reset()
        o.disable()
        o.reset()
    for name in ("data_wait", "forward", "backward", "update", "metric"):
        assert names.count(name) == (6 if name == "data_wait" else 5), name
    assert steps == 5
    assert [w["w"] for w in windows] == [0, 1, 2]  # 2 + 2 + 1 steps
    assert [w["steps"] for w in windows] == [2, 2, 1]


def test_fit_spans_equal_the_reference_order():
    """The port's fit emits its phase spans in the reference's order."""
    import mxnet_tpu as jmx
    from mxnet_tpu import obs as jobs

    orders = {}
    for tag, mx, o, ctx in (("ref", jmx, jobs, jmx.cpu()),
                            ("port", tmx, obs, tmx.cpu())):
        net, it = _tiny_module(mx, mx.sym, steps=2)
        o.enable()
        try:
            mod = mx.mod.Module(net, context=ctx)
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1})
            orders[tag] = [e[1] for e in o.trace.events()
                           if e[1] in fleetstats.PHASE_BLAME]
        finally:
            o.disable()
            o.reset()
    assert orders["port"] == orders["ref"]


def test_elastic_bench_legs_on_the_cpu():
    from mxnet_tpu_torch.tools import elastic_bench

    strag = elastic_bench.run_straggler_bench(steps=24)
    assert strag["ok"], strag
    assert strag["flagged_rank"] == 2 and strag["blame"] == "compute"
    asyn = elastic_bench.run_async_bench(steps=12)
    assert asyn["async_step_decoupling"] > asyn["sync_step_decoupling"]
    over = elastic_bench.run_train_obs_overhead(steps=20, warmup=3,
                                                repeats=1)
    assert over["device"] == "cpu" and over["ips_on"] > 0
    assert "train_obs_overhead_pct" in over


@pytest.mark.parametrize("traced", [True, False])
def test_train_obs_overhead_leaves_the_callers_tracing(tmp_path, traced):
    """The overhead leg turns tracing on for both sides; afterwards a
    traced caller still traces into its stream, an untraced one does
    not trace."""
    from mxnet_tpu_torch.tools import elastic_bench

    stream = str(tmp_path / "trace.jsonl")
    if traced:
        obs.enable(jsonl=stream)
    elastic_bench.run_train_obs_overhead(steps=3, warmup=1, repeats=1)
    assert obs.enabled() == traced
    if traced:
        assert obs.trace.tracer.stream_path == stream
        with obs.trace.span("after_the_leg"):
            pass
        obs.disable()
        with open(stream) as f:
            assert "after_the_leg" in f.read()


def test_elastic_bench_recovery_and_rejoin():
    from mxnet_tpu_torch.tools import elastic_bench

    res = elastic_bench.run_elastic_bench(workers=3, ops=40, segments=2,
                                          hb_interval=0.1, miss_k=3)
    assert res["elastic_recovery_s"] is not None
    assert res["rejoin_to_training_s"] is not None
    assert res["elastic_recovery_s"] < 5.0


# ---------------------------------------------------------------------------
# 5. parity with the reference on the same inputs
# ---------------------------------------------------------------------------

def _series(kind, n=12, ranks=4, seed=0):
    """A synthetic per-window fleet series of one shape."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        per = {}
        for r in range(ranks):
            fwd = 0.1 * (1 + 0.2 * rng.rand())
            data = 0.01 * rng.rand()
            red = 0.02 * rng.rand()
            if kind == "compute" and r == 1 and i >= 3:
                fwd *= 4
            if kind == "data" and r == 2 and i >= 2:
                data += 0.5
            if kind == "reduce" and r == 0:
                red += 0.6
            if kind == "flap" and r == 3:
                fwd *= 3.5 if (i // 2) % 2 == 0 else 1.3
            if kind == "recover" and r == 1:
                fwd *= 4 if i < 5 else 1.0
            per[r] = _win(fwd + data + red + 0.005 * rng.rand(),
                          forward=fwd, data=data, reduce=red,
                          steps=int(rng.randint(1, 5)))
        out.append(per)
    return out


@pytest.mark.parametrize("kind", ["uniform", "compute", "data", "reduce",
                                  "flap", "recover"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_detector_verdicts_equal_reference(kind, k):
    mine = fleetstats.StragglerDetector(factor=1.5, k=k)
    ref = jfs.StragglerDetector(factor=1.5, k=k)
    for i, per in enumerate(_series(kind, seed=k)):
        assert mine.observe(i, per) == ref.observe(i, per)
        assert mine.flagged == ref.flagged


@pytest.mark.parametrize("seed", range(4))
def test_categorize_and_summarize_equal_reference(seed):
    rng = np.random.RandomState(seed)
    names = ["data_wait", "forward", "backward", "update",
             "elastic.sync_grads", "metric", "checkpoint", "kvstore.rpc",
             "custom_phase"]
    wins = []
    for w in range(6):
        phases = {n: float(rng.rand() * 0.1) for n in names
                  if rng.rand() < 0.7}
        wins.append({"w": w, "steps": int(rng.randint(0, 6)),
                     "step_time": float(sum(phases.values())
                                        + rng.rand() * 0.05 - 0.02),
                     "phases": phases})
    for win in wins:
        assert fleetstats.categorize(win) == jfs.categorize(win)
    assert fleetstats.summarize_windows(wins) == jfs.summarize_windows(wins)
    assert fleetstats.summarize_windows([]) is None
    assert fleetstats.PHASE_BLAME == jfs.PHASE_BLAME
    assert fleetstats.BLAME_CATEGORIES == jfs.BLAME_CATEGORIES


SLOW_SPECS = ["1:forward@3-5:0.0002",
              "0:data_wait::0.0001;2:update@2,4:0.0003",
              "1:forward@2-6:0.0001+0.00005",
              "0:backward:0.0001+0.0001",
              "2:metric@1,3-4:1e-4",
              "1:forward@2:0.0001;1:forward@4:0.0002"]


@pytest.mark.parametrize("spec", SLOW_SPECS)
def test_chaos_slow_schedules_equal_reference(spec):
    def schedule(mod):
        out = {}
        for rank in range(3):
            mod.configure(mod.parse_env(spec))
            mod.set_rank(rank)
            for phase in ("forward", "backward", "data_wait", "update",
                          "metric"):
                out[(rank, phase)] = [mod.maybe_delay(phase)
                                      for _ in range(7)]
        mod.reset()
        return out

    assert [repr(r) for r in chaos_slow.parse_env(spec)] == \
        [repr(r) for r in jslow.parse_env(spec)]
    assert schedule(chaos_slow) == schedule(jslow)


def test_hot_key_table_equals_reference():
    rng = np.random.RandomState(5)
    mine, ref = fleetstats.HotKeyTable(capacity=6), jfs.HotKeyTable(
        capacity=6)
    for _ in range(500):
        key = f"k{int(rng.zipf(1.6)) % 20}"
        nbytes = int(rng.randint(1, 4096))
        for t in (mine, ref):
            t.record(key, nbytes, 0.0)
    strip = [{k: r[k] for k in ("key", "pushes", "bytes")}
             for r in mine.snapshot()]
    assert strip == [{k: r[k] for k in ("key", "pushes", "bytes")}
                     for r in ref.snapshot()]
    assert len(mine) == 6


# ---------------------------------------------------------------------------
# 6. the flagship (slow): a chaos-slowed 3-worker elastic fit
# ---------------------------------------------------------------------------

def _run_fleet(tmp_path, tag, chaos):
    from mxnet_tpu_torch.tools.launch import start_ps_server

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ps = start_ps_server(port, 3, elastic=True, kind="python", env={
        "MXNET_OBS": "1", "MXNET_OBS_FLEET_FACTOR": "1.5",
        "MXNET_OBS_FLEET_K": "2"})
    try:
        workers = []
        for r in range(3):
            env = dict(os.environ, MXNET_ELASTIC="1",
                       MXNET_ELASTIC_HEARTBEAT_S="0.2",
                       MXNET_ELASTIC_MISS_K="4", MXNET_PS_ADDR="127.0.0.1",
                       MXNET_PS_PORT=str(port), DMLC_NUM_WORKER="3",
                       DMLC_WORKER_ID=str(r), MXNET_OBS="1",
                       MXNET_OBS_FLEET_WINDOW="2", OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO)
            env.pop("MXNET_CHAOS_SLOW", None)
            env.update(chaos)
            workers.append(subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.tools.dist_worker",
                 "elastic", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path / f"ckpt_{tag}"), "--epochs", "4",
                 "--step-delay", "0.05"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for w in workers:
            out, _ = w.communicate(timeout=420)
            assert w.returncode == 0, out[-3000:]
        cli = PSClient("127.0.0.1", port, timeout=15, retries=3,
                       retry_interval=0.2)
        stats, tel = cli.stats(), cli.telemetry()
        cli.close()
        return stats, tel
    finally:
        ps.terminate()
        ps.wait(timeout=10)
        ps.stdout.close()


@pytest.mark.slow
def test_flagship_chaos_slow_rank1_flagged_with_compute_blame(tmp_path):
    from mxnet_tpu_torch.tools import train_report

    stats, tel = _run_fleet(tmp_path, "inj",
                            {"MXNET_CHAOS_SLOW": "1:forward@3-999:0.25"})
    fleet = stats["fleet"]
    assert fleet["stragglers"], fleet
    assert fleet["stragglers"][0]["rank"] == 1
    assert fleet["stragglers"][0]["blame"] == "compute"
    first = next(x for x in fleet["verdicts"] if x["kind"] == "straggler")
    assert first["window"] <= 1 + 2 + 2, fleet["verdicts"]
    ranks = fleet["ranks"]
    assert ranks["1"]["phases"]["compute"] \
        > 2 * ranks["0"]["phases"]["compute"]
    roles = {p.get("role") for p in tel["parts"]}
    assert {"ps_server", "rank0", "rank1", "rank2"} <= roles
    doc = tmp_path / "pulled.json"
    doc.write_text(json.dumps(tel, default=float))
    out = train_report.main(["--input", str(doc), "--trace",
                             str(tmp_path / "merged.json"), "--json"])
    assert "STRAGGLERS" in out["report"] and "rank 1" in out["report"]
    merged = json.loads((tmp_path / "merged.json").read_text())
    by_pid = {}
    for e in merged["traceEvents"]:
        if e.get("ph") == "X":
            by_pid.setdefault(e["pid"], set()).add(e["name"])
    for p in tel["parts"]:
        if str(p.get("role", "")).startswith("rank"):
            assert "forward" in by_pid.get(p["pid"], set())
    srv_pid = next(p["pid"] for p in tel["parts"]
                   if p.get("role") == "ps_server")
    assert "kvstore.server.rpc" in by_pid.get(srv_pid, set())
    stats2, _ = _run_fleet(tmp_path, "clean", {})
    assert stats2["fleet"]["stragglers"] == []
    assert [x for x in stats2["fleet"]["verdicts"]
            if x["kind"] == "straggler"] == []
