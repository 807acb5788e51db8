"""The port's tail-retention plane (``mxnet_tpu_torch/obs/tail.py``)
against the reference's ``mxnet_tpu/obs/tail.py``, on the CPU.

The same seeded outcome streams go through both packages'
``RetentionPolicy`` (one ``random.Random`` seed and explicit clock
readings each) and must give the same keep/drop verdicts and reasons: the
token bucket's burst and refill, the uniform baseline past the budget and
on the fast path, force-retain. The same span records go through both
``TailBuffer``s — hold, root verdicts, stragglers, verdicts resolved from
the telemetry plane, overflow, the per-trace cap and the hold-window
expiry under a patched clock — and must leave the same stats, retained-id
logs and durable rings. Root-close plumbing (thread-local notes,
``finish_root``/``finish_remote``, ``forced``) and the exemplars then
agree too. Pure Python on both sides: equality is exact.
"""
import random
import types

import numpy as np
import pytest

from mxnet_tpu import obs as jobs
from mxnet_tpu.obs import context as jctx
from mxnet_tpu.obs import tail as jtail
from mxnet_tpu_torch import obs as tobs
from mxnet_tpu_torch.obs import context as tctx
from mxnet_tpu_torch.obs import tail as ttail

PKGS = ((jobs, jctx, jtail), (tobs, tctx, ttail))


@pytest.fixture(autouse=True)
def _clean():
    for o, c, t in PKGS:
        t.disable()
        o.disable()
        o.reset()
        c.set_sample_rate(1.0)
    yield
    for o, c, t in PKGS:
        t.disable()
        o.disable()
        o.reset()
        c.set_sample_rate(1.0)


def _outcomes(seed, n=120):
    rng = np.random.default_rng(seed)
    out = []
    t = 0.0
    for _ in range(n):
        t += float(rng.exponential(0.02))
        kind = int(rng.integers(0, 6))
        outcome = ("ok", "error", "shed", "deadline", "ok", "ok")[kind]
        flags = ("hedged",) if rng.random() < 0.1 else ()
        dur = float(rng.exponential(0.1))
        forced = bool(rng.random() < 0.05)
        out.append((dur, outcome, flags, forced, t))
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kw", [
    {"slow_ms": 250.0, "budget_per_s": 5.0, "burst": 3.0, "baseline": 0.1},
    {"slow_ms": 50.0, "budget_per_s": 0.0, "burst": 1.0, "baseline": 0.0},
    {"slow_ms": 1e9, "budget_per_s": 50.0, "burst": None, "baseline": 0.5},
])
def test_policy_verdicts_equal_for_seeded_outcomes(seed, kw):
    verdicts = []
    for _o, _c, t in PKGS:
        p = t.RetentionPolicy(rng=random.Random(seed), **kw)
        verdicts.append([p.decide(d, outcome=o, flags=f, forced=fo, now=now)
                         for d, o, f, fo, now in _outcomes(seed)])
    assert verdicts[0] == verdicts[1]
    reasons = {r for _k, r in verdicts[1]}
    assert len(reasons) > 1


def test_policy_defaults_read_the_same_env(monkeypatch):
    monkeypatch.setenv("MXNET_OBS_TAIL_SLOW_MS", "12.5")
    monkeypatch.setenv("MXNET_OBS_TAIL_BUDGET", "3")
    monkeypatch.setenv("MXNET_OBS_TAIL_BASELINE", "garbage")
    got = [(p.slow_ms, p.budget_per_s, p.burst, p.baseline)
           for p in (t.RetentionPolicy() for _o, _c, t in PKGS)]
    assert got[0] == got[1] == (12.5, 3.0, 6.0, 0.01)


def _rec(name, tid="t"):
    return ("X", name, 0.0, 0.001, 1, 1, {"trace_id": tid})


def _buffer_run(o, t, monkeypatch):
    """One buffer scenario under a patched clock; returns its outcome."""
    clock = [10.0]
    monkeypatch.setattr(t, "time", types.SimpleNamespace(
        monotonic=lambda: clock[0], time=lambda: 1.7e9 + clock[0]))
    o.enable()
    policy = t.RetentionPolicy(slow_ms=100.0, budget_per_s=1.0, burst=2.0,
                               baseline=0.0, rng=random.Random(3))
    b = t.TailBuffer(policy=policy, max_traces=4, max_spans=3, hold_s=5.0)
    verdicts = []
    for i in range(6):  # 6 traces into 4 slots: 2 overflow
        for j in range(5):  # 5 spans into a cap of 3
            b.hold(f"t{i}", _rec(f"s{i}.{j}", f"t{i}"))
        clock[0] += 0.5
    verdicts.append(b.finish("t5", 0.2))             # slow: retained
    verdicts.append(b.finish("t4", 0.01))            # fast: dropped
    b.hold("t5", _rec("straggler5", "t5"))           # follows the verdict
    b.hold("t4", _rec("straggler4", "t4"))
    verdicts.append(b.finish("t3", 0.01, outcome="error"))
    verdicts.append(b.finish("t2", 0.01, outcome="error"))  # out of budget
    promoted = b.resolve(["t0", "t1", "nope"])       # t0/t1 overflowed
    b.hold("t9", _rec("late", "t9"))
    clock[0] += 4.0
    b.hold("t10", _rec("later", "t10"))
    clock[0] += 2.0
    expired = b.expire()                              # t9 past hold_s
    ring = [r[1] for r in o.trace.tracer.events()]
    return {"verdicts": verdicts, "promoted": promoted, "expired": expired,
            "stats": b.stats(), "retained": b.retained_ids(),
            "pending": b.pending_count(), "ring": ring,
            "counters": o.metrics.snapshot()["counters"]}


def test_buffer_settle_straggle_resolve_expire_equal(monkeypatch):
    ref = _buffer_run(jobs, jtail, monkeypatch)
    got = _buffer_run(tobs, ttail, monkeypatch)
    assert got == ref
    assert got["stats"]["overflow"] == 2 and got["expired"] == 1
    assert "straggler5" in got["ring"] and "straggler4" not in got["ring"]


def _root_close_run(o, c, t):
    o.enable()
    t.enable(policy=t.RetentionPolicy(slow_ms=1e9, budget_per_s=1e9,
                                      burst=1e9, baseline=0.0))
    out = []
    # a tail-mode root: spans pend, a noted deadline retains the trace
    root = c.new_root()
    assert root.tail and not root.sampled
    with c.use(root):
        with o.trace.span("serve.rpc", op="infer"):
            o.trace.complete("serve.queue_wait", 0.0, 0.001)
    t.note("deadline")
    out.append(t.finish_root(root, 0.01))
    # a healthy root drops, and its notes never leak into the next one
    root2 = c.new_root()
    with c.use(root2):
        with o.trace.span("serve.rpc", op="infer"):
            pass
    out.append(t.finish_root(root2, 0.01))
    # a remote hop with a hedge note retains locally
    remote = c.TraceContext("e" * 32, "f" * 16, False, tail=True)
    with c.use(remote):
        with o.trace.span("fleet.route", replica=0):
            pass
    t.note(hedged=True)
    out.append(t.finish_remote(remote, 0.01))
    # forced roots record durably at once and log their verdict
    with t.forced():
        froot = c.new_root()
    assert froot.force and froot.sampled
    with c.use(froot):
        with o.trace.span("serve.rpc", op="infer"):
            pass
    out.append(t.finish_root(froot, 0.02))
    # a tail context from the wire in a process without tail mode: dropped
    t.disable()
    with c.use(c.TraceContext("1" * 32, "2" * 16, False, tail=True)):
        with o.trace.span("replica.span"):
            pass
    spans = [(e["name"], (e.get("args") or {}).get("trace_id") in
              (root.trace_id, remote.trace_id, froot.trace_id))
             for e in o.trace.drain() if e["ph"] == "X"]
    return out, spans


def test_root_close_verdicts_and_durable_spans_equal():
    ref_out, ref_spans = _root_close_run(jobs, jctx, jtail)
    got_out, got_spans = _root_close_run(tobs, tctx, ttail)
    assert got_out == ref_out
    assert got_spans == ref_spans
    assert got_out == [(True, "deadline"), (False, "fast_path"),
                       (True, "hedged"), (True, "forced")]


def test_notes_are_noops_with_tail_mode_off():
    for _o, _c, t in PKGS:
        t.note("shed", hedged=True)
        assert t.take_notes() == (None, set())


def test_retained_traces_stamp_the_same_exemplar_buckets():
    snaps = []
    for o, c, t in PKGS:
        o.enable()
        o.observe("serve.latency_seconds", 0.01)  # the histogram exists
        b = t.enable(policy=t.RetentionPolicy(slow_ms=0.0, budget_per_s=1e9,
                                              burst=1e9, baseline=0.0))
        for i, d in enumerate((0.0004, 0.03, 0.2, 50.0)):
            b.finish(f"{i:032x}", d)
        ex = t.exemplars_snapshot()
        snaps.append({h: {le: (e["trace_id"], e["value"])
                          for le, e in by.items()} for h, by in ex.items()})
    assert snaps[0] == snaps[1]
    assert "+Inf" in snaps[1]["serve.latency_seconds"]


def test_set_buffer_and_reset_keep_the_config():
    b = ttail.enable(max_traces=7, max_spans=5, hold_s=1.5)
    assert tctx.tail_mode() and ttail.enabled()
    ttail.reset()
    nb = ttail.buffer()
    assert nb is not b and (nb.max_traces, nb.max_spans, nb.hold_s) == \
        (7, 5, 1.5)
    ttail.set_buffer(None)
    assert not tctx.tail_mode() and ttail.stats() is None
