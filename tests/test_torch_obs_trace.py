"""The port's span plane (``mxnet_tpu_torch/obs``: ``context``, ``trace``
and the Prometheus/merge half of ``export``) against the reference's
``mxnet_tpu/obs``, on the CPU.

- context: the same ids and flags give byte-identical traceparent headers
  and wire keys in both packages, malformed headers parse to None in
  both, and head sampling is decided once at the root (both packages'
  samplers seeded alike give the same decisions);
- trace: one call sequence (nested spans, spans under a context, instant
  events, counters, completes, a drain, a reset) through a fresh tracer of
  each package, under one patched clock and one span-id counter, gives
  equal chrome traces and equal JSONL lines; disabled and unsampled spans
  are the shared no-op;
- export: ``render_prometheus``/``to_prometheus``/``parts_to_prometheus``
  are byte-identical from the same snapshots (exemplars, strict 0.0.4 and
  HELP lines included), and ``merge_chrome_parts`` is equal for the same
  parts.

Everything here is pure Python over the same inputs: equality is exact.
"""
import itertools
import json
import random
import types

import numpy as np
import pytest

from mxnet_tpu import obs as jobs
from mxnet_tpu.obs import context as jctx
from mxnet_tpu.obs import trace as jtrace
from mxnet_tpu_torch import obs as tobs
from mxnet_tpu_torch.obs import context as tctx
from mxnet_tpu_torch.obs import trace as ttrace

# ``obs.export`` is the chrome-trace export function in both packages;
# the module is ``obs.export_mod``
jexp = jobs.export_mod
texp = tobs.export_mod


@pytest.fixture(autouse=True)
def _clean():
    for o in (jobs, tobs):
        o.disable()
        o.reset()
    for c in (jctx, tctx):
        c.set_sample_rate(1.0)
    yield
    for o in (jobs, tobs):
        o.disable()
        o.reset()
    for c in (jctx, tctx):
        c.set_sample_rate(1.0)


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

def _ids(seed):
    rng = np.random.default_rng(seed)
    return (f"{int(rng.integers(1, 2 ** 62)):032x}",
            f"{int(rng.integers(1, 2 ** 62)):016x}")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("flags", [(True, False, False), (False, True, False),
                                   (True, False, True), (False, False, False)])
def test_header_and_key_injection_byte_identical(seed, flags):
    trace_id, span_id = _ids(seed)
    sampled, tail, force = flags
    ref = jctx.TraceContext(trace_id, span_id, sampled, tail=tail,
                            force=force)
    got = tctx.TraceContext(trace_id, span_id, sampled, tail=tail,
                            force=force)
    assert got.to_header() == ref.to_header()
    assert got.records == ref.records
    for key in ("", "fc_weight", "arg:stage2_unit1_bn1_gamma"):
        wire = tctx.inject_key(key, got)
        assert wire == jctx.inject_key(key, ref)
        assert wire.encode("utf-8") == jctx.inject_key(key, ref).encode()
        k, back = tctx.extract_key(wire)
        rk, rback = jctx.extract_key(wire)
        assert k == rk == key
        assert back.to_header() == rback.to_header() == ref.to_header()
    assert tctx.inject_key("w", None) == jctx.inject_key("w", None) == "w"
    assert tctx.extract_key("w") == ("w", None)


@pytest.mark.parametrize("bad", [
    "", "garbage", "00-xyz-123-01", "01-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-zz",
    "00-" + "A" * 31 + "-" + "b" * 16 + "-01",
])
def test_malformed_headers_parse_to_none_in_both(bad):
    assert jctx.from_header(bad) is None
    assert tctx.from_header(bad) is None
    assert tctx.extract_key("k\x1f" + bad) == ("k", None)


def test_uppercase_and_padded_headers_parse_alike():
    h = "  00-" + "AB" * 16 + "-" + "CD" * 8 + "-03 "
    assert tctx.from_header(h).to_header() == jctx.from_header(h).to_header()


def test_head_sampling_decided_at_the_root():
    for c in (jctx, tctx):
        c.set_sample_rate(0.0)
        assert c.new_root().sampled is False
        c.set_sample_rate(1.0)
        assert c.new_root().sampled is True
        assert c.TraceContext("a" * 32, "b" * 16, False).child().sampled \
            is False
    decisions = []
    for c in (jctx, tctx):
        c.set_sample_rate(0.3)
        old = c._rng
        c._rng = random.Random(7)
        try:
            decisions.append([c.new_root().sampled for _ in range(64)])
        finally:
            c._rng = old
    assert decisions[0] == decisions[1]
    assert 0 < sum(decisions[1]) < 64


def test_use_is_a_noop_for_none_and_restores():
    outer = tctx.TraceContext("a" * 32, "b" * 16)
    with tctx.use(outer):
        with tctx.use(None):
            assert tctx.current() is outer
        inner = outer.child()
        with tctx.use(inner):
            assert tctx.current() is inner
        assert tctx.current() is outer
    assert tctx.current() is None


def test_wire_kill_switch(monkeypatch):
    ctx = tctx.new_root()
    monkeypatch.setattr(tctx, "_WIRE", False)
    assert tctx.inject_key("w", ctx) == "w"


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

def _patched(monkeypatch, mod_trace, mod_ctx, clock):
    fake = types.SimpleNamespace(monotonic=lambda: clock[0],
                                 time=lambda: 1.7e9 + clock[0])
    monkeypatch.setattr(mod_trace, "time", fake)
    monkeypatch.setattr(mod_trace, "_ENABLED", True)
    counter = itertools.count(1)
    monkeypatch.setattr(mod_ctx, "new_span_id",
                        lambda: f"{next(counter):016x}")


def _drive(mod_trace, mod_ctx, clock, path):
    """One call sequence through a fresh tracer; returns its exports."""
    tr = mod_trace.Tracer(capacity=64)
    tr.stream_to(str(path))

    def tick(dt=0.25):
        clock[0] += dt

    with tr.span("outer", epoch=1):
        tick()
        with tr.span("inner", rows=2):
            tick()
            tr.event("chaos.drop", op="infer")
        tick()
    tr.counter("device.live_bytes", 4096)
    root = mod_ctx.TraceContext("a" * 32, "b" * 16, True)
    with mod_ctx.use(root):
        with tr.span("serve.rpc", op="infer"):
            tick()
            tr.event("serve.client.retry", attempt=1)
            tr.complete("serve.queue_wait", clock[0] - 0.1, 0.1, rows=1)
        tick()
    tr.complete("decode.step", clock[0], 0.05, ctx=root, active=3)
    unsampled = mod_ctx.TraceContext("c" * 32, "d" * 16, False)
    with mod_ctx.use(unsampled):
        assert tr.span("skipped") is mod_trace._NOOP
        tr.event("skipped.event")
    chrome = tr.to_chrome_trace(metrics={"counters": {"a": 1}})
    drained = tr.drain()
    tick()
    tr.reset()
    with tr.span("after_reset"):
        tick()
    tr.stream_metrics({"counters": {"x": 2}})
    tr.stream_to(None)
    return chrome, drained, path.read_text().splitlines()


def test_same_calls_give_the_same_chrome_trace_and_jsonl(monkeypatch,
                                                         tmp_path):
    out = []
    for mod_trace, mod_ctx, name in ((jtrace, jctx, "ref"),
                                     (ttrace, tctx, "port")):
        clock = [100.0]
        _patched(monkeypatch, mod_trace, mod_ctx, clock)
        out.append(_drive(mod_trace, mod_ctx, clock,
                          tmp_path / f"{name}.jsonl"))
    (rc, rd, rl), (pc, pd, pl) = out
    assert pc == rc
    assert pd == rd
    assert pl == rl
    names = [json.loads(l)["name"] for l in pl]
    assert names[0] == "clock" and "skipped" not in names
    assert "after_reset" in names and names[-1] == "metrics"


def test_disabled_and_unsampled_spans_are_the_shared_noop():
    assert tobs.span("x") is ttrace._NOOP
    tobs.enable()
    with tctx.use(tctx.TraceContext("a" * 32, "b" * 16, False)):
        assert tobs.span("x") is ttrace._NOOP
        tobs.event("y")
    assert isinstance(tobs.span("x"), ttrace._Span)
    assert ttrace.drain() == []


def test_span_parent_chain_under_a_context():
    tobs.enable()
    root = tctx.new_root()
    with tctx.use(root):
        with tobs.span("outer"):
            with tobs.span("inner"):
                pass
    evs = {e["name"]: e["args"] for e in ttrace.drain() if e["ph"] == "X"}
    assert evs["outer"]["trace_id"] == evs["inner"]["trace_id"] \
        == root.trace_id
    assert evs["outer"]["parent_id"] == root.span_id
    assert evs["inner"]["parent_id"] == evs["outer"]["span_id"]
    assert tctx.current() is None


def test_telemetry_part_and_export_schema(tmp_path):
    for o in (jobs, tobs):
        o.enable()
        with o.span("a"):
            o.inc("serve.rows_executed", 3)
    ref = jobs.telemetry_part(drain=False, role="server")
    got = tobs.telemetry_part(drain=False, role="server")
    assert set(got) == set(ref)
    assert [e["name"] for e in got["spans"]] == ["a"]
    assert got["metrics"] == ref["metrics"]
    doc = json.loads(open(tobs.export(str(tmp_path / "t.json"))).read())
    assert doc["otherData"]["metrics"]["counters"] == \
        {"serve.rows_executed": 3}
    assert tobs.telemetry_part()["spans"] and \
        tobs.telemetry_part()["spans"] == []  # drained


def test_enable_jsonl_expands_pid_and_disable_appends_metrics(tmp_path):
    import os

    tobs.enable(jsonl=str(tmp_path / "r-%p.jsonl"))
    with tobs.span("x"):
        tobs.inc("c")
    tobs.disable()
    lines = [json.loads(l) for l in
             (tmp_path / f"r-{os.getpid()}.jsonl").read_text().splitlines()]
    assert [l["name"] for l in lines] == ["clock", "x", "metrics"]
    assert lines[-1]["metrics"]["counters"] == {"c": 1}


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _snapshot(seed):
    """A registry snapshot from the reference's registry (the port's
    registry shares its schema: tests/test_torch_obs_metrics.py)."""
    from mxnet_tpu.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    rng = np.random.default_rng(seed)
    for i in range(3):
        reg.counter(f"fleet.failovers{i}").inc(int(rng.integers(0, 9)))
        reg.gauge(f"serve.queue_depth{i}").set(float(rng.random() * 5))
    for v in rng.exponential(0.05, 40):
        reg.histogram("serve.latency_seconds").observe(float(v))
    reg.histogram("fleet.request_latency_seconds").observe(0.003)
    return reg.snapshot()


EXEMPLARS = {"serve.latency_seconds": {
    "0.05": {"trace_id": "ab" * 16, "value": 0.0423, "ts": 1.7e9 + 0.5},
    "0.0001": {"trace_id": "cd" * 16, "value": 0.00007, "ts": 1.7e9},
    "+Inf": {"trace_id": "ef" * 16, "value": 99.0, "ts": None}}}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("openmetrics", [True, False])
def test_prometheus_text_byte_identical(seed, openmetrics):
    snap = _snapshot(seed)
    labels = {"pid": "7", "role": "replica\n\"0\""}
    assert texp.to_prometheus(snap, labels=labels, exemplars=EXEMPLARS,
                              openmetrics=openmetrics) == \
        jexp.to_prometheus(snap, labels=labels, exemplars=EXEMPLARS,
                           openmetrics=openmetrics)
    parts = [{"pid": 1, "role": "fleet", "metrics": snap},
             {"pid": 2, "metrics": _snapshot(seed + 10),
              "exemplars": EXEMPLARS},
             {"pid": 1, "role": "dup", "metrics": {}}]
    text = texp.parts_to_prometheus(parts, openmetrics=openmetrics)
    assert text == jexp.parts_to_prometheus(parts, openmetrics=openmetrics)
    assert text.endswith("# EOF\n") == openmetrics
    assert "# HELP mxnet_serve_latency_seconds" in text


def test_render_prometheus_empty_and_prefix():
    assert texp.render_prometheus([]) == jexp.render_prometheus([]) == ""
    snap = _snapshot(5)
    assert texp.render_prometheus([(None, snap)], prefix="") == \
        jexp.render_prometheus([(None, snap)], prefix="")


def test_merge_chrome_parts_equal():
    parts = [
        {"pid": 10, "role": "fleet", "wall_epoch": 1000.5,
         "spans": [{"ph": "X", "name": "serve.rpc", "ts": 0.1, "dur": 0.02,
                    "tid": 3, "args": {"trace_id": "a" * 32}},
                   {"ph": "i", "name": "fleet.chaos_kill", "ts": 0.2,
                    "tid": 3},
                   {"ph": "C", "name": "device.live_bytes", "ts": 0.3,
                    "tid": 4, "args": {"value": 12.0}},
                   {"ph": "M", "name": "clock"}, "torn"],
         "metrics": _snapshot(1)},
        {"pid": 11, "wall_epoch": 1000.0,
         "spans": [{"ph": "X", "name": "serve.execute", "ts": 0.0,
                    "dur": None, "tid": 9}],
         "metrics": _snapshot(2)},
        {"pid": 10, "role": "replica0", "wall_epoch": 1000.5, "spans": [],
         "metrics": _snapshot(3)},
        {"pid": 12, "spans": [], "metrics": {}},
        "garbage",
    ]
    got = texp.merge_chrome_parts(parts)
    assert got == jexp.merge_chrome_parts(parts)
    assert got["otherData"]["skipped_records"] == 2
    assert texp.merge_chrome_parts(parts, metrics={"x": 1}) == \
        jexp.merge_chrome_parts(parts, metrics={"x": 1})
