"""The port's serve plane under telemetry — ``ServeClient`` →
``ServeServer`` → ``DynamicBatcher`` → ``InferenceEngine`` and the decode
stream path — mirroring ``tests/test_obs_distributed.py`` and the serve
cases of ``tests/test_tail.py``, on the CPU.

- one trace id from the client's ``serve.client.rpc`` span through
  ``serve.rpc``, ``serve.queue_wait``, ``serve.batch_assembly``,
  ``serve.execute`` and ``serve.serialize``, with the parent chain across
  threads; unsampled requests record nothing on any hop; a sampled batch
  member keeps the batch's spans behind an unsampled lead; a hedged
  router attempt keeps the trace; an ambient context is joined, not
  re-rooted; an old-format frame (no context) becomes a new root at the
  server;
- across packages: a reference client with a context against the port's
  server, and the port's client against the reference's server — each
  side's spans carry the other's trace id; the port's PS server strips a
  reference client's context before any key lookup;
- ``stats`` embeds the metrics snapshot; ``OP_TELEMETRY`` drains, carries
  retained verdicts, and exposes valid OpenMetrics (strict 0.0.4 on
  request); ``OP_DUMP`` returns a bundle;
- tail mode: a retained request keeps every hop under one id, a healthy
  one drops on every hop;
- decode streams: one trace id from the client to ``decode.queue_wait``,
  the prefill's ``decode.execute`` and ``decode.token``; each step span
  carries flops, bytes and a roofline class; tracing changes no token;
  a deadline-exceeded stream is retained with its outcome;
- ``serve_bench``'s telemetry legs return the reference legs' keys.
"""
import os
import re
import socket
import sys
import time

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu import obs as jobs
from mxnet_tpu import serve as jserve
from mxnet_tpu import symbol as jsym
from mxnet_tpu_torch import obs as tobs
from mxnet_tpu_torch import serve
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.kvstore.ps_server import (PSServer, _pack_arrays,
                                               _recv_msg, _send_msg,
                                               _unpack_arrays)
from mxnet_tpu_torch.obs import context
from mxnet_tpu_torch.serve import ServeClient, ServeServer
from mxnet_tpu_torch.serve.server import OP_INFER, STATUS_OK, _INFER_HDR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

X = np.arange(8, dtype=np.float32).reshape(2, 4)


def _off(o):
    o.tail.disable()
    o.disable()
    o.reset()
    o.context.set_sample_rate(1.0)


@pytest.fixture(autouse=True)
def _clean():
    for o in (jobs, tobs):
        _off(o)
    yield
    for o in (jobs, tobs):
        _off(o)


def _linear_engine(scale=1.0):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=4, no_bias=True, name="fc")
    arg = {"fc_weight": np.eye(4, dtype=np.float32) * scale}
    return serve.InferenceEngine(net, arg, max_batch_size=8, lint="off",
                                 ctx=mx.cpu())


def _serve_pair(engine=None, **kw):
    srv = ServeServer(engine or _linear_engine(), port=0,
                      max_linger_ms=0.0, **kw)
    srv.start()
    return srv, ServeClient("127.0.0.1", srv.port)


def _spans(evs):
    return {e["name"]: (e.get("args") or {}) for e in evs
            if e["ph"] == "X"}


# ---------------------------------------------------------------------------
# propagation
# ---------------------------------------------------------------------------

def test_serve_infer_one_trace_id_client_to_engine():
    tobs.enable()
    srv, cli = _serve_pair()
    try:
        np.testing.assert_array_equal(cli.infer(X), X)
    finally:
        cli.close()
        srv.stop()
    spans = _spans(tobs.trace.drain())
    for name in ("serve.client.rpc", "serve.rpc", "serve.queue_wait",
                 "serve.batch_assembly", "serve.execute",
                 "serve.serialize"):
        assert name in spans, f"missing {name}"
    assert len({s["trace_id"] for s in spans.values()}) == 1
    assert spans["serve.rpc"]["parent_id"] == \
        spans["serve.client.rpc"]["span_id"]
    assert spans["serve.queue_wait"]["parent_id"] == \
        spans["serve.rpc"]["span_id"]
    assert spans["serve.execute"]["parent_id"] == \
        spans["serve.rpc"]["span_id"]
    ex = spans["serve.execute"]
    assert (ex["bucket"], ex["rows"], ex["compile"]) == (2, 2, True)


def test_unsampled_request_succeeds_and_records_nothing():
    tobs.enable()
    context.set_sample_rate(0.0)
    srv, cli = _serve_pair()
    try:
        np.testing.assert_array_equal(cli.infer(X), X)
    finally:
        cli.close()
        srv.stop()
    assert [e["name"] for e in tobs.trace.drain()
            if e["name"].startswith("serve.")] == []


def test_sampled_member_keeps_execute_span_behind_unsampled_lead():
    from mxnet_tpu_torch.serve.batcher import DynamicBatcher

    tobs.enable()
    batcher = DynamicBatcher(_linear_engine(), max_linger_ms=80.0,
                             max_queue=16)
    unsampled = context.TraceContext("e" * 32, "f" * 16, sampled=False)
    sampled = context.new_root(sampled=True)
    try:
        with context.use(unsampled):
            f1 = batcher.submit([X[:1]])
        with context.use(sampled):
            f2 = batcher.submit([X[1:]])
        f1.result(timeout=10)
        f2.result(timeout=10)
    finally:
        batcher.close()
    evs = [e for e in tobs.trace.drain() if e["ph"] == "X"]
    spans = _spans(evs)
    assert spans["serve.execute"]["trace_id"] == sampled.trace_id
    assert spans["serve.batch_assembly"]["trace_id"] == sampled.trace_id
    waits = [e for e in evs if e["name"] == "serve.queue_wait"]
    assert [w["args"]["trace_id"] for w in waits] == [sampled.trace_id]


def test_hedged_attempt_carries_trace_context():
    from mxnet_tpu_torch.serve.fleet import LocalReplica, ReplicaPool, Router

    tobs.enable()

    def factory(delay):
        def f():
            eng = _linear_engine()
            if delay:
                real = eng.infer

                def slow(inputs, n_valid=None):
                    time.sleep(delay)
                    return real(inputs, n_valid=n_valid)

                eng.infer = slow
            s = ServeServer(eng, port=0, max_linger_ms=0.0)
            s.start()
            return s
        return f

    pool = ReplicaPool([LocalReplica(factory(0.6)), LocalReplica(factory(0))],
                       probe_interval=0.1, backoff_base=0.05,
                       ready_timeout=60).start()
    try:
        router = Router(pool, hedge_ms=60.0)
        root = context.new_root()
        with context.use(root):
            outs, _ = router.infer([X], deadline_ms=15000)
        np.testing.assert_array_equal(outs[0], X)
        assert router.hedges >= 1
    finally:
        pool.stop()
    evs = tobs.trace.drain()
    route = {(e.get("args") or {}).get("trace_id") for e in evs
             if e["name"] == "fleet.route"}
    execs = {(e.get("args") or {}).get("trace_id") for e in evs
             if e["name"] == "serve.execute"}
    assert route == {root.trace_id}
    assert execs and execs <= {root.trace_id}
    assert any(e["name"] == "fleet.hedge" and e["ph"] == "i" for e in evs)


def test_ambient_context_joined_and_old_format_frame_is_a_new_root():
    tobs.enable()
    srv, cli = _serve_pair()
    root = context.new_root()
    try:
        with context.use(root):
            cli.infer(X)
            cli.infer(X)
        assert {e["args"]["trace_id"] for e in tobs.trace.drain()
                if e["ph"] == "X" and "trace_id" in (e.get("args") or {})} \
            == {root.trace_id}
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        payload = (_INFER_HDR.pack(0.0, 1)
                   + _pack_arrays([np.ascontiguousarray(X)]))
        _send_msg(s, OP_INFER, "", payload)  # the old wire bytes
        op, _key, reply = _recv_msg(s)
        assert op == OP_INFER and reply[0] == STATUS_OK
        np.testing.assert_array_equal(_unpack_arrays(reply[5:])[0][0], X)
        s.close()
    finally:
        cli.close()
        srv.stop()
    spans = _spans(tobs.trace.drain())
    assert spans["serve.rpc"]["trace_id"] == \
        spans["serve.execute"]["trace_id"] != root.trace_id


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def test_reference_client_context_reaches_the_ports_spans():
    jobs.enable()
    tobs.enable()
    srv = ServeServer(_linear_engine(), port=0, max_linger_ms=0.0)
    srv.start()
    cli = jserve.ServeClient("127.0.0.1", srv.port)
    root = jobs.context.new_root()
    try:
        with jobs.context.use(root):
            np.testing.assert_array_equal(cli.infer(X), X)
    finally:
        cli.close()
        srv.stop()
    port = _spans(tobs.trace.drain())
    ref = _spans(jobs.trace.drain())
    for name in ("serve.rpc", "serve.queue_wait", "serve.execute"):
        assert port[name]["trace_id"] == root.trace_id
    assert port["serve.rpc"]["parent_id"] == \
        ref["serve.client.rpc"]["span_id"]


def test_port_client_context_reaches_the_references_spans():
    jobs.enable()
    tobs.enable()
    data = jsym.Variable("data")
    net = jsym.FullyConnected(data, num_hidden=4, no_bias=True, name="fc")
    eng = jserve.InferenceEngine(net, {"fc_weight": np.eye(4, dtype=np.float32)},
                                 max_batch_size=8, lint="off")
    srv = jserve.ServeServer(eng, port=0, max_linger_ms=0.0)
    srv.start()
    cli = ServeClient("127.0.0.1", srv.port)
    try:
        np.testing.assert_array_equal(cli.infer(X), X)
    finally:
        cli.close()
        srv.stop()
    port = _spans(tobs.trace.drain())
    ref = _spans(jobs.trace.drain())
    tid = port["serve.client.rpc"]["trace_id"]
    assert ref["serve.rpc"]["trace_id"] == ref["serve.execute"]["trace_id"] \
        == tid


def test_ps_wire_context_stripped_before_key_lookup():
    from mxnet_tpu.kvstore.ps_client import PSClient

    jobs.enable()
    srv = PSServer(host="127.0.0.1", port=0, num_workers=1)
    srv.start()
    try:
        cli = PSClient("127.0.0.1", srv.port, timeout=5, retries=2,
                       retry_interval=0.05)
        w = np.ones((4, 3), np.float32)
        root = jobs.context.new_root()
        with jobs.context.use(root):
            cli.init("w", w)
            cli.push("w", np.full((4, 3), 0.5, np.float32))
            out = cli.pull("w")
        np.testing.assert_allclose(out, w + 0.5)
        # old format (no context): the same key, the same tables
        cli.push("w", np.full((4, 3), 0.5, np.float32))
        np.testing.assert_allclose(cli.pull("w"), w + 1.0)
        cli.close()
    finally:
        srv.stop()
    traced = {(e["name"], (e.get("args") or {}).get("key"))
              for e in jobs.trace.drain()
              if (e.get("args") or {}).get("trace_id") == root.trace_id}
    assert ("kvstore.rpc", "w") in traced


# ---------------------------------------------------------------------------
# stats, telemetry, dump
# ---------------------------------------------------------------------------

_LINE = re.compile(
    r"^(# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram)"
    r"|# HELP [a-zA-Z_:][a-zA-Z0-9_:]* \S.*"
    r"|# EOF"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [0-9eE+.inf-]+"
    r"( # \{[^}]*\} [0-9eE+.inf-]+( [0-9eE+.-]+)?)?)$")


def test_stats_telemetry_and_dump_over_the_wire():
    tobs.enable()
    srv, cli = _serve_pair()
    try:
        cli.infer(X)
        st = cli.stats()
        assert set(st["metrics"]) == {"counters", "gauges", "histograms"}
        assert st["metrics"]["histograms"]["serve.latency_seconds"][
            "count"] >= 1
        part = cli.telemetry()["parts"][0]
        assert part["pid"] == os.getpid() and part["wall_epoch"] > 0
        assert {e["name"] for e in part["spans"]} >= {"serve.rpc",
                                                       "serve.execute"}
        assert part["stats"]["engine"]["executions"] >= 1
        again = {e["name"] for e in cli.telemetry()["parts"][0]["spans"]}
        assert "serve.execute" not in again  # drained
        prom = cli.telemetry(fmt="prometheus")
        strict = cli.telemetry(fmt="prometheus", openmetrics=False)
        bundle = cli.dump(reason="probe")
    finally:
        cli.close()
        srv.stop()
    lines = [ln for ln in prom.splitlines() if ln]
    assert lines[-1] == "# EOF"
    for ln in lines:
        assert _LINE.match(ln), ln
    assert any("mxnet_serve_latency_seconds_bucket" in ln for ln in lines)
    assert "# EOF" not in strict
    assert bundle["blackbox"] == 1 and bundle["reason"] == "probe"
    assert set(bundle) >= {"events", "metrics", "threads"}


def test_tail_mode_keeps_retained_hops_and_drops_healthy_ones():
    tobs.enable()
    tobs.tail.enable(policy=tobs.tail.RetentionPolicy(
        slow_ms=0.0, budget_per_s=1e9, burst=1e9, baseline=0.0))
    srv, cli = _serve_pair()
    try:
        np.testing.assert_array_equal(cli.infer(X), X)
        spans = _spans(tobs.trace.drain())
        assert {"serve.client.rpc", "serve.rpc", "serve.queue_wait",
                "serve.execute"} <= set(spans)
        assert len({s["trace_id"] for s in spans.values()}) == 1
        assert tobs.tail.stats()["pending"] == 0
        tobs.tail.buffer().policy = tobs.tail.RetentionPolicy(
            slow_ms=1e9, budget_per_s=1e9, burst=1e9, baseline=0.0)
        np.testing.assert_array_equal(cli.infer(X), X)
        assert [e for e in tobs.trace.drain()
                if e["ph"] == "X" and e["name"].startswith("serve.")] == []
        assert tobs.tail.stats()["dropped"] >= 1
        # a replica-side pending trace promotes with the collection that
        # carries its verdict
        ctx = context.new_root()
        with context.use(ctx):
            with tobs.span("serve.execute"):
                pass
        (part,) = cli.telemetry(retained=[ctx.trace_id])["parts"]
        assert [s["args"]["trace_id"] for s in part["spans"]
                if s["name"] == "serve.execute"] == [ctx.trace_id]
    finally:
        cli.close()
        srv.stop()


# ---------------------------------------------------------------------------
# decode streams
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    from mxnet_tpu_torch.models import transformer as tm

    with mx.cpu():
        mx.random.seed(11)
        net = tm.transformer_lm(vocab_size=97, units=32, hidden_size=64,
                                num_layers=2, num_heads=4, max_length=64,
                                dropout=0.0)
        net.initialize(ctx=mx.cpu())
        net(mx.nd.zeros((1, 8)))
    return net


def _decode_server(lm, step_delay=0.0):
    eng = serve.DecodeEngine(lm, slots=4, page_size=8, num_pages=24,
                             prompt_buckets=[8, 16], device="cpu")
    eng.warmup()
    if step_delay:  # a slow step: a deadline then passes mid-generation
        real = eng.step

        def slow(*args, **kwargs):
            time.sleep(step_delay)
            return real(*args, **kwargs)

        eng.step = slow
    srv = ServeServer(decode=serve.DecodeScheduler(eng, max_new_tokens=6),
                      port=0)
    srv.start()
    return srv, ServeClient("127.0.0.1", srv.port)


PROMPTS = [np.arange(1, 6, dtype=np.int32), np.arange(7, 19, dtype=np.int32)]


def _streams(cli):
    return [list(cli.generate(p, max_new_tokens=6)) for p in PROMPTS]


def test_decode_stream_one_trace_id_and_step_costs(lm):
    tobs.enable()  # the warmup's first runs are counted
    srv, cli = _decode_server(lm)
    try:
        tobs.disable()
        want = _streams(cli)  # obs off
        tobs.enable()
        root = context.new_root()
        with context.use(root):
            got = [list(cli.generate(PROMPTS[0], max_new_tokens=6))]
        got += _streams(cli)[1:]
    finally:
        cli.close()
        srv.stop()
    assert got == want  # tracing changes no token
    evs = [e for e in tobs.trace.drain() if e["ph"] == "X"]
    mine = [e for e in evs
            if (e.get("args") or {}).get("trace_id") == root.trace_id]
    names = {e["name"] for e in mine}
    assert {"serve.rpc", "decode.queue_wait", "decode.execute",
            "decode.token", "decode.generate"} <= names
    (prefill,) = [e for e in mine if e["name"] == "decode.execute"]
    assert prefill["args"]["kind"] == "prefill"
    assert len([e for e in mine if e["name"] == "decode.token"]) == 5
    steps = [e["args"] for e in evs if e["name"] == "decode.execute"
             and e["args"]["kind"] == "step"]
    assert steps and all({"flops", "bytes_accessed", "roofline",
                          "paged_flops", "attended"} <= set(a)
                         for a in steps)
    assert any(e["name"] == "decode.step" for e in evs)
    gen = [e["args"] for e in mine if e["name"] == "decode.generate"]
    assert gen[0]["outcome"] == "length" and gen[0]["tokens"] == 6


def test_decode_deadline_stream_is_retained_with_its_outcome(lm):
    tobs.enable()
    tobs.tail.enable(policy=tobs.tail.RetentionPolicy(
        slow_ms=1e9, budget_per_s=1e9, burst=1e9, baseline=0.0))
    srv, cli = _decode_server(lm, step_delay=0.05)
    try:
        assert len(list(cli.generate(PROMPTS[0], max_new_tokens=3))) == 3
        # 50 steps of 50 ms outlive the 500 ms deadline mid-generation at
        # the replica (admitted well inside it): the error rides the
        # stream's reply
        with pytest.raises(serve.DeadlineExceeded, match="after"):
            list(cli.generate(PROMPTS[1], max_new_tokens=50,
                              deadline_ms=500.0))
    finally:
        cli.close()
        srv.stop()
    st = tobs.tail.stats()
    assert st["retained"] == 1 and st["dropped"] == 1
    counters = tobs.metrics.snapshot()["counters"]
    assert counters["tail.retained.deadline"] == 1
    assert counters["tail.dropped.fast_path"] == 1
    (tid,) = tobs.tail.retained_ids()
    kept = {e["name"] for e in tobs.trace.drain()
            if (e.get("args") or {}).get("trace_id") == tid}
    assert {"serve.rpc", "decode.queue_wait", "decode.execute",
            "decode.generate"} <= kept


# ---------------------------------------------------------------------------
# serve_bench's telemetry legs
# ---------------------------------------------------------------------------

def test_serve_bench_legs_return_the_reference_keys():
    from mxnet_tpu_torch.tools import serve_bench as tsb

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import serve_bench as jsb

    kw = dict(duration=0.4, clients=2)
    pairs = [(tsb.run_obs_overhead(device="cpu", **kw),
              jsb.run_obs_overhead(**kw)),
             (tsb.run_wire_hop(device="cpu", **kw), jsb.run_wire_hop(**kw)),
             (tsb.run_prof_overhead(device="cpu", segments=2, **kw),
              jsb.run_prof_overhead(segments=2, **kw))]
    for got, want in pairs:
        assert set(got) == set(want)
    obs_leg, hop, prof = (p[0] for p in pairs)
    assert obs_leg["qps_off"] > 0 and obs_leg["qps_on"] > 0
    assert hop["completed"] > 0 and hop["bytes_copied_per_request"] is None
    assert prof["prof_samples"] > 0 and prof["segments"] == 2
    assert not tobs.enabled() and not tobs.profile.enabled()
