"""The port's black-box plane — the sampling profiler
(``mxnet_tpu_torch/obs/profile.py``) and the flight recorder
(``obs/blackbox.py``) — and the trace readers
(``mxnet_tpu_torch/tools/trace_report.py``, ``tools/fleet_report.py``)
against the reference's, on the CPU.

- profiler: samples are attributed to each thread's active span phase,
  folded stacks carry the phase first, the chrome lane coalesces
  consecutive samples, a root close releases the thread's registration;
- recorder: a bundle built in each package after the same calls has the
  same key set (events, metrics, profiler slice, tail state, thread
  stacks) and ``read_bundle`` the same part schema; the ring sees
  tail-held spans, ``trigger`` throttles, the periodic flush rewrites
  ``-last.json``, the hooks chain and unchain; an SLO breach triggers a
  bundle;
- in a fresh process: the env switches arm the planes and a SIGKILLed
  child leaves its flushed last bundle; SIGTERM dumps one before dying;
- readers: the port's ``trace_report``/``fleet_report`` give the same
  report and parts as the reference's tools on the same files (bundles
  with a profiler lane, torn JSONL).

The profiler's thread is started only where a test needs it, and every
test stops it, the recorder's writer and the hooks at teardown.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from mxnet_tpu import obs as jobs
from mxnet_tpu_torch import obs as tobs
from mxnet_tpu_torch.tools import fleet_report as tfr
from mxnet_tpu_torch.tools import trace_report as ttr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import fleet_report as jfr  # noqa: E402  (the reference's tools)
import trace_report as jtr  # noqa: E402


def _off(o):
    o.blackbox.disable()
    o.profile.stop()
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


def _sample_inside(o, prof, phase="serve.execute", n=1):
    """``n`` profiler sweeps while another thread sits in span ``phase``."""
    release, inside = threading.Event(), threading.Event()

    def worker():
        with o.trace.span(phase):
            inside.set()
            release.wait(5)

    t = threading.Thread(target=worker)
    t.start()
    try:
        assert inside.wait(5)
        for _ in range(n):
            assert prof.sample_once() >= 1
    finally:
        release.set()
        t.join()


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def test_folded_stacks_are_attributed_to_span_phases():
    tobs.enable()
    p = tobs.profile.SamplingProfiler(hz=100)
    _sample_inside(tobs, p, n=3)
    folded = p.folded()
    assert "serve.execute;" in folded
    for line in folded.splitlines():
        head, _, count = line.rpartition(" ")
        assert head and count.isdigit()
        assert head.split(";")[0] in ("serve.execute", "idle")
    assert p.phase_seconds()["serve.execute"] == pytest.approx(3 / 100)
    lane = p.chrome_events()
    runs = [e for e in lane if e["name"] == "prof:serve.execute"]
    assert len(runs) == 1 and runs[0]["args"]["samples"] == 3
    assert {e["phase"] for e in p.recent()} >= {"serve.execute"}
    st = p.stats()
    assert st["ticks"] == 3 and not st["running"]


def test_profiler_lifecycle_and_the_stack_registration():
    tobs.enable()
    with tobs.span("outer"):
        assert threading.get_ident() in tobs.trace.tracer._thread_stacks
    assert threading.get_ident() not in tobs.trace.tracer._thread_stacks
    p = tobs.profile.start(hz=200)
    assert tobs.profile.enabled() and tobs.profile.start() is p
    time.sleep(0.05)
    tobs.profile.stop()
    assert not tobs.profile.enabled() and p.ticks >= 1
    with pytest.raises(ValueError):
        tobs.profile.SamplingProfiler(hz=-1)


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

def _bundle(o, tmp_path):
    o.enable()
    o.tail.enable()
    o.blackbox.enable(dirpath=str(tmp_path), flush_s=0, signals=False)
    prof = o.profile.start(hz=100)
    with o.trace.span("forward", epoch=1):
        o.inc("serve.rows_executed", 2)
    o.event("chaos.kill", point="here")
    _sample_inside(o, prof, n=2)
    return o.blackbox.bundle("unit")


def test_bundle_key_set_and_part_schema_equal_the_reference(tmp_path):
    ref = _bundle(jobs, tmp_path / "ref")
    got = _bundle(tobs, tmp_path / "port")
    assert set(got) == set(ref)
    assert set(got["profiler"]) == set(ref["profiler"])
    assert set(got["tail"]) == set(ref["tail"])
    assert got["blackbox"] == 1 and got["reason"] == "unit"
    assert {"forward", "chaos.kill"} <= {e["name"] for e in got["events"]}
    assert got["metrics"]["counters"] == {"serve.rows_executed": 2}
    assert got["threads"] and got["profiler"]["stats"]["samples"] >= 2
    rpart = jobs.blackbox.read_bundle(ref)
    part = tobs.blackbox.read_bundle(got)
    assert set(part) == set(rpart)
    assert any(e["name"].startswith("prof:") for e in part["spans"])
    assert tobs.blackbox.is_bundle(got) and not tobs.blackbox.is_bundle({})


def test_dump_trigger_flush_and_the_tail_held_ring(tmp_path):
    tobs.enable()
    tobs.tail.enable(policy=tobs.tail.RetentionPolicy(baseline=0.0))
    r = tobs.blackbox.enable(dirpath=str(tmp_path), flush_s=0,
                             cooldown_s=60, signals=False)
    assert r.flush() is None  # nothing recorded yet
    ctx = tobs.context.new_root()
    with tobs.context.use(ctx):
        with tobs.span("doomed.span"):
            pass
    tobs.tail.buffer().finish(ctx.trace_id, 0.0)  # dropped
    assert not any(e[1] == "doomed.span"
                   for e in tobs.trace.tracer.events())
    path = r.flush()
    assert path.endswith(f"blackbox-{os.getpid()}-last.json")
    doc = json.load(open(path))
    assert doc["reason"] == "flush" and "threads" not in doc
    assert any(e["name"] == "doomed.span" for e in doc["events"])
    assert r.flush() is None  # not dirty again
    first = tobs.blackbox.trigger("slo_breach:x")
    assert first and os.path.exists(first)
    assert tobs.blackbox.trigger("slo_breach:y") is None
    snap = tobs.metrics.snapshot()["counters"]
    assert snap["blackbox.throttled"] == 1 and snap["blackbox.dumps"] == 1
    assert json.load(open(tobs.blackbox.dump("unit")))["reason"] == "unit"


def test_slo_breach_triggers_a_bundle(tmp_path):
    tobs.enable()
    tobs.blackbox.enable(dirpath=str(tmp_path), flush_s=0, signals=False)
    mon = tobs.slo.SLOMonitor(deadline_target=0.99)
    snap = {"counters": {"serve.shed_deadline": 5},
            "histograms": {"serve.latency_seconds": {
                "count": 5, "sum": 0.1, "buckets": {"0.05": 5}}}}
    assert not mon.evaluate(snap)["ok"]
    assert [f for f in os.listdir(tmp_path) if f.endswith(".json")]


def test_hooks_chain_and_unchain():
    prev_hook = sys.excepthook
    prev_term = signal.getsignal(signal.SIGTERM)
    tobs.blackbox.enable()
    assert sys.excepthook is not prev_hook
    assert signal.getsignal(signal.SIGTERM) is not prev_term
    tobs.blackbox.disable()
    assert sys.excepthook is prev_hook
    assert signal.getsignal(signal.SIGTERM) is prev_term


def _child_env(tmp_path, **extra):
    env = dict(os.environ)
    env.pop("MXNET_OBS_JSONL", None)
    env.update({"MXNET_OBS": "1", "MXNET_OBS_TAIL": "1",
                "MXNET_OBS_PROF": "1",
                "MXNET_OBS_BLACKBOX_DIR": str(tmp_path),
                "MXNET_OBS_BLACKBOX_FLUSH_S": "0.2",
                "PYTHONPATH": REPO}, **extra)
    return env


def test_env_switches_arm_the_planes_and_sigkill_leaves_a_bundle(tmp_path):
    code = ("import os, time, signal\n"
            "from mxnet_tpu_torch import obs\n"
            "assert obs.tail.enabled() and obs.profile.enabled()\n"
            "assert obs.blackbox.enabled()\n"
            "with obs.trace.span('child.work'):\n"
            "    time.sleep(0.05)\n"
            "time.sleep(0.8)\n"
            "os.kill(os.getpid(), signal.SIGKILL)\n")
    proc = subprocess.run([sys.executable, "-c", code], timeout=120,
                          env=_child_env(tmp_path))
    assert proc.returncode == -signal.SIGKILL
    last = [f for f in os.listdir(tmp_path) if f.endswith("-last.json")]
    assert len(last) == 1
    doc = json.load(open(tmp_path / last[0]))
    assert doc["reason"] == "flush"
    assert any(e["name"] == "child.work" for e in doc["events"])
    assert doc["profiler"]["stats"]["hz"] == 67.0


def test_sigterm_dumps_a_bundle_before_dying(tmp_path):
    code = ("import os, signal\n"
            "from mxnet_tpu_torch import obs\n"
            "with obs.trace.span('child.work'):\n"
            "    pass\n"
            "os.kill(os.getpid(), signal.SIGTERM)\n")
    proc = subprocess.run([sys.executable, "-c", code], timeout=120,
                          env=_child_env(tmp_path,
                                         MXNET_OBS_BLACKBOX_FLUSH_S="0",
                                         MXNET_OBS_PROF="0"))
    assert proc.returncode == -signal.SIGTERM
    dumps = [f for f in os.listdir(tmp_path)
             if f.endswith(".json") and "-last" not in f]
    assert len(dumps) == 1
    assert json.load(open(tmp_path / dumps[0]))["reason"] == \
        "signal:SIGTERM"


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

def _torn_jsonl(tmp_path):
    path = str(tmp_path / "replica-4242.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"ph": "M", "name": "clock", "pid": 4242,
                            "wall_epoch": 1.7e9}) + "\n")
        f.write(json.dumps({"ph": "X", "name": "forward", "ts": 0.1,
                            "dur": 0.01, "tid": 1}) + "\n")
        f.write(json.dumps({"ph": "i", "name": "chaos.kill", "ts": 0.2,
                            "tid": 1}) + "\n")
        f.write(json.dumps({"ph": "C", "name": "device.live_bytes",
                            "ts": 0.25, "tid": 1,
                            "args": {"value": 9.0}}) + "\n")
        f.write('{"ph": "X", "name": "torn", "ts"')
    return path


def test_readers_agree_with_the_reference_tools(tmp_path, capsys):
    b = _bundle(tobs, tmp_path)
    bundle = str(tmp_path / "bundle.json")
    with open(bundle, "w") as f:
        json.dump(b, f)
    trace = tobs.export(str(tmp_path / "trace.json"))
    torn = _torn_jsonl(tmp_path)
    files = [bundle, trace, torn]
    assert ttr.report(files) == jtr.report(files)
    assert ttr.merged_chrome(files) == jtr.merged_chrome(files)
    for path in files:
        assert tfr.jsonl_to_part(path) == jfr.jsonl_to_part(path)
    rep = ttr.report([torn])
    assert rep["torn_records"] == 1 and rep["n_spans"] == 1
    prof = ttr.report([bundle])["profiler"]
    assert {r["phase"] for r in prof["phases"]} >= {"serve.execute"}
    assert tfr.jsonl_to_part(bundle)["role"].startswith("blackbox:")
    capsys.readouterr()
    for tool in (jtr, ttr):
        tool.main([trace, torn, "--json"])
    ref_out, got_out = capsys.readouterr().out.split("\n{", 1)
    assert json.loads(ref_out) == json.loads("{" + got_out)
