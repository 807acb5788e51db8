"""The port's metrics plane (``mxnet_tpu_torch/obs``: the registry, the SLO
monitor, ``hist_quantile``/``merge_metrics`` and the ``obs`` switch)
against the reference's, on the CPU.

The same sequence of ``inc``/``observe``/``set_gauge``/``remove`` goes
through both registries, from a numpy seed; snapshots and dumps (text and
json) must be equal, bucket keys included. ``SLOMonitor.evaluate``,
``burn_window`` and ``render`` run over the same snapshots in both
packages; the merged fleet snapshots and their quantiles agree exactly
(both are pure Python over the same floats). The span and black-box
planes (``obs.span``, ``obs.trace``, ...) are held to the reference in
``tests/test_torch_obs_*.py``; the training planes are queue item A15
and raise naming it.
"""
import json

import numpy as np
import pytest

from mxnet_tpu import obs as jobs
from mxnet_tpu.obs import metrics as jmetrics
from mxnet_tpu.obs import slo as jslo
from mxnet_tpu_torch import obs as tobs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.obs import metrics as tmetrics
from mxnet_tpu_torch.obs import slo as tslo

# the package attribute ``export`` is the (chrome-trace) export function
# in both packages; the module is ``export_mod``
jexport, texport = jobs.export_mod, tobs.export_mod

_NAMES = ["fleet.request_latency_seconds", "fleet.rpc.replica0_seconds",
          "serve.latency_seconds", "fleet.failovers",
          "fleet.request_deadline_exceeded", "serve.shed_deadline",
          "serve.shed_queue_full", "fleet.hedges", "fleet.hedge_wins",
          "fleet.ready_replicas", "fleet.replica0.queue_depth",
          "fleet.breaker_open_seconds", "fleet.breaker_trips"]


def _ops(seed, n=300):
    """A random sequence of registry operations, as data."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(n):
        name = _NAMES[rng.randint(len(_NAMES))]
        kind = ("observe" if name.endswith("_seconds")
                else "gauge" if name in ("fleet.ready_replicas",
                                         "fleet.replica0.queue_depth",
                                         "fleet.breaker_open_seconds")
                else "inc")
        if kind == "observe":
            ops.append((kind, name, float(rng.lognormal(-4.0, 2.0))))
        elif kind == "gauge":
            ops.append((kind, name, float(rng.randint(0, 9) * 0.5)))
        else:
            ops.append((kind, name, int(rng.randint(1, 4))))
        if rng.rand() < 0.02:
            ops.append(("remove", _NAMES[rng.randint(len(_NAMES))], None))
    return ops


def _apply(registry, ops):
    for kind, name, v in ops:
        if kind == "observe":
            registry.histogram(name).observe(v)
        elif kind == "gauge":
            registry.gauge(name).set(v)
        elif kind == "inc":
            registry.counter(name).inc(v)
        else:
            registry.remove(name)
    return registry


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshots_and_dumps_equal(seed):
    ops = _ops(seed)
    r = _apply(jmetrics.MetricsRegistry(), ops)
    t = _apply(tmetrics.MetricsRegistry(), ops)
    assert r.snapshot() == t.snapshot()
    assert r.dump() == t.dump()
    assert r.dump("json") == t.dump("json")
    assert r.names() == t.names()
    assert json.loads(t.dump("json"))["histograms"]


def test_histogram_schema_and_quantiles():
    vals = [0.00005, 0.0003, 0.003, 0.003, 0.2, 7.0, 30.0]
    hs = [m.Histogram("h") for m in (jmetrics, tmetrics)]
    for h in hs:
        for v in vals:
            h.observe(v)
    r, t = (h.snapshot() for h in hs)
    assert r == t
    assert set(t["buckets"]) == {"0.0001", "0.0005", "0.005", "0.25", "10.0",
                                 "+Inf"}
    for q in (0.1, 0.5, 0.9, 0.99, 1.0):
        assert hs[0].quantile(q) == hs[1].quantile(q)
    assert tmetrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    custom = [m.Histogram("c", buckets=(3.0, 1.0, 2.0)) for m in
              (jmetrics, tmetrics)]
    for h in custom:
        for v in (0.5, 1.5, 2.5, 9.0):
            h.observe(v)
    assert custom[0].snapshot() == custom[1].snapshot()


def test_counter_gauge_and_type_drift():
    for m in (jmetrics, tmetrics):
        reg = m.MetricsRegistry()
        reg.counter("a").inc()
        reg.counter("a").inc(4)
        g = reg.gauge("g")
        g.set(3)
        g.inc(2.5)
        g.dec()
        assert reg.get("a").value == 5 and g.value == 4.5
        with pytest.raises(TypeError):
            reg.gauge("a")
        reg.remove("a")
        reg.remove("absent")
        assert reg.names() == ["g"]
        reg.reset()
        assert reg.dump() == "(no metrics)"
        with pytest.raises(ValueError):
            reg.dump("xml")


def test_descriptions_agree():
    names = _NAMES + ["fleet.replica3.occupancy", "autoscale.scale_out",
                      "kvstore.rpc.push_seconds", "nothing.here"]
    for n in names:
        assert jmetrics.description(n) == tmetrics.description(n)
    for m in (jmetrics, tmetrics):
        m.describe("test.only.exact", "exact help")
        m.describe("test.only.", "family help", family=True)
    try:
        for n in ("test.only.exact", "test.only.other"):
            assert jmetrics.description(n) == tmetrics.description(n)
    finally:
        for m in (jmetrics, tmetrics):
            m._DESCRIPTIONS.pop("test.only.exact", None)
            m._FAMILY_DESCRIPTIONS = tuple(
                f for f in m._FAMILY_DESCRIPTIONS if f[0] != "test.only.")


def _snaps(seed, n=4):
    return [_apply(tmetrics.MetricsRegistry(), _ops(seed * 10 + i, 120))
            .snapshot() for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_metrics_and_hist_quantile_agree(seed):
    snaps = _snaps(seed) + [None, "torn"]
    r, t = jexport.merge_metrics(snaps), texport.merge_metrics(snaps)
    assert r == t
    for h in t["histograms"].values():
        for q in (0.0, 0.25, 0.5, 0.99, 1.0):
            assert jexport.hist_quantile(h, q) == \
                texport.hist_quantile(h, q)
    assert texport.hist_quantile({"count": 0}, 0.5) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [{}, {"deadline_target": 0.9,
                                     "p99_target_ms": 5.0,
                                     "burn_alert": 1.0,
                                     "breaker_open_alert_s": 1.0}])
def test_slo_evaluate_burn_window_and_render_agree(seed, kw):
    snaps = _snaps(seed, 3)
    merged = texport.merge_metrics(snaps)
    stats = {"breaker_open_seconds": 2.5, "ready_replicas": 2}
    fired = {"j": [], "t": []}
    mons = (jslo.SLOMonitor(**kw).on_breach(
                lambda rep, br: fired["j"].append(len(br))),
            tslo.SLOMonitor(**kw).on_breach(
                lambda rep, br: fired["t"].append(len(br))))
    for st in (None, stats, {"ready_replicas": 0}):
        r, t = (m.evaluate(merged, st) for m in mons)
        assert r == t
        assert jslo.SLOMonitor.render(r) == tslo.SLOMonitor.render(t)
        assert mons[1].last_report == t
    assert fired["j"] == fired["t"]
    for prev, cur in ((None, snaps[0]), (snaps[0], merged)):
        assert mons[0].burn_window(prev, cur) == \
            mons[1].burn_window(prev, cur)


def test_slo_monitor_validates_its_target():
    for m in (jslo, tslo):
        with pytest.raises(ValueError):
            m.SLOMonitor(deadline_target=1.0)


def test_a_breach_runs_callbacks_and_a_failing_one_is_contained():
    mon = tslo.SLOMonitor()
    seen = []
    mon.on_breach(lambda rep, br: 1 / 0)
    mon.on_breach(lambda rep, br: seen.append([b["rule"] for b in br]))
    rep = mon.evaluate({"gauges": {"fleet.ready_replicas": 0}})
    assert not rep["ok"] and seen == [["no_ready_replicas"]]


def test_switch_gates_the_helpers_as_the_reference():
    ops = [("inc", "fleet.failovers", 2),
           ("observe", "fleet.request_latency_seconds", 0.003),
           ("gauge", "fleet.ready_replicas", 2.0)]

    def run(obs):
        was = obs.enabled()
        obs.reset()
        try:
            obs.disable()
            for kind, name, v in ops:  # off: nothing lands
                {"inc": obs.inc, "observe": obs.observe,
                 "gauge": obs.set_gauge}[kind](name, v)
            off = obs.metrics.snapshot()
            obs.enable()
            assert obs.enabled()
            for kind, name, v in ops:
                {"inc": obs.inc, "observe": obs.observe,
                 "gauge": obs.set_gauge}[kind](name, v)
            return off, obs.metrics.snapshot()
        finally:
            obs.disable()
            obs.reset()
            if was:
                obs.enable()

    assert run(jobs) == run(tobs)
    assert run(tobs)[0] == {"counters": {}, "gauges": {}, "histograms": {}}


@pytest.mark.parametrize("name", ["trace", "tail", "profile", "blackbox",
                                  "device", "health", "fleetstats",
                                  "context"])
def test_later_planes_name_a15(name):
    # the serving half of A15 is ported; the training-health and the
    # training-fleet planes still raise naming it
    if name in ("health", "fleetstats"):
        with pytest.raises(MXNetError, match="A15"):
            getattr(tobs, name)
    else:
        assert getattr(tobs, name).__name__ == f"mxnet_tpu_torch.obs.{name}"


@pytest.mark.parametrize("call", [lambda d: tobs.span("x"),
                                  lambda d: tobs.event("x"),
                                  lambda d: tobs.export(str(d / "x.json")),
                                  lambda d: tobs.telemetry_part(),
                                  lambda d: tobs.enable(
                                      jsonl=str(d / "x.jsonl"))],
                         ids=["span", "event", "export", "telemetry_part",
                              "jsonl"])
def test_later_calls_name_a15(call, tmp_path):
    # ported with the serving half of A15: each call works
    was = tobs.enabled()
    try:
        call(tmp_path)
    finally:
        tobs.disable()
        tobs.reset()
        if was:
            tobs.enable()


def test_mxnet_obs_env_enables_at_import(tmp_path):
    import subprocess
    import sys

    code = ("import mxnet_tpu_torch.obs as o; print(o.enabled())")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"MXNET_OBS": "1", "PATH": "", "PYTHONPATH": _root()},
        timeout=120, check=True).stdout.strip()
    assert out == "True"


def _root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
