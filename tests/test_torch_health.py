"""The port's training-health plane (``mxnet_tpu_torch/obs/health.py``,
``chaos/nan.py``, the fused engine's stats, ``fit(health=)``,
``Trainer.attach_health_monitor``, ``HealthHandler``, the Monitor adapter)
against the reference's ``tests/test_health.py``, on the CPU.

- the sentinel: the same synthetic series (host values through a stand-in
  engine) give equal reports from both packages' ``HealthMonitor``s —
  breaches, rules, actions, EWMAs — for every detector and the ladder;
- the stats: after one update of the same weights and gradients, the
  port's ``last_health`` norms and counts agree with the reference's to
  1e-6 relative; an update with the stats off dispatches exactly the
  operators of one with the plane off and reads nothing back, a sampled
  one adds only the stats operators and one batched ``d2h``;
- NaN chaos, the blame pass (both packages name ``fc1``) and the
  rollback target (CRC-valid and finite);
- the flagship: the ``fc1``/``fc2`` MLP fit from the same initial weights
  ends within 1e-5 of the reference's parameters, clean and poisoned;
  the port's poisoned run (breach, blame, rollback) is bitwise its own
  clean run, and ``trace_report``'s health section tells the story;
- the Trainer, the Estimator's handler and the Monitor adapter.
"""
import json
import math
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import obs as jobs
from mxnet_tpu.chaos import nan as jnan
from mxnet_tpu.obs import health as jhealth
from mxnet_tpu_torch import obs as tobs
from mxnet_tpu_torch import profiler as tprofiler
from mxnet_tpu_torch.chaos import nan as tnan
from mxnet_tpu_torch.obs import health as thealth

PKGS = {"ref": (jmx, jobs, jnan, jhealth), "port": (tmx, tobs, tnan,
                                                    thealth)}


def _reset():
    for _mx, o, nan, h in PKGS.values():
        o.disable()
        o.reset()
        nan.reset()
        h.request_stats(None)
        h._ACTIVE[0] = 0


@pytest.fixture(autouse=True)
def _clean():
    _reset()
    with tmx.cpu():
        yield
    _reset()


class _FakeEngine:
    """A stand-in engine whose ``last_health`` holds host values: the
    monitor's batched fetch passes them through, so detectors run on
    synthetic series with no device work (the reference test's idiom)."""

    def __init__(self, gnorm, nonfinite=(0, 0), streak=None):
        n = len(nonfinite)
        self.last_health = {
            "global_grad_norm": np.float32(gnorm),
            "grad_norms": np.full(n, gnorm / max(n, 1), np.float32),
            "param_norms": np.ones(n, np.float32),
            "update_norms": np.full(n, 1e-3, np.float32),
            "nonfinite": np.asarray(nonfinite, np.int32),
            "indices": tuple(range(n)),
        }
        if streak is not None:
            self.last_health["skip_streak"] = np.int32(streak)


def _both(drive, **kw):
    """``drive(monitor)`` -> reports, for a fresh monitor of each package
    built with ``kw``; asserts the two lists equal and returns the port's
    reports and monitor."""
    out = {}
    for tag, (_mx, _o, _n, h) in PKGS.items():
        mon = h.HealthMonitor(**kw)
        out[tag] = (drive(mon), mon)
    assert json.dumps(out["port"][0], default=str) == \
        json.dumps(out["ref"][0], default=str)
    return out["port"]


# ---------------------------------------------------------------------------
# sentinel detectors on synthetic series
# ---------------------------------------------------------------------------

def test_loss_spike_detector_judges_against_prior_ewma():
    def drive(mon):
        reps = [mon.step(i, loss=1.0 + 0.01 * i) for i in range(5)]
        return reps + [mon.step(6, loss=50.0)]

    reps, _ = _both(drive, every=1, loss_spike=3.0)
    assert all(r["ok"] for r in reps[:5])
    assert [b["rule"] for b in reps[5]["breaches"]] == ["loss_spike"]
    assert reps[5]["loss_ewma"] < 2.0


def test_grad_norm_explosion_detector():
    def drive(mon):
        reps = [mon.step(i, engine=_FakeEngine(gnorm=1.0)) for i in range(4)]
        return reps + [mon.step(5, engine=_FakeEngine(gnorm=500.0))]

    reps, _ = _both(drive, every=1, grad_explosion=10.0)
    assert all(r["ok"] for r in reps[:4])
    assert [b["rule"] for b in reps[4]["breaches"]] == \
        ["grad_norm_explosion"]


def test_plateau_detector_is_warn_only():
    def drive(mon):
        return [mon.step(i, loss=1.0) for i in range(8)]

    reps, _ = _both(drive, every=1, plateau_window=6, plateau_eps=1e-3,
                    actions="rollback")
    assert [b["rule"] for b in reps[5]["breaches"]] == ["plateau"]
    assert reps[5]["action"] == "warn"
    assert reps[6]["ok"]  # re-armed over a fresh window


def test_decreasing_loss_never_plateaus_or_spikes():
    def drive(mon):
        return [mon.step(i, loss=2.0 * 0.9 ** i,
                         engine=_FakeEngine(gnorm=1.0 + 0.01 * i))
                for i in range(30)]

    reps, _ = _both(drive, every=1, plateau_window=8)
    assert all(r["ok"] for r in reps)


def test_nonfinite_is_fatal_and_names_worst_param():
    def drive(mon):
        return [mon.step(1, engine=_FakeEngine(gnorm=float("nan"),
                                               nonfinite=(7, 0)))]

    (rep,), _ = _both(drive, every=1, actions="rollback",
                      param_names=["fc1_weight", "fc1_bias"])
    assert [b["rule"] for b in rep["breaches"]] == ["nonfinite"]
    assert rep["action"] == "rollback"
    assert rep["breaches"][0]["param"] == "fc1_weight"


def test_skip_streak_breach_and_warn_once():
    warned = {}

    def drive(mon):
        got = warned.setdefault(id(mon), [])
        mon.logger = type("L", (), {"warning":
                                    lambda self, *a: got.append(a)})()
        reps = [mon.step(1, engine=_FakeEngine(gnorm=1.0, streak=1)),
                mon.step(2, engine=_FakeEngine(gnorm=1.0, streak=4)),
                mon.step(3, engine=_FakeEngine(gnorm=1.0, streak=5))]
        once = [w for w in got if "skip streak reached" in str(w[0])]
        return reps + [len(once)]

    reps, _ = _both(drive, every=1, skip_streak_threshold=3)
    assert reps[0]["ok"]
    assert [b["rule"] for b in reps[1]["breaches"]] == ["scaler_skip_streak"]
    assert reps[3] == 1


def test_escalation_ladder_warn_backoff_rollback():
    def drive(mon):
        for i in range(4):
            mon.step(i, loss=1.0)
        return [mon.step(10 + i, loss=100.0 * (3 ** i))["action"]
                for i in range(3)]

    actions, _ = _both(drive, every=1, loss_spike=2.0, actions="rollback",
                       rollback_cooldown=0)
    assert actions == ["warn", "lr_backoff", "rollback"]


def test_ladder_capped_by_actions_ceiling():
    def drive(mon):
        for i in range(4):
            mon.step(i, loss=1.0)
        return [mon.step(10 + i, loss=1000.0 * (3 ** i))["action"]
                for i in range(4)]

    actions, _ = _both(drive, every=1, loss_spike=2.0, actions="warn")
    assert actions[-1] == "warn"


def test_rollback_cooldown_and_cap_suppress():
    def drive(mon):
        reps = [mon.step(10, engine=_FakeEngine(gnorm=1.0, nonfinite=(3,)))]
        mon.note_rollback(10)
        reps.append(mon.step(20, engine=_FakeEngine(gnorm=1.0,
                                                    nonfinite=(3,))))
        mon.note_rollback(200)
        reps.append(mon.step(400, engine=_FakeEngine(gnorm=1.0,
                                                     nonfinite=(3,))))
        return reps

    reps, _ = _both(drive, every=1, actions="rollback",
                    rollback_cooldown=100, max_rollbacks=2)
    assert reps[0]["action"] == "rollback"
    assert reps[1]["action"] == "warn" and "cooldown" in reps[1]["note"]
    assert reps[2]["action"] == "warn" and "cap" in reps[2]["note"]


def test_lr_backoff_applies_to_optimizer():
    from mxnet_tpu_torch.optimizer import create as opt_create

    opt = opt_create("sgd", learning_rate=0.1)
    mon = thealth.HealthMonitor(every=1, loss_spike=2.0, actions="lr_backoff")
    for i in range(4):
        mon.step(i, loss=1.0, optimizer=opt)
    mon.step(10, loss=100.0, optimizer=opt)           # warn
    rep = mon.step(11, loss=1000.0, optimizer=opt)    # lr_backoff
    assert rep["action"] == "lr_backoff"
    assert math.isclose(opt.learning_rate, 0.05)


def test_on_breach_callbacks_fire_and_cannot_break_training():
    seen = []
    mon = thealth.HealthMonitor(every=1).on_breach(
        lambda rep, br: seen.append(br)).on_breach(lambda rep, br: 1 / 0)
    mon.step(1, engine=_FakeEngine(gnorm=1.0, nonfinite=(1,)))
    assert len(seen) == 1 and seen[0][0]["rule"] == "nonfinite"


def test_sampling_period_and_will_sample():
    def drive(mon):
        outs = []
        for i in range(8):
            assert mon.will_sample() == ((i + 1) % 4 == 0)
            outs.append(mon.step(i, loss=1.0) is not None)
        return outs

    outs, _ = _both(drive, every=4)
    assert outs == [False, False, False, True] * 2


def test_as_monitor_coercions():
    assert thealth.as_monitor(None) is None
    m = thealth.HealthMonitor()
    assert thealth.as_monitor(m) is m
    assert isinstance(thealth.as_monitor(True), thealth.HealthMonitor)
    assert thealth.as_monitor({"every": 3}).every == 3
    with pytest.raises(TypeError):
        thealth.as_monitor(42)


def test_scaler_masked_overflow_is_not_a_fatal_breach():
    def drive(mon):
        return [mon.step(1, engine=_FakeEngine(gnorm=float("inf"),
                                               nonfinite=(9, 0), streak=1))]

    (rep,), _ = _both(drive, every=1, actions="rollback",
                      skip_streak_threshold=8)
    assert rep["ok"] and rep["action"] == "none"

    def drive2(mon):
        return [mon.step(1, engine=_FakeEngine(gnorm=float("inf"),
                                               nonfinite=(9, 0)))]

    (rep2,), _ = _both(drive2, every=1, actions="rollback")
    assert [b["rule"] for b in rep2["breaches"]] == ["nonfinite"]


def test_health_metrics_land_in_prometheus_exposition():
    from mxnet_tpu_torch.obs.export import to_prometheus

    tobs.enable()
    mon = thealth.HealthMonitor(every=1)
    mon.step(1, loss=1.25, engine=_FakeEngine(gnorm=2.0))
    text = to_prometheus(tobs.metrics.snapshot())
    assert "health_loss" in text and "health_grad_norm" in text


# ---------------------------------------------------------------------------
# the stats of the fused update, and the dispatch bound
# ---------------------------------------------------------------------------

def _tiny_module(pkg, seed=0, arg_params=None):
    mx = PKGS[pkg][0]
    sym = mx.symbol
    from importlib import import_module

    io = import_module(mx.__name__ + ".io")
    Module = import_module(mx.__name__ + ".module").Module
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(seed)
    X = rng.randn(8, 5).astype(np.float32)
    y = np.array([0, 1, 2, 3] * 2, np.float32)
    it = io.NDArrayIter(X, y, batch_size=4, label_name="softmax_label")
    mod = Module(net, context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    if arg_params is None:
        mod.init_params()
    else:
        mod.init_params(arg_params={k: mx.nd.array(v)
                                    for k, v in arg_params.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    return mod, next(iter(it))


def _mlp_params(seed=3):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(8, 5).astype(np.float32) * 0.5,
            "fc1_bias": rng.randn(8).astype(np.float32) * 0.1,
            "fc2_weight": rng.randn(4, 8).astype(np.float32) * 0.5,
            "fc2_bias": rng.randn(4).astype(np.float32) * 0.1}


def test_last_health_norms_agree_with_reference():
    """One sampled update of the same weights and batch: the port's
    device-resident stats equal the reference's to 1e-6 relative."""
    got = {}
    for pkg in ("ref", "port"):
        h = PKGS[pkg][3]
        mod, batch = _tiny_module(pkg, arg_params=_mlp_params())
        h.activate()
        h.request_stats(True)
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        lh = mod._updater._engine.last_health
        got[pkg] = dict(zip(lh, h.batched_fetch(list(lh.values()))))
        h.deactivate()
    assert got["port"]["indices"] == got["ref"]["indices"]
    for k in ("global_grad_norm", "grad_norms", "param_norms",
              "update_norms"):
        np.testing.assert_allclose(got["port"][k], got["ref"][k],
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_array_equal(got["port"]["nonfinite"],
                                  got["ref"]["nonfinite"])


def test_stats_leave_the_update_bitwise():
    """The weights after updates with the stats on equal those with the
    plane off, bit for bit."""
    out = []
    for on in (False, True):
        mod, batch = _tiny_module("port", arg_params=_mlp_params())
        if on:
            thealth.activate()
        for _ in range(3):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        thealth.deactivate()
        assert (mod._updater._engine.last_health is not None) == on
        out.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k])


def test_health_dispatch_bound():
    """The reference's bound (tests/test_health.py:252) in the port's
    terms: an unsampled update with the plane on dispatches exactly the
    operators of an update with it off and reads nothing back; a sampled
    one is the same one program call plus the stats operators and ONE
    batched d2h."""
    os.environ["MXNET_OBS_HEALTH"] = "0"
    try:
        mod, batch = _tiny_module("port")
        for _ in range(2):
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        with tprofiler.count_dispatches() as c_off:
            mod.update()
        assert c_off.d2h == 0 and c_off.compiled == 1
    finally:
        os.environ.pop("MXNET_OBS_HEALTH")

    mod, batch = _tiny_module("port")
    mon = thealth.HealthMonitor(every=2)
    thealth.activate()
    try:
        for _ in range(4):
            mod.forward(batch, is_train=True)
            mod.backward()
            thealth.request_stats(mon.will_sample())
            mod.update()
            mon.step(engine=mod._updater._engine)

        mod.forward(batch, is_train=True)
        mod.backward()
        thealth.request_stats(mon.will_sample())
        assert not mon.will_sample()
        with tprofiler.count_dispatches() as c_unsampled:
            mod.update()
            mon.step(engine=mod._updater._engine)
        assert c_unsampled.as_dict() == c_off.as_dict()

        mod.forward(batch, is_train=True)
        mod.backward()
        thealth.request_stats(mon.will_sample())
        assert mon.will_sample()
        with tprofiler.count_dispatches() as c_sampled:
            mod.update()
            rep = mon.step(engine=mod._updater._engine)
        assert rep is not None and rep["ok"]
        assert c_sampled.compiled == 1 and c_sampled.d2h == 1
        assert c_sampled.eager_ops > c_off.eager_ops
    finally:
        thealth.request_stats(None)
        thealth.deactivate()


def test_health_off_is_zero_cost_noop():
    assert not thealth.enabled()
    assert not thealth.stats_for_this_step()
    mod, batch = _tiny_module("port")
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    assert mod._updater._engine.last_health is None
    assert tobs.metrics.registry.get("health.samples") is None

    tobs.enable()
    assert not thealth.enabled()  # tracing alone never implies stats
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    assert mod._updater._engine.last_health is None


# ---------------------------------------------------------------------------
# chaos NaN injection, provenance, rollback-target selection
# ---------------------------------------------------------------------------

def test_chaos_nan_env_parse_and_occurrence_counting():
    import torch

    for nan in (jnan, tnan):
        rules = nan.parse_env("data@2,4;fc1_weight")
        assert rules[0].tensor == "data" and rules[0].occurrences == {2, 4}
        assert rules[1].tensor == "fc1_weight" and \
            rules[1].occurrences is None
        with pytest.raises(ValueError):
            nan.parse_env("@3")

    tnan.configure([tnan.Rule("x", {2})])
    v = torch.ones(4)
    outs = [tnan.poison(["x"], [v])[0] for _ in range(3)]
    assert bool(torch.isfinite(outs[0]).all())
    assert int((~torch.isfinite(outs[1])).sum()) == 1  # one element
    assert bool(torch.isfinite(outs[2]).all())
    assert bool(torch.isfinite(v).all())  # the input itself untouched


def test_chaos_nan_skips_integer_tensors():
    import torch

    tnan.configure([tnan.Rule("idx", None)])
    with pytest.warns(UserWarning, match="non-float"):
        out = tnan.poison(["idx"], [torch.arange(4)])
    assert bool((out[0] == torch.arange(4)).all())


def test_chaos_nan_env_reaches_the_executor(monkeypatch):
    monkeypatch.setenv("MXNET_CHAOS_NAN", "data@2")
    tnan.reset()
    mod, batch = _tiny_module("port")
    outs = []
    for _ in range(3):
        mod.forward(batch, is_train=True)
        outs.append(np.isfinite(mod.get_outputs()[0].asnumpy()).all())
    assert outs == [True, False, True]


def test_blame_pass_names_first_nonfinite_node():
    found = {}
    for pkg, (_mx, o, nan, h) in PKGS.items():
        o.enable()
        mod, batch = _tiny_module(pkg)
        nan.configure([nan.Rule("data", {1})])
        mod.forward(batch, is_train=True)
        mod.backward()
        found[pkg] = h.blame_nonfinite(mod._exec)
        evs = [e for e in o.trace.events() if e[1] == "health.nan_provenance"]
        assert len(evs) == 1 and evs[0][6]["node"] == "fc1"
    for res in found.values():
        assert res["node"] == "fc1" and res["op"] == "FullyConnected"
        assert res["nonfinite_inputs"] == ["data"]
    assert found["port"]["checked_nodes"] == found["ref"]["checked_nodes"]


def test_blame_pass_clean_forward_reports_backward():
    mod, batch = _tiny_module("port")
    mod.forward(batch, is_train=True)
    mod.backward()
    res = thealth.blame_nonfinite(mod._exec)
    assert res["node"] is None and "backward" in res["detail"]
    mod.forward(batch, is_train=False)  # a predict forward keeps nothing
    assert thealth.blame_nonfinite(mod._exec) is None


def test_find_rollback_target_skips_poisoned_checkpoints(tmp_path):
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.checkpoint.state import TrainingState

    man = CheckpointManager(str(tmp_path), async_write=False)
    good = TrainingState({"arg:w": np.ones((3,), np.float32)},
                         {"format": 1, "epoch": 0, "nbatch": 1,
                          "global_step": 1})
    man.save(good, 1)
    poisoned = TrainingState(
        {"arg:w": np.array([1.0, np.nan, 3.0], np.float32)},
        {"format": 1, "epoch": 0, "nbatch": 2, "global_step": 2})
    man.save(poisoned, 2)
    target = thealth.find_rollback_target(man)
    assert target is not None and target.global_step == 1
    assert thealth.find_rollback_target(man, before_step=1) is None
    man.close()


# ---------------------------------------------------------------------------
# the flagship: NaN mid-epoch -> breach -> blame -> rollback -> bitwise
# ---------------------------------------------------------------------------

def _flagship_params():
    rng = np.random.RandomState(99)
    return {"fc1_weight": rng.randn(16, 10).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rng.randn(4, 16).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(4, np.float32)}


def _flagship_run(pkg, ckpt_dir, poison_at=None, health=None):
    from importlib import import_module

    mx, _o, nan, _h = PKGS[pkg]
    sym = mx.symbol
    io = import_module(mx.__name__ + ".io")
    Module = import_module(mx.__name__ + ".module").Module
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    np.random.seed(7)
    mx.random.seed(7)
    np.random.seed(7)
    rng = np.random.RandomState(1234)
    X = rng.randn(64, 10).astype(np.float32)
    y = rng.randint(0, 4, 64).astype(np.float32)
    it = io.NDArrayIter(X, y, batch_size=8, shuffle=True,
                        label_name="softmax_label")
    mod = Module(net, context=mx.cpu())
    if poison_at is not None:
        nan.configure([nan.Rule("data", {poison_at})])
    else:
        nan.reset()
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            arg_params={k: mx.nd.array(v)
                        for k, v in _flagship_params().items()},
            eval_metric="ce", checkpoint=str(ckpt_dir), resume="never",
            checkpoint_batch_period=1, health=health)
    nan.reset()
    arg, _aux = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


def test_flagship_nan_breach_blame_rollback_bitwise(tmp_path):
    from mxnet_tpu_torch.tools import trace_report

    tobs.enable()
    runs = {}
    for pkg in ("ref", "port"):
        h = PKGS[pkg][3]
        clean = _flagship_run(pkg, tmp_path / pkg / "clean")
        mon = h.HealthMonitor(every=1, actions="rollback")
        out = _flagship_run(pkg, tmp_path / pkg / "chaos", poison_at=5,
                            health=mon)
        assert mon.rollbacks_done == 1
        runs[pkg] = (clean, out)
    clean, out = runs["port"]
    for k in clean:  # the port's rolled-back run is bitwise its clean run
        assert np.array_equal(clean[k], out[k]), f"param {k} drifted"
    for i in (0, 1):  # and both sit within 1e-5 of the reference's
        for k, v in runs["ref"][i].items():
            np.testing.assert_allclose(runs["port"][i][k], v, atol=1e-5,
                                       err_msg=k)

    trace_path = str(tmp_path / "trace.json")
    tobs.export(trace_path)
    with open(trace_path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    for required in ("chaos.nan", "health.breach", "health.nan_provenance",
                     "health.rollback", "health.loss", "health.grad_norm",
                     "health.blame"):
        assert required in names, f"missing {required} in trace"
    prov = [e for e in doc["traceEvents"]
            if e.get("name") == "health.nan_provenance"]
    assert prov[0]["args"]["node"] == "fc1"

    h = trace_report.report([trace_path])["health"]
    assert h is not None
    assert any(b["rule"] == "nonfinite" for b in h["breaches"])
    assert h["provenance"][0]["node"] == "fc1"
    assert any(a["what"] == "health.rollback" for a in h["actions"])
    assert {t["name"] for t in h["tracks"]} >= {"health.loss",
                                                "health.grad_norm"}


def test_fit_health_without_checkpoint_warns_not_crashes():
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module

    mon = thealth.HealthMonitor(every=1, actions="rollback")
    rng = np.random.RandomState(5)
    X = rng.randn(32, 10).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    it = NDArrayIter(X, y, batch_size=8, label_name="softmax_label")
    net = sym.SoftmaxOutput(sym.FullyConnected(
        sym.Variable("data"), num_hidden=4, name="fc1"), name="softmax")
    mod = Module(net, context=tmx.cpu())
    tnan.configure([tnan.Rule("data", {2})])
    mod.fit(it, num_epoch=1, optimizer="sgd", eval_metric="ce", health=mon)
    assert mon.last_report is not None
    assert mon.rollbacks_done == 0
    assert thealth._ACTIVE[0] == 0  # the fit turned the plane off again


# ---------------------------------------------------------------------------
# integration: Trainer, Estimator, Monitor adapter
# ---------------------------------------------------------------------------

def test_trainer_attach_skip_streak_breach_through_real_scaler():
    from mxnet_tpu_torch import amp, autograd, nd
    from mxnet_tpu_torch.gluon import Trainer, nn

    net = nn.Dense(4, in_units=3)
    net.initialize()
    tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.01})
    scaler = amp.LossScaler()
    amp.init_trainer(tr, scaler)
    mon = tr.attach_health_monitor(
        thealth.HealthMonitor(every=1, skip_streak_threshold=3))
    assert mon.param_names == [p.name for p in tr._params]
    x = nd.ones((2, 3))
    try:
        for _ in range(5):
            with autograd.record():
                loss = (net(x) ** 2).sum() * np.nan  # every step overflows
            loss.backward()
            tr.step(2)
        rep = mon.last_report
        rules = {b["rule"] for b in rep["breaches"]}
        assert "scaler_skip_streak" in rules
        assert "nonfinite" not in rules
        assert rep["skip_streak"] >= 3
    finally:
        tr.attach_health_monitor(None)
    assert thealth._ACTIVE[0] == 0


def test_health_handler_rejects_monitor_false():
    from mxnet_tpu_torch.gluon.contrib.estimator import HealthHandler

    with pytest.raises(ValueError, match="needs a monitor"):
        HealthHandler(monitor=False)


def test_estimator_exception_still_deactivates_health_plane():
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.contrib.estimator import (Estimator,
                                                         HealthHandler)

    net = nn.HybridSequential()
    net.add(nn.Dense(4))
    net.initialize()
    est = Estimator(net, loss=gloss.SoftmaxCrossEntropyLoss())
    handler = HealthHandler(monitor=thealth.HealthMonitor(every=1))

    class _Boom:
        def __iter__(self):
            yield (nd.ones((2, 3)), nd.array([0.0, 1.0]))
            raise RuntimeError("data source died")

    with pytest.raises(RuntimeError, match="data source died"):
        est.fit(train_data=_Boom(), epochs=1, event_handlers=[handler])
    assert thealth._ACTIVE[0] == 0
    assert not thealth.enabled()


def test_estimator_health_handler_samples_and_stops_on_nonfinite():
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.contrib.estimator import (Estimator,
                                                         HealthHandler)

    net = nn.HybridSequential()
    net.add(nn.Dense(8), nn.Dense(4))
    net.initialize()
    est = Estimator(net, loss=gloss.SoftmaxCrossEntropyLoss())
    handler = HealthHandler(monitor=thealth.HealthMonitor(every=2),
                            stop_on_nonfinite=True)
    rng = np.random.RandomState(0)
    batches = [(nd.array(rng.randn(4, 6).astype(np.float32)),
                nd.array(np.array([0, 1, 2, 3], np.float32)))
               for _ in range(6)]
    est.fit(train_data=batches, epochs=1, event_handlers=[handler])
    rep = handler.monitor.last_report
    assert rep is not None and rep["loss"] is not None
    assert rep["grad_norm"] is not None  # engine stats flowed through


def test_monitor_adapter_routes_health_gauges():
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.monitor import Monitor

    tobs.enable()
    net = nn.HybridSequential()
    net.add(nn.Dense(8), nn.Dense(4))
    net.initialize()
    mon = Monitor(interval=1, pattern=".*dense.*")
    mon.install_gluon(net)
    try:
        mon.tic()
        net(tmx.nd.ones((2, 6)))
        with tprofiler.count_dispatches() as c:
            stats = mon.toc()
    finally:
        mon.uninstall_gluon()
    assert len(stats) >= 2
    assert c.d2h == 1  # ONE batched transfer, via health.batched_fetch
    gauges = [n for n in tobs.metrics.registry.names()
              if n.startswith("health.monitor.")]
    assert len(gauges) >= 2


def test_profiler_counts_and_raises_beyond_dispatch_counting(tmp_path):
    """Dispatch counting, and the profiler beyond it (ported since): a
    run/stop window around the same program writes a trace."""
    x = tmx.nd.ones((3,))
    with tprofiler.count_dispatches() as c:
        (x + 1).asnumpy()
    assert c.d2h == 1 and c.eager_ops >= 1 and c.compiled == 0
    tprofiler.set_config(filename=str(tmp_path / "p.json"))
    tprofiler.set_state("run")
    (x + 1).asnumpy()
    tprofiler.set_state("stop")
    assert os.path.exists(tprofiler.dump())


def test_health_bench_reports_the_overhead_on_the_cpu():
    from mxnet_tpu_torch.tools import health_bench

    res = health_bench.run_health_overhead(steps=4, warmup=2, batch=8,
                                           in_dim=16, hidden=16, every=2,
                                           repeats=1, device="cpu")
    assert res["device"] == "cpu" and res["every"] == 2
    assert res["ips_off"] > 0 and res["ips_on"] > 0
    assert math.isfinite(res["health_overhead_pct"])
    assert not thealth.enabled() and not tobs.enabled()
