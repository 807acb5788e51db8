"""Training-health plane: numerics telemetry, NaN provenance, and a
divergence sentinel with checkpoint rollback (counterpart of
``mxnet_tpu/obs/health.py``).

The host plane (trace/metrics) and the device plane (``device.py``) watch
the runtime; this plane watches the model: the loss trajectory, gradient
norms, update-to-weight ratios and non-finite blowups, and recovers when
a run goes bad.

Three pieces:

- **Numerics stats on the device.** When the plane is on
  (:func:`stats_for_this_step`), the fused update engine
  (``optimizer/fused.py``) computes the health scalars in the same pass
  as the update: the global grad norm (the clip's norms when clipping is
  on), per-parameter grad, param and update norms, per-parameter
  non-finite counts, and the AMP scaler's skip streak. They stay on the
  device (``engine.last_health``) until a sampled step fetches them all
  with ONE batched transfer (:func:`batched_fetch`). The reference makes
  them extra outputs of its one compiled update program; the port's
  update is ``torch._foreach_*`` operators, so a stats step dispatches the
  stats operators beside the update's, and a step without stats
  dispatches exactly the update's. Off, every call site costs one check.
- **Divergence sentinel** (:class:`HealthMonitor`). EWMA loss-spike,
  grad-norm-explosion, plateau, scaler-skip-streak and non-finite
  detectors over the sampled series, with ``on_breach`` callbacks and an
  escalation ladder (warn -> lr backoff -> rollback to the newest
  checkpoint that is CRC-valid and finite: parameters, optimizer state,
  RNG streams and the iterator cursor, so the retried segment replays
  bitwise), a cooldown and a rollback cap.
- **NaN provenance** (:func:`blame_nonfinite`). A fault-only blame pass
  that replays the Executor's captured last inputs through the graph node
  by node with finite checks and names the first non-finite node
  (``analysis/findings``), emitted as a ``health.nan_provenance`` event in
  the same timeline as the breach and the rollback.

Everything lands in the existing surfaces under the reference's names:
``health.*`` gauges, counters and histograms in the metrics registry,
``health.loss``/``health.grad_norm`` counter tracks in the chrome trace,
``health.breach``/``health.rollback``/``health.nan_provenance`` events,
and the "Training health" section of ``tools/trace_report.py``.

On the card, a bitwise replay after a rollback needs
``torch.use_deterministic_algorithms(True)`` (and
``CUBLAS_WORKSPACE_CONFIG``, which cuBLAS needs under it): the flash
backward then sums dQ in key-tile order (``ops/flash_attention.py``).
"""
from __future__ import annotations

import logging
import math
import os
import threading
from collections import deque
from typing import Callable, List, Optional

import numpy as np

from . import metrics as _metrics
from . import trace as _trace

__all__ = ["HealthMonitor", "as_monitor", "enabled", "inline_stats_active",
           "request_stats", "stats_for_this_step", "sample_every",
           "batched_fetch", "apply_lr_backoff", "find_rollback_target",
           "blame_nonfinite", "activate", "deactivate"]

log = logging.getLogger("mxnet_tpu_torch.health")

# monitors currently attached to a live training loop — in-graph stats must
# be emitted for them even when the wider obs layer is off (the sentinel
# can act without the tracer recording anything)
_ACTIVE = [0]
_ACTIVE_LOCK = threading.Lock()


def activate() -> None:
    """A training loop attached a HealthMonitor (fit/Trainer call this)."""
    with _ACTIVE_LOCK:
        _ACTIVE[0] += 1


def deactivate() -> None:
    with _ACTIVE_LOCK:
        _ACTIVE[0] = max(0, _ACTIVE[0] - 1)


def enabled() -> bool:
    """Is the health plane on? ``MXNET_OBS_HEALTH`` forces (1) or vetoes
    (0); default: on while a HealthMonitor is attached to a training loop
    (fit ``health=``, ``Trainer.attach_health_monitor``, the estimator's
    HealthHandler). Deliberately NOT keyed to the obs tracing flag: the
    in-graph stats are real device work (per-param norm passes), and
    emitting them for a run that attached nothing to read them would be
    pure waste."""
    env = os.environ.get("MXNET_OBS_HEALTH", "").lower()
    if env in ("1", "true", "yes", "on"):
        return True
    if env in ("0", "false", "no", "off"):
        return False
    return _ACTIVE[0] > 0


# the reference's name for the engine's question
inline_stats_active = enabled

# per-step stats request: the per-param norms are extra memory passes over
# every weight and gradient, so a monitor-driven loop asks for them ONLY
# on the steps the monitor will sample (the updates are bitwise the same
# either way) and the overhead amortizes by 1/K. None = no loop is gating
# (plain enabled() behavior: always compute).
_STATS_REQUEST = [None]


def request_stats(flag) -> None:
    """Set by the training loop before each update: True/False gates this
    step's stats variant; None removes the gate (always-on when enabled)."""
    _STATS_REQUEST[0] = flag if flag is None else bool(flag)


def stats_for_this_step() -> bool:
    """What the fused engine consults: the plane is on AND (no per-step
    gate, or the loop asked for stats on this step)."""
    if not enabled():
        return False
    req = _STATS_REQUEST[0]
    return True if req is None else req


def sample_every() -> int:
    """Default sampling period K: fetch + evaluate every K update steps
    (``MXNET_OBS_HEALTH_EVERY``, default 10)."""
    try:
        return max(1, int(os.environ.get("MXNET_OBS_HEALTH_EVERY", "10")))
    except ValueError:
        return 10


def batched_fetch(values: list) -> list:
    """ONE batched device-to-host transfer for a mixed list of tensors,
    NDArrays and host values: the tensors of each device are flattened,
    cast to float64 (exact for f32, bf16, f16 and int32 values), joined by
    one ``torch.cat`` and read by one ``.cpu()``, then split back to numpy
    arrays of their own dtypes and shapes. Counts a single ``d2h``. Host
    values pass through. This is also what ``monitor.Monitor.toc``
    fetches through."""
    import torch

    out = list(values)
    by_dev: dict = {}
    for i, v in enumerate(values):
        t = getattr(v, "_data", v)
        if isinstance(t, torch.Tensor):
            by_dev.setdefault(t.device, []).append((i, t.detach()))
    if not by_dev:
        return out
    from .. import profiler

    if profiler.counting_dispatches():
        profiler.count_dispatch("d2h")
    for items in by_dev.values():
        flat = torch.cat([t.reshape(-1).to(torch.float64)
                          for _, t in items]).cpu().numpy()
        pos = 0
        for i, t in items:
            n = t.numel()
            dt = np.float32 if t.dtype == torch.bfloat16 else \
                torch.empty((), dtype=t.dtype).numpy().dtype
            out[i] = flat[pos:pos + n].astype(dt).reshape(tuple(t.shape))
            pos += n
    return out


def apply_lr_backoff(optimizer, factor: float = 0.5) -> Optional[float]:
    """Back the learning rate off by ``factor``; returns the new lr, or
    None when the optimizer's lr is scheduler-driven (can't be overridden
    — the reference raises on set_learning_rate then)."""
    try:
        new_lr = float(optimizer.learning_rate) * float(factor)
        optimizer.set_learning_rate(new_lr)
    except (RuntimeError, AttributeError, TypeError) as e:
        log.warning("health: lr backoff skipped (%s)", e)
        return None
    if _trace._ENABLED:
        _trace.tracer.event("health.lr_backoff", lr=new_lr, factor=factor)
        _metrics.registry.counter("health.lr_backoffs").inc()
        _metrics.registry.gauge("health.lr").set(new_lr)
    return new_lr


def find_rollback_target(manager, before_step: Optional[int] = None):
    """Newest checkpoint that (a) passes the manager's CRC validation and
    (b) holds only finite float arrays — a CRC-valid checkpoint written
    *after* a NaN blowup is poisoned, not valid. Returns a TrainingState
    or None. Fault-only path: the finite sweep is a host-side scan."""
    from ..checkpoint.manager import CheckpointError

    for step in reversed(manager.list_steps()):
        if before_step is not None and step >= before_step:
            continue
        try:
            state = manager.validate(step)
        except CheckpointError as e:
            log.warning("health: rollback skipping invalid checkpoint: %s", e)
            continue
        poisoned = False
        for name, arr in state.arrays.items():
            if np.issubdtype(arr.dtype, np.floating) and \
                    not np.all(np.isfinite(arr)):
                log.warning("health: rollback skipping checkpoint %d — "
                            "non-finite values in %r", step, name)
                poisoned = True
                break
        if not poisoned:
            return state
    return None


# ---------------------------------------------------------------------------
# the divergence sentinel
# ---------------------------------------------------------------------------

_ESCALATABLE = ("loss_spike", "grad_norm_explosion", "scaler_skip_streak")
_ACTION_ORDER = ("warn", "lr_backoff", "rollback")


class HealthMonitor:
    """Sample-and-judge monitor over a training run's numeric health.

    Feed it once per optimizer step (``step()``); every ``every`` steps it
    fetches the device-resident health scalars with one batched transfer,
    updates the EWMAs, evaluates the detectors, and returns a report dict
    (None between samples and when nothing is enabled).

    Detectors (synthetic-series unit tests in tests/test_health.py):

    - ``nonfinite`` — any non-finite gradient element, loss, or grad norm.
      Fatal: goes straight to the ceiling action (there is nothing an lr
      backoff can do for a NaN already in the parameters). Suppressed when
      an AMP loss scaler is attached: a found-inf step is *skipped* by the
      scaler (params untouched — routine fp16 scale-growth overflow), and
      only a skip *streak* is pathological.
    - ``loss_spike`` — sampled loss > ``loss_spike`` × its EWMA (judged
      against the EWMA *before* the sample folds in).
    - ``grad_norm_explosion`` — global grad norm > ``grad_explosion`` ×
      its EWMA.
    - ``plateau`` — relative loss-EWMA improvement over the last
      ``plateau_window`` samples < ``plateau_eps`` (warn-only: a plateau
      is advice, not an emergency).
    - ``scaler_skip_streak`` — the AMP scaler skipped
      ``skip_streak_threshold``+ consecutive steps (the silent skip-loop:
      counters advance, parameters don't). Also
      warned once per streak even below the breach ladder.

    Actions: ``actions`` is the escalation *ceiling* — "warn" (default),
    "lr_backoff", or "rollback". Escalatable breaches climb the ladder on
    consecutive breached samples (warn → lr backoff → rollback); fatal
    ones jump to the ceiling. lr backoff applies in-place when ``step()``
    is given the optimizer; rollback is *requested* via the report (the
    fit loop owns the checkpoint manager and the iterator) and throttled
    here: at most ``max_rollbacks`` per run and never within
    ``rollback_cooldown`` global steps of the last one.
    """

    def __init__(self, every: Optional[int] = None, alpha: float = 0.2,
                 loss_spike: float = 4.0, grad_explosion: float = 10.0,
                 plateau_window: int = 20, plateau_eps: float = 1e-3,
                 skip_streak_threshold: int = 8,
                 actions: str = "warn", lr_backoff_factor: float = 0.5,
                 rollback_cooldown: int = 50, max_rollbacks: int = 2,
                 param_names: Optional[List[str]] = None, logger=None):
        if actions not in ("off",) + _ACTION_ORDER:
            raise ValueError(f"actions must be one of "
                             f"{('off',) + _ACTION_ORDER}, got {actions!r}")
        self.every = int(every) if every else sample_every()
        self.alpha = float(alpha)
        self.loss_spike = float(loss_spike)
        self.grad_explosion = float(grad_explosion)
        self.plateau_window = int(plateau_window)
        self.plateau_eps = float(plateau_eps)
        self.skip_streak_threshold = int(skip_streak_threshold)
        self.actions = actions
        self.lr_backoff_factor = float(lr_backoff_factor)
        self.rollback_cooldown = int(rollback_cooldown)
        self.max_rollbacks = int(max_rollbacks)
        self.param_names = list(param_names) if param_names else None
        self.logger = logger or log
        self._callbacks: List[Callable] = []
        self.last_report: Optional[dict] = None
        self.rollbacks_done = 0
        self._n = 0
        self._pending_loss = None
        self._loss_ewma: Optional[float] = None
        self._gnorm_ewma: Optional[float] = None
        self._ewma_history: deque = deque(maxlen=max(2, self.plateau_window))
        self._ladder = 0
        self._last_rollback_step: Optional[int] = None
        self._warned_streak = False
        self._blamed_episode = False

    # -- feeding -----------------------------------------------------------
    def on_breach(self, fn: Callable) -> "HealthMonitor":
        """Register ``fn(report, breaches)``; returns self for chaining."""
        self._callbacks.append(fn)
        return self

    def attach_names(self, names: List[str]) -> None:
        """Parameter names parallel to the engine's update indices, so a
        breach can name the worst-offending parameter."""
        self.param_names = list(names)

    def will_sample(self) -> bool:
        """Will the NEXT ``step()`` call evaluate? Training loops ask this
        *before* the update runs and pass it to :func:`request_stats`, so
        the fused engine computes the stats exactly on sampled steps."""
        return (self._n + 1) % self.every == 0

    def record_loss(self, loss) -> None:
        """Note this step's loss. Cheap by contract: NDArrays / device
        scalars are *referenced*, not synced — the batched fetch at the
        next sampled step moves them to host."""
        self._pending_loss = loss

    def record_metric(self, eval_metric) -> None:
        """Module-path loss source: pick the loss-like metric (loss /
        entropy / perplexity in the name) out of an EvalMetric's running
        values. Host-side floats — no device work."""
        try:
            pairs = eval_metric.get_name_value()
        except Exception:  # noqa: BLE001 — a half-updated metric mid-epoch
            return         # must not take down the health plane
        for name, val in pairs:
            lname = str(name).lower()
            if any(k in lname for k in ("loss", "entropy", "perplexity")):
                self._pending_loss = val
                return

    # -- the sampled evaluation -------------------------------------------
    def step(self, global_step: Optional[int] = None, engine=None,
             scaler=None, optimizer=None, loss=None) -> Optional[dict]:
        """Feed one optimizer step; evaluates every ``self.every`` calls.
        Between samples this is reference bookkeeping only — no device
        work, no allocation beyond a ref swap."""
        if loss is not None:
            self._pending_loss = loss
        self._n += 1
        if self._n % self.every:
            return None
        return self._sample(global_step if global_step is not None
                            else self._n, engine, scaler, optimizer)

    def _sample(self, global_step, engine, scaler, optimizer) -> dict:
        lh = dict(getattr(engine, "last_health", None) or {})
        fetch_keys = list(lh)
        vals = [lh[k] for k in fetch_keys]
        loss_ref = self._pending_loss
        self._pending_loss = None
        if loss_ref is not None and not isinstance(
                loss_ref, (int, float, np.floating)):
            fetch_keys.append("__loss__")
            vals.append(loss_ref)
        host = batched_fetch(vals) if vals else []
        got = dict(zip(fetch_keys, host))

        loss_val: Optional[float] = None
        if "__loss__" in got:
            loss_val = float(np.mean(got["__loss__"]))
        elif loss_ref is not None:
            loss_val = float(loss_ref)

        gnorm = float(got["global_grad_norm"]) \
            if "global_grad_norm" in got else None
        nonfinite_total = int(np.sum(got["nonfinite"])) \
            if "nonfinite" in got else 0
        streak = int(got["skip_streak"]) if "skip_streak" in got else None
        if streak is None and scaler is not None:
            try:
                streak = int(getattr(scaler, "skip_streak", 0) or 0)
            except (TypeError, ValueError):
                streak = None

        # worst update-to-weight ratio + which parameter it belongs to
        ratio_max, worst_param, bad_param = None, None, None
        if "update_norms" in got and "param_norms" in got:
            un = np.asarray(got["update_norms"], np.float64)
            wn = np.asarray(got["param_norms"], np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                ratios = un / np.maximum(wn, 1e-12)
            if ratios.size:
                idx = int(np.nanargmax(ratios)) if np.any(
                    np.isfinite(ratios)) else 0
                ratio_max = float(ratios[idx]) if np.isfinite(
                    ratios[idx]) else float("inf")
                worst_param = self._param_name(engine, idx)
        if nonfinite_total and "nonfinite" in got:
            nf = np.asarray(got["nonfinite"])
            bad_param = self._param_name(engine, int(np.argmax(nf)))

        # an AMP scaler that found inf grads SKIPPED this update (params
        # untouched, scale shrunk) — that is the scaler doing its job, not
        # a fatal blowup; the pathological case (skipping forever) is the
        # skip-streak detector's. Only scaler-less runs treat non-finite
        # gradients as fatal.
        scaler_handled = scaler is not None or "found_inf" in lh \
            or "skip_streak" in lh
        breaches = self._evaluate(loss_val, gnorm, nonfinite_total, streak,
                                  ratio_max, worst_param, bad_param,
                                  scaler_handled)
        self._publish(global_step, loss_val, gnorm, nonfinite_total, streak,
                      ratio_max, breaches)
        action, note = self._decide(breaches, global_step)
        if action == "lr_backoff" and optimizer is not None:
            apply_lr_backoff(optimizer, self.lr_backoff_factor)

        report = {
            "step": global_step,
            "loss": loss_val,
            "loss_ewma": self._loss_ewma,
            "grad_norm": gnorm,
            "grad_norm_ewma": self._gnorm_ewma,
            "nonfinite": nonfinite_total,
            "skip_streak": streak,
            "update_ratio_max": ratio_max,
            "worst_param": worst_param,
            "breaches": breaches,
            "action": action,
            "ok": not breaches,
        }
        if note:
            report["note"] = note
        self.last_report = report
        if breaches:
            self.logger.warning(
                "health breach at step %s: %s (action=%s)", global_step,
                "; ".join(b["detail"] for b in breaches), action)
            try:  # snapshot the run's last seconds (spans, metrics,
                # profiler stacks) while the breach evidence is still in
                # the ring — throttled, no-op unless the recorder is armed
                from . import blackbox

                blackbox.trigger(
                    "health_breach:" + ",".join(b["rule"]
                                                for b in breaches))
            except Exception:  # noqa: BLE001 — never fail the train loop
                pass
            for fn in self._callbacks:
                try:
                    fn(report, breaches)
                except Exception:  # noqa: BLE001 — a pager hook must never
                    pass           # take down the training loop
        return report

    def _param_name(self, engine, pos: int) -> Optional[str]:
        idxs = list(getattr(engine, "last_health", {}).get("indices", ())) \
            if engine is not None else []
        if self.param_names:
            # engine indices index the *optimizer's* param table, which is
            # what attach_names mirrors
            i = idxs[pos] if pos < len(idxs) else pos
            if isinstance(i, int) and 0 <= i < len(self.param_names):
                return self.param_names[i]
        if pos < len(idxs):
            return str(idxs[pos])
        return None

    # -- detectors ---------------------------------------------------------
    def _evaluate(self, loss, gnorm, nonfinite_total, streak, ratio_max,
                  worst_param, bad_param,
                  scaler_handled: bool = False) -> List[dict]:
        breaches: List[dict] = []

        bad_loss = loss is not None and not math.isfinite(loss)
        bad_gnorm = gnorm is not None and not math.isfinite(gnorm)
        if (nonfinite_total or bad_loss or bad_gnorm) and not scaler_handled:
            what = []
            if nonfinite_total:
                what.append(f"{nonfinite_total} non-finite gradient "
                            f"element(s)"
                            + (f" (worst: {bad_param})" if bad_param else ""))
            if bad_loss:
                what.append(f"loss={loss}")
            if bad_gnorm:
                what.append(f"grad_norm={gnorm}")
            breaches.append({"rule": "nonfinite",
                             "value": nonfinite_total or float("nan"),
                             "threshold": 0,
                             "param": bad_param,
                             "detail": "non-finite values: "
                                       + ", ".join(what)})

        if (loss is not None and not bad_loss
                and self._loss_ewma is not None
                and math.isfinite(self._loss_ewma)
                and abs(self._loss_ewma) > 1e-12
                and loss > self.loss_spike * self._loss_ewma > 0):
            breaches.append({"rule": "loss_spike", "value": loss,
                             "threshold": self.loss_spike * self._loss_ewma,
                             "detail": f"loss {loss:.6g} > "
                                       f"{self.loss_spike}x EWMA "
                                       f"{self._loss_ewma:.6g}"})

        if (gnorm is not None and not bad_gnorm
                and self._gnorm_ewma is not None
                and math.isfinite(self._gnorm_ewma)
                and self._gnorm_ewma > 1e-12
                and gnorm > self.grad_explosion * self._gnorm_ewma):
            breaches.append({"rule": "grad_norm_explosion", "value": gnorm,
                             "threshold":
                                 self.grad_explosion * self._gnorm_ewma,
                             "detail": f"grad norm {gnorm:.6g} > "
                                       f"{self.grad_explosion}x EWMA "
                                       f"{self._gnorm_ewma:.6g}"})

        if streak is not None:
            if streak >= self.skip_streak_threshold:
                breaches.append({"rule": "scaler_skip_streak",
                                 "value": streak,
                                 "threshold": self.skip_streak_threshold,
                                 "detail": f"AMP scaler skipped {streak} "
                                           "consecutive steps — training "
                                           "is stalled, not progressing"})
                if not self._warned_streak:
                    # warn-once per streak: the silent skip-loop finally
                    # has a voice even when no pager hook is attached
                    self.logger.warning(
                        "AMP scaler skip streak reached %d (threshold %d) "
                        "— counters advance but parameters do not "
                        "(the update is skipped)", streak,
                        self.skip_streak_threshold)
                    self._warned_streak = True
            elif streak == 0:
                self._warned_streak = False

        # fold the sample into the EWMAs AFTER judging, and only when it
        # did not itself breach: a spike judged against the prior baseline
        # must not become the next sample's baseline (a divergence episode
        # would otherwise normalize itself); non-finite samples never fold
        rules_so_far = {b["rule"] for b in breaches}
        if (loss is not None and math.isfinite(loss)
                and "loss_spike" not in rules_so_far):
            self._loss_ewma = loss if self._loss_ewma is None else \
                (1 - self.alpha) * self._loss_ewma + self.alpha * loss
            self._ewma_history.append(self._loss_ewma)
        if (gnorm is not None and math.isfinite(gnorm)
                and "grad_norm_explosion" not in rules_so_far):
            self._gnorm_ewma = gnorm if self._gnorm_ewma is None else \
                (1 - self.alpha) * self._gnorm_ewma + self.alpha * gnorm

        if (len(self._ewma_history) == self.plateau_window
                and not any(b["rule"] in ("loss_spike", "nonfinite")
                            for b in breaches)):
            first, last = self._ewma_history[0], self._ewma_history[-1]
            denom = max(abs(first), 1e-12)
            improvement = (first - last) / denom
            if improvement < self.plateau_eps:
                breaches.append({"rule": "plateau", "value": improvement,
                                 "threshold": self.plateau_eps,
                                 "detail": f"loss EWMA improved "
                                           f"{improvement:.2e} over last "
                                           f"{self.plateau_window} samples "
                                           f"(< {self.plateau_eps:.0e})"})
                self._ewma_history.clear()  # re-arm over a fresh window

        return breaches

    # -- metrics / trace publication ---------------------------------------
    def _publish(self, global_step, loss, gnorm, nonfinite_total, streak,
                 ratio_max, breaches) -> None:
        if not _trace._ENABLED:
            return
        reg = _metrics.registry
        if loss is not None and math.isfinite(loss):
            reg.gauge("health.loss").set(loss)
            _trace.tracer.counter("health.loss", loss)
        if self._loss_ewma is not None:
            reg.gauge("health.loss_ewma").set(self._loss_ewma)
        if gnorm is not None and math.isfinite(gnorm):
            reg.gauge("health.grad_norm").set(gnorm)
            _trace.tracer.counter("health.grad_norm", gnorm)
            # ratio ladder, not the latency ladder: norms span decades
            reg.histogram("health.grad_norm_hist",
                          buckets=(1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0,
                                   1e3, 1e4)).observe(gnorm)
        if ratio_max is not None and math.isfinite(ratio_max):
            reg.gauge("health.update_ratio_max").set(ratio_max)
            reg.histogram("health.update_ratio",
                          buckets=(1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1,
                                   1.0)).observe(ratio_max)
        reg.gauge("health.nonfinite_grads").set(nonfinite_total)
        if nonfinite_total:
            reg.counter("health.nonfinite_total").inc(nonfinite_total)
        if streak is not None:
            reg.gauge("health.scaler.skip_streak").set(streak)
        reg.counter("health.samples").inc()
        for b in breaches:
            reg.counter(f"health.breach.{b['rule']}").inc()
            _trace.tracer.event("health.breach", step=global_step,
                                rule=b["rule"], value=b.get("value"),
                                threshold=b.get("threshold"),
                                detail=b["detail"])

    # -- action policy -----------------------------------------------------
    def _decide(self, breaches, global_step):
        if not breaches or self.actions == "off":
            self._ladder = 0
            self._blamed_episode = False
            return "none", None
        rules = {b["rule"] for b in breaches}
        ceiling = _ACTION_ORDER.index(self.actions) \
            if self.actions in _ACTION_ORDER else 0
        if "nonfinite" in rules:
            want = ceiling  # fatal: jump the ladder
        elif rules & set(_ESCALATABLE):
            self._ladder += 1
            want = min(self._ladder - 1, ceiling)
        else:  # plateau (and anything advisory): never more than a warn
            return "warn", None
        note = None
        if _ACTION_ORDER[want] == "rollback":
            if self.rollbacks_done >= self.max_rollbacks:
                want, note = 0, (f"rollback suppressed: cap of "
                                 f"{self.max_rollbacks} reached")
            elif (self._last_rollback_step is not None
                  and global_step is not None
                  and global_step - self._last_rollback_step
                  < self.rollback_cooldown):
                want, note = 0, (f"rollback suppressed: within cooldown "
                                 f"({self.rollback_cooldown} steps)")
        return _ACTION_ORDER[want], note

    def should_blame(self, report: Optional[dict]) -> bool:
        """One provenance pass per bad episode: True on the first sampled
        breach whose rule warrants attribution (non-finite values or a
        scaler skip-loop); re-arms after a clean sample."""
        if not report or not report.get("breaches"):
            return False
        rules = {b["rule"] for b in report["breaches"]}
        if not (rules & {"nonfinite", "scaler_skip_streak"}):
            return False
        if self._blamed_episode:
            return False
        self._blamed_episode = True
        return True

    def note_rollback(self, restored_step: int) -> None:
        """The fit loop rolled back to ``restored_step``: start cooldown,
        reset the sampled series (the replayed segment is a fresh run —
        stale EWMAs would re-judge it against a poisoned baseline)."""
        self.rollbacks_done += 1
        self._last_rollback_step = restored_step
        self.reset_series()
        if _trace._ENABLED:
            _metrics.registry.counter("health.rollbacks").inc()

    def reset_series(self) -> None:
        self._pending_loss = None
        self._loss_ewma = None
        self._gnorm_ewma = None
        self._ewma_history.clear()
        self._ladder = 0
        self._blamed_episode = False
        self._warned_streak = False


def as_monitor(spec) -> Optional[HealthMonitor]:
    """Coerce a fit-API ``health=`` argument: None | True | dict of
    HealthMonitor kwargs | a HealthMonitor instance."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, HealthMonitor):
        return spec
    if spec is True:
        return HealthMonitor()
    if isinstance(spec, dict):
        return HealthMonitor(**spec)
    raise TypeError(f"health must be None/True/dict/HealthMonitor, "
                    f"got {type(spec)}")


# ---------------------------------------------------------------------------
# NaN provenance — the fault-only blame pass
# ---------------------------------------------------------------------------

def blame_nonfinite(executor, max_report_inputs: int = 4) -> Optional[dict]:
    """Replay the Executor's captured last inputs through the graph
    eagerly with per-node finite checks; name the first node whose output
    is non-finite (and any already-non-finite leaf inputs feeding it — a
    poisoned batch blames the data, a bad op blames the op).

    Fault-only by design: one eager per-node walk with a host check per
    node, stopped at the first non-finite node, under ``no_grad``. Never
    called on the hot path; returns None when the executor holds no
    captured inputs (no ``forward(is_train=True)``, or
    ``grad_req="null"``). The finding is emitted as a tagged
    ``health.nan_provenance`` event and returned as a dict built on the
    findings machinery (``analysis/findings``)."""
    import torch

    from .. import autograd
    from ..analysis.findings import Finding, Severity
    from ..executor import _BN_OPS
    from ..ops import get_op
    from ..ops.registry import call_op, coerce_kwargs

    li = getattr(executor, "_last_inputs", None)
    if li is None:
        return None
    arg_vals, aux_vals, train = li
    symb = executor._symbol
    arg_names = symb.list_arguments()
    aux_names = symb.list_auxiliary_states()
    dev = getattr(executor, "_device", None)

    def _finite(v) -> bool:
        if isinstance(v, (tuple, list)):
            return all(_finite(x) for x in v)
        t = getattr(v, "_data", v)
        if not isinstance(t, torch.Tensor) or not (
                t.is_floating_point() or t.is_complex()):
            return True
        return bool(torch.isfinite(t).all())

    # leaf inputs first: a poisoned batch or parameter is the provenance
    # answer even before any op runs
    bad_inputs = [n for n, v in zip(arg_names, arg_vals) if not _finite(v)]
    bad_inputs += [n for n, v in zip(aux_names, aux_vals) if not _finite(v)]

    first_bad = None
    checked = 0
    env: dict = {}
    args = dict(zip(arg_names, arg_vals))
    auxs = dict(zip(aux_names, aux_vals))
    old_train = autograd.set_training(bool(train))
    try:
        with torch.no_grad():
            for node in symb._topo():
                if node._op is None:
                    env[id(node)] = args[node._name] if node._name in args \
                        else auxs[node._name]
                    continue
                if node._op == "_group":
                    continue
                opdef = getattr(node, "_opdef", None) or get_op(node._op)
                kwargs = coerce_kwargs({k: v for k, v in node._attrs.items()
                                        if not k.startswith("__")})
                in_vals = []
                for i in node._inputs:
                    v = env[id(i._base())]
                    if i._index is not None and isinstance(v, tuple):
                        v = v[i._index]
                    in_vals.append(v)
                if node._op in _BN_OPS and train and \
                        not kwargs.get("use_global_stats", False):
                    kwargs["output_mean_var"] = True
                    out = call_op(opdef, in_vals, kwargs, dev)[0]
                else:
                    out = call_op(opdef, in_vals, kwargs, dev)
                    if isinstance(out, list):
                        out = tuple(out)
                env[id(node)] = out
                checked += 1
                if not _finite(out):
                    bad_in = [i._base()._name or i._base()._op
                              for i, v in zip(node._inputs, in_vals)
                              if not _finite(v)]
                    first_bad = {"node": node._name or node._op,
                                 "op": node._op,
                                 "nonfinite_inputs":
                                     bad_in[:max_report_inputs]}
                    break
    finally:
        autograd.set_training(old_train)
        env.clear()

    if first_bad is None and not bad_inputs:
        # the forward replay is clean: the non-finite values arose in
        # backward or in the update itself — say so rather than inventing
        # a node
        result = {"node": None, "op": None, "nonfinite_inputs": [],
                  "checked_nodes": checked,
                  "detail": "forward replay is finite — non-finite values "
                            "arose in backward or the optimizer update "
                            "(loss-scale overflow?)"}
    else:
        fb = first_bad or {}
        finding = Finding(
            rule_id="nonfinite-value",
            severity=Severity.ERROR,
            message=("first non-finite output at this node"
                     if first_bad else "non-finite graph input"),
            node=fb.get("node") or (bad_inputs[0] if bad_inputs else None),
            op=fb.get("op"),
            fix_hint="inspect the named tensor; the health sentinel can "
                     "roll back past it (fit(health=, checkpoint=))")
        result = {"node": finding.node, "op": finding.op,
                  "nonfinite_inputs":
                      (fb.get("nonfinite_inputs") or bad_inputs)
                      [:max_report_inputs],
                  "checked_nodes": checked,
                  "detail": finding.format()}
    log.warning("health: NaN provenance — %s", result["detail"])
    if _trace._ENABLED:
        _metrics.registry.counter("health.nan_provenance").inc()
        _trace.tracer.event("health.nan_provenance",
                            node=result.get("node"), op=result.get("op"),
                            nonfinite_inputs=result.get("nonfinite_inputs"),
                            checked_nodes=result.get("checked_nodes"))
    return result
