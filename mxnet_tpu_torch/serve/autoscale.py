"""SLO-driven elastic autoscaling for the serving fleet (counterpart of
``mxnet_tpu/serve/autoscale.py``).

A controller that watches the SLO signals the platform measures —
error-budget burn (``obs/slo.py``), per-replica queue depth and batch
occupancy (the member records the
:class:`~mxnet_tpu_torch.serve.fleet.ReplicaPool` supervisor keeps and
exports as ``fleet.replica<i>.*`` gauges) — and grows or shrinks the pool
live. The join/leave *mechanics* live in ``ReplicaPool``: scale-out is
quarantine → resync-to-committed-generation → activate-at-a-generation-
boundary, scale-in is deactivate-at-boundary → drain → stop (zero requests
shed by construction). This module only decides WHEN.

Two layers, split so that the policy is testable as a pure function:

- :class:`AutoscalePolicy` — ``decide(signals, now)``: a decision function
  over one signal window. Scale **out** on SLO pressure (windowed burn
  over ``burn_out``, queue depth over ``queue_out``, occupancy over
  ``occupancy_out``), rate-limited by ``cooldown_s``. Scale **in** only
  after ``hysteresis`` *consecutive* quiet windows AND
  ``scale_in_cooldown_s`` since the last action — flapping is a worse
  failure mode than a briefly oversized fleet (every flap pays a warmup on
  the way back up). ``min_replicas``/``max_replicas`` clamp.
- :class:`Autoscaler` — the controller: a thread that assembles the signal
  window each ``interval`` (windowed burn from
  :meth:`~mxnet_tpu_torch.obs.slo.SLOMonitor.burn_window` over metric-
  snapshot deltas, queue/occupancy from pool member records), applies the
  policy, and drives the pool. One join in flight at a time. Every
  decision lands in ``self.events``, the ``autoscale.*`` metrics and an
  ``autoscale.<action>`` event.

The windowed burn reads the router's ``fleet.request_latency_seconds``
histogram and ``fleet.request_deadline_exceeded`` counter, which the
router records while ``obs`` is enabled. A pool on mesh slices
(``ReplicaPool.sharded``) scales out onto its spare slices by default
(``pool.new_sharded_handle``); any other pool passes ``factory=``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from .. import obs
from ..obs.slo import SLOMonitor
from .engine import ServeError

__all__ = ["AutoscalePolicy", "Autoscaler"]


class AutoscalePolicy:
    """Pure scale-out/scale-in decision over one signal window.

    ``signals`` keys (missing keys default to quiet): ``ready`` (int),
    ``burn`` (windowed error-budget burn rate), ``queue_depth`` (max
    per-replica queued requests), ``occupancy`` (mean batch occupancy in
    [0, 1]), ``joining`` (replicas mid-bring-up, counted as capacity
    already ordered).

    Decision dict: ``{"action": "scale_out"|"scale_in"|"hold",
    "reason": str, "signals": signals}``.
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8, *,
                 burn_out: float = 1.0, queue_out: float = 8.0,
                 occupancy_out: float = 0.9,
                 burn_in: float = 0.25, queue_in: float = 0.0,
                 occupancy_in: float = 0.3,
                 hysteresis: int = 3, cooldown_s: float = 5.0,
                 scale_in_cooldown_s: float = 15.0):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}")
        if hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.burn_out = float(burn_out)
        self.queue_out = float(queue_out)
        self.occupancy_out = float(occupancy_out)
        self.burn_in = float(burn_in)
        self.queue_in = float(queue_in)
        self.occupancy_in = float(occupancy_in)
        self.hysteresis = int(hysteresis)
        self.cooldown_s = float(cooldown_s)
        self.scale_in_cooldown_s = float(scale_in_cooldown_s)
        self._low_streak = 0
        self._last_action_at: Optional[float] = None
        self._prev_action_at: Optional[float] = None

    def reset(self) -> None:
        self._low_streak = 0
        self._last_action_at = None
        self._prev_action_at = None

    def _stamp(self, now: float) -> None:
        self._prev_action_at = self._last_action_at
        self._last_action_at = now

    def undo_action(self) -> None:
        """The controller could not execute the last decided action (e.g.
        the scale-out factory failed) — roll the cooldown stamp back so a
        fleet under genuine pressure doesn't wait out a cooldown for an
        action that never happened."""
        self._last_action_at = self._prev_action_at

    def _decision(self, action: str, reason: str, signals: dict) -> dict:
        return {"action": action, "reason": reason, "signals": signals}

    def decide(self, signals: dict, now: float) -> dict:
        ready = int(signals.get("ready", 0))
        joining = int(signals.get("joining", 0))
        burn = float(signals.get("burn", 0.0))
        queue_depth = float(signals.get("queue_depth", 0.0))
        occupancy = float(signals.get("occupancy", 0.0))
        capacity = ready + joining  # ordered capacity counts

        # capacity restoration outranks every damper: a fleet below its
        # floor (replica death, cold start) is an outage in progress
        if capacity < self.min_replicas:
            self._low_streak = 0
            self._stamp(now)
            return self._decision("scale_out",
                                  f"capacity {capacity} below floor "
                                  f"{self.min_replicas}", signals)

        pressure = []
        if burn > self.burn_out:
            pressure.append(f"burn {burn:.2f}x > {self.burn_out}x")
        if queue_depth > self.queue_out:
            pressure.append(f"queue {queue_depth:.0f} > {self.queue_out:.0f}")
        if occupancy > self.occupancy_out:
            pressure.append(
                f"occupancy {occupancy:.2f} > {self.occupancy_out}")

        if pressure:
            self._low_streak = 0
            if capacity >= self.max_replicas:
                return self._decision("hold",
                                      "pressure but fleet at max "
                                      f"({self.max_replicas}): "
                                      + "; ".join(pressure), signals)
            if (self._last_action_at is not None
                    and now - self._last_action_at < self.cooldown_s):
                return self._decision("hold",
                                      "pressure in cooldown: "
                                      + "; ".join(pressure), signals)
            self._stamp(now)
            return self._decision("scale_out", "; ".join(pressure), signals)

        quiet = (burn <= self.burn_in and queue_depth <= self.queue_in
                 and occupancy <= self.occupancy_in)
        if not quiet:
            # mid-band: neither pressure nor provably idle — the streak
            # resets so a blip can't sneak a scale-in through hysteresis
            self._low_streak = 0
            return self._decision("hold", "steady", signals)

        self._low_streak += 1
        if ready <= self.min_replicas:
            return self._decision("hold", "quiet at floor", signals)
        if self._low_streak < self.hysteresis:
            return self._decision(
                "hold", f"quiet {self._low_streak}/{self.hysteresis} "
                "(hysteresis)", signals)
        if (self._last_action_at is not None
                and now - self._last_action_at < self.scale_in_cooldown_s):
            return self._decision("hold", "quiet but in scale-in cooldown",
                                  signals)
        self._low_streak = 0
        self._stamp(now)
        return self._decision("scale_in",
                              f"quiet {self.hysteresis} consecutive windows",
                              signals)


class Autoscaler:
    """Drive a :class:`~mxnet_tpu.serve.fleet.ReplicaPool` from an
    :class:`AutoscalePolicy`.

    Parameters
    ----------
    pool / router
        The supervised fleet and its Router (the router's stats feed the
        SLO monitor; the pool executes joins and leaves).
    factory : callable, optional
        Zero-arg callable returning a fresh replica handle for scale-out.
        Default: ``pool.new_sharded_handle`` for sharded pools (the next
        spare mesh slice) — a non-sharded pool must pass one.
    policy / slo
        Decision policy and the SLO monitor whose ``burn_window`` supplies
        the windowed burn signal (defaults: :class:`AutoscalePolicy()`,
        ``SLOMonitor()``).
    interval : float
        Seconds between control-loop evaluations when started as a thread.
    drain_timeout : float
        Scale-in drain budget per replica.
    """

    def __init__(self, pool, router, factory: Optional[Callable] = None, *,
                 policy: Optional[AutoscalePolicy] = None,
                 slo: Optional[SLOMonitor] = None,
                 interval: float = 1.0, drain_timeout: float = 30.0):
        self._pool = pool
        self._router = router
        if factory is None:
            if getattr(pool, "_make_server", None) is None:
                raise ValueError(
                    "pass factory= for a non-sharded pool "
                    "(sharded pools default to pool.new_sharded_handle)")
            factory = pool.new_sharded_handle
        self._factory = factory
        self.policy = policy or AutoscalePolicy()
        self.slo = slo or SLOMonitor()
        self.interval = float(interval)
        self.drain_timeout = float(drain_timeout)
        self.events: List[dict] = []
        self.last_decision: Optional[dict] = None
        self._prev_snapshot: Optional[dict] = None
        self._leave_thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- signal assembly ------------------------------------------------
    def signals(self) -> dict:
        """One signal window: windowed burn from metric-snapshot deltas,
        queue depth / occupancy / membership from the pool's member records
        (the same numbers the supervisor exports as ``fleet.replica<i>.*``
        gauges — operator dashboards and this controller cannot drift)."""
        snap = obs.metrics.snapshot()
        win = self.slo.burn_window(self._prev_snapshot, snap)
        self._prev_snapshot = snap
        pst = self._pool.stats()
        members = pst.get("members", {})
        ready = [v for v in members.values() if v["state"] == "ready"]
        # "joining" = every member that is ordered-but-not-serving: a
        # joiner mid-bring-up AND a dead/resyncing member the supervisor
        # is restoring. Counting only happy-path joiners would make a
        # failed bring-up (state "dead" during restart backoff) invisible
        # and the controller would pop a fresh mesh slice per cooldown
        # window for the SAME pressure — capacity already ordered must
        # never be ordered twice
        joining = sum(1 for v in members.values()
                      if v["state"] in ("new", "starting", "quarantined",
                                        "dead", "resync"))
        queue_depth = max((v.get("queue_depth", 0) for v in ready), default=0)
        occ = (sum(v.get("occupancy", 0.0) for v in ready) / len(ready)
               if ready else 0.0)
        return {"burn": win["burn"], "attainment": win["attainment"],
                "window_completed": win["completed"],
                "window_misses": win["misses"],
                "queue_depth": queue_depth, "occupancy": round(occ, 4),
                "ready": pst["ready"], "joining": joining,
                "generation": pst.get("generation", 0)}

    # -- control loop ---------------------------------------------------
    def tick(self, signals: Optional[dict] = None) -> dict:
        """One control-loop evaluation (tests and benches call this
        directly; ``signals`` overrides the live window). Returns the
        decision actually applied."""
        now = time.monotonic()
        sig = self.signals() if signals is None else signals
        d = self.policy.decide(sig, now)
        if d["action"] == "scale_out":
            d = self._scale_out(d)
        elif d["action"] == "scale_in":
            d = self._scale_in(d)
        if d["action"] != "hold":
            self.events.append({"t": now, "action": d["action"],
                                "reason": d["reason"],
                                "ready": sig.get("ready")})
            obs.inc(f"autoscale.{d['action']}")
            obs.event(f"autoscale.{d['action']}", reason=d["reason"],
                      ready=sig.get("ready"))
        obs.set_gauge("autoscale.ready", sig.get("ready", 0))
        self.last_decision = d
        return d

    def _scale_out(self, d: dict) -> dict:
        if int(d["signals"].get("joining", 0)) > 0:
            # one join at a time: bring-up includes the warmup; deciding
            # again mid-join would order capacity twice for one signal
            return {**d, "action": "hold",
                    "reason": f"join in flight ({d['reason']})"}
        try:
            handle = self._factory()
        except ServeError as e:
            # no capacity was ordered: give the cooldown back, or genuine
            # pressure would wait out a damper for a no-op
            self.policy.undo_action()
            return {**d, "action": "hold", "reason": f"factory: {e}"}
        self._pool.add_replica(handle, wait_ready=False)
        return d

    def _scale_in(self, d: dict) -> dict:
        if self._leave_thread is not None and self._leave_thread.is_alive():
            self.policy.undo_action()
            return {**d, "action": "hold", "reason": "leave in flight"}
        ready = self._pool.ready_members()
        if len(ready) <= self.policy.min_replicas:
            self.policy.undo_action()
            return {**d, "action": "hold", "reason": "at floor"}
        victim = max(ready, key=lambda m: m.idx)  # youngest member leaves

        def leave():
            self._pool.remove_replica(victim.idx,
                                      drain_timeout=self.drain_timeout)

        # drain off the control thread: a slow drain must not freeze the
        # signal loop (pending-leave detection keeps decisions sane)
        self._leave_thread = threading.Thread(target=leave, daemon=True,
                                              name="mxtpu-autoscale-leave")
        self._leave_thread.start()
        return d

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 — the controller must
                # outlive a transient stats/RPC failure; the next window
                # gets a fresh read
                obs.inc("autoscale.tick_errors")
                obs.event("autoscale.tick_error",
                          error=f"{type(e).__name__}: {e}"[:160])

    def start(self) -> "Autoscaler":
        self._stop_evt.clear()
        self._prev_snapshot = obs.metrics.snapshot()  # window starts now
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxtpu-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                obs.inc("autoscale.thread_leaked")
                obs.event("autoscale.thread_leaked", which="control")
            self._thread = None
        if self._leave_thread is not None:
            self._leave_thread.join(timeout=self.drain_timeout + 5)
            if self._leave_thread.is_alive():
                # the drain outlived its budget: the replica will still be
                # stopped by remove_replica's own timeout, but the leak is
                # an operator signal
                obs.inc("autoscale.thread_leaked")
                obs.event("autoscale.thread_leaked", which="leave")
