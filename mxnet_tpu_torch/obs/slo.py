"""SLO monitor — service-level math over merged fleet telemetry
(counterpart of ``mxnet_tpu/obs/slo.py``).

Raw telemetry answers "what happened"; this module answers "are we keeping
our promises". It consumes a *merged* metrics snapshot (obs/export.py
``merge_metrics`` over every fleet member's registry — or a single
process's snapshot, same schema) plus optionally the router's stats dict,
and computes:

- **deadline attainment** — the fraction of finished requests that met
  their deadline: completions over completions + deadline sheds. The serve
  plane's contract is that an expired request is *shed, never executed
  late* (serve/batcher.py), so a deadline miss is precisely a
  ``serve.shed_deadline`` increment — attainment falls out of counters,
  no per-request log needed.
- **error-budget burn rate** — ``(1 - attainment) / (1 - target)``: burn
  1.0 spends the budget exactly at its allowance; burn 2.0 exhausts a
  30-day budget in 15 days. The standard multi-window alert input.
- **p99 latency** (bucket-resolution, from the merged
  ``serve.latency_seconds`` histogram) vs an optional target,
- **shed-by-reason rates**, **breaker open-time**, **hedge win rate** —
  the fleet-health signals the router records per replica, aggregated.

Threshold callbacks: ``monitor.on_breach(fn)`` fires ``fn(report,
breaches)`` whenever an ``evaluate()`` crosses a threshold — the hook a
pager/autoscaler attaches to. The monitor is deliberately pull-based
(evaluate on each telemetry collection); it owns no thread. A breach also
triggers the flight recorder (``obs/blackbox.py``; throttled, a no-op
unless the recorder is armed).
"""
from __future__ import annotations

from typing import Callable, List, Optional

from .export import hist_quantile

__all__ = ["SLOMonitor"]

_SHED_REASONS = ("deadline", "queue_full", "draining")


class SLOMonitor:
    """Compute SLO attainment / burn / tail-latency from a metrics
    snapshot and fire callbacks on threshold breaches.

    Parameters
    ----------
    deadline_target : float
        The SLO: fraction of requests that must meet their deadline
        (default 0.99 — "three nines of four" is a different monitor).
    p99_target_ms : float, optional
        Alert threshold on the merged p99 latency.
    burn_alert : float
        Breach when the error-budget burn rate exceeds this (default 2.0:
        the budget is being spent at twice its sustainable pace).
    breaker_open_alert_s : float, optional
        Breach when cumulative breaker open-time exceeds this.
    latency_metric : str
        Histogram name carrying end-to-end latency
        (default ``serve.latency_seconds``).
    """

    def __init__(self, deadline_target: float = 0.99,
                 p99_target_ms: Optional[float] = None,
                 burn_alert: float = 2.0,
                 breaker_open_alert_s: Optional[float] = None,
                 latency_metric: str = "serve.latency_seconds"):
        if not 0.0 < deadline_target < 1.0:
            raise ValueError("deadline_target must be in (0, 1)")
        self.deadline_target = float(deadline_target)
        self.p99_target_ms = p99_target_ms
        self.burn_alert = float(burn_alert)
        self.breaker_open_alert_s = breaker_open_alert_s
        self.latency_metric = latency_metric
        self._callbacks: List[Callable] = []
        self.last_report: Optional[dict] = None

    def on_breach(self, fn: Callable) -> "SLOMonitor":
        """Register ``fn(report, breaches)``; returns self for chaining."""
        self._callbacks.append(fn)
        return self

    # ------------------------------------------------------------------
    def evaluate(self, snapshot: dict, stats: Optional[dict] = None) -> dict:
        """One pass over a (merged) metrics snapshot → the SLO report.
        ``stats`` is the router/fleet stats dict when available (breaker
        open-time lives there too; the metrics gauge is used otherwise)."""
        counters = snapshot.get("counters") or {}
        hists = snapshot.get("histograms") or {}

        # prefer the ROUTER's per-request histogram when a fleet is in the
        # snapshot: replica-side serve.latency_seconds counts executions,
        # which hedging duplicates (the discarded loser still observed) —
        # attainment must be over requests, not executions. The miss
        # counter pairs with whichever source is used.
        fleet_lat = hists.get("fleet.request_latency_seconds")
        if fleet_lat is not None:
            lat = fleet_lat
            misses = counters.get("fleet.request_deadline_exceeded", 0)
        else:
            lat = hists.get(self.latency_metric)
            misses = counters.get("serve.shed_deadline", 0)
        completed = lat.get("count", 0) if lat else 0
        sheds = {r: counters.get(f"serve.shed_{r}", 0)
                 for r in _SHED_REASONS}
        shed_total = sum(sheds.values())
        finished = completed + shed_total
        # attainment over requests that HAD a deadline verdict (completed
        # or deadline-shed): queue_full/draining rejections are capacity
        # failures, tracked by shed_rate — folding them into this
        # denominator would DILUTE misses and keep the pager silent
        # exactly when the fleet is saturated
        denom = completed + misses
        attainment = 1.0 - (misses / denom) if denom else 1.0
        budget = 1.0 - self.deadline_target
        burn = ((1.0 - attainment) / budget) if budget else 0.0

        p99_s = hist_quantile(lat, 0.99) if lat else 0.0
        p50_s = hist_quantile(lat, 0.50) if lat else 0.0

        hedges = counters.get("fleet.hedges", 0)
        hedge_wins = counters.get("fleet.hedge_wins", 0)
        gauges = snapshot.get("gauges") or {}
        if stats and "breaker_open_seconds" in stats:
            breaker_open = float(stats["breaker_open_seconds"])
        else:
            breaker_open = float(
                gauges.get("fleet.breaker_open_seconds", 0.0))
        # a total outage makes NO latency observations and NO sheds —
        # attainment alone would read 1.0 while every client errors; the
        # ready-replica count and hard-error counters close that blind
        # spot (None when the snapshot carries no fleet at all)
        if stats and "ready_replicas" in stats:
            ready_replicas = int(stats["ready_replicas"])
        elif "fleet.ready_replicas" in gauges:
            ready_replicas = int(gauges["fleet.ready_replicas"])
        else:
            ready_replicas = None
        execute_errors = counters.get("serve.execute_errors", 0)

        report = {
            "requests_finished": finished,
            "completed": completed,
            "deadline_misses": misses,
            "deadline_attainment": round(attainment, 6),
            "deadline_target": self.deadline_target,
            "error_budget_burn": round(burn, 4),
            "p50_latency_ms": round(p50_s * 1e3, 3),
            "p99_latency_ms": round(p99_s * 1e3, 3),
            "shed_by_reason": sheds,
            "shed_rate": round(shed_total / finished, 6) if finished else 0.0,
            "breaker_trips": counters.get("fleet.breaker_trips", 0),
            "breaker_open_seconds": round(breaker_open, 3),
            "ready_replicas": ready_replicas,
            "execute_errors": execute_errors,
            "failovers": counters.get("fleet.failovers", 0),
            "hedges": hedges,
            "hedge_win_rate": round(hedge_wins / hedges, 4) if hedges
            else None,
            "stale_version_rejected":
                counters.get("fleet.stale_version_rejected", 0),
        }

        breaches = []
        if ready_replicas == 0:
            breaches.append({
                "rule": "no_ready_replicas",
                "value": 0, "threshold": 1,
                "detail": "0 ready replicas — total outage (no latency/"
                          "shed signal will be produced; attainment is "
                          "meaningless until capacity returns)"})
        if finished and attainment < self.deadline_target:
            breaches.append({
                "rule": "deadline_attainment",
                "value": attainment, "threshold": self.deadline_target,
                "detail": f"attainment {attainment:.4f} < target "
                          f"{self.deadline_target}"})
        if finished and burn > self.burn_alert:
            breaches.append({
                "rule": "error_budget_burn",
                "value": burn, "threshold": self.burn_alert,
                "detail": f"burn {burn:.2f}x > alert {self.burn_alert}x"})
        if (self.p99_target_ms is not None and lat
                and p99_s * 1e3 > self.p99_target_ms):
            breaches.append({
                "rule": "p99_latency",
                "value": p99_s * 1e3, "threshold": self.p99_target_ms,
                "detail": f"p99 {p99_s * 1e3:.1f}ms > "
                          f"{self.p99_target_ms}ms"})
        if (self.breaker_open_alert_s is not None
                and breaker_open > self.breaker_open_alert_s):
            breaches.append({
                "rule": "breaker_open_time",
                "value": breaker_open,
                "threshold": self.breaker_open_alert_s,
                "detail": f"breakers open {breaker_open:.1f}s > "
                          f"{self.breaker_open_alert_s}s"})
        report["breaches"] = breaches
        report["ok"] = not breaches
        self.last_report = report

        if breaches:
            try:  # a breach is a flight-recorder moment: capture the
                # last seconds while they are still in the ring
                from . import blackbox

                blackbox.trigger(
                    "slo_breach:" + ",".join(b["rule"] for b in breaches))
            except Exception:  # noqa: BLE001 — telemetry must not fail SLO
                pass
            for fn in self._callbacks:
                try:
                    fn(report, breaches)
                except Exception:  # noqa: BLE001 — a pager hook must never
                    pass           # take down the telemetry plane
        return report

    # ------------------------------------------------------------------
    def burn_window(self, prev: Optional[dict], cur: dict) -> dict:
        """Error-budget burn over the WINDOW between two metrics snapshots
        (counter deltas) — the autoscaler's signal (serve/autoscale.py).
        Cumulative burn never cools down after an incident, so a scaler
        fed :meth:`evaluate` would keep scaling out forever; a window
        recovers the moment the fleet does. Source priority matches
        ``evaluate``: the router's per-request histogram when present
        (hedging duplicates replica-side executions), the replica
        latency histogram otherwise. ``prev=None`` means "since boot"."""
        def _c(s, name):
            return ((s or {}).get("counters") or {}).get(name, 0)

        def _h(s, name):
            h = ((s or {}).get("histograms") or {}).get(name)
            return h.get("count", 0) if h else 0

        fleet_n = _h(cur, "fleet.request_latency_seconds")
        if fleet_n or _h(prev, "fleet.request_latency_seconds"):
            completed = fleet_n - _h(prev, "fleet.request_latency_seconds")
            misses = (_c(cur, "fleet.request_deadline_exceeded")
                      - _c(prev, "fleet.request_deadline_exceeded"))
        else:
            completed = (_h(cur, self.latency_metric)
                         - _h(prev, self.latency_metric))
            misses = (_c(cur, "serve.shed_deadline")
                      - _c(prev, "serve.shed_deadline"))
        completed = max(completed, 0)
        misses = max(misses, 0)
        denom = completed + misses
        attainment = 1.0 - (misses / denom) if denom else 1.0
        budget = 1.0 - self.deadline_target
        burn = ((1.0 - attainment) / budget) if budget else 0.0
        return {"completed": completed, "misses": misses,
                "attainment": round(attainment, 6),
                "burn": round(burn, 4)}

    # ------------------------------------------------------------------
    @staticmethod
    def render(report: dict) -> str:
        """The report as a terminal table."""
        lines = ["SLO report:"]
        order = ("requests_finished", "completed", "deadline_misses",
                 "deadline_attainment", "deadline_target",
                 "error_budget_burn", "p50_latency_ms", "p99_latency_ms",
                 "shed_rate", "breaker_trips", "breaker_open_seconds",
                 "ready_replicas", "execute_errors",
                 "failovers", "hedges", "hedge_win_rate",
                 "stale_version_rejected")
        for k in order:
            v = report.get(k)
            if v is None:
                continue
            lines.append(f"  {k:<26}{v}")
        for r, n in (report.get("shed_by_reason") or {}).items():
            lines.append(f"  {'shed[' + r + ']':<26}{n}")
        if report.get("breaches"):
            lines.append("  BREACHES:")
            for b in report["breaches"]:
                lines.append(f"    ! {b['detail']}")
        else:
            lines.append("  all SLO thresholds met")
        return "\n".join(lines)
