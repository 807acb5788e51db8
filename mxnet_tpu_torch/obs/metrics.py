"""Metrics registry — named counters, gauges and fixed-bucket histograms
(counterpart of ``mxnet_tpu/obs/metrics.py``).

Every numeric runtime signal lands in ONE process-global registry so that a
single ``snapshot()`` / ``dump()`` shows them side by side. The serving
fleet writes its ``fleet.*`` counters, gauges and histograms here, and the
autoscaler reads its windowed error-budget burn from two snapshots
(``obs/slo.py`` ``SLOMonitor.burn_window``).

Design notes:

- **Names, not label sets.** Metrics are keyed by a flat dotted name
  (``fleet.rpc.replica0_seconds``); callers bake the one discriminating
  dimension into the name, so ``observe()`` is one dict lookup and one
  lock.
- **Fixed buckets.** Histograms use preset upper bounds (a Prometheus-style
  latency ladder by default), so ``observe()`` is a bisect and snapshots
  are stable across runs. The snapshot schema is the reference's, down to
  the bucket keys (``repr(bound)`` and ``"+Inf"``).
- **Thread-safe.** Every mutation takes the metric's own lock.

The registry always exists and always works; the ``obs`` switch only gates
whether instrumentation call sites feed it (``obs/__init__.py``).
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "registry", "counter", "gauge", "histogram",
           "snapshot", "dump", "reset", "remove", "describe", "description"]

# Prometheus-style latency ladder (seconds). Fine enough to separate a
# sub-ms fused dispatch from a 100ms RPC retry from a multi-second compile.
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Counter:
    """Monotonically increasing integer (retries, bytes, retraces)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self):
        return self._value

    def __repr__(self):
        return f"Counter({self.name}={self._value})"


class Gauge:
    """Last-write-wins float (queue depth, samples/sec, loss scale)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self):
        return self._value

    def __repr__(self):
        return f"Gauge({self.name}={self._value})"


class Histogram:
    """Fixed-bucket distribution (latencies, sizes).

    ``buckets`` are ascending upper bounds; an implicit +Inf bucket catches
    the overflow. ``quantile(q)`` gives a bucket-resolution estimate (good
    enough for a p50/p99 column in a report, not for SLO math).
    """

    __slots__ = ("name", "buckets", "_counts", "_count", "_sum", "_min",
                 "_max", "_lock")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile (0 < q <= 1)."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            target = q * total
            running = 0
            for i, c in enumerate(self._counts):
                running += c
                if running >= target:
                    return (self.buckets[i] if i < len(self.buckets)
                            else self._max)
            return self._max

    def snapshot(self) -> dict:
        with self._lock:
            count = self._count
            s = {"count": count, "sum": self._sum,
                 "min": self._min if count else 0.0,
                 "max": self._max if count else 0.0,
                 "avg": (self._sum / count) if count else 0.0,
                 "buckets": {("+Inf" if i == len(self.buckets)
                              else repr(self.buckets[i])): c
                             for i, c in enumerate(self._counts) if c}}
        s["p50"] = self.quantile(0.5)
        s["p99"] = self.quantile(0.99)
        return s

    def __repr__(self):
        return f"Histogram({self.name} count={self._count})"


class MetricsRegistry:
    """Process-global name → metric map with typed accessors.

    Accessors get-or-create: ``registry.counter("a.b").inc()`` is the whole
    instrumentation idiom. Requesting an existing name as a different type
    raises — silent type drift is how dashboards lie.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """Deep, stable snapshot: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}``, names sorted. Safe to mutate or serialize."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def dump(self, fmt: str = "text") -> str:
        """Human table (fmt="text") or machine JSON (fmt="json")."""
        snap = self.snapshot()
        if fmt == "json":
            return json.dumps(snap, indent=2, default=float)
        if fmt != "text":
            raise ValueError(f"fmt must be 'text'|'json', got {fmt!r}")
        lines = []
        if snap["counters"]:
            lines.append(f"{'Counter':<44}{'Value':>14}")
            for n, v in snap["counters"].items():
                lines.append(f"{n:<44}{v:>14}")
        if snap["gauges"]:
            if lines:
                lines.append("")
            lines.append(f"{'Gauge':<44}{'Value':>14}")
            for n, v in snap["gauges"].items():
                lines.append(f"{n:<44}{v:>14.6g}")
        if snap["histograms"]:
            if lines:
                lines.append("")
            lines.append(f"{'Histogram':<44}{'Count':>8}{'Avg':>12}"
                         f"{'P50':>12}{'P99':>12}{'Max':>12}")
            for n, h in snap["histograms"].items():
                lines.append(f"{n:<44}{h['count']:>8}{h['avg']:>12.6g}"
                             f"{h['p50']:>12.6g}{h['p99']:>12.6g}"
                             f"{h['max']:>12.6g}")
        return "\n".join(lines) if lines else "(no metrics)"

    def remove(self, name: str) -> None:
        """Drop one metric by name (no-op when absent). The elastic serve
        plane uses this on scale-in: a removed replica's per-replica gauges
        (``fleet.replica<i>.*``) would otherwise sit in the Prometheus
        exposition forever as frozen last values."""
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self) -> None:
        """Drop every metric (tests; a fresh run's registry is empty)."""
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# metric descriptions — the `# HELP` text of the Prometheus exposition
# ---------------------------------------------------------------------------
#
# Exact names first; dynamic families (``kvstore.rpc.<op>_seconds``) match
# by longest prefix. ``obs/export.py`` looks descriptions up per family
# when rendering, so a described metric ships its HELP line with every
# exposition and an undescribed one renders exactly as before.

_DESCRIPTIONS: Dict[str, str] = {
    # serve plane
    "serve.latency_seconds": "end-to-end INFER latency per executed request",
    "serve.queue_depth": "dynamic-batcher queue depth at last submit",
    "serve.batch_occupancy": "rows filled / bucket capacity of the last batch",
    "serve.requests": "INFER requests accepted by the batcher",
    "serve.shed_queue_full": "requests shed at the queue watermark",
    "serve.shed_deadline": "requests shed because their deadline passed",
    "serve.shed_draining": "requests shed during draining shutdown",
    "serve.reloads": "hot reloads committed by the serving engine",
    "serve.telemetry_errors": "OP_TELEMETRY handler failures",
    "serve.dump_errors": "OP_DUMP flight-recorder handler failures",
    "serve.batcher_thread_leaked": "batcher threads alive past close()",
    "serve.handler_threads_leaked": "connection handlers alive past stop()",
    # fleet plane
    "fleet.request_latency_seconds":
        "per-REQUEST latency at the router (hedges collapse to one)",
    "fleet.request_deadline_exceeded":
        "requests whose deadline passed before a reply",
    "fleet.requests": "requests routed by the fleet router",
    "fleet.failovers": "requests retried on another replica after a failure",
    "fleet.hedges": "tail-latency hedge duplicates launched",
    "fleet.hedge_wins": "hedged duplicates that answered first",
    "fleet.breaker_trips": "circuit-breaker open transitions",
    "fleet.breaker_open_seconds":
        "cumulative seconds any replica breaker spent not closed",
    "fleet.replicas_ready": "replicas passing readiness at last probe",
    "fleet.replicas_total": "replicas supervised by the pool",
    "fleet.generation": "fleet membership generation (bumps on every change)",
    "fleet.stale_version_rejected":
        "replies rejected for a stale engine version mid-reload",
    # kvstore / PS plane
    "kvstore.rpc.retries": "PS client RPC attempts after the first",
    "kvstore.rpc.failures": "PS client RPCs that exhausted the retry budget",
    "kvstore.bytes_pushed": "client payload bytes pushed to the PS",
    "kvstore.bytes_pulled": "client payload bytes pulled from the PS",
    "kvstore.server.bytes_received": "PS-server inbound payload bytes",
    "kvstore.server.threads_leaked": "PS handler threads alive past stop()",
    "kvstore.barrier_timeout": "barriers that timed out naming absent ranks",
    # health plane
    "health.loss": "sampled training loss (also a chrome counter track)",
    "health.loss_ewma": "EWMA of the sampled training loss",
    "health.grad_norm": "global gradient norm at the last sampled step",
    "health.update_ratio_max":
        "worst update-to-weight ratio across parameters",
    "health.nonfinite_grads":
        "non-finite gradient elements at the last sample",
    "health.nonfinite_total": "cumulative non-finite gradient elements",
    "health.scaler.skip_streak":
        "consecutive AMP-scaler skipped steps (the silent skip-loop signal)",
    "health.samples": "sentinel evaluations run",
    "health.rollbacks": "automatic checkpoint rollbacks taken",
    "health.lr_backoffs": "automatic learning-rate backoffs taken",
    "health.nan_provenance": "NaN blame passes run",
    # training-fleet telemetry plane (obs/fleetstats.py)
    "train.step.seconds": "per-rank optimizer-step wall time",
    "train.straggler.verdicts":
        "straggler verdicts fired by the fleet detector",
    "train.straggler.recoveries":
        "flagged ranks cleared after sustained recovery",
    "train.straggler.flagged": "ranks currently flagged as stragglers",
    "train.fleet.bad_parts":
        "piggybacked worker telemetry parts that failed to parse",
    "kvstore.generation": "PS membership generation (fleet view)",
    "kvstore.live_workers": "active workers at the last liveness sweep",
    "kvstore.server.push.apply_seconds":
        "optimizer-apply time per applied push (reduce-plane split)",
    "kvstore.server.push.wal_seconds":
        "WAL append+fsync time per applied push (reduce-plane split)",
    "kvstore.server.pull.serialize_seconds":
        "reply array encode+send time per pull (reduce-plane split)",
    "kvstore.telemetry_errors": "PS OP_TELEMETRY handler failures",
    "kvstore.stats_errors": "PS OP_STATS handler failures",
    # tail retention / profiler / flight recorder (the black-box plane)
    "tail.resolved":
        "pending traces promoted by a telemetry-plane verdict list",
    "tail.overflow": "pending traces evicted at the buffer cap",
    "blackbox.dumps": "flight-recorder bundles written",
    "blackbox.throttled": "automatic dumps suppressed by the cooldown",
}

# (prefix, help) families for dynamically named metrics — longest prefix
# wins so `kvstore.server.rpc.` beats `kvstore.rpc.` beats `kvstore.`
_FAMILY_DESCRIPTIONS = (
    ("train.step.", "per-rank step-phase durations (fleet accounting)"),
    ("train.straggler.rank",
     "1 while the named rank is flagged as a straggler"),
    ("kvstore.member", "per-member heartbeat age at the last liveness"
                       " sweep (removed when the member is pruned)"),
    ("kvstore.reduce_wait.",
     "per-rank wait at generation-scoped reduce release"),
    ("kvstore.reduce_last_arriver.",
     "rounds in which the named rank arrived last (what the fleet"
     " waited on)"),
    ("kvstore.barrier_wait.", "per-rank wait at barrier release"),
    ("kvstore.server.push.", "PS push service-time split (apply vs WAL)"),
    ("kvstore.server.pull.", "PS pull service-time split (serialize)"),
    ("kvstore.server.rpc.", "PS server-side service time per opcode"),
    ("kvstore.rpc.backoff", "per-retry backoff sleeps"),
    ("kvstore.rpc.", "PS client-side RPC latency per opcode"),
    ("serve.rpc.", "serve server-side service time per opcode"),
    ("serve.client.rpc", "serve client-side RPC latency"),
    ("serve.shed_", "requests shed, by reason"),
    ("fleet.replica", "per-replica supervisor view (queue depth, occupancy,"
                      " breaker state)"),
    ("health.breach.", "sentinel breaches per rule"),
    ("health.monitor.", "Monitor scalar stats routed through the health"
                        " plane"),
    ("tail.retained.", "tail-mode traces retained, by policy reason"),
    ("tail.dropped.", "tail-mode traces dropped, by policy reason"),
    ("dispatch.", "compiled-program executions, eager dispatches, and"
                  " host-device transfers"),
    ("device.", "XLA cost/memory accounting (docs/OBSERVABILITY.md"
                " 'Device plane')"),
    ("update.", "fused update engine compile/execute accounting"),
    ("io.prefetch.", "prefetching iterator queue telemetry"),
    ("checkpoint.", "checkpoint writer durations and backlog"),
    ("chaos.", "injected faults"),
    ("autoscale.", "SLO-driven autoscaler decisions"),
    ("tsan.", "runtime lock-order sanitizer findings"),
)


def describe(name: str, help_text: str, family: bool = False) -> None:
    """Register ``# HELP`` text for a metric name (or, with
    ``family=True``, a name prefix). Later registrations win."""
    global _FAMILY_DESCRIPTIONS
    if family:
        _FAMILY_DESCRIPTIONS = ((name, help_text),) + tuple(
            f for f in _FAMILY_DESCRIPTIONS if f[0] != name)
    else:
        _DESCRIPTIONS[name] = help_text


def description(name: str) -> Optional[str]:
    """The HELP text for a metric name: exact match first, then the
    longest matching family prefix; None when undescribed."""
    d = _DESCRIPTIONS.get(name)
    if d is not None:
        return d
    best = None
    for prefix, text in _FAMILY_DESCRIPTIONS:
        if name.startswith(prefix) and (best is None
                                        or len(prefix) > len(best[0])):
            best = (prefix, text)
    return best[1] if best else None


# the process-global default registry — module-level helpers delegate here
registry = MetricsRegistry()


def counter(name: str) -> Counter:
    return registry.counter(name)


def gauge(name: str) -> Gauge:
    return registry.gauge(name)


def histogram(name: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
    return registry.histogram(name, buckets)


def snapshot() -> dict:
    return registry.snapshot()


def dump(fmt: str = "text") -> str:
    return registry.dump(fmt)


def remove(name: str) -> None:
    registry.remove(name)


def reset() -> None:
    registry.reset()
