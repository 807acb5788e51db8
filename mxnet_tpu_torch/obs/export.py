"""Fleet telemetry export — Prometheus text exposition + multi-process
trace merging (counterpart of ``mxnet_tpu/obs/export.py``; the same text,
byte for byte, from the same snapshots).

Two consumers, two formats, one source (the per-process telemetry *part*
produced by ``obs.telemetry_part()`` and pulled over ``OP_TELEMETRY``):

- :func:`to_prometheus` / :func:`render_prometheus` — the metrics registry
  snapshot as Prometheus text exposition (version 0.0.4): counters get a
  ``_total`` suffix, histograms unroll into cumulative ``_bucket{le=...}``
  series plus ``_sum``/``_count``. Every described family (the
  ``obs.metrics.describe``/``description`` registry) ships a ``# HELP``
  line before its ``# TYPE``. Labels (``pid``/``role``) distinguish
  fleet members, so one scrape of the FleetServer front covers every
  replica. HTTP-free by design: the text rides the existing STATS/
  TELEMETRY wire opcodes or lands in a file — point a node_exporter
  textfile collector or a pushgateway at it, no web server in-process.
  Latency-histogram buckets additionally carry **OpenMetrics exemplars**
  when the tail-retention plane supplies them (``obs/tail.py``): the
  trace_id of the most recent *retained* trace that landed in a bucket
  rides as ``# {trace_id="..."} value ts`` — a p99 bucket links straight
  to a kept tail trace. Exemplars are OpenMetrics-only syntax (a mid-line
  ``#`` is a whole-scrape parse error to a strict 0.0.4 parser): pass
  ``openmetrics=False`` for exemplar-free 0.0.4 output when the file
  feeds a node_exporter textfile collector or a pushgateway.
- :func:`merge_chrome_parts` — N parts (client, router front, replicas,
  plus JSONL evidence files of SIGKILLed processes) onto ONE chrome trace
  with a lane per pid. Each tracer's timestamps are relative to its own
  monotonic epoch; the part's ``wall_epoch`` (unix time of that epoch,
  captured at the same instant) rebases them onto shared unix time. On one
  host the wall clocks agree to well under a millisecond; across hosts the
  skew is NTP-bounded — callers surface the note, we record the anchors.

:func:`merge_metrics` folds many registry snapshots into one (counters and
histogram buckets sum, gauges sum — queue depths and ready-counts add
across replicas) for fleet-level SLO math (obs/slo.py).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["to_prometheus", "render_prometheus", "merge_metrics",
           "merge_chrome_parts", "hist_quantile"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_VAL_RE = re.compile(r"([\\\n\"])")


def _metric_name(name: str, prefix: str = "mxnet") -> str:
    """``serve.latency_seconds`` → ``mxnet_serve_latency_seconds``."""
    n = _NAME_RE.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return f"{prefix}_{n}" if prefix else n


def _labels_str(labels: Optional[dict], extra: Optional[dict] = None) -> str:
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{_LABEL_VAL_RE.sub(lambda m: chr(92) + m.group(1), str(v))}"'
        for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _fmt(v) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _help_escape(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _exemplar_suffix(ex: Optional[dict]) -> str:
    """OpenMetrics exemplar: ``# {trace_id="..."} value ts`` appended to a
    bucket line. Empty string when no exemplar landed in the bucket."""
    if not ex or not ex.get("trace_id"):
        return ""
    out = f' # {{trace_id="{ex["trace_id"]}"}} {_fmt(float(ex.get("value", 0.0)))}'
    if ex.get("ts") is not None:
        out += f" {_fmt(round(float(ex['ts']), 3))}"
    return out


def _rebucket_exemplars(ex: Optional[dict], bounds: Sequence[float]) -> dict:
    """Re-key exemplars onto the RENDERED bucket ladder. A histogram
    snapshot omits empty buckets, and the exemplar's stamped bucket is
    often exactly such a bucket (a shed/deadline verdict retains the
    trace without observing its latency into the histogram) — so an
    exemplar keyed to an unrendered bound attaches to the first rendered
    bucket that still contains its value (``value <= le``, which is all
    OpenMetrics requires). Values past every rendered bound land on
    ``+Inf``; ties within a bucket keep the most recent stamp."""
    if not ex:
        return {}
    entries = []
    for e in ex.values():
        try:
            entries.append((float(e.get("value", 0.0)), e))
        except (TypeError, ValueError):
            continue
    entries.sort(key=lambda t: t[0])
    out: dict = {}
    idx = 0
    for b in bounds:
        best = None
        while idx < len(entries) and entries[idx][0] <= b:
            cand = entries[idx][1]
            if best is None or (cand.get("ts") or 0) >= (best.get("ts") or 0):
                best = cand
            idx += 1
        if best is not None:
            out[repr(b)] = best
    best = None
    for _, e in entries[idx:]:
        if best is None or (e.get("ts") or 0) >= (best.get("ts") or 0):
            best = e
    if best is not None:
        out["+Inf"] = best
    return out


def render_prometheus(labeled_snapshots: Sequence[tuple],
                      prefix: str = "mxnet",
                      openmetrics: bool = True) -> str:
    """Render N ``(labels, registry_snapshot[, exemplars])`` tuples as one
    exposition. ``# TYPE`` (and, for described families, ``# HELP``)
    headers are emitted once per metric family even when many fleet
    members report the same names (the format forbids repeats).
    ``exemplars`` is the ``obs.tail.exemplars_snapshot()`` schema —
    ``{histogram_name: {le_repr: {"trace_id", "value", "ts"}}}``.

    ``openmetrics=True`` (default) emits OpenMetrics: exemplar suffixes
    on bucket lines plus the required ``# EOF`` terminator. Exemplars are
    a mid-line ``#``, which classic text format 0.0.4 rejects as a parse
    error for the WHOLE scrape — pass ``openmetrics=False`` for strict
    0.0.4 output (no exemplars, no EOF) when the file feeds a
    node_exporter textfile collector or a pushgateway."""
    # family → (type, orig_name, [(labels, payload, exemplars), ...]);
    # insertion-ordered so the output is stable across collections
    families: Dict[str, tuple] = {}

    def add(name, mtype, labels, payload, ex=None):
        fam = _metric_name(name, prefix)
        ent = families.get(fam)
        if ent is None:
            ent = families[fam] = (mtype, name, [])
        ent[2].append((labels, payload, ex))

    for entry in labeled_snapshots:
        labels, snap = entry[0], entry[1]
        exemplars = entry[2] if len(entry) > 2 else None
        for name, v in (snap.get("counters") or {}).items():
            add(name, "counter", labels, v)
        for name, v in (snap.get("gauges") or {}).items():
            add(name, "gauge", labels, v)
        for name, h in (snap.get("histograms") or {}).items():
            add(name, "histogram", labels, h,
                (exemplars or {}).get(name) if openmetrics else None)

    try:
        from .metrics import description as _description
    except ImportError:  # pragma: no cover — parser-only environments
        def _description(_name):
            return None

    lines: List[str] = []
    for fam in sorted(families):
        mtype, orig_name, series = families[fam]
        help_text = _description(orig_name)
        if help_text:
            lines.append(f"# HELP {fam} {_help_escape(help_text)}")
        lines.append(f"# TYPE {fam} {mtype}")
        for labels, payload, ex in series:
            if mtype == "counter":
                lines.append(f"{fam}_total{_labels_str(labels)} "
                             f"{_fmt(payload)}")
            elif mtype == "gauge":
                lines.append(f"{fam}{_labels_str(labels)} {_fmt(payload)}")
            else:  # histogram: cumulative le-buckets + _sum + _count
                buckets = payload.get("buckets") or {}
                bounds = sorted(
                    (float(k) for k in buckets if k != "+Inf"))
                ex_by_le = _rebucket_exemplars(ex, bounds)
                running = 0
                for b in bounds:
                    running += buckets.get(repr(b), buckets.get(str(b), 0))
                    lines.append(
                        f"{fam}_bucket{_labels_str(labels, {'le': _fmt(b)})}"
                        f" {running}{_exemplar_suffix(ex_by_le.get(repr(b)))}")
                lines.append(
                    f"{fam}_bucket{_labels_str(labels, {'le': '+Inf'})}"
                    f" {payload.get('count', running)}"
                    f"{_exemplar_suffix(ex_by_le.get('+Inf'))}")
                lines.append(f"{fam}_sum{_labels_str(labels)} "
                             f"{_fmt(float(payload.get('sum', 0.0)))}")
                lines.append(f"{fam}_count{_labels_str(labels)} "
                             f"{payload.get('count', 0)}")
    if lines and openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + ("\n" if lines else "")


def to_prometheus(snapshot: dict, labels: Optional[dict] = None,
                  prefix: str = "mxnet",
                  exemplars: Optional[dict] = None,
                  openmetrics: bool = True) -> str:
    """One registry snapshot (``obs.metrics.snapshot()``) as Prometheus
    text exposition. ``exemplars`` (``obs.tail.exemplars_snapshot()``)
    pins retained-trace ids to latency buckets (OpenMetrics only — see
    :func:`render_prometheus`)."""
    return render_prometheus([(labels, snapshot, exemplars)], prefix=prefix,
                             openmetrics=openmetrics)


def parts_to_prometheus(parts: Sequence[dict], prefix: str = "mxnet",
                        openmetrics: bool = True) -> str:
    """Telemetry parts (``obs.telemetry_part()`` schema) → one exposition,
    each part labeled by pid (+role when present). A part's ``exemplars``
    (tail mode) ride onto its histogram bucket lines (OpenMetrics only —
    see :func:`render_prometheus`)."""
    labeled = []
    seen = set()
    for p in parts:
        pid = p.get("pid", "?")
        if pid in seen:
            continue  # same process, same registry (see merge_chrome_parts)
        seen.add(pid)
        labels = {"pid": str(pid)}
        if p.get("role"):
            labels["role"] = str(p["role"])
        labeled.append((labels, p.get("metrics") or {}, p.get("exemplars")))
    return render_prometheus(labeled, prefix=prefix, openmetrics=openmetrics)


# ---------------------------------------------------------------------------
# metrics merging (fleet-level SLO math)
# ---------------------------------------------------------------------------

def hist_quantile(hist: dict, q: float) -> float:
    """Bucket-resolution quantile of a histogram *snapshot* (the registry's
    schema: ``{"count", "sum", "min", "max", "buckets": {bound: n}}``) —
    the registry's own estimator, reimplemented over serialized data so it
    works on merged fleet snapshots."""
    count = hist.get("count", 0)
    if not count:
        return 0.0
    buckets = hist.get("buckets") or {}
    bounds = sorted((float(k) for k in buckets if k != "+Inf"))
    target = q * count
    running = 0
    for b in bounds:
        running += buckets.get(repr(b), buckets.get(str(b), 0))
        if running >= target:
            return b
    return float(hist.get("max", bounds[-1] if bounds else 0.0))


def merge_metrics(snapshots: Sequence[dict]) -> dict:
    """Fold registry snapshots from many processes into one: counters and
    histogram buckets/counts/sums add; gauges add too (queue depths, ready
    counts, and breaker open-times are extensive across replicas —
    last-write semantics would silently drop all but one member)."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue  # a torn JSONL tail can surface as a non-dict record
        for name, v in (snap.get("counters") or {}).items():
            out["counters"][name] = out["counters"].get(name, 0) + v
        for name, v in (snap.get("gauges") or {}).items():
            out["gauges"][name] = out["gauges"].get(name, 0.0) + v
        for name, h in (snap.get("histograms") or {}).items():
            m = out["histograms"].get(name)
            if m is None:
                m = out["histograms"][name] = {
                    "count": 0, "sum": 0.0, "min": math.inf,
                    "max": -math.inf, "buckets": {}}
            m["count"] += h.get("count", 0)
            m["sum"] += h.get("sum", 0.0)
            if h.get("count", 0):
                m["min"] = min(m["min"], h.get("min", math.inf))
                m["max"] = max(m["max"], h.get("max", -math.inf))
            for k, n in (h.get("buckets") or {}).items():
                m["buckets"][k] = m["buckets"].get(k, 0) + n
    for h in out["histograms"].values():
        if not h["count"]:
            h["min"] = h["max"] = 0.0
        h["avg"] = (h["sum"] / h["count"]) if h["count"] else 0.0
        h["p50"] = hist_quantile(h, 0.5)
        h["p99"] = hist_quantile(h, 0.99)
    # keep the snapshot schema stable (sorted names, like the registry's)
    for k in out:
        out[k] = dict(sorted(out[k].items()))
    return out


# ---------------------------------------------------------------------------
# trace merging (one timeline, a lane per pid)
# ---------------------------------------------------------------------------

def merge_chrome_parts(parts: Sequence[dict],
                       metrics: Optional[dict] = None) -> dict:
    """N telemetry parts → one chrome-trace document. Every part gets its
    own pid lane (process_name = its role, or ``pid N``); events are
    rebased onto a shared origin via each part's ``wall_epoch`` anchor.
    Parts with no anchor (a pre-context JSONL, say) sit at the shared
    origin and the caller should surface the clock-skew caveat."""
    anchors = [p["wall_epoch"] for p in parts
               if isinstance(p, dict) and p.get("wall_epoch") is not None]
    base = min(anchors) if anchors else 0.0
    trace_events: List[dict] = []
    merged_metrics = []
    metric_pids = set()
    skipped = 0  # torn/garbled records (a SIGKILL'd stream's final line)
    for p in parts:
        if not isinstance(p, dict):
            skipped += 1
            continue
        pid = p.get("pid", 0)
        off = ((p["wall_epoch"] - base)
               if p.get("wall_epoch") is not None else 0.0)
        name = p.get("role") or f"pid {pid}"
        trace_events.append({"name": "process_name", "ph": "M", "pid": pid,
                             "tid": 0, "args": {"name": str(name)}})
        tids = {}
        for ev in p.get("spans") or ():
            if not isinstance(ev, dict):
                skipped += 1  # torn final record — skip, never raise
                continue
            ph = ev.get("ph", "X")
            if ph not in ("X", "i", "C"):
                continue  # clock/metrics metadata records
            tid = ev.get("tid", 0)
            tids.setdefault(tid, len(tids))
            out = {"name": ev.get("name", "?"), "ph": ph, "pid": pid,
                   "tid": tid, "ts": (ev.get("ts", 0.0) + off) * 1e6}
            if ph == "X":
                out["dur"] = (ev.get("dur") or 0.0) * 1e6
            elif ph == "i":
                out["s"] = "t"
            # "C" counter samples (device.live_bytes lane) carry args only
            if ev.get("args"):
                out["args"] = dict(ev["args"])
            trace_events.append(out)
        for tid, idx in tids.items():
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"thread-{idx}" if idx else "main"}})
        # one registry per PROCESS: parts sharing a pid (an in-process
        # LocalReplica fleet) snapshot the same registry — merging each
        # copy would multiply every count
        if p.get("metrics") and pid not in metric_pids:
            metric_pids.add(pid)
            merged_metrics.append(p["metrics"])
    other = {"merged_from": [
        {"pid": p.get("pid"), "role": p.get("role"),
         "wall_epoch": p.get("wall_epoch")}
        for p in parts if isinstance(p, dict)]}
    other["metrics"] = metrics if metrics is not None \
        else merge_metrics(merged_metrics)
    if skipped:
        other["skipped_records"] = skipped
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": other}
