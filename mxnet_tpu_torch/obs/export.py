"""Fleet metrics merging (the part of ``mxnet_tpu/obs/export.py`` that
the SLO monitor needs): :func:`hist_quantile` reads a quantile off a
histogram snapshot, and :func:`merge_metrics` folds many registry
snapshots into one (counters and histogram buckets add; gauges add too,
since queue depths and ready counts are extensive across replicas).

The chrome-trace merge and the Prometheus exposition of the reference's
module belong to the span plane, queue item A15 of the port.
"""
from __future__ import annotations

import math
from typing import Sequence

__all__ = ["hist_quantile", "merge_metrics"]


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
