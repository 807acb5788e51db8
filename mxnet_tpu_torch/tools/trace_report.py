"""trace_report — terminal breakdown of one or MANY obs traces
(counterpart of the reference's ``tools/trace_report.py``).

Reads chrome-trace ``trace.json`` files (``mx.obs.export(...)`` /
``python -m mxnet_tpu_torch.tools.fleet_report``),
JSONL event streams (``MXNET_OBS_JSONL=...`` — including the per-replica
``replica-<pid>.jsonl`` evidence a SIGKILL'd fleet member leaves behind),
and/or **flight-recorder bundles** (``obs/blackbox.py`` —
``blackbox-<pid>-*.json``, detected by their ``{"blackbox": 1}`` marker;
their recent-event ring AND continuous-profiler samples join the timeline
as that pid's lane) and prints:

1. the per-phase time breakdown — every span name aggregated
   (count / total / mean / max / % of wall), step phases first;
2. the top-N individual spans by duration (where did the spikes go);
3. counter tracks (``"C"`` events — the ``device.live_bytes`` memory
   lane) and the top-N-programs-by-device-cost table from the
   ``device.compile`` events the compile choke points emit;
4. tagged instant events (chaos injections, RPC retries, preemptions);
5. the metrics table (counters / gauges / histograms) embedded in the
   trace (`otherData.metrics` in chrome traces, the final ``"ph": "M"``
   record in JSONL streams).

With multiple inputs, events merge onto per-pid/tid lanes: each file's
clock anchor (the ``wall_epoch`` every tracer stamps into its stream /
export) rebases its events onto shared unix time. Files without an anchor
(pre-anchor captures) are pinned at the shared origin and the report
carries an explicit clock-skew note — cross-file ordering is then
approximate. ``--chrome-out merged.json`` writes the merged timeline as
one Perfetto-loadable chrome trace.

Usage::

    python -m mxnet_tpu_torch.tools.trace_report trace.json \
        [more.json replica-*.jsonl] [--top 10] [--json] \
        [--chrome-out merged.json]

It parses files and imports nothing of the framework but the metrics
merge (``obs/export.py``, itself pure Python), so it runs anywhere.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

# the canonical step phases (obs); shown first and in pipeline order so a
# fit's breakdown reads top to bottom
STEP_PHASES = ("data_wait", "forward", "backward", "update", "metric",
               "checkpoint")


def load_trace(path: str) -> Tuple[List[dict], List[dict], Optional[dict]]:
    """Parse chrome-trace JSON or a JSONL stream into (spans, instants,
    metrics). Spans/instants are normalized to seconds-based dicts:
    {"name", "ts", "dur", "tid", "pid", "args"}."""
    spans, instants, metrics, _ = load_trace_meta(path)
    return spans, instants, metrics


def _norm_seconds_event(ev: dict, spans: list, instants: list,
                        meta: dict) -> None:
    """File one seconds-based event dict (JSONL stream / blackbox bundle
    schema) into the spans / instants / counter-sample collections."""
    ph = ev.get("ph")
    if ph == "X":
        spans.append({"name": ev.get("name", "?"), "ts": ev.get("ts", 0.0),
                      "dur": ev.get("dur", 0.0) or 0.0,
                      "tid": ev.get("tid"),
                      "pid": ev.get("pid"),
                      "args": ev.get("args") or {}})
    elif ph == "i":
        instants.append({"name": ev.get("name", "?"),
                         "ts": ev.get("ts", 0.0),
                         "tid": ev.get("tid"),
                         "pid": ev.get("pid"),
                         "args": ev.get("args") or {}})
    elif ph == "C":
        args = ev.get("args") or {}
        meta["counters"].append({
            "name": ev.get("name", "?"), "ts": ev.get("ts", 0.0),
            "tid": ev.get("tid"), "pid": ev.get("pid"),
            "value": args.get("value", next(iter(args.values()), None))})


def load_trace_meta(path: str, text=None):
    """``load_trace`` plus the file's merge metadata: ``{"pid",
    "wall_epoch", "counters", "skipped_lines", "blackbox_reason"}``
    (pid/wall_epoch may be None on old captures; counters are ``"C"``
    counter-track samples — the ``device.live_bytes`` memory lane;
    skipped_lines counts torn/garbled JSONL records — a SIGKILL can end a
    stream mid-line, which must never make the corpse unreadable).
    ``text`` skips the file read when the caller already holds the
    content (fleet_report probes the same file for the bundle schema)."""
    if text is None:
        with open(path) as f:
            text = f.read()
    meta = {"pid": None, "wall_epoch": None, "counters": [],
            "skipped_lines": 0, "blackbox_reason": None}
    # chrome traces are one JSON document with "traceEvents"; JSONL lines
    # each start with "{" too, so try the whole-document parse first
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if isinstance(doc, dict) and doc.get("blackbox") == 1:
        # a flight-recorder bundle (obs/blackbox.py): the recent-event
        # ring plus the continuous profiler's sample lane, one pid
        spans, instants = [], []
        meta["pid"] = doc.get("pid")
        meta["wall_epoch"] = doc.get("wall_epoch")
        meta["blackbox_reason"] = doc.get("reason")
        events = [e for e in (doc.get("events") or ())
                  if isinstance(e, dict)]
        prof = doc.get("profiler") or {}
        events.extend(e for e in (prof.get("samples") or ())
                      if isinstance(e, dict))
        for ev in events:
            _norm_seconds_event(ev, spans, instants, meta)
        spans.sort(key=lambda e: e["ts"])
        instants.sort(key=lambda e: e["ts"])
        return spans, instants, doc.get("metrics"), meta
    if isinstance(doc, dict) and "traceEvents" in doc:
        spans, instants = [], []
        for ev in doc.get("traceEvents", []):
            ph = ev.get("ph")
            if ph == "X":
                spans.append({"name": ev["name"],
                              "ts": ev.get("ts", 0.0) / 1e6,
                              "dur": ev.get("dur", 0.0) / 1e6,
                              "tid": ev.get("tid"),
                              "pid": ev.get("pid"),
                              "args": ev.get("args") or {}})
            elif ph == "i":
                instants.append({"name": ev["name"],
                                 "ts": ev.get("ts", 0.0) / 1e6,
                                 "tid": ev.get("tid"),
                                 "pid": ev.get("pid"),
                                 "args": ev.get("args") or {}})
            elif ph == "C":
                args = ev.get("args") or {}
                meta["counters"].append({
                    "name": ev["name"], "ts": ev.get("ts", 0.0) / 1e6,
                    "tid": ev.get("tid"), "pid": ev.get("pid"),
                    "value": args.get("value",
                                      next(iter(args.values()), None))})
        other = doc.get("otherData") or {}
        meta["pid"] = other.get("pid")
        meta["wall_epoch"] = other.get("wall_epoch")
        return spans, instants, other.get("metrics"), meta
    # JSONL stream: one event per line, ts/dur already in seconds
    spans, instants, metrics = [], [], None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            # torn final line after a SIGKILL: skip it, COUNT it — the
            # report surfaces the count so a truncated corpse is visible
            # without ever being unreadable
            meta["skipped_lines"] += 1
            continue
        if not isinstance(ev, dict):
            meta["skipped_lines"] += 1
            continue
        ph = ev.get("ph")
        if ph == "M":
            if "metrics" in ev:
                metrics = ev["metrics"]
            if ev.get("name") == "clock":  # the stream's first record
                meta["pid"] = ev.get("pid", meta["pid"])
                meta["wall_epoch"] = ev.get("wall_epoch")
        else:
            _norm_seconds_event(ev, spans, instants, meta)
    return spans, instants, metrics, meta


def phase_breakdown(spans: List[dict]) -> List[dict]:
    """Aggregate spans by name: step phases first (pipeline order), then
    everything else by descending total time."""
    agg = {}
    for s in spans:
        ent = agg.setdefault(s["name"], {"name": s["name"], "count": 0,
                                         "total": 0.0, "max": 0.0})
        ent["count"] += 1
        ent["total"] += s["dur"]
        ent["max"] = max(ent["max"], s["dur"])
    wall = 0.0
    if spans:
        wall = (max(s["ts"] + s["dur"] for s in spans)
                - min(s["ts"] for s in spans))
    rows = []
    for name in STEP_PHASES:
        if name in agg:
            rows.append(agg.pop(name))
    rows.extend(sorted(agg.values(), key=lambda e: -e["total"]))
    for r in rows:
        r["avg"] = r["total"] / r["count"]
        r["pct_wall"] = (100.0 * r["total"] / wall) if wall > 0 else 0.0
    return rows


def merge_loaded(loaded: List[tuple]) -> tuple:
    """Merge N ``load_trace_meta`` results onto per-pid lanes, rebased via
    each file's wall-clock anchor. Returns ``(spans, instants, metrics,
    lanes, clock_note, counters)`` — ``clock_note`` is None only when
    EVERY file carried an anchor (cross-file timestamps are then
    trustworthy); ``counters`` are the merged counter-track samples.
    Per-lane ``torn`` counts surface each file's skipped (truncated)
    records; ``blackbox`` marks flight-recorder bundle lanes."""
    anchors = [m["wall_epoch"] for *_rest, m in loaded
               if m["wall_epoch"] is not None]
    base = min(anchors) if anchors else 0.0
    missing = [i for i, (*_r, m) in enumerate(loaded)
               if m["wall_epoch"] is None]
    spans, instants, counters, lanes = [], [], [], {}
    metrics_parts = []
    metric_pids = set()
    for i, (sp, ins, met, meta) in enumerate(loaded):
        off = ((meta["wall_epoch"] - base)
               if meta["wall_epoch"] is not None else 0.0)
        # lane key: the file's pid (per-event pid wins when present —
        # a chrome file may already be a merge), else a synthetic lane
        fallback_pid = meta["pid"] if meta["pid"] is not None \
            else f"file{i}"
        n = 0
        for ev in sp:
            ev = dict(ev, ts=ev["ts"] + off,
                      pid=ev.get("pid") or fallback_pid)
            spans.append(ev)
            n += 1
        for ev in ins:
            ev = dict(ev, ts=ev["ts"] + off,
                      pid=ev.get("pid") or fallback_pid)
            instants.append(ev)
            n += 1
        for ev in meta.get("counters") or ():
            ev = dict(ev, ts=ev["ts"] + off,
                      pid=ev.get("pid") or fallback_pid)
            counters.append(ev)
            n += 1
        lanes[str(fallback_pid)] = {"file_index": i, "events": n,
                                    "wall_epoch": meta["wall_epoch"]}
        if meta.get("skipped_lines"):
            lanes[str(fallback_pid)]["torn"] = meta["skipped_lines"]
        if meta.get("blackbox_reason"):
            lanes[str(fallback_pid)]["blackbox"] = meta["blackbox_reason"]
        # one registry per PROCESS: two files from one pid (a JSONL stream
        # plus an export, say) snapshot the same registry — summing both
        # copies would double every count
        if met and (meta["pid"] is None or meta["pid"] not in metric_pids):
            if meta["pid"] is not None:
                metric_pids.add(meta["pid"])
            metrics_parts.append(met)
    spans.sort(key=lambda e: e["ts"])
    instants.sort(key=lambda e: e["ts"])
    counters.sort(key=lambda e: e["ts"])
    if metrics_parts:
        if len(metrics_parts) == 1:
            metrics = metrics_parts[0]
        else:  # fold fleet members' registries into one table
            from ..obs.export import merge_metrics

            metrics = merge_metrics(metrics_parts)
    else:
        metrics = None
    note = None
    if missing and len(loaded) > 1:
        note = (f"{len(missing)} of {len(loaded)} inputs carry no "
                "wall-clock anchor; their lanes are pinned at the shared "
                "origin — cross-file ordering is approximate (clock skew "
                "unbounded)")
    return spans, instants, metrics, lanes, note, counters


def counter_tracks(counters: List[dict]) -> List[dict]:
    """Aggregate counter samples per track name: sample count, min / max /
    last value — the terminal view of the Perfetto memory lane."""
    agg = {}
    for c in counters:
        v = c.get("value")
        if v is None:
            continue
        ent = agg.setdefault(c["name"], {"name": c["name"], "samples": 0,
                                         "min": v, "max": v, "last": v})
        ent["samples"] += 1
        ent["min"] = min(ent["min"], v)
        ent["max"] = max(ent["max"], v)
        ent["last"] = v
    return sorted(agg.values(), key=lambda e: e["name"])


def device_cost_table(instants: List[dict], top: int = 10) -> List[dict]:
    """Top-N programs by device cost, from the ``device.compile`` instant
    events the compile choke points emit (one per compiled program, args =
    the compile_log cost fields: flops / bytes_accessed / peak_hbm_bytes).
    Sorted by flops descending."""
    rows = []
    for ev in instants:
        if ev["name"] != "device.compile":
            continue
        a = ev.get("args") or {}
        rows.append({"site": a.get("site", "?"), "label": a.get("label", "?"),
                     "flops": a.get("flops", 0) or 0,
                     "bytes_accessed": a.get("bytes_accessed", 0) or 0,
                     "peak_hbm_bytes": a.get("peak_hbm_bytes", 0) or 0,
                     "pid": ev.get("pid")})
    rows.sort(key=lambda r: -r["flops"])
    return rows[:top]


def profiler_section(spans: List[dict]) -> Optional[dict]:
    """The continuous profiler's lane (``obs/profile.py`` — ``prof:<phase>``
    spans, in live telemetry parts and flight-recorder bundles alike)
    aggregated by phase: sample counts and approximate seconds, hottest
    first — "what were this process's last seconds spent on". None when
    no profiler lane is present."""
    agg = {}
    for s in spans:
        if not s["name"].startswith("prof:"):
            continue
        phase = s["name"][5:] or "?"
        a = s.get("args") or {}
        ent = agg.setdefault(phase, {"phase": phase, "samples": 0,
                                     "seconds": 0.0, "leaves": {}})
        n = a.get("samples", 1) or 1
        ent["samples"] += n
        ent["seconds"] += s.get("dur", 0.0) or 0.0
        leaf = a.get("leaf")
        if leaf:
            ent["leaves"][leaf] = ent["leaves"].get(leaf, 0) + n
    if not agg:
        return None
    rows = sorted(agg.values(), key=lambda e: -e["seconds"])
    for r in rows:
        top = sorted(r["leaves"].items(), key=lambda kv: -kv[1])[:3]
        r["top_leaves"] = [k for k, _ in top]
        del r["leaves"]
    return {"phases": rows}


def health_section(instants: List[dict], counters: List[dict],
                   metrics: Optional[dict]) -> Optional[dict]:
    """The training-health story in one block: the loss / grad-norm counter
    tracks' trajectory, every sentinel breach (rule + detail), NaN
    provenance verdicts (first non-finite node), lr backoffs, rollbacks,
    and injected NaN chaos — the events the training-health plane emits
    (the reference's ``obs/health.py``; the port's is queue item A15).
    None when the trace carries no health plane at all."""
    tracks = [c for c in counter_tracks(counters)
              if c["name"].startswith("health.")]
    breaches, provenance, actions = [], [], []
    for ev in instants:
        a = ev.get("args") or {}
        if ev["name"] == "health.breach":
            breaches.append({"t": ev["ts"], "rule": a.get("rule"),
                             "detail": a.get("detail"),
                             "step": a.get("step")})
        elif ev["name"] == "health.nan_provenance":
            provenance.append({"t": ev["ts"], "node": a.get("node"),
                               "op": a.get("op"),
                               "nonfinite_inputs":
                                   a.get("nonfinite_inputs")})
        elif ev["name"] in ("health.rollback", "health.lr_backoff",
                            "chaos.nan"):
            actions.append({"t": ev["ts"], "what": ev["name"], **a})
    gauges = {k: v for k, v in ((metrics or {}).get("gauges") or {}).items()
              if k.startswith("health.")}
    if not (tracks or breaches or provenance or actions or gauges):
        return None
    return {"tracks": tracks, "breaches": breaches,
            "provenance": provenance, "actions": actions, "gauges": gauges}


def report(paths, top: int = 10, _loaded=None) -> dict:
    """Build the full report as data (the CLI renders it; tests assert on
    it). ``paths``: one path or a list — multiple inputs merge onto
    per-pid lanes (see module doc)."""
    if isinstance(paths, str):
        paths = [paths]
    loaded = _loaded if _loaded is not None \
        else [load_trace_meta(p) for p in paths]
    spans, instants, metrics, lanes, note, counters = merge_loaded(loaded)
    torn = sum(info.get("torn", 0) for info in lanes.values())
    out = {
        "trace": paths[0] if len(paths) == 1 else list(paths),
        "n_spans": len(spans),
        "n_events": len(instants),
        "lanes": lanes,
        "clock_note": note,
        "torn_records": torn,
        "phases": phase_breakdown(spans),
        "top_spans": sorted(spans, key=lambda s: -s["dur"])[:top],
        "events": instants,
        "counters": counter_tracks(counters),
        "device_programs": device_cost_table(instants, top=top),
        "profiler": profiler_section(spans),
        "health": health_section(instants, counters, metrics),
        "metrics": metrics,
    }
    return out


def merged_chrome(paths, _loaded=None) -> dict:
    """The merged timeline as one chrome-trace document (``--chrome-out``):
    a process lane per pid, thread tracks inside, clock-anchored."""
    loaded = _loaded if _loaded is not None \
        else [load_trace_meta(p) for p in paths]
    spans, instants, metrics, lanes, note, counters = merge_loaded(loaded)
    events = []
    seen = set()
    # synthetic lanes (anchor-less files with no recorded pid) get
    # deterministic ids far above any real pid — str hashes randomize per
    # interpreter run and could collide with a genuine pid's lane
    synthetic: dict = {}

    def lane_of(ev):
        pid = ev.get("pid")
        if isinstance(pid, int):
            pid_num = pid
        else:
            pid_num = synthetic.setdefault(pid, 10_000_000 + len(synthetic))
        if pid_num not in seen:
            seen.add(pid_num)
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid_num, "tid": 0,
                           "args": {"name": f"pid {pid}"}})
        return pid_num

    for ev in spans + instants:
        pid_num = lane_of(ev)
        out = {"name": ev["name"], "pid": pid_num, "tid": ev.get("tid", 0),
               "ts": ev["ts"] * 1e6}
        if "dur" in ev:
            out["ph"] = "X"
            out["dur"] = ev["dur"] * 1e6
        else:
            out["ph"] = "i"
            out["s"] = "t"
        if ev.get("args"):
            out["args"] = ev["args"]
        events.append(out)
    for ev in counters:  # counter lanes (device.live_bytes) ride along
        pid_num = lane_of(ev)
        events.append({"name": ev["name"], "ph": "C", "pid": pid_num,
                       "tid": ev.get("tid", 0), "ts": ev["ts"] * 1e6,
                       "args": {"value": ev.get("value", 0)}})
    other = {"lanes": lanes}
    if note:
        other["clock_note"] = note
    if metrics:
        other["metrics"] = metrics
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def _fmt_s(sec: float) -> str:
    if sec >= 1.0:
        return f"{sec:.3f}s"
    return f"{sec * 1e3:.3f}ms"


def render(rep: dict, stream=None) -> None:
    out = stream or sys.stdout
    w = out.write
    trace = rep["trace"]
    if isinstance(trace, list):
        trace = f"{len(trace)} files merged"
    w(f"trace: {trace}  "
      f"({rep['n_spans']} spans, {rep['n_events']} events)\n")
    lanes = rep.get("lanes") or {}
    if len(lanes) > 1:
        w("lanes: " + ", ".join(
            f"pid {p} ({info['events']} ev"
            + (f", blackbox:{info['blackbox']}" if info.get("blackbox")
               else "") + ")"
            for p, info in sorted(lanes.items())) + "\n")
    if rep.get("clock_note"):
        w(f"NOTE: {rep['clock_note']}\n")
    if rep.get("torn_records"):
        w(f"WARNING: skipped {rep['torn_records']} torn/garbled "
          "record(s) — a stream truncated mid-line (SIGKILL?)\n")
    w("\n")

    w("Per-phase breakdown:\n")
    w(f"  {'Phase':<28}{'Count':>7}{'Total':>12}{'Avg':>12}"
      f"{'Max':>12}{'%Wall':>8}\n")
    for r in rep["phases"]:
        w(f"  {r['name']:<28}{r['count']:>7}{_fmt_s(r['total']):>12}"
          f"{_fmt_s(r['avg']):>12}{_fmt_s(r['max']):>12}"
          f"{r['pct_wall']:>7.1f}%\n")

    if rep["top_spans"]:
        w(f"\nTop {len(rep['top_spans'])} spans:\n")
        for s in rep["top_spans"]:
            args = (" " + json.dumps(s["args"], default=str)
                    if s["args"] else "")
            w(f"  {_fmt_s(s['dur']):>12}  {s['name']}{args}\n")

    if rep.get("counters"):
        w("\nCounter tracks:\n")
        w(f"  {'Track':<28}{'Samples':>8}{'Min':>14}{'Max':>14}"
          f"{'Last':>14}\n")
        for c in rep["counters"]:
            w(f"  {c['name']:<28}{c['samples']:>8}{c['min']:>14.6g}"
              f"{c['max']:>14.6g}{c['last']:>14.6g}\n")

    if rep.get("device_programs"):
        w("\nTop programs by device cost:\n")
        w(f"  {'Site':<12}{'Program':<20}{'GFLOPs':>10}{'MB accessed':>13}"
          f"{'Peak HBM MB':>13}\n")
        for p in rep["device_programs"]:
            w(f"  {p['site']:<12}{p['label']:<20}"
              f"{p['flops'] / 1e9:>10.4g}"
              f"{p['bytes_accessed'] / 1e6:>13.4g}"
              f"{p['peak_hbm_bytes'] / 1e6:>13.4g}\n")

    prof = rep.get("profiler")
    if prof:
        w("\nContinuous profiler (by phase):\n")
        w(f"  {'Phase':<28}{'Samples':>8}{'~Seconds':>10}  Top frames\n")
        for r in prof["phases"]:
            w(f"  {r['phase']:<28}{r['samples']:>8}{r['seconds']:>10.3f}  "
              f"{', '.join(r['top_leaves'])}\n")

    h = rep.get("health")
    if h:
        w("\nTraining health:\n")
        for c in h["tracks"]:
            w(f"  {c['name']:<28}{c['samples']:>6} samples  "
              f"min {c['min']:.6g}  max {c['max']:.6g}  "
              f"last {c['last']:.6g}\n")
        for b in h["breaches"]:
            w(f"  ! t={b['t']:.3f}s breach [{b['rule']}] "
              f"{b.get('detail') or ''}\n")
        for p in h["provenance"]:
            w(f"  ! t={p['t']:.3f}s NaN provenance: first non-finite at "
              f"{p.get('node')} ({p.get('op')}), bad inputs: "
              f"{p.get('nonfinite_inputs')}\n")
        for a in h["actions"]:
            extra = {k: v for k, v in a.items() if k not in ("t", "what")}
            w(f"  > t={a['t']:.3f}s {a['what']} "
              f"{json.dumps(extra, default=str) if extra else ''}\n")
        if not (h["breaches"] or h["provenance"] or h["actions"]):
            w("  no breaches — run healthy\n")

    if rep["events"]:
        w("\nTagged events:\n")
        for e in rep["events"]:
            args = (" " + json.dumps(e["args"], default=str)
                    if e["args"] else "")
            w(f"  t={e['ts']:.6f}s  {e['name']}{args}\n")

    m = rep["metrics"]
    if m:
        w("\nMetrics:\n")
        for name, v in (m.get("counters") or {}).items():
            w(f"  {name:<44}{v:>14}\n")
        for name, v in (m.get("gauges") or {}).items():
            w(f"  {name:<44}{v:>14.6g}\n")
        hists = m.get("histograms") or {}
        if hists:
            w(f"  {'histogram':<44}{'count':>8}{'avg':>12}{'p99':>12}"
              f"{'max':>12}\n")
            for name, h in hists.items():
                w(f"  {name:<44}{h['count']:>8}{h['avg']:>12.6g}"
                  f"{h.get('p99', 0.0):>12.6g}{h['max']:>12.6g}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", nargs="+",
                    help="trace.json (chrome) and/or events.jsonl — "
                         "multiple inputs merge onto per-pid lanes")
    ap.add_argument("--top", type=int, default=10,
                    help="how many individual spans to list")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of tables")
    ap.add_argument("--chrome-out", default=None,
                    help="also write the merged timeline as one "
                         "Perfetto-loadable chrome trace")
    args = ap.parse_args(argv)
    loaded = [load_trace_meta(p) for p in args.trace]  # parse each ONCE
    rep = report(args.trace, top=args.top, _loaded=loaded)
    if args.chrome_out:
        with open(args.chrome_out, "w") as f:
            json.dump(merged_chrome(args.trace, _loaded=loaded), f,
                      default=str)
        sys.stderr.write(f"merged chrome trace -> {args.chrome_out}\n")
    if args.json:
        json.dump(rep, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    else:
        render(rep)
    return rep


if __name__ == "__main__":
    try:
        main()
    except BrokenPipeError:  # `trace_report.py t.json | head` is routine
        sys.exit(0)
