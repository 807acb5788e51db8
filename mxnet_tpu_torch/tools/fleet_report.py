"""fleet_report — pull fleet-wide telemetry and render the one timeline
(counterpart of the reference's ``tools/fleet_report.py``).

The collection plane's CLI: one
``OP_TELEMETRY`` against a serving endpoint — a FleetServer front answers
with its own part (client rpc + fleet.route spans, router/breaker state)
plus one part per live replica; a plain ServeServer answers with just its
own — and this tool turns the parts into:

- ``--trace out.json``  — ONE merged chrome trace, a lane per pid, every
  sampled INFER's client → router → replica spans stitched by trace_id
  (load in Perfetto, or feed to ``mxnet_tpu_torch.tools.trace_report``);
- ``--prom out.prom``   — Prometheus text exposition, pid/role-labeled
  (``-`` writes to stdout; point a textfile collector at the file — no
  HTTP server in-process);
- the SLO report (default on): deadline attainment, error-budget burn,
  p99 vs target, shed-by-reason, breaker open-time, hedge win rate
  (``obs/slo.py``), computed over the MERGED metrics.

SIGKILL'd replicas answer nothing — but their evidence files do: pass
``replica-<pid>.jsonl`` streams (``MXNET_OBS_DIR``) and/or flight-recorder
bundles (``obs/blackbox.py`` — ``blackbox-<pid>-last.json``, the periodic
"last seconds" snapshot a SIGKILL cannot suppress) via ``--jsonl`` and
they join the same timeline as extra pid lanes — a bundle's lane carries
the continuous profiler's ``prof:<phase>`` spans, attributing the corpse's
final seconds by phase. A stream the kill tore mid-line is skipped past
with a counted warning, never an error.

Usage::

    python -m mxnet_tpu_torch.tools.fleet_report \
        --connect 127.0.0.1:9191 --trace merged.json --prom - \
        [--jsonl obs/replica-*.jsonl obs/blackbox-*-last.json]
        [--target 0.99] [--p99-ms 50] [--no-drain]

The training plane's pull (the reference's ``--ps``, ``obs.fleetstats``)
is queue item A15 (its training half) of the port and raises.
"""
from __future__ import annotations

import argparse
import json
import sys



def jsonl_to_part(path: str) -> dict:
    """An evidence file — a JSONL stream or a flight-recorder bundle — as
    a telemetry part (the dead replica's contribution: its clock record
    anchors the lane, its spans are whatever it recorded before the kill;
    a bundle also carries the profiler's ``prof:<phase>`` lane). Torn
    trailing records are skipped and counted (``"torn_records"``)."""
    from ..obs import blackbox
    from .trace_report import load_trace_meta

    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        doc = None
    if blackbox.is_bundle(doc):
        # the bundle schema is owned by obs/blackbox.py — its reader
        # already folds the profiler samples into the span lane
        return blackbox.read_bundle(doc)
    spans, instants, metrics, meta = load_trace_meta(path, text=text)
    events = []
    for ev in spans:
        events.append(dict(ev, ph="X"))
    for ev in instants:
        events.append(dict(ev, ph="i"))
    for ev in meta.get("counters") or ():
        # counter-track samples (the device.live_bytes memory lane) — a
        # leak-before-OOM-kill corpse's most valuable evidence
        events.append({"ph": "C", "name": ev["name"], "ts": ev["ts"],
                       "tid": ev.get("tid"),
                       "args": {"value": ev.get("value", 0)}})
    events.sort(key=lambda e: e.get("ts", 0.0))
    base = path.rsplit("/", 1)[-1]
    role = (f"blackbox:{base}" if meta.get("blackbox_reason")
            else f"jsonl:{base}")
    part = {"pid": meta.get("pid"), "role": role,
            "wall_epoch": meta.get("wall_epoch"),
            "spans": events, "metrics": metrics or {}}
    if meta.get("skipped_lines"):
        part["torn_records"] = meta["skipped_lines"]
    if meta.get("blackbox_reason"):
        part["blackbox_reason"] = meta["blackbox_reason"]
    return part


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="a ServeServer/FleetServer endpoint (or, with "
                         "--ps, a PSServer)")
    ap.add_argument("--ps", action="store_true",
                    help="the endpoint is a training-plane PSServer "
                         "(obs.fleetstats: queue item A15 of the port, "
                         "raises)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write the merged chrome trace here")
    ap.add_argument("--prom", default=None, metavar="OUT.prom",
                    help="write the Prometheus exposition ('-' = stdout)")
    ap.add_argument("--prom-strict", action="store_true",
                    help="strict text format 0.0.4 (no OpenMetrics "
                         "exemplars/EOF) — for node_exporter textfile "
                         "collectors and pushgateways")
    ap.add_argument("--jsonl", nargs="*", default=(),
                    help="evidence files to merge in (SIGKILL'd members): "
                         "per-replica JSONL streams and/or flight-recorder "
                         "blackbox-*.json bundles")
    ap.add_argument("--no-drain", action="store_true",
                    help="peek without consuming the span rings")
    ap.add_argument("--no-slo", action="store_true",
                    help="skip the SLO report")
    ap.add_argument("--target", type=float, default=0.99,
                    help="deadline-attainment SLO target (default 0.99)")
    ap.add_argument("--p99-ms", type=float, default=None,
                    help="p99 latency alert threshold (ms)")
    ap.add_argument("--json", action="store_true",
                    help="emit everything as one JSON document")
    args = ap.parse_args(argv)

    from .. import obs
    from ..obs.export import (merge_chrome_parts, merge_metrics,
                              parts_to_prometheus)
    from ..obs.slo import SLOMonitor
    from ..serve import ServeClient

    host, _, port = args.connect.partition(":")
    if args.ps:
        tel = obs.fleetstats.collect(host, int(port),  # raises: A15
                                     drain=not args.no_drain)
        stats = None
    else:
        cli = ServeClient(host, int(port))
        try:
            tel = cli.telemetry(drain=not args.no_drain)
            # stats ride the front part when the server attached them
            # (the router's breaker open-time lives there)
            stats = next((p.get("stats") for p in tel["parts"]
                          if p.get("stats")), None)
        finally:
            cli.close()
    # a live replica answers OP_TELEMETRY *and* has a JSONL file — a glob
    # like obs/replica-*.jsonl matches both, so drop evidence whose pid
    # already reported over the wire (its spans would merge twice); only
    # the dead, who answer nothing, contribute through their files
    live_pids = {p.get("pid") for p in tel["parts"]}
    jsonl_parts = []
    torn = 0
    for path in args.jsonl:
        jp = jsonl_to_part(path)
        torn += jp.get("torn_records", 0)
        if jp.get("pid") is not None and jp["pid"] in live_pids:
            continue
        jsonl_parts.append(jp)
    parts = tel["parts"] + jsonl_parts
    if torn and not args.json:
        print(f"WARNING: skipped {torn} torn/garbled evidence record(s) "
              "— stream(s) truncated mid-line (SIGKILL?)")

    # dedupe by pid: parts from one process share one registry (an
    # in-process LocalReplica fleet); merging each copy would multiply
    # every count
    seen_pids, uniq = set(), []
    for p in parts:
        if p.get("pid") in seen_pids:
            continue
        seen_pids.add(p.get("pid"))
        uniq.append(p.get("metrics") or {})
    merged_metrics = merge_metrics(uniq)
    out = {"parts": [{"pid": p.get("pid"), "role": p.get("role"),
                      "spans": len(p.get("spans") or ())} for p in parts],
           "torn_records": torn}

    if args.trace:
        doc = merge_chrome_parts(parts, metrics=merged_metrics)
        with open(args.trace, "w") as f:
            json.dump(doc, f, default=str)
        out["trace"] = args.trace
        if not args.json:
            print(f"merged chrome trace ({len(parts)} lanes) "
                  f"-> {args.trace}")

    if args.prom:
        text = parts_to_prometheus(parts,
                                   openmetrics=not args.prom_strict)
        if args.prom == "-":
            sys.stdout.write(text)
        else:
            with open(args.prom, "w") as f:
                f.write(text)
            if not args.json:
                print(f"prometheus exposition -> {args.prom}")
        out["prometheus_lines"] = text.count("\n")

    if not args.no_slo and not args.ps:  # SLO math is serve-plane
        mon = SLOMonitor(deadline_target=args.target,
                         p99_target_ms=args.p99_ms)
        # a FleetServer's "batcher" IS the Router — its stats carry the
        # breaker open-time the SLO report wants
        rep = mon.evaluate(merged_metrics,
                           stats=(stats or {}).get("batcher"))
        out["slo"] = rep
        if not args.json:
            print(SLOMonitor.render(rep))

    if args.json:
        json.dump(out, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    return out


if __name__ == "__main__":
    main()
