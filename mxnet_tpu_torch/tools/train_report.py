"""train_report — the training fleet's report: per-rank step phases,
straggler verdicts, reduce-plane hot keys, one merged timeline
(counterpart of the reference's ``tools/train_report.py``).

The PS-plane twin of ``fleet_report``: one ``OP_TELEMETRY`` pull against
a PS server returns the server's own part (its ``kvstore.server.rpc``
lanes and STATS with the straggler verdicts and the hot-key table) and
every worker part cached off the heartbeats (windowed step-phase
summaries, drained spans, clock anchors). This tool renders:

- the **Training fleet** section: the per-rank phase breakdown (data-wait
  / compute / reduce-wait / host, ms per step), the step-time skew
  against the fleet median, the live straggler verdicts with the blamed
  phase, the top hot keys, and the server's reduce/barrier wait by rank;
- ``--trace out.json``: ONE merged chrome timeline, every rank's step
  phases and the PS server's RPC lanes on the shared wall-clock anchor.
  SIGKILLed ranks answer nothing over the wire, but their evidence files
  do: pass their JSONL streams or flight-recorder bundles with
  ``--jsonl`` and they join as extra pid lanes.

Usage::

    python -m mxnet_tpu_torch.tools.train_report --connect 127.0.0.1:9091 \
        [--trace merged.json] [--jsonl obs/rank-*.jsonl] [--no-drain]
        [--json] [--input pulled.json]
"""
from __future__ import annotations

import argparse
import json
import sys


def _fmt_ms(v) -> str:
    return f"{float(v) * 1e3:8.2f}"


def render_training_fleet(parts, merged_metrics=None) -> str:
    """The "Training fleet" section over pulled telemetry parts (the
    server part carries STATS; rank parts carry windows)."""
    from ..obs import fleetstats

    lines = ["Training fleet:"]
    server = next((p for p in parts if p.get("role") == "ps_server"), None)
    stats = (server or {}).get("stats") or {}
    fleet = stats.get("fleet") or {}
    ranks = dict(fleet.get("ranks") or {})
    # rank parts carry their windows too — prefer them when the server
    # part is absent (an --input doc from a dead server, say)
    for p in parts:
        r = p.get("rank")
        if r is None or str(r) in ranks:
            continue
        # same helper the server's STATS uses — the fallback rendering
        # (an --input doc from a dead server) can never diverge from it
        summary = fleetstats.summarize_windows(p.get("windows"))
        if summary is not None:
            ranks[str(r)] = dict(summary, pid=p.get("pid"))

    if ranks:
        med = sorted(v["step_time_avg"] for v in ranks.values())[
            len(ranks) // 2]
        lines.append(f"  {'rank':<6}{'steps':>7}{'step ms':>10}"
                     f"{'skew':>7}{'data ms':>10}{'comp ms':>10}"
                     f"{'redu ms':>10}{'host ms':>10}")
        for r in sorted(ranks, key=lambda x: int(x)):
            v = ranks[r]
            ph = v.get("phases") or {}
            st = float(v.get("step_time_avg") or 0.0)
            skew = st / med if med else 0.0
            lines.append(
                f"  {r:<6}{v.get('steps', 0):>7}{_fmt_ms(st):>10}"
                f"{skew:>7.2f}"
                f"{_fmt_ms(ph.get('data_wait', 0)):>10}"
                f"{_fmt_ms(ph.get('compute', 0)):>10}"
                f"{_fmt_ms(ph.get('reduce_wait', 0)):>10}"
                f"{_fmt_ms(ph.get('host', 0)):>10}")
    else:
        lines.append("  (no rank windows reported)")

    stragglers = fleet.get("stragglers") or []
    if stragglers:
        lines.append("  STRAGGLERS:")
        for v in stragglers:
            lines.append(
                f"    ! rank {v['rank']}: {v['ratio']}x the fleet median "
                f"for {v.get('windows', v.get('streak'))} window(s) — "
                f"blame: {v['blame']}")
    else:
        lines.append("  no straggler flagged")
    for v in fleet.get("verdicts") or []:
        if v.get("kind") == "recovered":
            lines.append(f"    recovered: rank {v['rank']} at window "
                         f"{v['window']} (was blamed "
                         f"{v.get('was_blamed')})")

    hot = stats.get("hot_keys") or []
    if hot:
        lines.append("  hot keys (top pushes):")
        for row in hot[:10]:
            lines.append(
                f"    {row['key']:<28}{row['pushes']:>8} pushes"
                f"{row['bytes']:>12} B  {row['push_rate']:>8}/s"
                f"  apply {row['apply_ms_avg']} ms")

    # reduce/barrier wait-by-rank from the merged metrics (the server's
    # vantage point: the rank with ~zero reduce wait is what the fleet
    # stood waiting on)
    hists = (merged_metrics or {}).get("histograms") or {}
    waits = {n: h for n, h in hists.items()
             if n.startswith(("kvstore.reduce_wait.",
                              "kvstore.barrier_wait."))}
    if waits:
        lines.append("  collective wait-by-rank (server view):")
        for n in sorted(waits):
            h = waits[n]
            lines.append(f"    {n:<42}{h.get('count', 0):>6}x  "
                         f"avg {_fmt_ms(h.get('avg', 0))} ms  "
                         f"p99 {_fmt_ms(h.get('p99', 0))} ms")
    counters = (merged_metrics or {}).get("counters") or {}
    last = {n: c for n, c in counters.items()
            if n.startswith("kvstore.reduce_last_arriver.")}
    if last:
        worst = max(last, key=lambda n: last[n])
        lines.append(f"  last arriver: {worst.rsplit('.', 1)[-1]} "
                     f"({last[worst]} of "
                     f"{sum(last.values())} rounds)")

    if stats.get("membership"):
        lines.append("  membership:")
        for m in stats["membership"]:
            lines.append(
                f"    rank {m['rank']}: {m['state']}, last heartbeat "
                f"{m['last_hb_age_s']}s ago")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="a PSServer endpoint (OP_TELEMETRY pull)")
    ap.add_argument("--input", default=None, metavar="PULLED.json",
                    help="read a previously pulled telemetry document "
                         "instead of connecting")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="write the merged chrome timeline here")
    ap.add_argument("--jsonl", nargs="*", default=(),
                    help="evidence files for SIGKILL'd ranks: JSONL "
                         "streams and/or flight-recorder bundles")
    ap.add_argument("--no-drain", action="store_true",
                    help="peek without consuming the span rings")
    ap.add_argument("--json", action="store_true",
                    help="emit everything as one JSON document")
    args = ap.parse_args(argv)
    if not args.connect and not args.input:
        ap.error("need --connect or --input")

    from ..obs import fleetstats
    from ..obs.export import merge_chrome_parts, merge_metrics
    from .fleet_report import jsonl_to_part

    if args.input:
        with open(args.input) as f:
            tel = json.load(f)
    else:
        host, _, port = args.connect.partition(":")
        tel = fleetstats.collect(host, int(port),
                                 drain=not args.no_drain)

    # dead ranks' evidence files; drop any whose pid answered the wire
    live_pids = {p.get("pid") for p in tel["parts"]}
    torn = 0
    jsonl_parts = []
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
    server = next((p for p in tel["parts"]
                   if p.get("role") == "ps_server"), None)
    if server is not None:
        out["fleet"] = (server.get("stats") or {}).get("fleet")
        out["hot_keys"] = (server.get("stats") or {}).get("hot_keys")

    if args.trace:
        doc = merge_chrome_parts(parts, metrics=merged_metrics)
        with open(args.trace, "w") as f:
            json.dump(doc, f, default=str)
        out["trace"] = args.trace
        if not args.json:
            print(f"merged chrome timeline ({len(parts)} lanes) "
                  f"-> {args.trace}")

    report = render_training_fleet(parts, merged_metrics)
    out["report"] = report
    if args.json:
        json.dump(out, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    else:
        print(report)
    return out


if __name__ == "__main__":
    main()
