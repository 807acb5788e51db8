"""Perf-regression dossier over a trajectory of bench artifacts
(counterpart of ``mxnet_tpu/obs/regress.py``, copied: stdlib only).

Each round's bench run leaves one JSON line in a ``BENCH_rNN.json``
artifact (``bench.py``'s schema). This module turns a trajectory of them
into a machine-checked dossier:

- **Gains** — each named metric (headline ips, the ``extra.*`` matrix:
  bf16/piped/high legs, BERT seq/s + MFU, LM token rates, serve qps/p99)
  is extracted into a per-round series via one declarative spec table.
- **Noise bands** — the artifacts carry honesty spreads (``*_spread`` =
  (worst-best)/best across runs); a transition only classifies as
  improvement/regression when the relative delta clears
  ``max(spread_a, spread_b, min_band)``; inside the band it is
  ``within_noise``.
- **Gaps, not zeros** — a ``platform_unavailable`` artifact (nonzero rc,
  ``error``/``platform_error`` keys, null value) is a *gap* in every
  series, never a 100% regression; transitions skip over gap rounds and
  compare the flanking measurements instead.
- **Anomaly checks** — cross-metric invariants within one round: bf16
  piped slower than fp32 piped (bf16 compute moves more on the same
  wire, so slower means the pipeline regressed), and MFU > 1 (a
  self-contradicting denominator).

Exit codes (``tools/bench_compare.py`` returns them; 1 is left to python
itself so an uncaught crash stays distinguishable from a verdict):

- ``EXIT_CLEAN`` (0)      — no regression, no anomaly, no gap
- ``EXIT_REGRESSION`` (2) — at least one out-of-band regression or anomaly
- ``EXIT_GAP`` (3)        — no regression, but the trajectory has holes

Pure stdlib on purpose: ``mxnet_tpu_torch/tools/bench_compare.py`` loads
this file without importing the framework. The port has no bench
trajectory of its own yet; the dossier reads any artifacts in this
schema.
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Dict, List, Optional, Sequence

__all__ = ["EXIT_CLEAN", "EXIT_REGRESSION", "EXIT_GAP", "GAIN_SPECS",
           "load_round", "extract_gains", "compare", "dossier", "render"]

EXIT_CLEAN = 0
EXIT_REGRESSION = 2
EXIT_GAP = 3

# default relative noise floor when an artifact carries no spread for a
# gain (early rounds predate the *_spread fields): single-chip throughput
# jitters a few percent run to run even uncontended
DEFAULT_MIN_BAND = 0.03


def _dig(d: dict, path: str):
    """``"extra.bert_base_bf16.seq_per_sec"`` → nested lookup or None."""
    cur = d
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


# (name, value path, spread path, higher_is_better) — the declarative map
# from bench.py's output schema to named gain series. Spread paths may be
# None (no honesty field for that gain; the min band applies alone).
GAIN_SPECS = (
    ("resnet50_fp32_ips", "value", "extra.fp32_spread", True),
    ("resnet50_bf16_ips", "extra.resnet50_bf16_ips",
     "extra.resnet50_bf16_spread", True),
    ("resnet50_fp32_high_ips", "extra.resnet50_fp32_high_ips",
     "extra.resnet50_fp32_high_spread", True),
    ("resnet50_piped_ips", "extra.resnet50_piped_ips",
     "extra.resnet50_piped_breakdown.spread", True),
    ("resnet50_piped_bf16_ips", "extra.resnet50_piped_bf16_ips",
     "extra.resnet50_piped_bf16_breakdown.spread", True),
    ("bert_seq_per_sec", "extra.bert_base_bf16.seq_per_sec",
     "extra.bert_base_bf16.spread", True),
    ("bert_mfu_vs_measured_peak", "extra.bert_base_bf16.mfu_vs_measured_peak",
     "extra.bert_base_bf16.spread", True),
    ("lm2048_flash_tokens_per_sec", "extra.lm_seq2048_bf16.flash.tokens_per_sec",
     "extra.lm_seq2048_bf16.flash.spread", True),
    ("lm2048_plain_tokens_per_sec", "extra.lm_seq2048_bf16.plain.tokens_per_sec",
     "extra.lm_seq2048_bf16.plain.spread", True),
    ("lm2048_flash_speedup", "extra.lm_seq2048_bf16.flash_speedup",
     None, True),
    ("lm4096_flash_tokens_per_sec", "extra.lm_seq4096_bf16.flash.tokens_per_sec",
     "extra.lm_seq4096_bf16.flash.spread", True),
    ("serve_qps", "extra.serve.serve_qps", None, True),
    ("serve_p99_ms", "extra.serve.serve_p99_ms", None, False),
    # autoregressive decode:
    # fleet token throughput and the client-observed inter-token p99
    # under concurrent streams WITH churn — the streaming-UX trajectory
    # numbers; the leg itself gates the program bound and page leaks
    ("decode_tokens_per_s", "extra.decode.decode_tokens_per_s",
     None, True),
    ("decode_p99_per_token_ms", "extra.decode.decode_p99_per_token_ms",
     None, False),
    # replica spawn → readiness-probe-OK with a WARMED persistent program
    # cache (progcache.py; the cold twin rides extra.cold_start.cold_s) —
    # the fleet-elasticity number: what autoscale scale-out actually waits
    ("cold_start_to_ready_s", "extra.cold_start.cold_start_to_ready_s",
     None, False),
    # per-request wire-hop cost with the MXNET_COPYTRACK twin counting:
    # p50 client latency minus execute, and bytes crossing a copy per
    # request, so a zero-copy rewrite lands as a classified improvement
    ("wire_hop_ms_p50", "extra.wire_hop.hop_ms_p50", None, False),
    ("wire_bytes_copied_per_req",
     "extra.wire_hop.bytes_copied_per_request", None, False),
    # bounded-staleness asynchronous training: slowest rank's median step time over the fleet median
    # under one slowed rank on the gated-pull wire — ~1 means lockstep
    # coupling, >=2 means only the straggler pays for its own lag
    ("async_step_decoupling", "extra.async_step_decoupling", None, True),
)


def load_round(path: str) -> dict:
    """One BENCH artifact → ``{round, file, gap, reason, gains}``.

    Gap detection is deliberately broad: nonzero rc, a null headline
    value, or an ``error`` / ``platform_error`` key all mean "the platform
    never answered", and the round must contribute NO numbers."""
    with open(path) as f:
        doc = json.load(f)
    parsed = doc.get("parsed") or {}
    m = re.search(r"r?(\d+)", os.path.basename(path))
    rnd = doc.get("n", int(m.group(1)) if m else -1)
    out = {"round": rnd, "file": os.path.basename(path),
           "gap": False, "reason": None, "gains": {}}
    err = parsed.get("error") or _dig(parsed, "platform_error.detail")
    if doc.get("rc", 0) != 0 or parsed.get("value") is None or err:
        out["gap"] = True
        out["reason"] = (str(err)[:200] if err
                         else f"rc={doc.get('rc')} / no headline value")
        return out
    out["gains"] = extract_gains(parsed)
    return out


def extract_gains(parsed: dict) -> Dict[str, dict]:
    """Apply GAIN_SPECS to one parsed bench line."""
    gains = {}
    for name, vpath, spath, hib in GAIN_SPECS:
        v = _dig(parsed, vpath)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not math.isfinite(v):
            continue
        spread = _dig(parsed, spath) if spath else None
        if not isinstance(spread, (int, float)) or spread < 0:
            spread = None
        gains[name] = {"value": float(v), "spread": spread,
                       "higher_is_better": hib}
    return gains


def _check_anomalies(rnd: dict) -> List[dict]:
    """Cross-metric invariants inside one round's gains."""
    out = []
    g = rnd["gains"]

    def val(name):
        return g.get(name, {}).get("value")

    fp32p, bf16p = val("resnet50_piped_ips"), val("resnet50_piped_bf16_ips")
    if fp32p and bf16p and bf16p < fp32p * 0.95:
        out.append({
            "check": "bf16_piped_inversion", "round": rnd["round"],
            "detail": f"bf16-piped {bf16p:g} ips < fp32-piped {fp32p:g} ips "
                      "— bf16 compute must not lose on the same input "
                      "pipeline; the program or pipeline regressed"})
    mfu = val("bert_mfu_vs_measured_peak")
    if mfu is not None and mfu > 1.0:
        out.append({
            "check": "mfu_above_one", "round": rnd["round"],
            "detail": f"MFU {mfu:g} > 1 — the peak denominator "
                      "contradicts the model math; the probe measured "
                      "something other than the chip"})
    return out


def compare(rounds: Sequence[dict],
            min_band: float = DEFAULT_MIN_BAND) -> Dict[str, dict]:
    """Per-gain transition classification over the round sequence.

    Gap rounds contribute no points; each transition compares consecutive
    *measured* points (possibly skipping gaps) and classifies the relative
    delta against the noise band."""
    names: List[str] = []
    for r in rounds:
        for n in r["gains"]:
            if n not in names:
                names.append(n)
    out: Dict[str, dict] = {}
    for name in names:
        series, transitions = [], []
        for r in rounds:
            ent = r["gains"].get(name)
            if r["gap"]:
                series.append({"round": r["round"], "gap": True})
                continue
            if ent is None:
                series.append({"round": r["round"], "missing": True})
                continue
            series.append({"round": r["round"], "value": ent["value"],
                           "spread": ent["spread"]})
        measured = [p for p in series if "value" in p]
        hib = True
        for r in rounds:
            if name in r["gains"]:
                hib = r["gains"][name]["higher_is_better"]
                break
        for a, b in zip(measured, measured[1:]):
            va, vb = a["value"], b["value"]
            if va == 0:
                continue
            delta = (vb - va) / abs(va)
            band = max(a.get("spread") or 0.0, b.get("spread") or 0.0,
                       min_band)
            signed = delta if hib else -delta
            if signed < -band:
                klass = "regression"
            elif signed > band:
                klass = "improvement"
            else:
                klass = "within_noise"
            transitions.append({
                "from_round": a["round"], "to_round": b["round"],
                "delta_pct": round(delta * 100, 2),
                "band_pct": round(band * 100, 2), "class": klass})
        worst = "no_data"
        if transitions:
            classes = [t["class"] for t in transitions]
            worst = ("regression" if "regression" in classes else
                     "improvement" if "improvement" in classes else
                     "within_noise")
        out[name] = {"series": series, "transitions": transitions,
                     "status": worst, "higher_is_better": hib}
    return out


def dossier(paths: Sequence[str],
            min_band: float = DEFAULT_MIN_BAND) -> dict:
    """The full report as data: rounds (with gap attribution), per-gain
    series + classified transitions, anomalies, and the verdict/exit
    code. ``paths`` are BENCH_r*.json files; rounds order by their parsed
    round NUMBER (lexical path sort would put r100 before r99)."""
    rounds = sorted((load_round(p) for p in paths),
                    key=lambda r: r["round"])
    gains = compare(rounds, min_band=min_band)
    anomalies = []
    for r in rounds:
        if not r["gap"]:
            anomalies.extend(_check_anomalies(r))
    regressions = [
        {"gain": name, **t}
        for name, g in gains.items()
        for t in g["transitions"] if t["class"] == "regression"]
    gaps = [{"round": r["round"], "file": r["file"], "reason": r["reason"]}
            for r in rounds if r["gap"]]
    if regressions or anomalies:
        status, code = "regression", EXIT_REGRESSION
    elif gaps:
        status, code = "gap", EXIT_GAP
    else:
        status, code = "clean", EXIT_CLEAN
    return {"rounds": [{k: r[k] for k in ("round", "file", "gap", "reason")}
                       for r in rounds],
            "gains": gains, "anomalies": anomalies,
            "regressions": regressions, "gaps": gaps,
            "min_band": min_band, "status": status, "exit_code": code}


def render(d: dict) -> str:
    """The dossier as a terminal table (the CLI's default output)."""
    lines = []
    w = lines.append
    w(f"perf dossier over {len(d['rounds'])} rounds — status: "
      f"{d['status'].upper()} (exit {d['exit_code']})")
    for r in d["rounds"]:
        tag = f"GAP: {r['reason']}" if r["gap"] else "ok"
        w(f"  r{r['round']:02d}  {r['file']:<22} {tag}")
    w("")
    w(f"{'Gain':<28}{'Trajectory':<44}{'Status':>14}")
    for name, g in d["gains"].items():
        pts = []
        for p in g["series"]:
            if p.get("gap"):
                pts.append("~gap~")
            elif p.get("missing"):
                pts.append("-")
            else:
                pts.append(f"{p['value']:g}")
        w(f"{name:<28}{' -> '.join(pts):<44}{g['status']:>14}")
    if d["regressions"]:
        w("")
        w("Regressions (outside noise band):")
        for t in d["regressions"]:
            w(f"  {t['gain']}: r{t['from_round']:02d} -> r{t['to_round']:02d}"
              f"  {t['delta_pct']:+.1f}% (band ±{t['band_pct']:.1f}%)")
    if d["anomalies"]:
        w("")
        w("Anomalies (cross-metric invariants):")
        for a in d["anomalies"]:
            w(f"  [{a['check']}] r{a['round']:02d}: {a['detail']}")
    if d["gaps"]:
        w("")
        w("Platform gaps (excluded from every comparison):")
        for gp in d["gaps"]:
            w(f"  r{gp['round']:02d} {gp['file']}: {gp['reason']}")
    return "\n".join(lines)
