#!/usr/bin/env python
"""bench_compare.py — the perf-regression dossier over BENCH_r*.json
(counterpart of ``tools/bench_compare.py``).

Loads a trajectory of bench artifacts (each round's captured bench JSON
line), computes per-gain deltas with noise bands from the artifacts' own
``*_spread`` fields, treats ``platform_unavailable`` rounds as GAPS, never
as 100% regressions, and flags cross-metric anomalies such as bf16 piped
slower than fp32 piped. The logic lives in
``mxnet_tpu_torch/obs/regress.py``, loaded by file path: no framework or
torch import, so this runs anywhere the JSON does.

Usage::

    python -m mxnet_tpu_torch.tools.bench_compare      # BENCH_r*.json in the repo root
    python -m mxnet_tpu_torch.tools.bench_compare BENCH_r0[1-4].json --json
    python -m mxnet_tpu_torch.tools.bench_compare --min-band 0.05 --out dossier.json

Exit codes: 0 clean · 2 regression/anomaly · 3 platform gap(s) only
(1 stays reserved for an actual crash).
"""
from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)


def _load_regress():
    """Import ``obs/regress.py`` straight from its file, bypassing the
    package ``__init__`` (which imports torch)."""
    path = os.path.join(PKG, "obs", "regress.py")
    spec = importlib.util.spec_from_file_location("_bench_regress", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifacts", nargs="*",
                    help="BENCH_r*.json files (default: repo root glob)")
    ap.add_argument("--min-band", type=float, default=None,
                    help="relative noise floor when an artifact has no "
                         "spread field (default 0.03)")
    ap.add_argument("--json", action="store_true",
                    help="emit the dossier as JSON instead of tables")
    ap.add_argument("--out", default=None,
                    help="also write the dossier JSON to this path")
    args = ap.parse_args(argv)

    regress = _load_regress()
    paths = args.artifacts or sorted(glob.glob(
        os.path.join(REPO, "BENCH_r*.json")))
    if not paths:
        sys.stderr.write("no BENCH_r*.json artifacts found\n")
        return 1
    kw = {}
    if args.min_band is not None:
        kw["min_band"] = args.min_band
    d = regress.dossier(paths, **kw)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(d, f, indent=2)
        sys.stderr.write(f"dossier JSON -> {args.out}\n")
    if args.json:
        json.dump(d, sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(regress.render(d) + "\n")
    return d["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
