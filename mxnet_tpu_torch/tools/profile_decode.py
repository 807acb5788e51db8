"""Where the time of one full-width decode step goes, on a CUDA card.

    python -m mxnet_tpu_torch.tools.profile_decode [--context 1024]
        [--steps 20] [--trace build/profile_decode.json]

Builds the repo's full-width TransformerLM (seeded random weights) behind a
``DecodeEngine`` (8 slots, pages of 16, 1025 pages), gives every slot a
history of ``--context`` positions, and runs ``--steps`` decode steps
under ``torch.profiler``. Prints one JSON line: the card (name and power
limit from ``nvidia-smi``), host wall ms per step (``DecodeEngine.step``,
its one host sync included), device-busy ms per step (union of the CUDA
kernel intervals in the trace), the idle share, the paged-attention
kernel's share, and the kernels by device time. The chrome trace is
written to ``--trace``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np


def _kernel_intervals(trace_path):
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return [(e["ts"], e["ts"] + e["dur"], e.get("name", "?"))
            for e in events if e.get("cat") == "kernel" and "dur" in e]


def _busy_us(intervals):
    busy, end = 0.0, -1.0
    for s, e, _ in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--context", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default=os.path.join("build",
                                                    "profile_decode.json"))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer_lm
    from mxnet_tpu_torch.serve import DecodeEngine
    from mxnet_tpu_torch.serve.kvcache import pages_for

    # the first touch of the card, under the platform watchdog: a hung
    # or missing card exits with one parseable artifact line
    from mxnet_tpu_torch import platform

    platform.devices_or_exit(what="mxnet_tpu_torch/tools/profile_decode.py")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    mx.random.seed(0)
    lm = transformer_lm()
    lm.initialize()
    eng = DecodeEngine(lm, slots=8, page_size=16, num_pages=1025,
                       device=dev)
    eng.warmup()
    slots, total = eng.slots, args.context + args.steps + 3
    if total > eng.max_length:
        raise SystemExit(f"--context + steps exceeds {eng.max_length}")
    tables = np.zeros((slots, eng.max_pages), np.int32)
    for i in range(slots):
        pages = eng.pool.alloc(i, pages_for(total, eng.page_size))
        tables[i, :len(pages)] = pages
    rng = np.random.default_rng(0)
    temps = np.zeros((slots,), np.float32)

    def step(s):
        pos = np.full((slots,), args.context + s, np.int32)
        toks = rng.integers(1, 32000, size=slots).astype(np.int32)
        return eng.step(toks, pos, tables, pos + 1, temps, seed=s)

    for s in range(3):
        step(s)
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for s in range(3, 3 + args.steps):
            t0 = time.perf_counter()
            step(s)
            walls.append(time.perf_counter() - t0)
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    for i in range(slots):
        eng.pool.free(i)

    ivs = _kernel_intervals(args.trace)
    by_name = defaultdict(float)
    for s, e, name in ivs:
        by_name[name] += e - s
    n = args.steps
    wall_ms = 1e3 * float(np.mean(walls))
    busy_ms = _busy_us(ivs) / 1e3 / n
    attn_ms = sum(v for k, v in by_name.items()
                  if "paged_decode" in k) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "tool": "profile_decode", "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smi, "slots": slots, "context": args.context,
        "steps": n, "step_wall_ms": wall_ms,
        "step_wall_ms_median": 1e3 * float(np.median(walls)),
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(ivs) / n,
        "attention_ms_per_step": attn_ms,
        "attention_share_of_busy": attn_ms / busy_ms if busy_ms else None,
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / n] for k, v in top],
        "trace": args.trace}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
