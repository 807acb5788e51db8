"""Time design variants of the flash-attention kernels on a CUDA card.

    python -m mxnet_tpu_torch.tools.flash_variants [--only NAME ...]
        [--repeats 2] [--dtype bfloat16|float32] [--against DIR]

Each variant is a copy of this package under ``build/flash_variants/NAME``
with one design choice of ``csrc/flash_attention_{fwd,bwd}.cu`` undone or
changed (``VARIANTS``; "chosen" is the package as it is). The tool builds
every copy's two flash kernels (one ``nvcc`` per source, all started
together), then times each copy in a process of its own, the variants
taking turns ``--repeats`` times, in reverse order every other round:
forward and backward in ``--dtype`` (bf16: the tensor-core kernels; f32:
the FFMA kernels) at the training path's shapes (B 4, H 12, S 2048, D 64,
q/k/v strided views of one QKV projection), causal and full, median
device ms of 30 calls with the L2 flushed before each, and the largest
error against the plain versions (absolute for out, relative to
max(1, |plain|) for the gradients).
``--against DIR`` times the kernels of the checkout at DIR (for example
the parent commit unpacked by ``git archive``) as one more entry,
"against", taking turns with the variants. Prints the card's name and
power limit, then one JSON line per run.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_OUT = _PKG.parent / "build" / "flash_variants"
_FWD, _BWD = "flash_attention_fwd.cu", "flash_attention_bwd.cu"

# name -> [(source, text, replacement)]
VARIANTS = {
    "chosen": [],
    # forward products by mma.sync + ldmatrix instead of wgmma
    "fwd_mma_sync": [(_FWD, "kWgmma = D == 64 && kFwdBN == 64;",
                      "kWgmma = false;")],
    # forward K/V tiles of 128 keys (mma.sync: the wgmma path takes 64),
    # one block an SM for the registers
    "fwd_keys128": [(_FWD, "constexpr int kFwdBN = 64;",
                     "constexpr int kFwdBN = 128;"),
                    (_FWD, "kMinBlocks = D <= 64 ? 2 : 1;",
                     "kMinBlocks = 1;")],
    # forward K/V ring of three stages, one barrier a tile
    "fwd_three_stages": [
        (_FWD, "kBytes = kQ + 4 * kKV + 1024;", "kBytes = kQ + 6 * kKV + 1024;"),
        (_FWD, "skv + ((j + 1) & 1) * 2 * BN * D", "skv + ((j + 1) % 3) * 2 * BN * D"),
        (_FWD, "skv + (j & 1) * 2 * BN * D", "skv + (j % 3) * 2 * BN * D"),
        (_FWD, "    __syncthreads();  // before the next copy overwrites "
               "this stage\n", "")],
    # backward by the mma.sync kernel (64-key tiles) instead of wgmma
    "bwd_mma_sync": [(_BWD, "  if constexpr (D == 64)\n    return launch_pass",
                      "  if constexpr (false)\n    return launch_pass")],
    # the same with 128-key tiles (one block an SM for the registers)
    "bwd_mma_sync_keys128": [
        (_BWD, "  if constexpr (D == 64)\n    return launch_pass",
         "  if constexpr (false)\n    return launch_pass"),
        (_BWD, "constexpr int kBwdBN = 64;", "constexpr int kBwdBN = 128;")],
    # f32 (FFMA) forward at D <= 64 on 64-row Q tiles (4 rows a thread),
    # S in one chunk of 64 (104 KB of shared memory) or two of 32 (72 KB),
    # instead of 128-row tiles (8 rows a thread)
    "fwd_ffma_rows64": [
        (_FWD, "launch_ffma_slabs<T, kFfmaFwdBM / 16, 1, kFfmaFwdChunk>",
         "launch_ffma_slabs<T, 4, 1, 64>")],
    "fwd_ffma_rows64_chunk32": [
        (_FWD, "launch_ffma_slabs<T, kFfmaFwdBM / 16, 1, kFfmaFwdChunk>",
         "launch_ffma_slabs<T, 4, 1, kFfmaFwdChunk>")],
    # f32 (FFMA) backward with one block an SM, so no register spills
    "bwd_ffma_one_block": [
        (_BWD, "__launch_bounds__(kThreads, 2)\nflash_bwd_ffma_kernel",
         "__launch_bounds__(kThreads, 1)\nflash_bwd_ffma_kernel")],
}


def make(name):
    """The package copy of variant ``name``; returns its root."""
    root = _OUT / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, root / _PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, old, new in VARIANTS[name]:
        path = root / _PKG.name / "csrc" / src
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {src}")
        path.write_text(text.replace(old, new))
    return root


def time_here(label, dtype_name):
    """Times the flash kernels of the package that ``mxnet_tpu_torch``
    imports (the timing process's PYTHONPATH) in ``dtype_name``; prints one
    JSON line."""
    import numpy as np
    import torch

    from mxnet_tpu_torch.ops import _kernels
    from mxnet_tpu_torch.ops.flash_attention import (
        _flash_attention_plain, _flash_bwd_plain, flash_attention_bwd,
        flash_attention_fwd)

    dev = torch.device("cuda", 0)
    flush = torch.empty(128 * 2 ** 20, device=dev)

    def timed(fn, n=30):
        for _ in range(3):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for s, e in ev:
            flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))

    b, h, s, d = 4, 12, 2048, 64
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
    res = {"variant": label, "package": str(_kernels.CSRC.parent),
           "dtype": dtype_name}
    for causal in (True, False):
        out, lse = flash_attention_fwd(q, k, v, causal)
        grads = flash_attention_bwd(q, k, v, out, lse, do, None, causal)
        ref_o, _ = _flash_attention_plain(q, k, v, causal)
        refs = _flash_bwd_plain(q, k, v, out, lse, do, None, causal)
        errs = [float((out.float() - ref_o.float()).abs().max())]
        for g, r in zip(grads, refs):
            r = r.float()
            errs.append(float(((g.float() - r).abs()
                               / r.abs().clamp_min(1.0)).max()))
        pairs = b * h * s * (s + 1) // 2 if causal else b * h * s * s
        fwd = timed(lambda: flash_attention_fwd(q, k, v, causal))
        bwd = timed(lambda: flash_attention_bwd(q, k, v, out, lse, do, None,
                                                causal))
        res["causal" if causal else "full"] = {
            "max_err": max(errs), "fwd_ms": fwd,
            "fwd_tflops": 4 * d * pairs / fwd / 1e9, "bwd_ms": bwd,
            "bwd_tflops": 10 * d * pairs / bwd / 1e9}
    res["build_dir"] = str(_kernels.BUILD_DIR)
    print(json.dumps(res), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS))
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--against", default=None,
                    help="root of another checkout to time beside these")
    ap.add_argument("--time-here", metavar="LABEL",
                    help=argparse.SUPPRESS)  # one timing process
    args = ap.parse_args(argv)
    if args.time_here:
        time_here(args.time_here, args.dtype)
        return 0
    import torch

    # the first touch of the card, under the platform watchdog: a hung
    # or missing card exits with one parseable artifact line
    from mxnet_tpu_torch import platform

    platform.devices_or_exit(what="mxnet_tpu_torch/tools/flash_variants.py")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    names = args.only or list(VARIANTS)
    roots = {n: make(n) for n in names}
    if args.against:
        roots["against"] = Path(args.against).resolve()
    build = ("from mxnet_tpu_torch.ops import _kernels as k\n"
             "names = ('flash_attention_fwd', 'flash_attention_bwd')\n"
             "procs = [k._start_build(n) for n in names]\n"
             "for n, p in zip(names, procs): k._finish_build(n, p)\n")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=root)
             for root in roots.values()]
    if any(p.wait() for p in procs):
        return 1
    # each timing process runs this file, importing the package under its
    # root (the other checkout's own copy of this tool may be older); the
    # order reverses every other round (a, b, b, a)
    items = list(roots.items())
    for i in range(args.repeats):
        for name, root in (items if i % 2 == 0 else items[::-1]):
            env = dict(os.environ, PYTHONPATH=str(root))
            subprocess.run([sys.executable, __file__, "--time-here", name,
                            "--dtype", args.dtype], cwd=root, env=env,
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
