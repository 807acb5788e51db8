"""Time the paged-decode kernel's chunk sizes on a CUDA card, beside the
kernel of another checkout.

    python -m mxnet_tpu_torch.tools.decode_chunks [--chunks 64 128 256 512]
        [--against DIR] [--repeats 2]

At the serving path's shapes (8 slots, 12 heads of 64, pages of 16, the
strided view ``kv[:, 5, 0]`` of a pool of 1025 pages x 12 layers) and two
sets of lengths, ``chip_smoke.py``'s check lengths
[0, 1, 15, 16, 17, 700, 2047, 2048] and eight full rows of 2048, in f32
and bf16, it times this checkout's kernel with the chunk that its rule
picks (``_decode_chunk``, row "chosen") and with each of ``--chunks``.
With ``--against DIR``, it also times the kernel of the checkout at
DIR (for example the parent commit unpacked by ``git archive``) through
that checkout's own ``flash_decode_attention`` (row "kernel"). Times are
the median device ms of 60 calls, the L2 flushed before each. Every
checkout's paged kernel is built first, all in parallel; then each
timing process imports the package of one checkout, the checkouts taking
turns (the order reversed on every other repeat). Each row carries its
largest error against the plain version on the live rows, the bytes
bound (each live K/V row read once, q read and out written once, at
3.35 TB/s), the achieved GB/s and share of that rate, and SDPA's time on
the same inputs gathered beforehand. Prints the card's name and power
limit, then one JSON line per row.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
SLOTS, HEADS, HEAD_DIM, PAGE, LAYERS = 8, 12, 64, 16, 12
MAX_PAGES, NUM_PAGES = 128, 1025
LENGTHS = {"check": [0, 1, 15, 16, 17, 700, 2047, 2048],
           "uniform": [2048] * 8}
_PKG = Path(__file__).resolve().parents[1]
_ROOT = _PKG.parent

_BUILD = """
from mxnet_tpu_torch.ops import _kernels as k
name = "paged_decode_attention"
if not k._lib_path(name).exists():
    k._finish_build(name, k._start_build(name))
"""


def time_root(label, chunks):
    """Times the package importable first on sys.path; prints JSON rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    scale = 1.0 / math.sqrt(HEAD_DIM)

    def timed(fn, n=60):
        for _ in range(5):
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

    launch = getattr(fa, "_paged_decode_launch", None)
    pool32 = torch.randn((NUM_PAGES, LAYERS, 2, PAGE, HEADS, HEAD_DIM),
                         generator=gen, device=dev)
    q32 = torch.randn((SLOTS, HEADS, HEAD_DIM), generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        pool = pool32.to(dtype)
        k, v = pool[:, 5, 0], pool[:, 5, 1]
        q = q32.to(dtype)
        itemsize = pool.element_size()
        for case, lengths in LENGTHS.items():
            lengths = np.asarray(lengths, np.int32)
            table = np.zeros((SLOTS, MAX_PAGES), np.int32)
            free = rng.permutation(np.arange(1, NUM_PAGES)).tolist()
            for b, n in enumerate(lengths):
                live = -(-int(n) // PAGE)
                table[b, :live] = [free.pop() for _ in range(live)]
            table_t = torch.from_numpy(table).to(dev)
            len_t = torch.from_numpy(lengths).to(dev)
            live_rows = torch.from_numpy(lengths > 0).to(dev)
            pages = sum(-(-int(n) // PAGE) for n in lengths)
            nbytes = (pages * PAGE * HEADS * HEAD_DIM * 2 * itemsize
                      + 2 * SLOTS * HEADS * HEAD_DIM * itemsize)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ref = fa._decode_attention_plain(q.float(), k, v, table_t, len_t,
                                             scale)
            s = MAX_PAGES * PAGE
            kg = k[table_t.long()].reshape(SLOTS, s, HEADS, HEAD_DIM) \
                .transpose(1, 2).contiguous()
            vg = v[table_t.long()].reshape(SLOTS, s, HEADS, HEAD_DIM) \
                .transpose(1, 2).contiguous()
            mask = (torch.arange(s, device=dev)[None, :]
                    < len_t.long()[:, None])[:, None, None, :]
            sdpa_ms = timed(lambda: F.scaled_dot_product_attention(
                q[:, :, None, :], kg, vg, attn_mask=mask))
            del kg, vg
            runs = {"kernel" if launch is None else "chosen":
                    lambda: fa.flash_decode_attention(q, k, v, table_t,
                                                      len_t, scale)}
            if launch is not None:
                for c in chunks:
                    runs[c] = (lambda c=c: launch(q, k, v, table_t, len_t,
                                                  scale, c))
            for name, fn in runs.items():
                out = fn()
                torch.cuda.synchronize()
                err = float((out.float() - ref)[live_rows].abs().max())
                ms = timed(fn)
                row = {"tool": "decode_chunks", "root": label,
                       "dtype": str(dtype).split(".")[-1], "lengths": case,
                       "chunk": name, "ms": ms, "bound_ms": bound_ms,
                       "bytes": nbytes, "gbps": nbytes / ms / 1e6,
                       "share_of_hbm": bound_ms / ms, "max_abs_err": err,
                       "sdpa_ms": sdpa_ms}
                if name == "chosen":
                    row["chosen_chunk"] = fa._decode_chunk(
                        SLOTS, HEADS, MAX_PAGES * PAGE, PAGE,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count)
                print(json.dumps(row), flush=True)
        del pool, k, v
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chunks", type=int, nargs="*",
                    default=[64, 128, 256, 512])
    ap.add_argument("--against", default=None,
                    help="root of another checkout to time beside this one")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--time-root", nargs=2, metavar=("LABEL", "ROOT"),
                    help=argparse.SUPPRESS)  # one timing process
    args = ap.parse_args(argv)
    if args.time_root:
        sys.path.insert(0, args.time_root[1])
        time_root(args.time_root[0], args.chunks)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("decode_chunks: no CUDA device available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    roots = [("this", str(_ROOT))]
    if args.against:
        roots.insert(0, ("against", os.path.abspath(args.against)))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root))
             for _, root in roots]
    if any(p.wait() for p in procs):
        return 1
    for i in range(args.repeats):
        for label, root in (roots if i % 2 == 0 else roots[::-1]):
            subprocess.run([sys.executable, __file__, "--time-root", label,
                            root, "--chunks", *map(str, args.chunks)],
                           cwd=root, env=dict(os.environ, PYTHONPATH=root),
                           check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
