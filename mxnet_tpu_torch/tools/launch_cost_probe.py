"""The card's fixed cost of one kernel launch, and of a launch plus a sync.

    python -m mxnet_tpu_torch.tools.launch_cost_probe [--reps 5]

Counterpart of ``tools/tunnel_cost_probe.py`` (its ``copy_kern`` Pallas
kernel). ``copy_probe`` launches ``csrc/copy_probe.cu``, y = x + 1 on one
(8, 128) f32 block, through the launch path every kernel wrapper of the
port takes (``ops/_kernels.py``: ``entry`` and ``stream``): no work, so its
time is the fixed cost. The probe times chains of 1, 20 and 100 launches
of ``copy_probe`` and of the one PyTorch call ``x + 1`` three ways and
prints one JSON line with the card's name and power limit:

- ``device_ms``: CUDA events around the chain (the device's view, launch
  gaps included);
- ``host_ms``: host clock around the chain and one
  ``torch.cuda.synchronize()`` (enqueue of n launches plus one sync);
- ``sync_each_ms``: host clock around n x (launch + sync), the round trip
  an eager step pays for every host read.

Each is the median over ``--reps`` repetitions; ``*_per_launch_us`` are
the slopes between the 20- and 100-launch chains. ``host_us`` splits the
launch path's host cost into its steps, each timed alone on the host
clock (median of ``--reps`` loops of 2000 calls): the raw stream handle,
the entry point's lookup and its call (returning before a launch), the
output's allocation and the wrapper's checks. The output is checked
against ``x + 1``. With no CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..base import MXNetError
from ..ops import _kernels

CHAINS = (1, 20, 100)


def _copy_probe_plain(x):
    return x + 1.0


def copy_probe(x):
    """y = x + 1 over a contiguous f32 tensor. On a CUDA tensor this
    launches ``csrc/copy_probe.cu`` and adds one to
    ``copy_probe.launches``; on a CPU tensor it computes the plain
    version."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return _copy_probe_plain(x)
        raise MXNetError(f"copy_probe: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise MXNetError("copy_probe: x must be a non-empty contiguous "
                         "float32 tensor")
    y = torch.empty_like(x)
    err = _kernels.entry("copy_probe")(x.data_ptr(), y.data_ptr(), x.numel(),
                                       _kernels.stream(x))
    if err != 0:
        raise MXNetError(f"copy_probe launch failed: cudaError {err}")
    copy_probe.launches += 1
    return y


copy_probe.launches = 0


def _chain(fn, x, n):
    for _ in range(n):
        fn(x)


def _time(fn, x, n, reps):
    dev, host, each = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        _chain(fn, x, n)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
            torch.cuda.synchronize()
        each.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(dev)), float(np.median(host)),
            float(np.median(each)))


def _slope_us(by_n):
    return (by_n[CHAINS[-1]] - by_n[CHAINS[-2]]) / (CHAINS[-1] - CHAINS[-2]) \
        * 1e3


def _host_us(fn, reps, n=2000):
    """Median host microseconds of one ``fn()`` over ``reps`` loops."""
    fn()
    per = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per.append((time.perf_counter() - t0) / n * 1e6)
    return float(np.median(per))


def host_parts(x, reps: int = 5) -> dict:
    """Host microseconds of each step of ``copy_probe``'s launch path, on
    CUDA tensor ``x``. The entry point is given an empty problem (n = 0),
    on which the launcher returns an error before launching."""
    ptr, st = x.data_ptr(), _kernels.stream(x)
    launch = _kernels.entry("copy_probe")
    return {
        "loop_and_call": _host_us(lambda: None, reps),
        "raw_stream": _host_us(lambda: _kernels.stream(x), reps),
        "entry_lookup": _host_us(lambda: _kernels.entry("copy_probe"),
                                 reps),
        "entry_call": _host_us(lambda: launch(ptr, ptr, 0, st), reps),
        "empty_like": _host_us(lambda: torch.empty_like(x), reps),
        "checks": _host_us(
            lambda: (not x.is_cuda or x.dtype != torch.float32
                     or not x.is_contiguous() or x.numel() == 0), reps),
        "data_ptr": _host_us(lambda: x.data_ptr(), reps),
    }


def run(reps: int = 5) -> dict:
    """Probe the current CUDA device; returns the JSON-able result."""
    if not torch.cuda.is_available():
        raise MXNetError("launch_cost_probe: no CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((8, 128), generator=gen, device=dev)
    y = copy_probe(x)
    torch.cuda.synchronize()
    err = float((y - (x + 1.0)).abs().max())
    if err != 0.0:
        raise MXNetError(f"copy_probe: max_abs_err {err} against x + 1")
    out = {"tool": "launch_cost_probe", "shape": [8, 128],
           "max_abs_err": err, "reps": reps}
    for name, fn in (("kernel", copy_probe), ("plain", _copy_probe_plain)):
        _chain(fn, x, 10)  # warm up
        res = {n: _time(fn, x, n, reps) for n in CHAINS}
        out[name] = {
            "device_ms": {str(n): r[0] for n, r in res.items()},
            "host_ms": {str(n): r[1] for n, r in res.items()},
            "sync_each_ms": {str(n): r[2] for n, r in res.items()},
            "device_per_launch_us": _slope_us({n: r[0] for n, r in
                                               res.items()}),
            "host_per_launch_us": _slope_us({n: r[1] for n, r in
                                             res.items()}),
            "launch_plus_sync_us": _slope_us({n: r[2] for n, r in
                                              res.items()}),
        }
    out["host_us"] = host_parts(x, reps)
    out["device"] = torch.cuda.get_device_name(dev)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_cost_probe: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(run(args.reps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
