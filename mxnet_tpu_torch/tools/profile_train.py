"""Where the time of one full-width training step goes, on a CUDA card.

    python -m mxnet_tpu_torch.tools.profile_train [--impl flash]
        [--steps 3] [--trace build/profile_train.json]

Builds the repo's full-width Gluon TransformerLM (seeded random weights,
on the card) and a ``ShardedTrainer`` on a one-device mesh in
``bench.py::bench_lm_long``'s configuration (batch
4 x 2048 tokens, Adam lr 1e-4, bf16 compute, labels = inputs), runs two
warmup steps, then ``--steps`` steps under ``torch.profiler`` with the
attention of ``--impl`` (``MXNET_ATTENTION_IMPL``). Prints one JSON line:
the card (name and power limit from ``nvidia-smi``), host wall ms per
step (the step and one sync), device-busy ms per step (union of the CUDA
kernel intervals), the idle share, device ms per step by kernel class
(flash forward, flash backward, matrix products, softmax, optimizer,
other element-wise) and the top kernels. The chrome trace is written to
``--trace``.
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

from .profile_decode import _busy_us, _kernel_intervals

# kernel class -> substrings of the kernel name, first match wins
_CLASSES = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd", ("flash_bwd",)),
    ("matmul", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
    ("softmax", ("softmax",)),
    ("optimizer", ("multi_tensor", "foreach")),
)


def _class_of(name):
    low = name.lower()
    for cls, keys in _CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise_other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--impl", default="flash", choices=("flash", "plain"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=os.path.join("build",
                                                    "profile_train.json"))
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import transformer_lm
    from mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh

    # the first touch of the card, under the platform watchdog: a hung
    # or missing card exits with one parseable artifact line
    from mxnet_tpu_torch import platform

    platform.devices_or_exit(what="mxnet_tpu_torch/tools/profile_train.py")
    os.environ["MXNET_ATTENTION_IMPL"] = args.impl
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    mx.random.seed(0)
    lm = transformer_lm()
    lm.initialize()
    tr = ShardedTrainer(lm, SoftmaxCrossEntropyLoss(),
                        make_mesh({"dp": 1}, devices=[dev]),
                        optimizer="adam",
                        optimizer_params={"learning_rate": 1e-4},
                        compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 32000, (4, 2048)).astype(np.int64)).to(dev)

    def step():
        tr.step(x, x)
        torch.cuda.synchronize()

    for _ in range(2):
        step()
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            walls.append(time.perf_counter() - t0)
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)

    ivs = _kernel_intervals(args.trace)
    n = args.steps
    by_name, by_class = defaultdict(float), defaultdict(float)
    for s, e, name in ivs:
        by_name[name] += e - s
        by_class[_class_of(name)] += e - s
    wall_ms = 1e3 * float(np.mean(walls))
    busy_ms = _busy_us(ivs) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "tool": "profile_train", "impl": args.impl,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "batch": 4, "seq_len": 2048, "steps": n, "step_wall_ms": wall_ms,
        "step_wall_ms_all": [1e3 * w for w in walls],
        "device_busy_ms_per_step": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "kernels_per_step": len(ivs) / n,
        "ms_per_step_by_class": {k: v / 1e3 / n for k, v in
                                 sorted(by_class.items(),
                                        key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": [[k[:90], v / 1e3 / n] for k, v in top],
        "trace": args.trace}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
