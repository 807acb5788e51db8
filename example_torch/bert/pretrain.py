#!/usr/bin/env python
"""BERT-base MLM pretraining over a device mesh — baseline config 3 (the
port's copy of example/bert/pretrain.py).

``parallel.ShardedTrainer`` runs the step (forward, backward, gradient
reduction, Adam) over a dp x tp x sp mesh; ring attention engages when the
mesh has sp > 1. A port mesh is one process per device: run with a mesh
larger than one device, the script starts its own ranks (it re-runs
itself under ``python -m mxnet_tpu_torch.tools.launch -n <mesh size>``,
gloo on the CPU, the card shared round-robin with ``--device cuda``);
rank 0 prints and the job's exit code is the first nonzero rank's. A
launched rank does not launch again. ``--device cuda`` (the default)
trains on the card and raises without one; ``--device cpu`` trains on the
CPU.

Smoke test:
  python pretrain.py --model tiny --batch-size 8 --seq-len 32 --steps 3 \
      --mesh dp=2,sp=2,tp=2 --device cpu
"""
from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, _ROOT)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.kvstore.dist import join_process_group, launcher_rank
from mxnet_tpu_torch.models import (bert_base, bert_large, bert_sharding_rules,
                                    bert_tiny)


def _parser():
    parser = argparse.ArgumentParser(description="BERT pretraining (MLM)")
    parser.add_argument("--model", default="base",
                        choices=["tiny", "base", "large"])
    parser.add_argument("--vocab-size", type=int, default=30522)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--mesh", type=str, default="dp=-1",
                        help="mesh axes, e.g. dp=2,sp=2,tp=2 (-1 = rest)")
    parser.add_argument("--mask-prob", type=float, default=0.15)
    parser.add_argument("--log-interval", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    return parser


args = None


def make_batch(rng, vocab, bs, sl, mask_id=103):
    tokens = rng.randint(5, vocab, (bs, sl)).astype(np.int32)
    mask = rng.rand(bs, sl) < args.mask_prob
    inputs = tokens.copy()
    inputs[mask] = mask_id
    return mx.nd.array(inputs), mx.nd.array(tokens)


def _axes(spec):
    axes = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        axes[k.strip()] = int(v)
    return axes


def _launch(n, argv):
    """Re-run this script as ``n`` ranks of one job; the job's exit code."""
    env = dict(os.environ)
    for var in ("DMLC_NUM_WORKER", "DMLC_WORKER_ID", "MXNET_COORDINATOR",
                "MXNET_PS_ADDR", "MXNET_PS_PORT", "MXNET_ELASTIC"):
        env.pop(var, None)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if args.device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")
    return subprocess.call(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", str(n),
         sys.executable, os.path.abspath(__file__), *argv], env=env)


def main(argv=None):
    global args
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    size = math.prod(v for v in _axes(args.mesh).values() if v > 0)
    rank, world = launcher_rank()
    if size > 1 and world == 1:
        return _launch(size, argv)
    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    ctx.torch_device()  # no card: raises here, nothing runs on the CPU
    with ctx:
        if world > 1:
            join_process_group(rank, world, who="example/bert")
        train(print if rank == 0 else (lambda *a, **k: None))
    if world > 1:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    return 0


def train(say):
    mx.random.seed(0)
    builders = {"tiny": bert_tiny, "base": bert_base, "large": bert_large}
    kwargs = {"vocab_size": args.vocab_size, "dropout": 0.0,
              "max_length": max(args.seq_len, 128)}
    net = builders[args.model](**kwargs)
    net.initialize()

    mesh = par.make_mesh(_axes(args.mesh))
    say(f"mesh: {par.mesh_axes(mesh)}")

    rng = np.random.RandomState(0)
    x, y = make_batch(rng, args.vocab_size, args.batch_size, args.seq_len)
    net(x)  # resolve deferred shapes before sharding
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = par.ShardedTrainer(net, loss_fn, mesh, rules=bert_sharding_rules(),
                                 optimizer="adam",
                                 optimizer_params={"learning_rate": args.lr})

    loss = trainer.step(x, y)
    say(f"step 0 loss {float(loss.asnumpy()):.4f} (compile included)")
    tic = time.time()
    for step in range(1, args.steps):
        x, y = make_batch(rng, args.vocab_size, args.batch_size, args.seq_len)
        loss = trainer.step(x, y)
        if step % args.log_interval == 0 or step == args.steps - 1:
            lv = float(loss.asnumpy())
            dt = time.time() - tic
            sps = step * args.batch_size / dt
            say(f"step {step} loss {lv:.4f} {sps:.1f} seq/s", flush=True)
    trainer.sync_to_net()
    say("done")


if __name__ == "__main__":
    sys.exit(main())
