"""Shared fit loop + flags (the port's copy of
example/image-classification/common/fit.py). ``--device cuda`` (the
default) trains on the card and raises without one; ``--device cpu``
trains on the CPU."""
from __future__ import annotations

import argparse
import logging
import time

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..", "..")))
import mxnet_tpu_torch as mx


def add_fit_args(parser: argparse.ArgumentParser):
    train = parser.add_argument_group("Training")
    train.add_argument("--network", type=str, default="resnet")
    train.add_argument("--num-layers", type=int, default=50)
    train.add_argument("--batch-size", type=int, default=128)
    train.add_argument("--num-epochs", type=int, default=1)
    train.add_argument("--lr", type=float, default=0.1)
    train.add_argument("--lr-step-epochs", type=str, default="30,60,80")
    train.add_argument("--lr-factor", type=float, default=0.1)
    train.add_argument("--mom", type=float, default=0.9)
    train.add_argument("--wd", type=float, default=1e-4)
    train.add_argument("--optimizer", type=str, default="sgd")
    train.add_argument("--kv-store", type=str, default="device")
    train.add_argument("--disp-batches", type=int, default=20)
    train.add_argument("--model-prefix", type=str, default=None)
    train.add_argument("--load-epoch", type=int, default=None)
    train.add_argument("--max-batches", type=int, default=0,
                       help="stop each epoch early (smoke tests)")
    train.add_argument("--dtype", type=str, default="float32")
    train.add_argument("--device", type=str, default="cuda",
                       choices=["cuda", "cpu"])
    return train


def context(args):
    """The context ``--device`` names; a card that is not there raises
    here (nothing falls back to the CPU)."""
    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    ctx.torch_device()
    return ctx


def fit(args, network, data_loader, **kwargs):
    """network: symbol; data_loader: (train, val) iters factory."""
    kv = None
    if args.kv_store and args.kv_store.startswith("dist"):
        kv = mx.kv.create(args.kv_store)
    train, val = data_loader(args, kv)
    if args.max_batches:
        train = mx.io.ResizeIter(train, args.max_batches)

    head = "%(asctime)-15s Node[0] %(message)s"
    logging.basicConfig(level=logging.INFO, format=head)

    epoch_size = max(args.num_examples // args.batch_size, 1)
    steps = [int(e) * epoch_size for e in args.lr_step_epochs.split(",") if e]
    lr_sched = mx.lr_scheduler.MultiFactorScheduler(step=steps,
                                                    factor=args.lr_factor) \
        if steps else None

    optimizer_params = {"learning_rate": args.lr, "wd": args.wd}
    if args.optimizer in ("sgd", "nag"):
        optimizer_params["momentum"] = args.mom
    if lr_sched is not None:
        optimizer_params["lr_scheduler"] = lr_sched

    mod = mx.mod.Module(symbol=network, context=mx.current_context())
    cbs = [mx.callback.Speedometer(args.batch_size, args.disp_batches)]
    epoch_cbs = []
    if args.model_prefix:
        epoch_cbs.append(mx.callback.do_checkpoint(args.model_prefix))
    mod.fit(train, eval_data=val, num_epoch=args.num_epochs,
            optimizer=args.optimizer, optimizer_params=optimizer_params,
            initializer=mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                       magnitude=2),
            batch_end_callback=cbs, epoch_end_callback=epoch_cbs,
            eval_metric=["acc"], kvstore=args.kv_store)
    return mod
