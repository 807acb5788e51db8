#!/usr/bin/env python
"""SSD object-detection training — baseline config 5 (the port's copy of
example/ssd/train.py).

Synthetic boxes stand in for VOC/COCO; MultiBoxTarget / SSDMultiBoxLoss /
MultiBoxDetection are the real ops. ``--device cuda`` (the default) trains
on the card and raises without one; ``--device cpu`` trains on the CPU.

Smoke test: python train.py --steps 3 --batch-size 4 --image-size 64
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.models import SSDMultiBoxLoss, ssd_300


def _parser():
    parser = argparse.ArgumentParser(description="SSD training")
    parser.add_argument("--num-classes", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--image-size", type=int, default=128)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--log-interval", type=int, default=5)
    parser.add_argument("--eval-batches", type=int, default=2,
                        help="post-training VOC07 mAP eval batches (0 disables)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    return parser


args = None


def make_batch(rng):
    imgs = rng.rand(args.batch_size, 3, args.image_size, args.image_size) \
        .astype(np.float32)
    # up to 3 ground-truth boxes per image: [cls, l, t, r, b] in [0,1]
    labels = np.full((args.batch_size, 3, 5), -1, np.float32)
    for b in range(args.batch_size):
        for k in range(rng.randint(1, 4)):
            cls = rng.randint(0, args.num_classes)
            x0, y0 = rng.rand(2) * 0.6
            w, h = 0.2 + rng.rand(2) * 0.2
            labels[b, k] = [cls, x0, y0, min(x0 + w, 1.0), min(y0 + h, 1.0)]
    return nd.array(imgs), nd.array(labels)


def main(argv=None):
    global args
    args = _parser().parse_args(argv)
    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    ctx.torch_device()  # no card: raises here, nothing runs on the CPU
    with ctx:
        train()


def train():
    mx.random.seed(0)
    net = ssd_300(num_classes=args.num_classes)
    net.initialize()
    rng = np.random.RandomState(0)
    x, labels = make_batch(rng)
    net(x)  # resolve shapes
    loss_fn = SSDMultiBoxLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": args.lr, "momentum": 0.9,
                                "wd": 5e-4})
    tic = time.time()
    for step in range(args.steps):
        x, labels = make_batch(rng)
        anchors, cls_preds, box_preds = net(x)
        with mx.autograd.pause():
            loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
                anchors, labels, cls_preds.transpose((0, 2, 1)))
        with mx.autograd.record():
            anchors, cls_preds, box_preds = net(x)
            loss = loss_fn(cls_preds, box_preds, cls_t, loc_t, loc_m)
        loss.backward()
        trainer.step(args.batch_size)
        if step % args.log_interval == 0 or step == args.steps - 1:
            ips = (step + 1) * args.batch_size / (time.time() - tic)
            print(f"step {step} loss {float(loss.asnumpy()):.4f} "
                  f"{ips:.1f} img/s", flush=True)

    dets = net.detect(x)
    valid = (dets[:, :, 0].asnumpy() >= 0).sum()
    print(f"detect: {valid} boxes kept after NMS across batch")

    # --- evaluation: VOC07 mAP over held-out synthetic batches (the
    # reference's SSD acceptance metric — example/ssd/evaluate) ---
    if args.eval_batches > 0:
        metric = mx.metric.VOC07MApMetric(ovp_thresh=0.5)
        eval_rng = np.random.RandomState(99)
        for _ in range(args.eval_batches):
            ex, elabels = make_batch(eval_rng)
            metric.update([elabels], [net.detect(ex)])
        name, value = metric.get()
        print(f"{name}: {value:.4f}", flush=True)


if __name__ == "__main__":
    main()
