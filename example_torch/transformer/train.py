#!/usr/bin/env python
"""Transformer NMT training + beam-search decode — baseline config 4 (the
port's copy of example/transformer/train.py).

Synthetic copy-task data stands in for WMT; the model/loss/decode path is
the real thing. ``--device cuda`` (the default) trains on the card and
raises without one; ``--device cpu`` trains on the CPU.

Smoke test: python train.py --steps 5 --batch-size 8 --seq-len 12 --units 64
"""
from __future__ import annotations

import argparse
import time

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..")))
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import (Seq2SeqTransformer, beam_search,
                                    label_smoothing_loss)


def _parser():
    parser = argparse.ArgumentParser(description="transformer NMT")
    parser.add_argument("--vocab-size", type=int, default=1000)
    parser.add_argument("--units", type=int, default=128)
    parser.add_argument("--hidden", type=int, default=256)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--seq-len", type=int, default=16)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--label-smoothing", type=float, default=0.1)
    parser.add_argument("--beam-size", type=int, default=4)
    parser.add_argument("--log-interval", type=int, default=10)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    return parser


args = None
BOS, EOS = 1, 2


def make_batch(rng):
    """Copy task: target = source (classic seq2seq sanity benchmark)."""
    src = rng.randint(3, args.vocab_size, (args.batch_size, args.seq_len)) \
        .astype(np.int32)
    tgt_in = np.concatenate([np.full((args.batch_size, 1), BOS, np.int32),
                             src[:, :-1]], axis=1)
    return mx.nd.array(src), mx.nd.array(tgt_in), mx.nd.array(src)


def main(argv=None):
    global args
    args = _parser().parse_args(argv)
    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    ctx.torch_device()  # no card: raises here, nothing runs on the CPU
    with ctx:
        train()


def train():
    mx.random.seed(0)
    net = Seq2SeqTransformer(src_vocab=args.vocab_size,
                             tgt_vocab=args.vocab_size, units=args.units,
                             hidden_size=args.hidden, num_layers=args.layers,
                             num_heads=args.heads, dropout=0.0,
                             max_length=max(64, args.seq_len))
    net.initialize()
    rng = np.random.RandomState(0)
    src, tgt_in, tgt_out = make_batch(rng)
    net(src, tgt_in)  # resolve shapes
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": args.lr})

    tic = time.time()
    for step in range(args.steps):
        src, tgt_in, tgt_out = make_batch(rng)
        with mx.autograd.record():
            logits = net(src, tgt_in)
            loss = label_smoothing_loss(logits, tgt_out,
                                        epsilon=args.label_smoothing)
        loss.backward()
        trainer.step(1)
        if step % args.log_interval == 0 or step == args.steps - 1:
            tps = (step + 1) * args.batch_size * args.seq_len / (time.time() - tic)
            print(f"step {step} loss {float(loss.asnumpy()):.4f} "
                  f"{tps:.0f} tok/s", flush=True)

    # beam-search decode a few sources
    out, scores = beam_search(net, src[:2], beam_size=args.beam_size,
                              max_length=args.seq_len + 2, bos=BOS, eos=EOS)
    print("beam output  :", out[0][:args.seq_len].tolist())
    print("beam source  :", src[:2].asnumpy()[0].tolist())
    print("beam scores  :", [float(s) for s in scores])


if __name__ == "__main__":
    main()
