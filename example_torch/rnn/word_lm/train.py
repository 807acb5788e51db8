#!/usr/bin/env python
"""PTB word language model training — baseline config 2 (the port's copy
of example/rnn/word_lm/train.py).

Reads a PTB-format text file (space-separated tokens) or generates
synthetic data with --benchmark. ``--device cuda`` (the default) trains on
the card and raises without one; ``--device cpu`` trains on the CPU.
Smoke test:  python train.py --benchmark 1 --epochs 1 --max-batches 4
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), '..', '..', '..')))
import mxnet_tpu_torch as mx
from model import RNNModel


def _parser():
    parser = argparse.ArgumentParser(description="PTB word LM")
    parser.add_argument("--data", type=str, default="./data/ptb.train.txt")
    parser.add_argument("--model", type=str, default="lstm",
                        choices=["lstm", "gru", "rnn_tanh", "rnn_relu"])
    parser.add_argument("--emsize", type=int, default=200)
    parser.add_argument("--nhid", type=int, default=200)
    parser.add_argument("--nlayers", type=int, default=2)
    parser.add_argument("--lr", type=float, default=1.0)
    parser.add_argument("--clip", type=float, default=0.2)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--bptt", type=int, default=35)
    parser.add_argument("--dropout", type=float, default=0.2)
    parser.add_argument("--log-interval", type=int, default=10)
    parser.add_argument("--benchmark", type=int, default=0)
    parser.add_argument("--max-batches", type=int, default=0)
    parser.add_argument("--vocab-size", type=int, default=10000)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    return parser


args = None


def load_corpus():
    if args.benchmark or not os.path.exists(args.data):
        rng = np.random.RandomState(0)
        return rng.randint(0, args.vocab_size, 20000).astype(np.int32), \
            args.vocab_size
    with open(args.data) as f:
        words = f.read().replace("\n", " <eos> ").split()
    vocab = {w: i for i, w in enumerate(sorted(set(words)))}
    return np.asarray([vocab[w] for w in words], np.int32), len(vocab)


def batchify(data, batch_size):
    nbatch = len(data) // batch_size
    return data[:nbatch * batch_size].reshape(batch_size, nbatch).T  # (T, N)


def detach(states):
    return [s.detach() for s in states]


def main(argv=None):
    global args
    args = _parser().parse_args(argv)
    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    ctx.torch_device()  # no card: raises here, nothing runs on the CPU
    with ctx:
        train()


def train():
    corpus, vocab_size = load_corpus()
    data = batchify(corpus, args.batch_size)
    model = RNNModel(args.model, vocab_size, args.emsize, args.nhid,
                     args.nlayers, args.dropout)
    model.initialize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": args.lr,
                                "clip_gradient": args.clip})

    for epoch in range(args.epochs):
        total_loss = 0.0
        nbatches = 0
        hidden = model.begin_state(args.batch_size)
        tic = time.time()
        for i in range(0, data.shape[0] - 1, args.bptt):
            if args.max_batches and nbatches >= args.max_batches:
                break
            seq_len = min(args.bptt, data.shape[0] - 1 - i)
            if seq_len < args.bptt:
                break  # keep every batch one shape
            x = mx.nd.array(data[i:i + seq_len])
            y = mx.nd.array(data[i + 1:i + 1 + seq_len].reshape(-1))
            hidden = detach(hidden)
            with mx.autograd.record():
                output, hidden = model(x, hidden)
                loss = loss_fn(output.reshape((-1, vocab_size)), y)
            loss.backward()
            trainer.step(args.batch_size * seq_len)
            total_loss += float(loss.mean().asnumpy())
            nbatches += 1
            if nbatches % args.log_interval == 0:
                cur = total_loss / nbatches
                wps = nbatches * args.batch_size * args.bptt / (time.time() - tic)
                print(f"epoch {epoch} batch {nbatches} loss {cur:.3f} "
                      f"ppl {math.exp(min(cur, 20)):.1f} {wps:.0f} wps",
                      flush=True)
        avg = total_loss / max(nbatches, 1)
        print(f"epoch {epoch} done: loss {avg:.3f} ppl "
              f"{math.exp(min(avg, 20)):.1f}", flush=True)


if __name__ == "__main__":
    main()
