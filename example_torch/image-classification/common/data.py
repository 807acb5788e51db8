"""Shared data args/iterators (the port's copy of
example/image-classification/common/data.py)."""
from __future__ import annotations

import argparse

import numpy as np

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", "..", "..")))
import mxnet_tpu_torch as mx


def add_data_args(parser: argparse.ArgumentParser):
    data = parser.add_argument_group("Data")
    data.add_argument("--data-train", type=str, help="train .rec file")
    data.add_argument("--data-val", type=str, help="validation .rec file")
    data.add_argument("--image-shape", type=str, default="3,224,224")
    data.add_argument("--rgb-mean", type=str, default="123.68,116.779,103.939")
    data.add_argument("--rgb-std", type=str, default="1,1,1")
    data.add_argument("--num-classes", type=int, default=1000)
    data.add_argument("--num-examples", type=int, default=1281167)
    data.add_argument("--benchmark", type=int, default=0,
                      help="1 = synthetic data (no files needed)")
    data.add_argument("--data-nthreads", type=int, default=4)
    return data


def add_data_aug_args(parser):
    aug = parser.add_argument_group("Augmentation")
    aug.add_argument("--random-crop", type=int, default=1)
    aug.add_argument("--random-mirror", type=int, default=1)
    aug.add_argument("--resize", type=int, default=256)
    return aug


class SyntheticIter(mx.io.DataIter):
    """Device-resident synthetic batches (reference --benchmark 1 path)."""

    def __init__(self, batch_size, image_shape, num_classes, num_batches=50):
        super().__init__(batch_size)
        self.num_batches = num_batches
        rng = np.random.RandomState(0)
        self._data = mx.nd.array(rng.rand(batch_size, *image_shape)
                                 .astype(np.float32))
        self._label = mx.nd.array(rng.randint(0, num_classes, batch_size)
                                  .astype(np.float32))
        self._i = 0
        self.provide_data = [mx.io.DataDesc("data", (batch_size,) + image_shape)]
        self.provide_label = [mx.io.DataDesc("softmax_label", (batch_size,))]

    def reset(self):
        self._i = 0

    def next(self):
        if self._i >= self.num_batches:
            raise StopIteration
        self._i += 1
        return mx.io.DataBatch([self._data], [self._label], 0, None)


def get_rec_iter(args, kv=None):
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    if args.benchmark or not args.data_train:
        train = SyntheticIter(args.batch_size, image_shape, args.num_classes)
        val = None
        return train, val
    rank, nworker = (kv.rank, kv.num_workers) if kv else (0, 1)
    mean = [float(x) for x in args.rgb_mean.split(",")]
    std = [float(x) for x in args.rgb_std.split(",")]
    train = mx.io.ImageRecordIter(
        path_imgrec=args.data_train, data_shape=image_shape,
        batch_size=args.batch_size, shuffle=True,
        rand_crop=bool(args.random_crop), rand_mirror=bool(args.random_mirror),
        resize=args.resize, mean_r=mean[0], mean_g=mean[1], mean_b=mean[2],
        std_r=std[0], std_g=std[1], std_b=std[2],
        preprocess_threads=args.data_nthreads, part_index=rank,
        num_parts=nworker)
    val = None
    if args.data_val:
        val = mx.io.ImageRecordIter(
            path_imgrec=args.data_val, data_shape=image_shape,
            batch_size=args.batch_size, shuffle=False, resize=args.resize,
            mean_r=mean[0], mean_g=mean[1], mean_b=mean[2],
            std_r=std[0], std_g=std[1], std_b=std[2],
            preprocess_threads=args.data_nthreads, part_index=rank,
            num_parts=nworker)
    return train, val
