#!/usr/bin/env python
"""ResNet ImageNet training — baseline config 1 (the port's copy of
example/image-classification/train_imagenet.py, the Module path).

Run a smoke test without data (``--device cpu`` trains on the CPU; the
default is the card):
  python train_imagenet.py --benchmark 1 --batch-size 8 --num-layers 18 \
      --image-shape 3,64,64 --num-classes 10 --max-batches 3 --num-examples 64
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common import data, fit
from symbols import resnet


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="train imagenet",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    fit.add_fit_args(parser)
    data.add_data_args(parser)
    data.add_data_aug_args(parser)
    args = parser.parse_args(argv)

    with fit.context(args):
        net = resnet.get_symbol(args.num_classes, args.num_layers,
                                args.image_shape)
        fit.fit(args, net, data.get_rec_iter)


if __name__ == "__main__":
    main()
