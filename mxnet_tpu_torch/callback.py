"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``)."""
from __future__ import annotations

import logging
import time
from collections import namedtuple

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "module_checkpoint", "ProgressBar",
           "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


class Speedometer:
    """Log samples/sec every ``frequent`` batches (the number the baseline
    quotes — reference callback.Speedometer).

    Uses ``time.monotonic()`` (wall-clock steps from NTP would corrupt the
    rate) and guards the zero-elapsed division (``frequent=1`` fires on the
    first measured batch, which can land in the same clock tick). The
    reference's obs gauge of the rate belongs to the host planes (queue
    item A15).
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                elapsed = time.monotonic() - self.tic
                speed = (self.frequent * self.batch_size
                         / max(elapsed, 1e-9))
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s" % (
                        param.epoch, count, speed,
                        "\t".join(f"{n}={v:f}" for n, v in name_value))
                else:
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec" % (
                        param.epoch, count, speed)
                logging.info(msg)
                self.tic = time.monotonic()
        else:
            self.init = True
            self.tic = time.monotonic()


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (reference do_checkpoint)."""

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint

            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


module_checkpoint = do_checkpoint


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            logging.info("Iter[%d] Batch[%d] Train-%s", param.epoch, param.nbatch,
                         "\t".join(f"{n}={v:f}" for n, v in name_value))
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class ProgressBar:
    """Console progress bar callback (reference callback.ProgressBar)."""

    def __init__(self, total, length=80):
        self.total = max(1, int(total))
        self.length = int(length)

    def __call__(self, param):
        count = getattr(param, "nbatch", 0)
        filled = int(round(self.length * min(count, self.total) / self.total))
        bar = "=" * filled + "-" * (self.length - filled)
        import sys

        sys.stdout.write(f"\r[{bar}] {count}/{self.total}")
        sys.stdout.flush()
        if count >= self.total:
            sys.stdout.write("\n")
