"""Estimator event handlers (counterpart of
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``). Same mixin
contract: a handler subclasses any of the six phase mixins and the
Estimator calls it at that phase. ``CheckpointHandler`` writes through the
port's ``checkpoint/``; ``HealthHandler`` needs the training-health plane
(queue item A15) and raises."""
from __future__ import annotations

import logging
import os
import time

import numpy as np

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "EventHandler", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler", "HealthHandler"]


class EventHandler:
    pass


class TrainBegin(EventHandler):
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd(EventHandler):
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin(EventHandler):
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd(EventHandler):
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin(EventHandler):
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd(EventHandler):
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop on max_epoch / max_batch (reference StoppingHandler)."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch >= self.max_batch:
            self.stop_training = True
        return self.stop_training

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch >= self.max_epoch:
            self.stop_training = True
        return self.stop_training


class MetricHandler(EpochBegin, BatchEnd):
    """Reset metrics per epoch, update per batch (reference MetricHandler)."""

    def __init__(self, metrics, priority=-1000):
        self.metrics = metrics
        self.priority = priority

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs.get("pred")
        label = kwargs.get("label")
        loss = kwargs.get("loss")
        for m in self.metrics:
            if _is_loss_metric(m):
                m.update(0, loss)
            else:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation every N epochs/batches (reference ValidationHandler)."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.priority = priority
        self.current_batch = 0
        self.current_epoch = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Log throughput + metric values (reference LoggingHandler)."""

    LOG_PER_EPOCH = 1
    LOG_PER_BATCH = 2

    def __init__(self, log_interval="epoch", metrics=None, priority=float("inf")):
        self.metrics = metrics or []
        self.log_interval = log_interval
        self.priority = priority
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.time()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        t = time.time() - self.train_start
        self.logger.info("Train finished using total %ds", t)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.time()
        self.batch_index = 0
        self.processed_samples = 0

    def epoch_end(self, estimator, *args, **kwargs):
        t = time.time() - self.epoch_start
        msg = f"Epoch {self.current_epoch} finished in {t:.3f}s: "
        for m in self.metrics:
            name, value = m.get()
            msg += f"{name}: {_fmt(value)} "
        self.logger.info(msg)
        self.current_epoch += 1

    def batch_begin(self, estimator, *args, **kwargs):
        if self.log_interval == "batch" or isinstance(self.log_interval, int):
            self.batch_start = time.time()

    def batch_end(self, estimator, *args, **kwargs):
        interval = self.log_interval
        batch = kwargs.get("batch")
        if batch is not None and hasattr(batch, "data"):
            self.processed_samples += batch.data[0].shape[0]
        self.batch_index += 1
        if interval == "epoch":
            return
        every = 1 if interval == "batch" else int(interval)
        if self.batch_index % every == 0:
            t = time.time() - self.batch_start
            msg = f"[Epoch {self.current_epoch}][Batch {self.batch_index}]"
            msg += f"[Samples {self.processed_samples}] time/batch: {t:.3f}s "
            for m in self.metrics:
                name, value = m.get()
                msg += f"{name}: {_fmt(value)} "
            self.logger.info(msg)


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd, TrainEnd):
    """Save params (+trainer states) per epoch; keep the best by monitor.

    Two layers: the legacy per-tag ``.params`` /
    ``.states`` files (now written atomically), and a full-training-state
    :class:`~mxnet_tpu_torch.checkpoint.CheckpointManager` under the same
    directory — atomic rename commits, per-array CRC32, keep-last-N GC.
    ``resume_from_checkpoint=True`` restores the newest *valid* full-state
    checkpoint (net params + optimizer slots and counters + RNG streams) at
    ``train_begin``; corrupt checkpoints are skipped.
    """

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5, resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.resume_from_checkpoint = resume_from_checkpoint
        self.current_epoch = 0
        self.current_batch = 0
        self.saved = []
        self.resumed_from = None
        if mode == "auto" and monitor is not None:
            name = monitor.get()[0]
            mode = "max" if "acc" in name or "f1" in name else "min"
        self._cmp = (np.greater if mode == "max" else np.less)
        self.best = -np.inf if mode == "max" else np.inf
        os.makedirs(model_dir, exist_ok=True)
        from ....checkpoint import CheckpointManager

        self._manager = CheckpointManager(model_dir, prefix=model_prefix,
                                          keep_last=max_checkpoints)

    def train_begin(self, estimator, *args, **kwargs):
        if not self.resume_from_checkpoint:
            return
        from ....checkpoint.state import restore_rng
        from ....ndarray import NDArray

        state = self._manager.load_latest()
        if state is None:
            return
        # structural names (as save_parameters uses), NOT p.name: the gluon
        # auto-prefix counter differs in a fresh process, so dense0_weight
        # would never match the restarted net's dense1_weight
        params = estimator.net._collect_params_with_prefix()
        for name, arr in state.arg_params().items():
            if name in params:
                p = params[name]
                if p._data is None:
                    p.shape = arr.shape
                    p.initialize()
                p.set_data(NDArray(arr))
        if estimator.trainer is not None:
            estimator.trainer.set_checkpoint_state(
                {"arrays": state.arrays, "optimizer":
                 state.meta.get("optimizer", {})})
        restore_rng(state)
        self.current_epoch = state.meta.get("epochs_done", 0)
        self.current_batch = state.meta.get("batches_done", 0)
        self.resumed_from = state.global_step
        logging.info("CheckpointHandler: resumed from step %d "
                     "(%d epochs done)", state.global_step, self.current_epoch)

    def _save(self, estimator, tag):
        path = os.path.join(self.model_dir, f"{self.model_prefix}-{tag}.params")
        estimator.net.save_parameters(path)
        self.saved.append(path)
        if estimator.trainer is not None:
            try:
                estimator.trainer.save_states(path.replace(".params", ".states"))
            except Exception:
                pass

    def _save_full(self, estimator):
        from ....checkpoint.state import capture_training_state

        trainer = estimator.trainer
        updater = trainer._updaters[0] if trainer is not None else None
        optimizer = trainer._optimizer if trainer is not None else None
        state = capture_training_state(
            arg_params={name: p.data() for name, p in
                        estimator.net._collect_params_with_prefix().items()
                        if p._data is not None},
            updater=updater, optimizer=optimizer,
            global_step=self.current_batch,
            extra_meta={"epochs_done": self.current_epoch,
                        "batches_done": self.current_batch})
        self._manager.save(state, self.current_batch)

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(estimator, f"batch{self.current_batch}")
            self._save_full(estimator)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch - 1}")
            self._save_full(estimator)
        if self.save_best and self.monitor is not None:
            value = self.monitor.get()[1]
            if np.isscalar(value) and self._cmp(value, self.best):
                self.best = value
                self._save(estimator, "best")

    def train_end(self, estimator, *args, **kwargs):
        self._manager.flush()  # drain the async writer before exit


class HealthHandler(TrainBegin, BatchBegin, BatchEnd, TrainEnd):
    """The training-health sentinel in an Estimator fit. It needs the
    training-health plane (``obs/health.py``), queue item A15, which is
    not ported yet: constructing one raises."""

    def __init__(self, monitor=True, stop_on_nonfinite=False, priority=-500):
        from ....base import MXNetError

        raise MXNetError("HealthHandler: the training-health plane (queue "
                         "item A15) is not ported yet")


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when the monitored metric stops improving (reference analog)."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        name = monitor.get()[0]
        if mode == "auto":
            mode = "max" if "acc" in name or "f1" in name else "min"
        self._mode = mode

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stop_training = False
        self.best = -np.inf if self._mode == "max" else np.inf
        if self.baseline is not None:
            self.best = self.baseline

    def _improved(self, value):
        if self._mode == "max":
            return value > self.best + self.min_delta
        return value < self.best - self.min_delta

    def epoch_end(self, estimator, *args, **kwargs):
        value = self.monitor.get()[1]
        if not np.isscalar(value):
            return self.stop_training
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                self.stop_training = True
        self.current_epoch += 1
        return self.stop_training

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch > 0:
            logging.getLogger("mxnet_tpu_torch.estimator").info(
                "Epoch %d: early stopping", self.stopped_epoch)


def _is_loss_metric(m):
    from ....metric import Loss

    return isinstance(m, Loss)


def _fmt(v):
    return f"{v:.4f}" if np.isscalar(v) and np.isfinite(v) else str(v)
