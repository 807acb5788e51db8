"""Estimator, the high-level Gluon fit loop (counterpart of
``mxnet_tpu/gluon/contrib/estimator/estimator.py``): wraps net + loss +
metrics + Trainer, drives epochs/batches, and dispatches the event-handler
lifecycle (train_begin → [epoch_begin → [batch_begin → batch_end]* →
epoch_end]* → train_end). The train step is autograd.record + backward +
Trainer.step, the imperative path Gluon users write by hand. The default
MetricHandler's Loss metric reads the loss to the host every batch, as the
reference's does.
"""
from __future__ import annotations

import copy
import logging

from .... import autograd
from ....metric import EvalMetric, Loss as LossMetric
from ...trainer import Trainer
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, ValidationHandler)

__all__ = ["Estimator"]


class Estimator:
    def __init__(self, net, loss, metrics=None, initializer=None,
                 trainer=None, context=None):
        self.net = net
        self.loss = loss
        self.train_metrics = _as_metrics(metrics)
        # one Loss metric tracking the objective, like the reference
        if not any(isinstance(m, LossMetric) for m in self.train_metrics):
            self.train_metrics.append(LossMetric("loss"))
        self.val_metrics = [copy.deepcopy(m) for m in self.train_metrics]
        for m in self.val_metrics:
            m.name = "validation " + m.name
        self.context = context
        if initializer is not None:
            self.net.initialize(initializer)
        self.trainer = trainer or Trainer(
            net.collect_params(), "sgd", {"learning_rate": 0.001})
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        self.stop_training = False

    # ------------------------------------------------------------------
    def evaluate(self, val_data, batch_axis=0):
        for m in self.val_metrics:
            m.reset()
        for batch in val_data:
            data, label = _split_batch(batch)
            pred = self.net(data)
            loss = self.loss(pred, label)
            for m in self.val_metrics:
                if isinstance(m, LossMetric):
                    m.update(0, loss)
                else:
                    m.update(label, pred)
        return self.val_metrics

    # ------------------------------------------------------------------
    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        if epochs is None and batches is None:
            epochs = 1
        handlers = self._prepare_handlers(event_handlers, val_data, epochs,
                                          batches)
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = _sort_phases(handlers)

        self.stop_training = False
        for h in train_begin:
            h.train_begin(self)
        # train_end handlers hold cleanup that must not leak past an
        # aborted fit (checkpoint flushes): on an exception they still
        # run, and their own errors are logged so that cleanup cannot mask
        # the real failure
        unwinding = True
        try:
            while not self.stop_training:
                for h in epoch_begin:
                    h.epoch_begin(self)
                for batch in train_data:
                    data, label = _split_batch(batch)
                    for h in batch_begin:
                        h.batch_begin(self, batch=batch)
                    with autograd.record():
                        pred = self.net(data)
                        loss = self.loss(pred, label)
                    loss.backward()
                    self.trainer.step(_batch_size(data, batch_axis))
                    for h in batch_end:
                        if h.batch_end(self, batch=batch, pred=pred,
                                       label=label, loss=loss):
                            self.stop_training = True
                    if self.stop_training:
                        break
                for h in epoch_end:
                    if h.epoch_end(self):
                        self.stop_training = True
                if hasattr(train_data, "reset"):
                    train_data.reset()
            unwinding = False
        finally:
            for h in train_end:
                try:
                    h.train_end(self)
                except Exception:
                    if not unwinding:
                        raise
                    self.logger.warning("train_end handler failed during "
                                        "unwind", exc_info=True)
        return self.train_metrics

    # ------------------------------------------------------------------
    def _prepare_handlers(self, event_handlers, val_data, epochs, batches):
        handlers = list(event_handlers or [])
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(max_epoch=epochs,
                                            max_batch=batches))
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(self.train_metrics))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(metrics=self.train_metrics))
        return handlers


def _as_metrics(metrics):
    if metrics is None:
        return []
    metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
    for m in metrics:
        if not isinstance(m, EvalMetric):
            raise ValueError(f"metrics must be EvalMetric, got {type(m)}")
    return list(metrics)


def _split_batch(batch):
    if hasattr(batch, "data"):  # DataBatch from an io iterator
        return batch.data[0], batch.label[0]
    data, label = batch[0], batch[1]
    return data, label


def _batch_size(data, batch_axis):
    return data.shape[batch_axis]


def _sort_phases(handlers):
    def by_priority(hs):
        return sorted(hs, key=lambda h: getattr(h, "priority", 0))

    return (by_priority([h for h in handlers if isinstance(h, TrainBegin)]),
            by_priority([h for h in handlers if isinstance(h, EpochBegin)]),
            by_priority([h for h in handlers if isinstance(h, BatchBegin)]),
            by_priority([h for h in handlers if isinstance(h, BatchEnd)]),
            by_priority([h for h in handlers if isinstance(h, EpochEnd)]),
            by_priority([h for h in handlers if isinstance(h, TrainEnd)]))
