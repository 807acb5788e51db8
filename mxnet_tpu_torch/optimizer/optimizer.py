"""Optimizers: thin state machines over the update ops.

Counterpart of the ``register``/``create``/``Optimizer``/``SGD``/``Adam``/
``AdamW`` part of ``mxnet_tpu/optimizer/optimizer.py``: create by name,
``create_state(index, weight)``, ``update(index, weight, grad, state)``
(in place, through ``ops/optimizer_ops.py``), per-index update counts and
``set_learning_rate``. The other optimizers, lr schedulers, lr/wd
multipliers, multi-precision and the ``Updater`` belong to a later
slice.
"""
from __future__ import annotations

import math

import torch

from ..ops import optimizer_ops as ops

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register"]

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    name = name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have "
                         f"{sorted(_REGISTRY)} (the others belong to a "
                         "later slice of the port)")
    return _REGISTRY[name](**kwargs)


class Optimizer:
    def __init__(self, learning_rate=0.01, rescale_grad=1.0,
                 clip_gradient=None, wd=0.0, **kwargs):
        self.lr = learning_rate
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient if clip_gradient is not None \
            else -1.0
        self.wd = wd
        self._index_update_count = {}

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _common(self, index):
        self._index_update_count[index] = \
            self._index_update_count.get(index, 0) + 1
        return self.lr, self.wd

    def _bias_coef(self, index):
        t = self._index_update_count[index]
        return math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)


@register
class SGD(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return torch.zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        lr, wd = self._common(index)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient)
        if state is not None:
            ops.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                               **kw)
        else:
            ops.sgd_update(weight, grad, **kw)


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd = self._common(index)
        mean, var = state
        ops.adam_update(weight, grad, mean, var,
                        lr=lr * self._bias_coef(index), beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                        rescale_grad=self.rescale_grad,
                        clip_gradient=self.clip_gradient)


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (reference contrib adamw_update)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd = self._common(index)
        mean, var = state
        ops.adamw_update(weight, grad, mean, var,
                         lr=lr * self._bias_coef(index), beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                         eta=1.0, rescale_grad=self.rescale_grad,
                         clip_gradient=self.clip_gradient)
