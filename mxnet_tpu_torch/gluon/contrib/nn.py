"""``gluon.contrib.nn`` (counterpart of ``mxnet_tpu/gluon/contrib/nn.py``):
``SyncBatchNorm``, ``Identity``, ``HybridConcurrent`` and ``Concurrent``."""
from __future__ import annotations

from ..block import HybridBlock
from ..nn.basic_layers import BatchNorm

__all__ = ["SyncBatchNorm", "Identity", "HybridConcurrent", "Concurrent"]


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm through the ``SyncBatchNorm`` op: its
    variance is E[x^2] - E[x]^2, both moments over the global batch. On a
    mesh of several ranks (``parallel.ShardedTrainer``) the batch is a
    ``DTensor`` sharded over ``dp``, and the op's means reduce over every
    rank's rows, forward and backward; on one device it has BatchNorm's
    semantics. ``num_devices`` is accepted and unused, as the
    reference's."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", axis_name="dp",
                 **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         in_channels=in_channels, **kwargs)
        self._num_devices = num_devices
        self._axis_name = axis_name

    def _bn_op(self, F):
        return F.SyncBatchNorm, {"axis_name": self._axis_name}


class Identity(HybridBlock):
    """Passthrough block."""

    def hybrid_forward(self, F, x):
        return x


class HybridConcurrent(HybridBlock):
    """Feeds one input to every child and concatenates their outputs on
    ``axis`` (the Inception-branch combinator)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        outs = [b(x) for b in self._children.values()]
        return F.concat(*outs, dim=self._axis)


class Concurrent(HybridConcurrent):
    """The imperative alias of HybridConcurrent (the reference keeps
    both)."""
