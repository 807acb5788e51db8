"""Gluon ``Trainer``: applies an optimizer to a set of Parameters
(counterpart of ``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, reduces
the gradients across devices (nothing to reduce on one device) and updates
every parameter that has a gradient in one multi-tensor pass
(``optimizer.Updater.update_batch``), with the global-norm clip and an
attached AMP loss scaler folded into it. ``save_states``/``load_states``
write and read the reference's pickled state layout atomically;
``get_checkpoint_state``/``set_checkpoint_state`` carry the slots and the
counters ``save_states`` loses, for a ``checkpoint.CheckpointManager``.

Only single-device stores exist in the port: ``kvstore`` ``None``,
``"device"`` or ``"local"``; the others are queue item A14. The health
monitor (A15) raises.
"""
from __future__ import annotations

from ..base import MXNetError
from ..checkpoint.atomic import atomic_write_bytes
from ..optimizer import Updater, create as opt_create

__all__ = ["Trainer"]

_LOCAL_STORES = (None, "device", "local")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, clip_global_norm=None):
        if hasattr(params, "values"):
            params = list(params.values())
        if not (kvstore in _LOCAL_STORES):
            raise MXNetError(f"Trainer: kvstore {kvstore!r}: distributed "
                             "and multi-device stores (queue item A14) are "
                             "not ported yet; use 'device', 'local' or None")
        self._params = [p for p in params if p.grad_req != "null"]
        self._all_params = list(params)
        self._scale = 1.0
        optimizer_params = optimizer_params or {}
        self._optimizer = opt_create(optimizer, param_dict={
            i: p for i, p in enumerate(self._params)}, **optimizer_params)
        self._updaters = [Updater(self._optimizer)]
        self._kvstore_kind = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._clip_global_norm = clip_global_norm
        self._amp_loss_scaler = None

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # ------------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by 1/batch_size, reduce, update."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One logical copy per parameter on one device: nothing to
        reduce."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        idxs, grads, weights = [], [], []
        for i, p in enumerate(self._params):
            g = p.data().grad
            if g is None:
                if ignore_stale_grad:
                    continue
                raise RuntimeError(f"Parameter {p.name} has no grad")
            idxs.append(i)
            grads.append(g)
            weights.append(p.data())
        if idxs:
            self._updaters[0].update_batch(
                idxs, grads, weights, loss_scaler=self._amp_loss_scaler,
                clip_global_norm=self._clip_global_norm)

    # ------------------------------------------------------------------
    def attach_health_monitor(self, monitor=True):
        raise MXNetError("Trainer.attach_health_monitor: the training-health "
                         "plane (queue item A15) is not ported yet")

    def save_states(self, fname):
        atomic_write_bytes(fname, self._updaters[0].get_states())

    def load_states(self, fname):
        with open(fname, "rb") as f:
            data = f.read()
        ctx = self._params[0].data().context if self._params else None
        self._updaters[0].set_states(data, ctx=ctx)

    def get_checkpoint_state(self):
        """Full optimizer snapshot for a CheckpointManager: slot arrays plus
        the scalar counters ``save_states`` loses (num_update and the
        per-index counts that drive Adam's bias correction)."""
        from ..checkpoint.state import capture_optimizer

        arrays = {}
        meta = capture_optimizer(self._updaters[0], self._optimizer, arrays)
        return {"arrays": arrays, "optimizer": meta}

    def set_checkpoint_state(self, state):
        from ..checkpoint.state import TrainingState, restore_optimizer

        ctx = self._params[0].data().context if self._params else None
        restore_optimizer(self._updaters[0], self._optimizer,
                          TrainingState(state["arrays"],
                                        {"optimizer": state["optimizer"]}),
                          ctx=ctx)
