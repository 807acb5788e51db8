"""Gluon ``Trainer``: applies an optimizer to a set of Parameters
(counterpart of ``mxnet_tpu/gluon/trainer.py``).

``step(batch_size)`` sets ``rescale_grad = scale / batch_size``, reduces
the gradients through the kvstore and updates every parameter that has a
gradient in one multi-tensor pass (``optimizer.Updater.update_batch``),
with the global-norm clip and an attached AMP loss scaler folded into it.
``save_states``/``load_states`` write and read the reference's pickled
state layout atomically; ``get_checkpoint_state``/``set_checkpoint_state``
carry the slots and the counters ``save_states`` loses, for a
``checkpoint.CheckpointManager``.

``kvstore``: None, ``"device"`` or ``"local"`` reduce nothing (one
process, one logical copy per parameter); any other name
(``kvstore.create``: ``dist_sync``, ``dist_async``, ``nccl``, ...) or a
``KVStore`` object is made at the first step, each parameter is
``init``-ed on it, and every step pushes all gradients and pulls back
their sum. With ``update_on_kvstore=True`` the optimizer runs on the
store (``set_optimizer``) and the step pulls the updated weights; the
global-norm clip and an AMP loss scaler cannot ride that update and raise
``ValueError``. ``attach_health_monitor`` attaches the training-health
sentinel (``obs/health.py``): each update then computes the stats on the
steps it samples and feeds it.
"""
from __future__ import annotations

from .. import obs
from ..base import MXNetError
from ..checkpoint.atomic import atomic_write_bytes
from ..optimizer import Updater, create as opt_create

__all__ = ["Trainer"]

class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, clip_global_norm=None):
        if hasattr(params, "values"):
            params = list(params.values())
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
        self._kv_initialized = False
        self._clip_global_norm = clip_global_norm
        self._amp_loss_scaler = None
        self._health_monitor = None  # attach_health_monitor

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self):
        from ..kvstore import create as kv_create

        kind = self._kvstore_kind
        if kind is None or (isinstance(kind, str)
                            and kind in ("device", "local")):
            # one process, one logical copy per parameter: nothing to
            # reduce between processes
            self._kvstore = None
        else:
            # a store object gets the same keys (init ignores a key the
            # caller initialized already); the reference leaves them to
            # the caller and fails at the first push without them
            self._kvstore = kv_create(kind) if isinstance(kind, str) \
                else kind
            for i, p in enumerate(self._params):
                self._kvstore.init(i, p.data())
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
        if self._kvstore is not None and self._update_on_kvstore and \
                (self._clip_global_norm or self._amp_loss_scaler is not None):
            raise ValueError(
                "clip_global_norm / an attached AMP loss scaler are not "
                "supported with update_on_kvstore=True — the update runs "
                "server-side without them; set update_on_kvstore=False")
        self._kv_initialized = True

    # ------------------------------------------------------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by 1/batch_size, reduce, update."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        with obs.trace.span("allreduce"):
            self._allreduce_grads()
        with obs.trace.span("update"):
            self._update(ignore_stale_grad)

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One batched push and pull over every key: the store sums across
        processes (dist stores move them in one fused collective)."""
        if self._kvstore is None:
            return
        keys = list(range(len(self._params)))
        grads = [p.data().grad for p in self._params]
        self._kvstore.push(keys, grads)
        if not self._update_on_kvstore:
            self._kvstore.pull(keys, out=grads)

    def update(self, batch_size, ignore_stale_grad=False):
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        updater = self._updaters[0]
        if self._health_monitor is not None:
            from ..obs import health as health_mod

            # the stats only on sampled steps (the cost amortizes 1/K)
            health_mod.request_stats(self._health_monitor.will_sample())
        if self._kvstore is not None and self._update_on_kvstore:
            keys = list(range(len(self._params)))
            self._kvstore.pull(keys, out=[p.data() for p in self._params])
            return
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
            updater.update_batch(
                idxs, grads, weights, loss_scaler=self._amp_loss_scaler,
                clip_global_norm=self._clip_global_norm)
        if self._health_monitor is not None:
            # the sampled sentinel; an lr backoff applies in place, a
            # rollback needs a checkpoint manager and stays with the loop
            # that owns one
            self._health_monitor.step(
                engine=getattr(updater, "_engine", None),
                scaler=self._amp_loss_scaler, optimizer=self._optimizer)

    # ------------------------------------------------------------------
    def attach_health_monitor(self, monitor=True):
        """Attach the training-health sentinel (``obs/health.py``):
        ``True``, a kwargs dict or a ``HealthMonitor``; ``None`` detaches.
        While attached, the update computes the stats on the steps the
        monitor samples and ``step()`` feeds it; record the per-batch loss
        with ``monitor.record_loss(loss)`` (the estimator's
        ``HealthHandler`` does). Returns the monitor."""
        from ..obs import health as health_mod

        if self._health_monitor is not None:
            health_mod.deactivate()
            health_mod.request_stats(None)
            self._health_monitor = None
        mon = health_mod.as_monitor(monitor)
        if mon is not None:
            if mon.param_names is None:
                mon.attach_names([p.name for p in self._params])
            health_mod.activate()
            self._health_monitor = mon
        return mon

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
