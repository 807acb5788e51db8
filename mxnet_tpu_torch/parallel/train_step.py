"""ShardedTrainer: forward, backward and the optimizer update of a Gluon
block's training step, on a one-device mesh.

Counterpart of ``mxnet_tpu/parallel/train_step.py``. The reference traces
the step into one sharded XLA program; here the step runs eagerly on the
mesh's device: the forward through :func:`functionalize` over the
trainer's own parameter values (the attention's through the flash
kernels), the backward through ``torch.autograd.grad``, and one
multi-tensor update (``optimizer/fused.py``).

Semantics kept from the reference:

- the parameters are captured at construction, or at the first
  :meth:`step` when some shapes are deferred (one eager forward in
  predict mode resolves them); they are named by ``Parameter.name`` and
  those with ``grad_req != "null"`` are trained;
- the trainer works on private copies, updated in place; the net changes
  only at :meth:`sync_to_net`;
- ``compute_dtype`` casts the trained weights and the floating inputs
  (not the labels) for the forward and backward; the ``grad_req="null"``
  statistics, master weights, their gradients and the optimizer state
  keep the master dtype (no loss scaling);
- the forward's aux updates (BatchNorm's running statistics) are merged
  back after the update, in the master dtype; under ``grad_accum`` they
  come from the last micro-batch;
- ``preprocess`` runs on each input before the cast; ``remat``
  recomputes the forward during the backward (``torch.utils.checkpoint``
  over the loss, the framework's random stream replayed so that dropout
  draws the same masks); ``grad_accum`` splits the batch into
  micro-batches, averages their gradients and applies one update;
- the loss is the mean of ``loss_fn``'s output; :meth:`step` returns it as
  a 0-d ``NDArray`` on the device.

``mesh`` (default: a one-device mesh over the parameters' device),
``rules``, ``input_specs`` and ``label_specs`` are accepted as the
reference takes them; on one device every spec places the whole array on
it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import autograd
from .. import random as _random
from ..base import MXNetError
from ..context import as_device
from ..ndarray import NDArray
from ..optimizer import create as _opt_create
from ..optimizer.fused import lower_update
from .functional import functionalize
from .mesh import Mesh, make_mesh
from .sharding import P, ShardingRules

__all__ = ["ShardedTrainer"]

_SUPPORTED = ("sgd", "adam", "adamw")


class ShardedTrainer:
    """Train a Gluon block on a one-device mesh.

    Usage::

        mesh = parallel.make_mesh({"dp": 1})
        trainer = parallel.ShardedTrainer(
            net, loss_fn, mesh, rules=bert_sharding_rules(),
            optimizer="adam", optimizer_params={"learning_rate": 1e-4},
            compute_dtype="bfloat16")
        for x, y in loader:
            loss = trainer.step(x, y)
        trainer.sync_to_net()             # write weights back
    """

    def __init__(self, net, loss_fn, mesh: Optional[Mesh] = None,
                 rules: Optional[ShardingRules] = None,
                 optimizer: str = "sgd",
                 optimizer_params: Optional[Dict] = None,
                 input_specs=P("dp"), label_specs=P("dp"),
                 grad_clip: float = -1.0, donate: bool = True,
                 compute_dtype=None, preprocess: Optional[Callable] = None,
                 remat: bool = False, grad_accum: int = 1):
        if optimizer not in _SUPPORTED:
            raise ValueError(f"optimizer {optimizer!r} not in {_SUPPORTED}")
        self.net = net
        self.loss_fn = loss_fn
        if mesh is None:
            first = next((p for p in net._iter_params()
                          if p._data is not None or p._deferred_init), None)
            if first is None:
                raise MXNetError("ShardedTrainer: the net has no "
                                 "initialized parameters")
            dev = (first.data()._data.device if first._data is not None
                   else first._deferred_init[1])
            mesh = make_mesh({"dp": 1}, devices=[as_device(dev)])
        self.mesh = mesh
        self.rules = rules or ShardingRules()
        opt = dict(optimizer_params or {})
        self._lr = float(opt.pop("learning_rate", opt.pop("lr", 0.01)))
        self._opt_name = optimizer
        self._opt = opt
        self._grad_clip = grad_clip
        self._opt_obj = _opt_create(
            optimizer, learning_rate=self._lr,
            clip_gradient=(grad_clip if grad_clip and grad_clip > 0
                           else None),
            **{k: v for k, v in opt.items() if k != "lr"})
        # updates are always in place; `donate` is accepted for the
        # reference's signature
        self._donate = donate
        self._compute_dtype = (getattr(torch, compute_dtype)
                               if isinstance(compute_dtype, str)
                               else compute_dtype)
        self._preprocess = preprocess
        self._remat = bool(remat)
        self._grad_accum = int(grad_accum)
        if self._grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        # on one device every batch spec places the whole batch on it
        self.device = mesh.devices.flat[0]
        self._t = 0
        self._captured = False
        self._params = {}
        self._grad_names = []
        self._stat_names = set()
        self.param_vals = {}
        self.opt_state = {}
        # deferred shapes are resolved at the first step; capturing now
        # would leave those parameters out of training
        if not any(p._data is None for p in net._iter_params()):
            self._capture()

    def _capture(self):
        """Snapshot the parameter set into private values on the mesh's
        device and create the optimizer state."""
        self._params = {p.name: p for p in self.net._iter_params()
                        if p._data is not None}
        self._grad_names = [n for n, p in self._params.items()
                            if p.grad_req != "null"]
        self._stat_names = set(self._params) - set(self._grad_names)
        _names, self._apply = functionalize(self.net, train=True)
        self.param_vals = {
            n: p.data()._data.detach().to(
                self.rules.sharding_for(n, self.mesh, p.data().shape).device,
                copy=True)
            for n, p in self._params.items()}
        self.opt_state = {n: self._opt_obj.create_state(n,
                                                        self.param_vals[n])
                          for n in self._grad_names}
        self._captured = True

    # ------------------------------------------------------------------
    def _cast(self, x):
        cdt = self._compute_dtype
        if cdt is not None and x.is_floating_point():
            return x.to(cdt)
        return x

    def _prepare(self, batch):
        vals = [b._data if isinstance(b, NDArray) else torch.as_tensor(b)
                for b in batch]
        vals = [v.to(self.device) for v in vals]
        inputs, label = vals[:-1], vals[-1]
        if self._preprocess is not None:
            inputs = [self._preprocess(b) for b in inputs]
        return [self._cast(b) for b in inputs] + [label]

    def _loss(self, grad_vals, *batch):
        full = dict(self.param_vals)
        full.update(grad_vals)
        if self._compute_dtype is not None:
            full = {k: (v if k in self._stat_names else self._cast(v))
                    for k, v in full.items()}
        out, aux = self._apply(full, *batch[:-1])
        outs = out if isinstance(out, tuple) else (out,)
        with autograd._Scope(True, None):
            loss = self.loss_fn(*[NDArray(o) for o in outs],
                                NDArray(batch[-1]))
        return torch.mean(loss._data), aux

    def _remat_loss(self, leaves, batch):
        """The loss under activation checkpointing. The recompute during
        the backward replays the framework's random stream from where the
        forward started, so dropout draws the same masks."""
        gen = _random.generator(self.device)
        start, calls = gen.get_state(), []

        def run(leaves, *batch):
            if calls:
                gen.set_state(start)
            calls.append(1)
            return self._loss(leaves, *batch)

        return checkpoint(run, leaves, *batch, use_reentrant=False)

    def _one(self, batch):
        leaves = {n: self.param_vals[n].detach().requires_grad_()
                  for n in self._grad_names}
        with torch.enable_grad():
            if self._remat:
                loss, aux = self._remat_loss(leaves, batch)
            else:
                loss, aux = self._loss(leaves, *batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(self._grad_names, grads)]
        return loss.detach(), grads, aux

    def value_and_grad(self, *batch):
        """The step's forward and backward without the update: (loss,
        {name: gradient in the master dtype}, {name: aux update}) for
        batch = (*inputs, labels), averaged over ``grad_accum``
        micro-batches (the aux of the last one)."""
        if not self._captured:
            self._resolve_deferred(batch)
        batch = self._prepare(batch)
        accum = self._grad_accum
        if accum == 1:
            loss, grads, aux = self._one(batch)
        else:
            for b in batch:
                if b.shape[0] % accum:
                    raise ValueError(f"grad_accum={accum} does not divide "
                                     f"batch dim {b.shape[0]}")
            micro = [b.chunk(accum) for b in batch]
            losses, grads = [], None
            for i in range(accum):
                loss_i, g_i, aux = self._one([m[i] for m in micro])
                losses.append(loss_i)
                grads = g_i if grads is None else \
                    torch._foreach_add(grads, g_i)
            torch._foreach_div_(grads, float(accum))
            loss = torch.stack(losses).mean()
        return loss, dict(zip(self._grad_names, grads)), aux

    def _resolve_deferred(self, batch):
        if any(p._data is None for p in self.net._iter_params()):
            # one throwaway eager forward in predict mode resolves them
            with autograd.pause():
                ins = [b._data if isinstance(b, NDArray)
                       else torch.as_tensor(b) for b in batch[:-1]]
                ins = [b.to(self.device) for b in ins]
                if self._preprocess is not None:
                    ins = [self._preprocess(b) for b in ins]
                self.net(*[NDArray(b) for b in ins])
        self._capture()

    def step(self, *batch):
        """batch = (*inputs, labels); returns the loss, a 0-d NDArray on
        the trainer's device."""
        loss, grads, aux = self.value_and_grad(*batch)
        self._t += 1
        o = self._opt
        names = self._grad_names
        lower_update(self._opt_obj, [self.param_vals[n] for n in names],
                     [grads[n] for n in names],
                     [self.opt_state[n] for n in names], lr=self._lr,
                     wd=o.get("wd", 0.0), t=self._t,
                     rescale=o.get("rescale_grad", 1.0))
        with torch.no_grad():
            for k, v in aux.items():
                self.param_vals[k].copy_(v)
        return NDArray(loss)

    # ------------------------------------------------------------------
    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = float(lr)

    def sync_to_net(self):
        """Copy the trained weights back into the Gluon parameters."""
        with autograd.pause():
            for n, p in self._params.items():
                p.data()._set_data(self.param_vals[n].clone())

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
