"""ShardedTrainer: forward, backward and the optimizer update of a Gluon
block's training step over a device mesh.

Counterpart of ``mxnet_tpu/parallel/train_step.py``. The reference traces
the step into one sharded XLA program; here the step runs eagerly: the
forward through :func:`functionalize` over the trainer's own parameter
values (the attention's through the flash kernels), the backward through
``torch.autograd.grad``, and one multi-tensor update
(``optimizer/fused.py``).

On a mesh of one device the values are plain tensors on it. On a mesh of
several ranks (one process each, ``parallel/mesh.py``) every rank runs
the same step over ``DTensor``s, PyTorch's counterpart of GSPMD's global
view: each parameter is placed by ``rules.sharding_for`` (rank 0's values
at capture, so replicas start equal), the batch, which every rank passes
whole, by ``input_specs``/``label_specs`` pruned by its shape, and the
collectives follow from the placements. So the loss is the mean over the
global batch, BatchNorm's statistics are the global batch's, the
attention layer takes each rank's shard (the ring over ``sp``), and the
gradients, which arrive ``Partial`` over ``dp``, are redistributed to
their parameter's placement; the update then runs on the matching local
shards, and the optimizer state is sharded as its parameter is. The step
runs under ``implicit_replication``, so a plain tensor that an op makes
on the side (a constant, a mask, a random draw) counts as replicated.

Semantics kept from the reference:

- the parameters are captured at construction, or at the first
  :meth:`step` when some shapes are deferred (one eager forward in
  predict mode resolves them); they are named by ``Parameter.name`` and
  those with ``grad_req != "null"`` are trained;
- the trainer works on private copies, updated in place; the net changes
  only at :meth:`sync_to_net`, which writes the whole (gathered) tensors
  into it on every rank;
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
  draws the same masks); ``grad_accum`` splits the global batch into
  micro-batches, each sharded like the batch, averages their gradients
  and applies one update;
- the loss is the mean of ``loss_fn``'s output; :meth:`step` returns it as
  a 0-d ``NDArray`` on this rank's device, equal on every rank;
- the step runs under ``mesh_scope``, so the attention layers find the
  mesh.

``mesh`` defaults to a one-device mesh over the parameters' device.
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
from .mesh import Mesh, make_mesh, mesh_scope
from .sharding import P, ShardingRules, batch_sharding, shard_local

__all__ = ["ShardedTrainer"]

_SUPPORTED = ("sgd", "adam", "adamw")


def _spec(spec):
    return spec if isinstance(spec, P) else P(*spec)


class ShardedTrainer:
    """Train a Gluon block over a mesh with dp/sp/tp shardings.

    Usage (every rank of the job runs the same code)::

        mesh = parallel.make_mesh({"dp": 2, "tp": 2})
        trainer = parallel.ShardedTrainer(
            net, loss_fn, mesh, rules=bert_sharding_rules(),
            optimizer="adam", optimizer_params={"learning_rate": 1e-4},
            compute_dtype="bfloat16")
        for x, y in loader:               # the global batch, on every rank
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
        self._input_spec = _spec(input_specs)
        self._label_spec = _spec(label_specs)
        self._dist = mesh.distributed
        if self._dist:
            mesh.device_mesh  # a mesh of several ranks needs their job
        self.device = mesh.local_device
        self._t = 0
        self._captured = False
        self._params = {}
        self._grad_names = []
        self._stat_names = set()
        self._shardings = {}
        self.param_vals = {}
        self.opt_state = {}
        # deferred shapes are resolved at the first step; capturing now
        # would leave those parameters out of training
        if not any(p._data is None for p in net._iter_params()):
            self._capture()

    # -- placement ------------------------------------------------------
    def _place(self, full, placements):
        """This rank's piece of ``full`` (a tensor every rank holds) as a
        ``DTensor`` with ``placements``."""
        return shard_local(full, self.mesh, placements)

    def _broadcast(self, tensors):
        """The first rank's values of ``tensors`` on every rank of the
        mesh, in place: one broadcast along each mesh dimension for each
        dtype."""
        import torch.distributed as dist

        dm = self.mesh.device_mesh
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            for i in range(dm.ndim):
                group = dm.get_group(i)
                dist.broadcast(flat, src=dist.get_global_rank(group, 0),
                               group=group)
            torch._foreach_copy_(ts, [f.view_as(t) for f, t in zip(
                flat.split([t.numel() for t in ts]), ts)])

    def _capture(self):
        """Snapshot the parameter set into private values placed on the
        mesh and create the optimizer state."""
        self._params = {p.name: p for p in self.net._iter_params()
                        if p._data is not None}
        self._grad_names = [n for n, p in self._params.items()
                            if p.grad_req != "null"]
        self._stat_names = set(self._params) - set(self._grad_names)
        _names, self._apply = functionalize(self.net, train=True)
        self._shardings = {
            n: self.rules.sharding_for(n, self.mesh, p.data().shape)
            for n, p in self._params.items()}
        vals = {n: p.data()._data.detach().to(self.device, copy=True)
                for n, p in self._params.items()}
        if self._dist:
            self._broadcast(list(vals.values()))
            vals = {n: self._place(v, self._shardings[n].placements)
                    for n, v in vals.items()}
        self.param_vals = vals
        self.opt_state = {n: self._new_state(n) for n in self._grad_names}
        self._captured = True

    def _new_state(self, name):
        """The optimizer state of ``name``, sharded as the parameter."""
        val = self.param_vals[name]
        if not self._dist:
            return self._opt_obj.create_state(name, val)
        from torch.distributed.tensor import DTensor

        def wrap(st):
            if isinstance(st, tuple):
                return tuple(wrap(x) for x in st)
            if isinstance(st, torch.Tensor):
                return DTensor.from_local(st, val.device_mesh,
                                          val.placements, run_check=False,
                                          shape=val.shape,
                                          stride=val.stride())
            return st

        return wrap(self._opt_obj.create_state(name, val.to_local()))

    # ------------------------------------------------------------------
    def _cast(self, x):
        cdt = self._compute_dtype
        if cdt is not None and x.is_floating_point():
            return x.to(cdt)
        return x

    def _prepare(self, batch):
        """The global batch on this rank's device, inputs preprocessed and
        cast (not yet placed)."""
        vals = [b._data if isinstance(b, NDArray) else torch.as_tensor(b)
                for b in batch]
        vals = [v.to(self.device) for v in vals]
        inputs, label = vals[:-1], vals[-1]
        if self._preprocess is not None:
            inputs = [self._preprocess(b) for b in inputs]
        return [self._cast(b) for b in inputs] + [label]

    def _place_batch(self, batch):
        """Shard a (micro-)batch over the mesh by the batch specs."""
        if not self._dist:
            return batch
        specs = [self._input_spec] * (len(batch) - 1) + [self._label_spec]
        return [self._place(b, batch_sharding(self.mesh, sp,
                                              tuple(b.shape)).placements)
                for b, sp in zip(batch, specs)]

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
        loss = torch.mean(loss._data)
        if self._dist:
            from torch.distributed.tensor import Replicate

            loss = loss.redistribute(loss.device_mesh,
                                     [Replicate()] * loss.device_mesh.ndim)
        return loss, aux

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
        if self._dist:
            # Partial over dp (and wherever the forward replicated)
            grads = [g.redistribute(g.device_mesh, leaves[n].placements)
                     for n, g in zip(self._grad_names, grads)]
        return loss.detach(), grads, aux

    def _scope(self):
        """The mesh scope, and on a mesh of several ranks implicit
        replication of plain tensors."""
        import contextlib

        stack = contextlib.ExitStack()
        stack.enter_context(mesh_scope(self.mesh))
        if self._dist:
            from torch.distributed.tensor.experimental import \
                implicit_replication

            stack.enter_context(implicit_replication())
        return stack

    def value_and_grad(self, *batch):
        """The step's forward and backward without the update: (loss,
        {name: gradient in the master dtype, placed as its parameter},
        {name: aux update}) for batch = (*inputs, labels), averaged over
        ``grad_accum`` micro-batches (the aux of the last one)."""
        if not self._captured:
            self._resolve_deferred(batch)
        batch = self._prepare(batch)
        accum = self._grad_accum
        with self._scope():
            if accum == 1:
                loss, grads, aux = self._one(self._place_batch(batch))
            else:
                for b in batch:
                    if b.shape[0] % accum:
                        raise ValueError(f"grad_accum={accum} does not "
                                         f"divide batch dim {b.shape[0]}")
                micro = [b.chunk(accum) for b in batch]
                losses, grads = [], None
                for i in range(accum):
                    loss_i, g_i, aux = self._one(
                        self._place_batch([m[i] for m in micro]))
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

    @staticmethod
    def _local(x):
        return x.to_local() if hasattr(x, "to_local") else x

    def _local_state(self, st):
        if isinstance(st, tuple):
            return tuple(self._local_state(x) for x in st)
        return self._local(st) if isinstance(st, torch.Tensor) else st

    def step(self, *batch):
        """batch = (*inputs, labels), the global batch (every rank passes
        the same); returns the loss, a 0-d NDArray on this rank's
        device."""
        loss, grads, aux = self.value_and_grad(*batch)
        self._t += 1
        o = self._opt
        names = self._grad_names
        with torch.no_grad():
            lower_update(self._opt_obj,
                         [self._local(self.param_vals[n]) for n in names],
                         [self._local(grads[n]) for n in names],
                         [self._local_state(self.opt_state[n])
                          for n in names], lr=self._lr,
                         wd=o.get("wd", 0.0), t=self._t,
                         rescale=o.get("rescale_grad", 1.0))
            for k, v in aux.items():
                dst = self.param_vals[k]
                if self._dist:
                    v = v.redistribute(dst.device_mesh, dst.placements)
                self._local(dst).copy_(self._local(v))
        return NDArray(self._local(loss))

    # ------------------------------------------------------------------
    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = float(lr)

    def sync_to_net(self):
        """Copy the trained weights back into the Gluon parameters, whole
        (every rank of the mesh calls it together)."""
        with autograd.pause():
            for n, p in self._params.items():
                v = self.param_vals[n]
                v = v.full_tensor() if self._dist else v.clone()
                p.data()._set_data(v)

    @property
    def step_cost(self):
        """The reference's device-plane record of the step program: the
        device plane's training capture sites are queue item A15 (the
        training half of its item 1) of the port."""
        raise MXNetError("ShardedTrainer.step_cost: the device plane's "
                         "training capture is queue item A15 (its "
                         "training half) of the port")

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
