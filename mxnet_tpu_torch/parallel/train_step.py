"""ShardedTrainer on one device: forward, backward and the optimizer update
of a training step.

Counterpart of ``mxnet_tpu/parallel/train_step.py``. The reference traces
the step into one sharded XLA program over a device mesh; here the step
runs eagerly on one device: the forward through
``torch.func.functional_call`` over the trainer's own parameter values,
the backward through ``torch.autograd`` (the attention's through the
flash kernels), and one multi-tensor update (``optimizer/fused.py``).

Semantics kept from the reference:

- the trainer works on private copies of the net's parameters, updated in
  place; ``net`` changes only at :meth:`sync_to_net`;
- ``compute_dtype`` casts the trainable weights and the floating inputs
  (not the labels) for the forward and backward; master weights, their
  gradients and the optimizer state stay f32 (no loss scaling);
- ``preprocess`` runs on each input before the cast; ``remat`` recomputes
  the forward during the backward (``torch.utils.checkpoint`` over the
  loss); ``grad_accum`` splits the batch into micro-batches, averages
  their gradients and applies one update;
- the loss is the mean of ``loss_fn``'s output; :meth:`step` returns it
  as a 0-d tensor on the device.

``mesh``, ``rules``, ``input_specs`` and ``label_specs`` take only None:
data and tensor parallelism over several cards belong to a later slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..base import MXNetError
from ..context import as_device
from ..optimizer import create as _opt_create
from ..optimizer.fused import lower_update

__all__ = ["ShardedTrainer"]

_SUPPORTED = ("sgd", "adam", "adamw")


class ShardedTrainer:
    """Train an ``nn.Module`` on one device.

    Usage::

        trainer = parallel.ShardedTrainer(
            net, gluon.loss.SoftmaxCrossEntropyLoss(), optimizer="adam",
            optimizer_params={"learning_rate": 1e-4},
            compute_dtype="bfloat16")
        for x, y in loader:
            loss = trainer.step(x, y)
        trainer.sync_to_net()             # write weights back
    """

    def __init__(self, net, loss_fn, mesh=None, rules=None,
                 optimizer: str = "sgd",
                 optimizer_params: Optional[Dict] = None, input_specs=None,
                 label_specs=None, grad_clip: float = -1.0,
                 donate: bool = True, compute_dtype=None,
                 preprocess: Optional[Callable] = None, remat: bool = False,
                 grad_accum: int = 1, *, device=None):
        if optimizer not in _SUPPORTED:
            raise ValueError(f"optimizer {optimizer!r} not in {_SUPPORTED}")
        for name, val in (("mesh", mesh), ("rules", rules),
                          ("input_specs", input_specs),
                          ("label_specs", label_specs)):
            if val is not None:
                raise MXNetError(f"ShardedTrainer: {name} must be None; "
                                 "meshes and sharding rules belong to a "
                                 "later slice of the port")
        self.net = net
        self.loss_fn = loss_fn
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
        self._t = 0

        params = dict(net.named_parameters())
        if not params:
            raise MXNetError("ShardedTrainer: the net has no parameters")
        first = next(iter(params.values()))
        self.device = (as_device(device) if device is not None
                       else first.device)
        # private copies, the reference's donated generation
        self.param_vals = {n: p.detach().to(self.device, copy=True)
                           for n, p in params.items()}
        self._grad_names = [n for n, p in params.items() if p.requires_grad]
        self._stat_names = set(params) - set(self._grad_names)
        self.opt_state = {n: self._opt_obj.create_state(n, self.param_vals[n])
                          for n in self._grad_names}

    # ------------------------------------------------------------------
    def _cast(self, x):
        cdt = self._compute_dtype
        if cdt is not None and x.is_floating_point():
            return x.to(cdt)
        return x

    def _prepare(self, batch):
        vals = [torch.as_tensor(b, device=self.device) for b in batch]
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
        out = torch.func.functional_call(self.net, full, tuple(batch[:-1]))
        outs = out if isinstance(out, tuple) else (out,)
        return torch.mean(self.loss_fn(*outs, batch[-1]))

    def _one(self, batch):
        leaves = {n: self.param_vals[n].detach().requires_grad_()
                  for n in self._grad_names}
        with torch.enable_grad():
            if self._remat:
                loss = checkpoint(self._loss, leaves, *batch,
                                  use_reentrant=False)
            else:
                loss = self._loss(leaves, *batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = [torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(self._grad_names, grads)]
        return loss.detach(), grads

    def value_and_grad(self, *batch):
        """The step's forward and backward without the update: (loss,
        {name: f32 gradient}) for batch = (*inputs, labels), averaged over
        ``grad_accum`` micro-batches."""
        batch = self._prepare(batch)
        accum = self._grad_accum
        if accum == 1:
            loss, grads = self._one(batch)
        else:
            for b in batch:
                if b.shape[0] % accum:
                    raise ValueError(f"grad_accum={accum} does not divide "
                                     f"batch dim {b.shape[0]}")
            micro = [b.chunk(accum) for b in batch]
            losses, grads = [], None
            for i in range(accum):
                loss_i, g_i = self._one([m[i] for m in micro])
                losses.append(loss_i)
                grads = g_i if grads is None else \
                    torch._foreach_add(grads, g_i)
            torch._foreach_div_(grads, float(accum))
            loss = torch.stack(losses).mean()
        return loss, dict(zip(self._grad_names, grads))

    def step(self, *batch):
        """batch = (*inputs, labels); returns the loss, a 0-d tensor on the
        trainer's device."""
        loss, grads = self.value_and_grad(*batch)
        self._t += 1
        o = self._opt
        names = self._grad_names
        lower_update(self._opt_obj, [self.param_vals[n] for n in names],
                     [grads[n] for n in names],
                     [self.opt_state[n] for n in names], lr=self._lr,
                     wd=o.get("wd", 0.0), t=self._t,
                     rescale=o.get("rescale_grad", 1.0))
        return loss

    # ------------------------------------------------------------------
    @property
    def learning_rate(self):
        return self._lr

    def set_learning_rate(self, lr):
        self._lr = float(lr)

    @torch.no_grad()
    def sync_to_net(self):
        """Copy the trained weights back into the net's parameters."""
        for n, p in self.net.named_parameters():
            p.copy_(self.param_vals[n])

    def block_until_ready(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
