"""One multi-tensor update per step.

Counterpart of ``lower_update`` in ``mxnet_tpu/optimizer/fused.py`` for
sgd, adam and adamw, the optimizers of ``parallel.ShardedTrainer``. The
reference lowers one parameter's update to pure JAX and lets XLA fuse
all of them into the step program. Here one call updates every parameter
in place with ``torch._foreach_*`` ops, a few multi-tensor kernels per
step instead of about ten small ones per parameter. The math is the
reference's, term for term: Adam's bias correction folded into lr as
``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``, wd added to the gradient
before the moments (``_grad_prep``), epsilon outside the square root;
AdamW decays the weights with ``eta``. Only the rounding order inside a
fused multiply-add may differ.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from .optimizer import SGD, Adam, AdamW

__all__ = ["lower_update"]

_LOWER: Dict[type, object] = {}


def _lower(cls):
    def deco(fn):
        _LOWER[cls] = fn
        return fn
    return deco


def _clipped(opt, grads, rescale):
    g = torch._foreach_mul(grads, rescale)
    if opt.clip_gradient is not None and opt.clip_gradient > 0:
        torch._foreach_clamp_min_(g, -opt.clip_gradient)
        torch._foreach_clamp_max_(g, opt.clip_gradient)
    return g


def _grad_prep(opt, ws, grads, wd, rescale):
    g = _clipped(opt, grads, rescale)
    torch._foreach_add_(g, ws, alpha=wd)  # g + wd * w
    return g


@_lower(SGD)
def _low_sgd(opt, ws, gs, states, lr, wd, t, rescale):
    g = _grad_prep(opt, ws, gs, wd, rescale)
    if states[0] is None:
        torch._foreach_add_(ws, g, alpha=-lr)
        return
    moms = list(states)
    torch._foreach_mul_(moms, opt.momentum)
    torch._foreach_add_(moms, g, alpha=-lr)  # momentum * mom - lr * g
    torch._foreach_add_(ws, moms)


def _moments(opt, g, states):
    means = [s[0] for s in states]
    var = [s[1] for s in states]
    torch._foreach_mul_(means, opt.beta1)
    torch._foreach_add_(means, g, alpha=1 - opt.beta1)
    torch._foreach_mul_(var, opt.beta2)
    torch._foreach_addcmul_(var, g, g, value=1 - opt.beta2)
    denom = torch._foreach_sqrt(var)
    torch._foreach_add_(denom, opt.epsilon)
    return means, denom


def _coef(opt, t):
    return math.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t)


@_lower(Adam)
def _low_adam(opt, ws, gs, states, lr, wd, t, rescale):
    g = _grad_prep(opt, ws, gs, wd, rescale)
    means, denom = _moments(opt, g, states)
    torch._foreach_addcdiv_(ws, means, denom, value=-lr * _coef(opt, t))


@_lower(AdamW)
def _low_adamw(opt, ws, gs, states, lr, wd, t, rescale):
    g = _clipped(opt, gs, rescale)
    means, denom = _moments(opt, g, states)
    upd = torch._foreach_div(means, denom)
    torch._foreach_mul_(upd, lr * _coef(opt, t))
    torch._foreach_add_(upd, ws, alpha=wd)  # lr * m / (sqrt(v) + eps) + wd w
    torch._foreach_add_(ws, upd, alpha=-1.0)  # eta = 1


@torch.no_grad()
def lower_update(opt, weights: List[torch.Tensor], grads: List[torch.Tensor],
                 states: list, lr, wd=0.0, t=1, rescale=1.0):
    """Apply one step of ``opt`` to every weight, in place.

    ``states`` holds one entry per weight in the layout of
    ``opt.create_state``: None (sgd), the momentum tensor (sgd with
    momentum) or (mean, var) (adam, adamw); they too update in place.
    ``t`` is the 1-based update count of Adam's bias correction. Returns
    (weights, states)."""
    fn = _LOWER.get(type(opt))
    if fn is None:
        raise NotImplementedError(
            f"no fused lowering for {type(opt).__name__}: the port has sgd, "
            "adam and adamw; the other optimizers belong to a later slice")
    weights, grads, states = list(weights), list(grads), list(states)
    if weights:
        fn(opt, weights, grads, states, float(lr), float(wd), float(t),
           float(rescale))
    return weights, states
