"""Optimizer-update ops, in place.

Counterpart of the sgd/adam/adamw part of ``mxnet_tpu/ops/optimizer_ops.py``
(``_grad_prep``, ``sgd_update``, ``sgd_mom_update``, ``adam_update``,
``adamw_update``). The reference returns new arrays; these update the
weight and state tensors in place and return them, which saves a copy of
every parameter and optimizer slot per step. The math, and the order of
its terms, is the reference's: MXNet's Adam adds wd to the gradient
before the moments and keeps epsilon outside the square root; its bias
correction is folded into ``lr`` by the caller (``optimizer/fused.py``).
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "adam_update", "adamw_update"]


def _grad_prep(grad, wd, weight, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """weight -= lr * (clip(rescale * grad) + wd * weight)."""
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    return weight.sub_(lr * g)


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """mom = momentum * mom - lr * g; weight += mom. Returns both."""
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_(lr * g)
    return weight.add_(mom), mom


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """MXNet Adam step (no bias correction here). Returns (w, mean, var)."""
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * torch.square(g))
    weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))
    return weight, mean, var


@torch.no_grad()
def adamw_update(weight, grad, mean, var, rescale_grad=None, lr=0.001,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                 clip_gradient=-1.0):
    """Adam with decoupled weight decay:
    w -= eta * (lr * mean / (sqrt(var) + eps) + wd * w)."""
    g = grad * (1.0 if rescale_grad is None else rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * torch.square(g))
    weight.sub_(eta * (lr * mean / (torch.sqrt(var) + epsilon)
                       + wd * weight))
    return weight, mean, var
