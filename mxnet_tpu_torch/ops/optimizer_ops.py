"""Optimizer-update ops (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``).

Every update of the reference, registered under its op name, output count
and inputs, as the reference's pure function: the op returns new tensors,
so ``nd.sgd_update(w, g, lr=...)`` leaves ``w`` as it is and
``nd.sgd_update(w, g, out=w, lr=...)`` rebinds ``w`` to the result (the
classic imperative loop; ``optimizer.Optimizer.update`` calls them so).
The math, and the order of its terms, is the reference's: MXNet's Adam
adds wd to the gradient before the moments and keeps epsilon outside the
square root; its bias correction is folded into ``lr`` by the caller.
The updates: SGD (with momentum), NAG, the multi-precision ``mp_*``
updates, Adam, AdamW, RMSProp (plain and centered), FTRL, signSGD/Signum,
LAMB's two phases, AdaGrad, AdaDelta, FTML, AdaMax, Nadam, SGLD, LARS and
DCASGD, the multi-tensor ``multi_*`` updates and their
``preloaded_multi_*`` forms (lrs and wds as arrays). Scalars may be Python
numbers or 0-d tensors.
"""
from __future__ import annotations

import torch

from .elemwise import sign
from .registry import register

__all__ = ["sgld_noise", "lars_trust"]

_f32 = torch.float32


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient > 0:
        return torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _grad_prep(grad, wd, weight, rescale_grad, clip_gradient):
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


def _sgd_mom(weight, grad, mom, lr, momentum, wd, rescale_grad,
             clip_gradient):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * g
    return weight + mom, mom


@register("sgd_update", ndarray_inputs=["weight", "grad"])
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    return weight - lr * _grad_prep(grad, wd, weight, rescale_grad,
                                    clip_gradient)


@register("sgd_mom_update", num_outputs=2,
          ndarray_inputs=["weight", "grad", "mom"])
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    return _sgd_mom(weight, grad, mom, lr, momentum, wd, rescale_grad,
                    clip_gradient)


@register("adam_update", num_outputs=3,
          ndarray_inputs=["weight", "grad", "mean", "var"])
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    return weight - lr * mean / (torch.sqrt(var) + epsilon), mean, var


def _adamw(weight, grad, mean, var, lr, beta1, beta2, epsilon, wd, eta,
           rescale_grad, clip_gradient):
    g = _clip(grad * rescale_grad, clip_gradient)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - eta * (lr * mean / (torch.sqrt(var) + epsilon)
                        + wd * weight)
    return w, mean, var


@register("adamw_update", aliases=["_adamw_update", "_contrib_adamw_update"],
          num_outputs=3, ndarray_inputs=["weight", "grad", "mean", "var"])
def _adamw_update(weight, grad, mean, var, rescale_grad=None, lr=0.001,
                  beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                  clip_gradient=-1.0):
    """Adam with decoupled weight decay:
    w -= eta * (lr * mean / (sqrt(var) + eps) + wd * w)."""
    if hasattr(rescale_grad, "_data"):  # an NDArray passed as a kwarg
        rescale_grad = rescale_grad._data.reshape(())
    return _adamw(weight, grad, mean, var, lr, beta1, beta2, epsilon, wd,
                  eta, 1.0 if rescale_grad is None else rescale_grad,
                  clip_gradient)


@register("nag_mom_update", num_outputs=2,
          ndarray_inputs=["weight", "grad", "mom"])
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * g
    return weight + momentum * mom - lr * g, mom


@register("mp_sgd_update", num_outputs=2,
          ndarray_inputs=["weight", "grad", "weight32"])
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _grad_prep(grad.to(_f32), wd, weight32, rescale_grad,
                        clip_gradient)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_outputs=3,
          ndarray_inputs=["weight", "grad", "mom", "weight32"])
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    w32, mom = _sgd_mom(weight32, grad.to(_f32), mom, lr, momentum, wd,
                        rescale_grad, clip_gradient)
    return w32.to(weight.dtype), mom, w32


@register("rmsprop_update", num_outputs=2,
          ndarray_inputs=["weight", "grad", "n"])
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    n = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n


@register("rmspropalex_update", num_outputs=4,
          ndarray_inputs=["weight", "grad", "n", "g_", "delta"])
def _rmspropalex_update(weight, grad, n, g_, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    n = gamma1 * n + (1 - gamma1) * torch.square(g)
    g_ = gamma1 * g_ + (1 - gamma1) * g
    delta = gamma2 * delta - lr * g / torch.sqrt(n - torch.square(g_)
                                                 + epsilon)
    w = weight + delta
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, n, g_, delta


@register("ftrl_update", num_outputs=3,
          ndarray_inputs=["weight", "grad", "z", "n"])
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    n_new = n + torch.square(g)
    z = z + g - (torch.sqrt(n_new) - torch.sqrt(n)) / lr * weight
    w = torch.where(
        torch.abs(z) > lamda1,
        -(z - sign(z) * lamda1) / ((beta + torch.sqrt(n_new)) / lr
                                          + wd),
        torch.zeros_like(z))
    return w.to(weight.dtype), z, n_new


@register("signsgd_update", ndarray_inputs=["weight", "grad"])
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    return weight - lr * (sign(g) + wd * weight)


@register("signum_update", num_outputs=2,
          ndarray_inputs=["weight", "grad", "mom"])
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    mom = momentum * mom - (1 - momentum) * g
    return (1 - lr * wd_lh) * weight + lr * sign(mom), mom


def _lamb_states(grad, mean, var, beta1=0.9, beta2=0.999, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """LAMB's state advance, shared by the one- and multi-tensor ops."""
    g = _clip(grad * rescale_grad, clip_gradient)
    return (beta1 * mean + (1 - beta1) * g,
            beta2 * var + (1 - beta2) * torch.square(g))


@register("lamb_update_phase1",
          ndarray_inputs=["weight", "grad", "mean", "var"])
def _lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                        epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0):
    m, v = _lamb_states(grad, mean, var, beta1, beta2, rescale_grad,
                        clip_gradient)
    if bias_correction:
        m = m / (1 - beta1 ** t)
        v = v / (1 - beta2 ** t)
    return m / (torch.sqrt(v) + epsilon) + wd * weight


def _lamb_ratio(r1, r2, lower_bound, upper_bound):
    r1v, r2v = r1.reshape(()), r2.reshape(())
    if lower_bound is not None and lower_bound > 0:
        r1v = torch.clamp_min(r1v, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1v = torch.clamp_max(r1v, upper_bound)
    return torch.where((r1v > 0) & (r2v > 0), r1v / r2v,
                       torch.ones_like(r1v))


@register("lamb_update_phase2", ndarray_inputs=["weight", "g", "r1", "r2"])
def _lamb_update_phase2(weight, g, r1, r2, lr=0.01, lower_bound=-1.0,
                        upper_bound=-1.0):
    return weight - lr * _lamb_ratio(r1, r2, lower_bound, upper_bound) * g


@register("adagrad_update", aliases=["_sparse_adagrad_update"],
          num_outputs=2, ndarray_inputs=["weight", "grad", "history"])
def _adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    history = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(history) + epsilon), history


@register("adadelta_update", aliases=["adaalpha_update"], num_outputs=3,
          ndarray_inputs=["weight", "grad", "acc_g", "acc_delta"])
def _adadelta_update(weight, grad, acc_g, acc_delta, rho=0.9, epsilon=1e-5,
                     wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(acc_g + epsilon) * g
    acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta, acc_g, acc_delta


@register("ftml_update", num_outputs=4,
          ndarray_inputs=["weight", "grad", "d", "v", "z"])
def _ftml_update(weight, grad, d, v, z, lr=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    g = _clip(grad * rescale_grad + wd * weight, clip_grad)
    v = beta2 * v + (1 - beta2) * torch.square(g)
    d_new = (1 - beta1 ** t) / lr * (torch.sqrt(v / (1 - beta2 ** t))
                                     + epsilon)
    sigma = d_new - beta1 * d
    z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z / d_new, d_new, v, z


@register("adamax_update", num_outputs=3,
          ndarray_inputs=["weight", "grad", "mean", "inf_norm"])
def _adamax_update(weight, grad, mean, inf_norm, lr=0.002, beta1=0.9,
                   beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, t=1):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    mean = beta1 * mean + (1 - beta1) * g
    inf_norm = torch.maximum(beta2 * inf_norm, torch.abs(g))
    lr_t = lr / (1 - beta1 ** t)
    return weight - lr_t * mean / (inf_norm + epsilon), mean, inf_norm


@register("nadam_update", num_outputs=3,
          ndarray_inputs=["weight", "grad", "mean", "var"])
def _nadam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                  epsilon=1e-8, schedule_decay=0.004, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, t=1, m_schedule=1.0):
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    momentum_t = beta1 * (1 - 0.5 * 0.96 ** (t * schedule_decay))
    momentum_t1 = beta1 * (1 - 0.5 * 0.96 ** ((t + 1) * schedule_decay))
    m_sched = m_schedule * momentum_t
    m_sched_next = m_sched * momentum_t1
    g_prime = g / (1 - m_sched)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    m_prime = mean / (1 - m_sched_next)
    v_prime = var / (1 - beta2 ** t)
    m_bar = (1 - momentum_t) * g_prime + momentum_t1 * m_prime
    return weight - lr * m_bar / (torch.sqrt(v_prime) + epsilon), mean, var


def sgld_noise(weight, lr):
    """N(0, lr) noise shaped like ``weight``, from the framework stream of
    its device: the draw of one SGLD update."""
    from ..random import generator

    noise = torch.randn(weight.shape, generator=generator(weight.device),
                        device=weight.device, dtype=_f32).to(weight.dtype)
    return noise * (lr ** 0.5 if not torch.is_tensor(lr)
                    else torch.sqrt(lr.to(weight.dtype)))


@register("sgld_update", differentiable=False,
          ndarray_inputs=["weight", "grad"])
def _sgld_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Stochastic gradient Langevin dynamics: an SGD step plus N(0, lr)
    noise (matches the reference in distribution only)."""
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    return weight - 0.5 * lr * g + sgld_noise(weight, lr)


def lars_trust(weight, grad, eta, epsilon, wd, rescale_grad, clip_gradient):
    """LARS's per-tensor trust ratio eta ||w|| / (||g|| + wd ||w|| + eps),
    in f32 on the device (1 where either norm is 0)."""
    g = _clip(grad.to(_f32) * rescale_grad, clip_gradient)
    w_norm = torch.linalg.vector_norm(weight.to(_f32))
    g_norm = torch.linalg.vector_norm(g)
    return torch.where((w_norm > 0) & (g_norm > 0),
                       eta * w_norm / (g_norm + wd * w_norm + epsilon),
                       torch.ones_like(w_norm))


@register("lars_update", num_outputs=2,
          ndarray_inputs=["weight", "grad", "mom"])
def _lars_update(weight, grad, mom, lr=0.01, momentum=0.9, eta=0.001,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    trust = lars_trust(weight, grad, eta, epsilon, wd, rescale_grad,
                       clip_gradient)
    return _sgd_mom(weight, grad, mom, (lr * trust).to(weight.dtype),
                    momentum, wd, rescale_grad, clip_gradient)


@register("dcasgd_update", num_outputs=3,
          ndarray_inputs=["weight", "grad", "mom", "prev_weight"])
def _dcasgd_update(weight, grad, mom, prev_weight, lr=0.01, momentum=0.0,
                   lamda=0.04, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Delay-compensated async SGD: the delayed gradient is corrected with
    lamda g^2 (w - w_prev)."""
    g = _grad_prep(grad, wd, weight, rescale_grad, clip_gradient)
    comp = g + lamda * torch.square(g) * (weight - prev_weight)
    mom = momentum * mom - lr * comp
    return weight + mom, mom, weight


# ---------------------------------------------------------------------------
# Multi-tensor updates: inputs flattened as [w0, g0, (states0...), w1, ...],
# per-group lrs/wds lists; the outputs list every updated weight first,
# then each state slot (the reference's calling convention)
# ---------------------------------------------------------------------------

def _per_group(kwargs, name, i, default):
    v = kwargs.get(name, None)
    if v is None:
        return default
    if isinstance(v, (list, tuple)):
        return v[i]
    return v


def _multi(step, n_in, n_out_per, arrays, kwargs):
    num = int(kwargs.get("num_weights", len(arrays) // n_in))
    outs = [step(i, *arrays[i * n_in:(i + 1) * n_in]) for i in range(num)]
    flat = [o[j] if isinstance(o, tuple) else o
            for j in range(n_out_per) for o in outs]
    return tuple(flat) if len(flat) > 1 else flat[0]


def _multi_n_out(n_in, n_out_per):
    def n(kwargs):
        return int(kwargs["num_weights"]) * n_out_per \
            if "num_weights" in kwargs else n_out_per
    return n


def _common_kw(kwargs):
    return dict(rescale_grad=kwargs.get("rescale_grad", 1.0),
                clip_gradient=kwargs.get("clip_gradient", -1.0))


@register("multi_sgd_update", num_outputs=_multi_n_out(2, 1),
          ndarray_inputs="*")
def _multi_sgd_update(*arrays, **kwargs):
    def step(i, w, g):
        return _sgd_update(w, g, lr=_per_group(kwargs, "lrs", i, 0.01),
                           wd=_per_group(kwargs, "wds", i, 0.0),
                           **_common_kw(kwargs))
    return _multi(step, 2, 1, arrays, kwargs)


@register("multi_sgd_mom_update", num_outputs=_multi_n_out(3, 2),
          ndarray_inputs="*")
def _multi_sgd_mom_update(*arrays, **kwargs):
    def step(i, w, g, m):
        return _sgd_mom(w, g, m, _per_group(kwargs, "lrs", i, 0.01),
                        kwargs.get("momentum", 0.0),
                        _per_group(kwargs, "wds", i, 0.0),
                        **_common_kw(kwargs))
    return _multi(step, 3, 2, arrays, kwargs)


@register("multi_mp_sgd_update", num_outputs=_multi_n_out(3, 2),
          ndarray_inputs="*")
def _multi_mp_sgd_update(*arrays, **kwargs):
    def step(i, w, g, w32):
        return _mp_sgd_update(w, g, w32,
                              lr=_per_group(kwargs, "lrs", i, 0.01),
                              wd=_per_group(kwargs, "wds", i, 0.0),
                              **_common_kw(kwargs))
    return _multi(step, 3, 2, arrays, kwargs)


@register("multi_mp_sgd_mom_update", num_outputs=_multi_n_out(4, 3),
          ndarray_inputs="*")
def _multi_mp_sgd_mom_update(*arrays, **kwargs):
    def step(i, w, g, m, w32):
        return _mp_sgd_mom_update(w, g, m, w32,
                                  lr=_per_group(kwargs, "lrs", i, 0.01),
                                  momentum=kwargs.get("momentum", 0.0),
                                  wd=_per_group(kwargs, "wds", i, 0.0),
                                  **_common_kw(kwargs))
    return _multi(step, 4, 3, arrays, kwargs)


def _preloaded(base_fn, n_in):
    """preloaded_multi_*: lrs and wds arrive as arrays (the last two
    inputs) instead of Python lists."""
    def fn(*arrays, **kwargs):
        lrs, wds = arrays[-2], arrays[-1]
        body = arrays[:-2]
        num = int(kwargs.get("num_weights", len(body) // n_in))
        kw = dict(kwargs, num_weights=num,
                  lrs=[lrs.reshape(-1)[i] for i in range(num)],
                  wds=[wds.reshape(-1)[i] for i in range(num)])
        return base_fn(*body, **kw)
    return fn


for _name, _base, _n_in, _n_out in (
        ("preloaded_multi_sgd_update", _multi_sgd_update, 2, 1),
        ("preloaded_multi_sgd_mom_update", _multi_sgd_mom_update, 3, 2),
        ("preloaded_multi_mp_sgd_update", _multi_mp_sgd_update, 3, 2),
        ("preloaded_multi_mp_sgd_mom_update", _multi_mp_sgd_mom_update, 4,
         3)):
    register(_name, num_outputs=_multi_n_out(_n_in, _n_out),
             ndarray_inputs="*")(_preloaded(_base, _n_in))


@register("multi_lamb_update_phase1",
          aliases=["_multi_lamb_update_phase1"],
          num_outputs=_multi_n_out(4, 3), ndarray_inputs="*")
def _multi_lamb_phase1(*arrays, **kwargs):
    b1, b2 = kwargs.get("beta1", 0.9), kwargs.get("beta2", 0.999)

    def step(i, w, g, mean, var):
        m, v = _lamb_states(g, mean, var, beta1=b1, beta2=b2,
                            **_common_kw(kwargs))
        mb, vb = m, v
        if kwargs.get("bias_correction", True):
            t = _per_group(kwargs, "step_count", i,
                           _per_group(kwargs, "t", i, 1))
            mb = m / (1 - b1 ** t)
            vb = v / (1 - b2 ** t)
        upd = (mb / (torch.sqrt(vb) + kwargs.get("epsilon", 1e-6))
               + _per_group(kwargs, "wds", i, 0.0) * w)
        return upd, m, v
    return _multi(step, 4, 3, arrays, kwargs)


@register("multi_lamb_update_phase2",
          aliases=["_multi_lamb_update_phase2"],
          num_outputs=_multi_n_out(4, 1), ndarray_inputs="*")
def _multi_lamb_phase2(*arrays, **kwargs):
    def step(i, w, g, r1, r2):
        return _lamb_update_phase2(
            w, g, r1, r2, lr=_per_group(kwargs, "lrs", i, 0.01),
            lower_bound=kwargs.get("lower_bound", -1.0),
            upper_bound=kwargs.get("upper_bound", -1.0))
    return _multi(step, 4, 1, arrays, kwargs)


def _adamw_kw(kwargs, i):
    return dict(lr=_per_group(kwargs, "lrs", i, 0.01),
                beta1=kwargs.get("beta1", 0.9),
                beta2=kwargs.get("beta2", 0.999),
                epsilon=kwargs.get("epsilon", 1e-8),
                wd=_per_group(kwargs, "wds", i, 0.0),
                eta=_per_group(kwargs, "etas", i, kwargs.get("eta", 1.0)),
                **_common_kw(kwargs))


@register("multi_adamw_update", aliases=["_multi_adamw_update"],
          num_outputs=_multi_n_out(4, 3), ndarray_inputs="*")
def _multi_adamw_update(*arrays, **kwargs):
    def step(i, w, g, mean, var):
        return _adamw(w, g, mean, var, **_adamw_kw(kwargs, i))
    return _multi(step, 4, 3, arrays, kwargs)


@register("multi_mp_adamw_update", aliases=["_multi_mp_adamw_update"],
          num_outputs=_multi_n_out(5, 4), ndarray_inputs="*")
def _multi_mp_adamw_update(*arrays, **kwargs):
    def step(i, w, g, mean, var, w32):
        nw32, m, v = _adamw(w32, g.to(_f32), mean, var,
                            **_adamw_kw(kwargs, i))
        return nw32.to(w.dtype), m, v, nw32
    return _multi(step, 5, 4, arrays, kwargs)
