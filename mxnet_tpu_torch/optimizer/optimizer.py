"""Optimizers: thin state machines over the update ops (counterpart of
``mxnet_tpu/optimizer/optimizer.py``).

The reference's API and semantics: create by name, ``create_state`` /
``update(index, weight, grad, state)`` through the registered update ops
(``ops/optimizer_ops.py``) with ``out=`` rebinding the weight and state
arrays, per-index update counts from ``begin_num_update``, an lr
scheduler, lr/wd multipliers (by index, by name through
``param_idx2name``, or from the ``Parameter`` in ``param_dict``),
multi-precision (16-bit weights updated through an f32 master copy kept
in the state), and the ``Updater``, whose ``update_batch`` runs the whole
parameter set through the multi-tensor engine (``fused.py``) unless
``MXNET_FUSED_UPDATE=0`` selects the per-parameter eager oracle.

Weights and states may also be plain ``torch.Tensor``s (as
``parallel.ShardedTrainer`` keeps them): ``create_state`` then makes
tensors, and ``update`` writes the results into them in place.
``Updater.get_states``/``set_states`` use the reference's pickle layout
(a dict index -> nested tuples of numpy arrays), so a ``.states`` file
written by either package loads in the other.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from ..context import current_context
from ..ndarray import NDArray, array
from ..ndarray.ndarray import invoke
from ..ops import get_op

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "LAMB", "RMSProp",
           "AdaGrad", "AdaDelta", "Ftrl", "FTML", "Signum", "AdaMax",
           "Adamax", "Nadam", "SGLD", "DCASGD", "LARS", "create", "register",
           "Updater", "get_updater"]

_REGISTRY = {}
_HALF = (torch.float16, torch.bfloat16)


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    name = name.lower()
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def _tensor(x) -> torch.Tensor:
    return x._data if isinstance(x, NDArray) else x


def _zeros_like(weight):
    if isinstance(weight, NDArray):
        return NDArray(torch.zeros_like(weight._data.detach()),
                       ctx=weight._ctx)
    return torch.zeros_like(weight)


def _copy(weight):
    if isinstance(weight, NDArray):
        return NDArray(weight._data.detach().clone(), ctx=weight._ctx)
    return weight.detach().clone()


@torch.no_grad()
def _apply(op_name, inputs, kwargs, outs):
    """Run registered update ``op_name``: on NDArrays through ``invoke``
    with ``out=outs`` (rebinding them); on tensors by its function, the
    results written into ``outs`` in place."""
    if isinstance(inputs[0], NDArray):
        return invoke(op_name, inputs, {**kwargs, "out": outs})
    res = get_op(op_name).fn(*inputs, **kwargs)
    res = res if isinstance(res, tuple) else (res,)
    outs = outs if isinstance(outs, (list, tuple)) else (outs,)
    for o, r in zip(outs, res):
        o.copy_(r)
    return outs


class Optimizer:
    def __init__(self, learning_rate=0.01, rescale_grad=1.0,
                 clip_gradient=None, lr_scheduler=None, wd=0.0, momentum=0.0,
                 param_idx2name=None, multi_precision=False, param_dict=None,
                 begin_num_update=0, **kwargs):
        self.lr = learning_rate
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient if clip_gradient is not None \
            else -1.0
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.multi_precision = multi_precision
        self.num_update = begin_num_update
        self.begin_num_update = begin_num_update
        self._index_update_count = {}
        self.idx2name = param_idx2name or {}
        self.param_dict = param_dict or {}
        self.lr_mult = {}
        self.wd_mult = {}

    # -- bookkeeping -----------------------------------------------------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        p = self.param_dict.get(index)
        if p is not None:
            lr *= p.lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        p = self.param_dict.get(index)
        if p is not None:
            wd *= p.wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise RuntimeError("cannot set lr directly when lr_scheduler is "
                               "active")
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    # -- state -----------------------------------------------------------
    def _use_mp(self, weight):
        return bool(self.multi_precision) and _tensor(weight).dtype in _HALF

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self._use_mp(weight):
            w32 = weight.astype(np.float32) if isinstance(weight, NDArray) \
                else weight.detach().float()
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._use_mp(weight):
            inner_state, w32 = state
            if isinstance(grad, NDArray):
                g32 = grad.astype(np.float32)
            else:
                g32 = grad.float()
            self.update(index, w32, g32, inner_state)
            if isinstance(weight, NDArray):
                weight._set_data(w32._data.to(weight._data.dtype))
            else:
                weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    def _common(self, index):
        self._update_count(index)
        return self._get_lr(index), self._get_wd(index)

    def _base_kw(self, lr, wd):
        return {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad,
                "clip_gradient": self.clip_gradient}


@register
class SGD(Optimizer):
    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        kw = self._base_kw(*self._common(index))
        if state is not None:
            _apply("sgd_mom_update", [weight, grad, state],
                   {**kw, "momentum": self.momentum}, (weight, state))
        else:
            _apply("sgd_update", [weight, grad], kw, weight)


@register
class NAG(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        kw = self._base_kw(*self._common(index))
        _apply("nag_mom_update", [weight, grad, state],
               {**kw, "momentum": self.momentum}, (weight, state))


def _bias_coef(opt, t):
    return float(np.sqrt(1 - opt.beta2 ** t) / (1 - opt.beta1 ** t))


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd = self._common(index)
        lr *= _bias_coef(self, self._index_update_count[index])
        mean, var = state
        _apply("adam_update", [weight, grad, mean, var],
               {**self._base_kw(lr, wd), "beta1": self.beta1,
                "beta2": self.beta2, "epsilon": self.epsilon},
               (weight, mean, var))


@register
class AdamW(Optimizer):
    """Adam with decoupled weight decay (the contrib ``adamw_update``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    def update(self, index, weight, grad, state):
        lr, wd = self._common(index)
        lr *= _bias_coef(self, self._index_update_count[index])
        mean, var = state
        _apply("adamw_update", [weight, grad, mean, var],
               {**self._base_kw(lr, wd), "beta1": self.beta1,
                "beta2": self.beta2, "epsilon": self.epsilon, "eta": 1.0},
               (weight, mean, var))


@register
class LAMB(Optimizer):
    """Layer-wise adaptive large-batch optimizer (``lamb_update_phase1``
    and ``_phase2``)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound = lower_bound if lower_bound is not None else -1.0
        self.upper_bound = upper_bound if upper_bound is not None else -1.0
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        lr, wd = self._common(index)
        t = self._index_update_count[index]
        mean, var = state
        w, g, m, v = (_tensor(x) for x in (weight, grad, mean, var))
        op = get_op("lamb_update_phase1").fn
        direction = op(w, g, m, v, beta1=self.beta1, beta2=self.beta2,
                       epsilon=self.epsilon, t=t,
                       bias_correction=self.bias_correction, wd=wd,
                       rescale_grad=self.rescale_grad,
                       clip_gradient=self.clip_gradient)
        # phase 1 returns the direction only; the states advance on the
        # rescaled gradient, unclipped, as the reference's do
        gr = g * self.rescale_grad
        new_m = self.beta1 * m + (1 - self.beta1) * gr
        new_v = self.beta2 * v + (1 - self.beta2) * gr ** 2
        r1 = torch.linalg.vector_norm(w)
        r2 = torch.linalg.vector_norm(direction)
        new_w = get_op("lamb_update_phase2").fn(
            w, direction, r1, r2, lr=lr, lower_bound=self.lower_bound,
            upper_bound=self.upper_bound)
        _store((weight, mean, var), (new_w, new_m, new_v))


def _store(outs, news):
    """Write results into arrays (rebinding) or tensors (in place)."""
    for o, n in zip(outs, news):
        if isinstance(o, NDArray):
            o._set_data(n)
        else:
            o.copy_(n)


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self.clip_weights = clip_weights if clip_weights is not None \
            else -1.0

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return (_zeros_like(weight),)

    def update(self, index, weight, grad, state):
        base = {**self._base_kw(*self._common(index)),
                "gamma1": self.gamma1, "epsilon": self.epsilon,
                "clip_weights": self.clip_weights}
        if self.centered:
            n, g_, delta = state
            _apply("rmspropalex_update", [weight, grad, n, g_, delta],
                   {**base, "gamma2": self.gamma2}, (weight, n, g_, delta))
        else:
            (n,) = state
            _apply("rmsprop_update", [weight, grad, n], base, (weight, n))


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, eps=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _apply("adagrad_update", [weight, grad, state],
               {**self._base_kw(*self._common(index)),
                "epsilon": self.float_stable_eps}, (weight, state))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _, wd = self._common(index)
        acc_g, acc_d = state
        _apply("adadelta_update", [weight, grad, acc_g, acc_d],
               {"rho": self.rho, "epsilon": self.epsilon, "wd": wd,
                "rescale_grad": self.rescale_grad,
                "clip_gradient": self.clip_gradient},
               (weight, acc_g, acc_d))


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    def update(self, index, weight, grad, state):
        z, n = state
        _apply("ftrl_update", [weight, grad, z, n],
               {**self._base_kw(*self._common(index)),
                "lamda1": self.lamda1, "beta": self.beta}, (weight, z, n))


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    def update(self, index, weight, grad, state):
        lr, wd = self._common(index)
        d, v, z = state
        _apply("ftml_update", [weight, grad, d, v, z],
               {"lr": lr, "beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon,
                "t": self._index_update_count[index], "wd": wd,
                "rescale_grad": self.rescale_grad,
                "clip_grad": self.clip_gradient}, (weight, d, v, z))


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum != 0.0:
            return _zeros_like(weight)
        return None

    def update(self, index, weight, grad, state):
        kw = self._base_kw(*self._common(index))
        if state is not None:
            _apply("signum_update", [weight, grad, state],
                   {**kw, "momentum": self.momentum, "wd_lh": self.wd_lh},
                   (weight, state))
        else:
            _apply("signsgd_update", [weight, grad], kw, weight)


@register
class AdaMax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    def update(self, index, weight, grad, state):
        kw = self._base_kw(*self._common(index))
        mean, inf_norm = state
        _apply("adamax_update", [weight, grad, mean, inf_norm],
               {**kw, "beta1": self.beta1, "beta2": self.beta2,
                "t": self._index_update_count[index]},
               (weight, mean, inf_norm))


Adamax = AdaMax  # the reference exposes both spellings


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros_like(weight), _zeros_like(weight)

    def momentum_t(self, t):
        return self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))

    def update(self, index, weight, grad, state):
        kw = self._base_kw(*self._common(index))
        t = self._index_update_count[index]
        # a loss-scaled fused step keeps m_schedule on the device; the
        # eager path reads it back
        if not isinstance(self.m_schedule, float):
            self.m_schedule = float(_tensor(self.m_schedule))
        mean, var = state
        _apply("nadam_update", [weight, grad, mean, var],
               {**kw, "beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "t": t,
                "schedule_decay": self.schedule_decay,
                "m_schedule": self.m_schedule}, (weight, mean, var))
        self.m_schedule *= self.momentum_t(t)


@register
class SGLD(Optimizer):
    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        _apply("sgld_update", [weight, grad],
               self._base_kw(*self._common(index)), weight)


@register
class DCASGD(Optimizer):
    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return _zeros_like(weight), _copy(weight)

    def update(self, index, weight, grad, state):
        mom, prev = state
        _apply("dcasgd_update", [weight, grad, mom, prev],
               {**self._base_kw(*self._common(index)),
                "momentum": self.momentum, "lamda": self.lamda},
               (weight, mom, prev))


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling: the per-tensor trust ratio
    eta ||w|| / (||g|| + wd ||w|| + eps) scales the lr of a momentum step
    (norms on the device, no read of the host)."""

    def __init__(self, momentum=0.9, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _apply("lars_update", [weight, grad, state],
               {**self._base_kw(*self._common(index)),
                "momentum": self.momentum, "eta": self.eta,
                "epsilon": self.epsilon}, (weight, state))


_REGISTRY["adamax"] = AdaMax


class Updater:
    """Applies an optimizer to (index, grad, weight) triplets.

    ``update_batch`` is the fast path: the whole parameter set updates in
    one multi-tensor pass (``fused.FusedUpdateEngine``) unless
    ``MXNET_FUSED_UPDATE=0`` selects the per-parameter eager oracle;
    ``__call__`` stays per parameter.
    """

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}
        self._engine = None

    def _get_engine(self):
        if self._engine is None:
            from .fused import FusedUpdateEngine

            self._engine = FusedUpdateEngine(self.optimizer)
        return self._engine

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def prewarm_batch(self, indices, weights, loss_scaler=None,
                      clip_global_norm=None) -> bool:
        """Resolve the fused step for this parameter set WITHOUT running
        it on the real arrays (``FusedUpdateEngine.prewarm``): from the
        program cache, or filling it. The optimizer's counters, the
        weights and the states are untouched. The elastic rejoiner warms
        here while quarantined. Returns True when the step is resolved."""
        from .fused import fused_update_enabled

        if not fused_update_enabled() or len(set(indices)) != len(indices):
            return False
        eng = self._get_engine()
        if not eng.supported():
            return False
        # existing states are reused; missing ones are built locally and
        # dropped: only their structure and avals shape the program, and
        # keeping a state made from prewarm-time weights would seed the
        # real first update with a stale master copy
        states = [self.states[i] if i in self.states
                  else self.optimizer.create_state_multi_precision(i, w)
                  for i, w in zip(indices, weights)]
        grads = [w.zeros_like() for w in weights]
        return eng.prewarm(indices, weights, grads, states,
                           loss_scaler=loss_scaler,
                           clip_global_norm=clip_global_norm)

    def update_batch(self, indices, grads, weights, loss_scaler=None,
                     clip_global_norm=None):
        """Update a whole parameter set at once, with global-norm clipping
        and the loss scaler's unscale and found-inf skip."""
        from .fused import fused_update_enabled

        for i, w in zip(indices, weights):
            if i not in self.states:
                self.states[i] = \
                    self.optimizer.create_state_multi_precision(i, w)
        # a repeated index must apply sequentially: the multi-tensor pass
        # reads every pre-step value up front
        if fused_update_enabled() and len(set(indices)) == len(indices):
            eng = self._get_engine()
            if eng.supported():
                eng.apply(indices, weights, grads,
                          [self.states[i] for i in indices],
                          loss_scaler=loss_scaler,
                          clip_global_norm=clip_global_norm)
                return
        self._eager_batch(indices, grads, weights, loss_scaler,
                          clip_global_norm)

    def _eager_batch(self, indices, grads, weights, loss_scaler=None,
                     clip_global_norm=None):
        """The per-parameter oracle: the engine's semantics, one dispatch
        per op, host reads allowed."""
        opt = self.optimizer
        gs = list(grads)
        skip = False
        if loss_scaler is not None:
            scale = float(loss_scaler.loss_scale)
            if scale != 1.0:
                gs = [g * (1.0 / scale) for g in gs]
            skip = _grads_nonfinite(gs)
        if not skip and clip_global_norm is not None and \
                clip_global_norm > 0:
            rescale = float(opt.rescale_grad)
            sq = 0.0
            for g in gs:
                sq += float((g.astype(np.float32) * rescale).square().sum()
                            .asscalar())
            coef = min(1.0, float(clip_global_norm)
                       / (float(np.sqrt(np.float32(sq))) + 1e-6))
            if coef < 1.0:
                gs = [g * coef for g in gs]
        if skip:
            for i in indices:  # counters advance on skipped steps
                opt._update_count(i)
        else:
            for i, g, w in zip(indices, gs, weights):
                opt.update_multi_precision(i, w, g, self.states[i])
        if loss_scaler is not None:
            loss_scaler.loss_scale = float(loss_scaler.loss_scale)
            loss_scaler._unskipped = int(_tensor_scalar(
                getattr(loss_scaler, "_unskipped", 0)))
            loss_scaler.update_scale(skip)
            loss_scaler.last_overflow = skip
            prev = int(_tensor_scalar(getattr(loss_scaler, "skip_streak",
                                              0)))
            loss_scaler.skip_streak = prev + 1 if skip else 0

    def get_states(self, dump_optimizer=False):
        """The states as the reference pickles them: {index: nested tuples
        of numpy arrays} (bfloat16 slots as float32, numpy having no
        bfloat16)."""
        return pickle.dumps({k: _states_np(v) for k, v in
                             self.states.items()})

    def set_states(self, states, ctx=None):
        """Load pickled states; arrays land on ``ctx`` (default: the
        current context)."""
        loaded = pickle.loads(states)
        ctx = ctx or current_context()
        self.states = {k: _states_nd(v, ctx) for k, v in loaded.items()}


def _tensor_scalar(x):
    if isinstance(x, NDArray):
        return x.asscalar()
    if isinstance(x, torch.Tensor):
        return x.item()
    return x


def _grads_nonfinite(grads) -> bool:
    """One batched finiteness reduction over all gradients (one read)."""
    flags = torch.stack([torch.isfinite(_tensor(g).float()).all()
                         for g in grads])
    return not bool(flags.all())


def _states_np(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_states_np(x) for x in s)
    return np.asarray(s.asnumpy() if isinstance(s, NDArray)
                      else s.detach().float().cpu().numpy())


def _states_nd(s, ctx):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_states_nd(x, ctx) for x in s)
    return array(np.asarray(s, np.float32) if s.dtype.name == "bfloat16"
                 else s, ctx=ctx)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
