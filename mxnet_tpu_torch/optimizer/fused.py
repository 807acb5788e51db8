"""The multi-tensor update engine: one pass over every parameter a step.

Counterpart of ``mxnet_tpu/optimizer/fused.py``. The reference lowers each
optimizer to a pure JAX transform and compiles the whole step's update,
with global-norm clipping and the loss scaler's unscale and found-inf
skip, into one XLA program. Here each optimizer has a lowering over lists
(``_low_*``): it takes the weights, gradients and states of the whole
parameter set and returns new ones, mostly through ``torch._foreach_*``
ops, which update many tensors per kernel launch (the optimizers whose
step needs a per-tensor norm, a select or a random draw loop over the
parameters with the registered op's function). The math is the
registered update ops', term for term; only the rounding order inside a
fused multiply-add may differ.

``FusedUpdateEngine.apply`` adds the cross-parameter work on the device,
with no read of the host a step: the loss scaler's unscale, the found-inf
flag over every gradient, the global-norm clip, and on a skipped step the
old weights and states kept by a select, while the update counters still
advance and the scale halves. The scale, its window count and the skip
streak stay on the device between steps. ``MXNET_FUSED_UPDATE=0`` selects
the per-parameter eager oracle (``Updater._eager_batch``).

When the training-health plane asks for this step's stats
(``obs.health.stats_for_this_step()``), ``apply`` computes them in the
same pass and leaves them on the device as ``last_health`` (None when
off): the global grad norm (the clip's norms when clipping is on),
per-parameter grad, param and update norms, per-parameter non-finite
counts and, with a loss scaler, its found-inf flag and skip streak. A step
without stats dispatches exactly the operators of a step with the plane
off, and the weights are bitwise the same either way.

Device plane: the first run of each signature (optimizer and its
step-shaping hyperparameters, parameter and state avals, multi-precision,
scaler, clip, stats) is captured by ``obs.device.capture`` (site
``update``, label the optimizer's class name) into ``compile_log``; later
runs carry the analytic MFU on their ``update.fused`` span. The
element-wise update's operations are counted one per element produced
(``capture(pointwise=True)``).

Program cache (``progcache``, the process-global one): the signature's
``progcache.program_key`` is looked up at its first run. A hit marks the
``compile_log`` entry ``cache_hit``, adopts the stored cost instead of a
capture run and applies the step as always (bitwise the same update); a
miss writes the program's record. :meth:`FusedUpdateEngine.prewarm` (and
``Updater.prewarm_batch``) does the lookup, or fills the cache from a run
on copies, without touching weights, states or counters: what a
quarantined elastic rejoiner does while it waits.

Signature accounting (``compile_log``) runs while the device plane
captures, the program cache is armed, or a ``TraceLinter.watch`` block is
open (:func:`track_signatures`), whose ``check_update_engine`` reads the
entries' ``static``/``avals``/``state_structure``/``flags``; otherwise no
signature is built (zero cost when off).

``lower_update`` is the in-place form over tensor lists that
``parallel.ShardedTrainer`` calls.
"""
from __future__ import annotations

import contextlib
import copy
import math
import os
import threading
import time
from typing import Dict, List

import torch

from .. import obs
from .. import progcache as _progcache
from ..ndarray import NDArray
from ..ops import get_op
from ..ops.elemwise import sign
from ..ops.optimizer_ops import lars_trust, sgld_noise
from .optimizer import (DCASGD, FTML, LAMB, LARS, NAG, SGD, SGLD, AdaDelta,
                        AdaGrad, Adam, AdamW, AdaMax, Ftrl, Nadam, RMSProp,
                        Signum)

__all__ = ["FusedUpdateEngine", "fused_update_enabled", "lower_update",
           "supports"]


_TRACKING = [0]  # open track_signatures() scopes
_TRACKING_LOCK = threading.Lock()


@contextlib.contextmanager
def track_signatures():
    """Record every engine's new update signatures into its
    ``compile_log`` for the scope's duration, with the device plane and
    the program cache off (``TraceLinter.watch`` opens one)."""
    with _TRACKING_LOCK:
        _TRACKING[0] += 1
    try:
        yield
    finally:
        with _TRACKING_LOCK:
            _TRACKING[0] -= 1


def fused_update_enabled() -> bool:
    """``MXNET_FUSED_UPDATE``, read per call."""
    return os.environ.get("MXNET_FUSED_UPDATE", "1").lower() not in (
        "0", "false", "no", "off")


def _f(name):
    return get_op(name).fn


_LOWER: Dict[type, object] = {}


def _lower(cls):
    def deco(fn):
        _LOWER[cls] = fn
        return fn
    return deco


def supports(optimizer) -> bool:
    return type(optimizer) in _LOWER


# ---------------------------------------------------------------------------
# list helpers
# ---------------------------------------------------------------------------

def _prep(opt, gs, rescale, ws=None, wds=None):
    """clip(rescale * g) [+ wd * w], new tensors."""
    g = torch._foreach_mul(gs, rescale)
    if opt.clip_gradient is not None and opt.clip_gradient > 0:
        torch._foreach_clamp_min_(g, -opt.clip_gradient)
        torch._foreach_clamp_max_(g, opt.clip_gradient)
    if ws is not None:
        _add_scaled(g, ws, wds)
    return g


def _add_scaled(acc, xs, scalars):
    """acc += scalars[i] * xs[i], in place."""
    if len(set(scalars)) == 1:
        torch._foreach_add_(acc, xs, alpha=scalars[0])
    else:
        torch._foreach_add_(acc, torch._foreach_mul(xs, scalars))


def _ema(xs, ys, decay):
    """decay * x + (1 - decay) * y, new tensors."""
    out = torch._foreach_mul(xs, decay)
    torch._foreach_add_(out, ys, alpha=1 - decay)
    return out


def _ema_sq(xs, ys, decay):
    """decay * x + (1 - decay) * y^2, new tensors."""
    out = torch._foreach_mul(xs, decay)
    torch._foreach_addcmul_(out, ys, ys, value=1 - decay)
    return out


def _neg(scalars):
    return [-s for s in scalars]


def _per_param(op_name, ws, gs, sts, kws):
    """The registered op applied parameter by parameter; ``kws`` holds one
    kwargs dict per parameter. Returns (new weights, new states)."""
    fn = _f(op_name)
    new_ws, new_sts = [], []
    for w, g, st, kw in zip(ws, gs, sts, kws):
        states = () if st is None else (st if isinstance(st, tuple)
                                        else (st,))
        out = fn(w, g, *states, **kw)
        out = out if isinstance(out, tuple) else (out,)
        new_ws.append(out[0])
        rest = out[1:]
        new_sts.append(None if st is None else
                       (tuple(rest) if isinstance(st, tuple) else rest[0]))
    return new_ws, new_sts


# ---------------------------------------------------------------------------
# lowerings: (opt, ws, gs, states, lrs, wds, ts, rescale, ex)
#            -> (new ws, new states, ex)
# ---------------------------------------------------------------------------

@_lower(SGD)
def _low_sgd(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    torch._foreach_mul_(g, lrs)  # lr * g
    if sts[0] is None:
        return torch._foreach_sub(ws, g), sts, ex
    moms = torch._foreach_mul(list(sts), opt.momentum)
    torch._foreach_sub_(moms, g)  # momentum * mom - lr * g
    return torch._foreach_add(ws, moms), moms, ex


@_lower(NAG)
def _low_nag(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    torch._foreach_mul_(g, lrs)
    moms = torch._foreach_mul(list(sts), opt.momentum)
    torch._foreach_sub_(moms, g)
    new_ws = torch._foreach_add(ws, moms, alpha=opt.momentum)
    torch._foreach_sub_(new_ws, g)  # w + momentum * mom - lr * g
    return new_ws, moms, ex


def _adam_coefs(opt, lrs, ts):
    return [lr * math.sqrt(1.0 - opt.beta2 ** t) / (1.0 - opt.beta1 ** t)
            for lr, t in zip(lrs, ts)]


def _adam_moments(opt, g, sts):
    means = _ema([s[0] for s in sts], g, opt.beta1)
    var = _ema_sq([s[1] for s in sts], g, opt.beta2)
    denom = torch._foreach_sqrt(var)
    torch._foreach_add_(denom, opt.epsilon)
    return means, var, denom


@_lower(Adam)
def _low_adam(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    means, var, denom = _adam_moments(opt, g, sts)
    new_ws = torch._foreach_addcdiv(ws, means, denom,
                                    _neg(_adam_coefs(opt, lrs, ts)))
    return new_ws, list(zip(means, var)), ex


@_lower(AdamW)
def _low_adamw(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale)
    means, var, denom = _adam_moments(opt, g, sts)
    upd = torch._foreach_div(means, denom)
    torch._foreach_mul_(upd, _adam_coefs(opt, lrs, ts))
    _add_scaled(upd, ws, wds)  # lr m / (sqrt(v) + eps) + wd w
    return torch._foreach_sub(ws, upd), list(zip(means, var)), ex


@_lower(LAMB)
def _low_lamb(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    gr = torch._foreach_mul(gs, rescale)
    g = _prep(opt, gs, rescale)
    ms, vs = [s[0] for s in sts], [s[1] for s in sts]
    m_dir, v_dir = _ema(ms, g, opt.beta1), _ema_sq(vs, g, opt.beta2)
    if opt.bias_correction:
        torch._foreach_div_(m_dir, [1 - opt.beta1 ** t for t in ts])
        torch._foreach_div_(v_dir, [1 - opt.beta2 ** t for t in ts])
    denom = torch._foreach_sqrt(v_dir)
    torch._foreach_add_(denom, opt.epsilon)
    direction = torch._foreach_div(m_dir, denom)
    _add_scaled(direction, ws, wds)
    # the states advance on the rescaled gradient, unclipped
    new_m, new_v = _ema(ms, gr, opt.beta1), _ema_sq(vs, gr, opt.beta2)
    r1 = torch._foreach_norm(ws)
    r2 = torch._foreach_norm(direction)
    phase2 = _f("lamb_update_phase2")
    new_ws = [phase2(w, d, a, b, lr=lr, lower_bound=opt.lower_bound,
                     upper_bound=opt.upper_bound)
              for w, d, a, b, lr in zip(ws, direction, r1, r2, lrs)]
    return new_ws, list(zip(new_m, new_v)), ex


@_lower(RMSProp)
def _low_rmsprop(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    n = _ema_sq([s[0] for s in sts], g, opt.gamma1)
    if opt.centered:
        g_ = _ema([s[1] for s in sts], g, opt.gamma1)
        denom = torch._foreach_mul(g_, g_)
        torch._foreach_sub_(denom, n)
        torch._foreach_neg_(denom)  # n - g_^2
        torch._foreach_add_(denom, opt.epsilon)
        torch._foreach_sqrt_(denom)
        delta = torch._foreach_mul([s[2] for s in sts], opt.gamma2)
        torch._foreach_addcdiv_(delta, g, denom, _neg(lrs))
        new_ws = torch._foreach_add(ws, delta)
        new_sts = list(zip(n, g_, delta))
    else:
        denom = torch._foreach_add(n, opt.epsilon)
        torch._foreach_sqrt_(denom)
        new_ws = torch._foreach_addcdiv(ws, g, denom, _neg(lrs))
        new_sts = [(x,) for x in n]
    if opt.clip_weights is not None and opt.clip_weights > 0:
        torch._foreach_clamp_min_(new_ws, -opt.clip_weights)
        torch._foreach_clamp_max_(new_ws, opt.clip_weights)
    return new_ws, new_sts, ex


@_lower(AdaGrad)
def _low_adagrad(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    hist = torch._foreach_addcmul(list(sts), g, g)
    denom = torch._foreach_sqrt(hist)
    torch._foreach_add_(denom, opt.float_stable_eps)
    return torch._foreach_addcdiv(ws, g, denom, _neg(lrs)), hist, ex


@_lower(AdaDelta)
def _low_adadelta(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    acc_g = _ema_sq([s[0] for s in sts], g, opt.rho)
    num = torch._foreach_add([s[1] for s in sts], opt.epsilon)
    torch._foreach_sqrt_(num)
    den = torch._foreach_add(acc_g, opt.epsilon)
    torch._foreach_sqrt_(den)
    delta = torch._foreach_div(num, den)
    torch._foreach_mul_(delta, g)
    acc_d = _ema_sq([s[1] for s in sts], delta, opt.rho)
    return torch._foreach_sub(ws, delta), list(zip(acc_g, acc_d)), ex


@_lower(Ftrl)
def _low_ftrl(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    kws = [dict(lr=lr, lamda1=opt.lamda1, beta=opt.beta, wd=wd,
                rescale_grad=rescale, clip_gradient=opt.clip_gradient)
           for lr, wd in zip(lrs, wds)]
    new_ws, new_sts = _per_param("ftrl_update", ws, gs, sts, kws)
    return new_ws, new_sts, ex


@_lower(FTML)
def _low_ftml(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = torch._foreach_mul(gs, rescale)
    _add_scaled(g, ws, wds)
    if opt.clip_gradient is not None and opt.clip_gradient > 0:
        torch._foreach_clamp_min_(g, -opt.clip_gradient)
        torch._foreach_clamp_max_(g, opt.clip_gradient)
    ds, vs, zs = ([s[i] for s in sts] for i in range(3))
    v = _ema_sq(vs, g, opt.beta2)
    d_new = torch._foreach_div(v, [1 - opt.beta2 ** t for t in ts])
    torch._foreach_sqrt_(d_new)
    torch._foreach_add_(d_new, opt.epsilon)
    torch._foreach_mul_(d_new, [(1 - opt.beta1 ** t) / lr
                                for t, lr in zip(ts, lrs)])
    sigma = torch._foreach_sub(d_new, torch._foreach_mul(ds, opt.beta1))
    z = _ema(zs, g, opt.beta1)
    torch._foreach_sub_(z, torch._foreach_mul(sigma, ws))
    new_ws = torch._foreach_div(z, d_new)
    torch._foreach_neg_(new_ws)
    return new_ws, list(zip(d_new, v, z)), ex


@_lower(Signum)
def _low_signum(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale)
    if sts[0] is None:
        step = [sign(x) for x in g]
        _add_scaled(step, ws, wds)  # sign(g) + wd w
        torch._foreach_mul_(step, lrs)
        return torch._foreach_sub(ws, step), sts, ex
    moms = torch._foreach_mul(list(sts), opt.momentum)
    torch._foreach_sub_(moms, torch._foreach_mul(g, 1 - opt.momentum))
    new_ws = torch._foreach_mul(ws, [1 - lr * opt.wd_lh for lr in lrs])
    _add_scaled(new_ws, [sign(m) for m in moms], lrs)
    return new_ws, moms, ex


@_lower(AdaMax)
def _low_adamax(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    means = _ema([s[0] for s in sts], g, opt.beta1)
    inf_norm = torch._foreach_maximum(
        torch._foreach_mul([s[1] for s in sts], opt.beta2),
        torch._foreach_abs(g))
    denom = torch._foreach_add(inf_norm, 1e-8)
    lr_t = [-lr / (1 - opt.beta1 ** t) for lr, t in zip(lrs, ts)]
    new_ws = torch._foreach_addcdiv(ws, means, denom, lr_t)
    return new_ws, list(zip(means, inf_norm)), ex


@_lower(Nadam)
def _low_nadam(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    # m_schedule is multiplied once per parameter update, as the eager
    # path does; it is a 0-d device tensor when a loss scaler may skip
    ms = ex["m_schedule"]
    kws = []
    for lr, wd, t in zip(lrs, wds, ts):
        kws.append(dict(lr=lr, beta1=opt.beta1, beta2=opt.beta2,
                        epsilon=opt.epsilon, wd=wd, t=t,
                        schedule_decay=opt.schedule_decay, m_schedule=ms,
                        rescale_grad=rescale,
                        clip_gradient=opt.clip_gradient))
        ms = ms * opt.momentum_t(t)
    new_ws, new_sts = _per_param("nadam_update", ws, gs, sts, kws)
    return new_ws, new_sts, dict(ex, m_schedule=ms)


@_lower(SGLD)
def _low_sgld(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    torch._foreach_mul_(g, [0.5 * lr for lr in lrs])
    new_ws = torch._foreach_sub(ws, g)
    # the draws in the eager path's order, from the same stream
    torch._foreach_add_(new_ws, [sgld_noise(w, lr)
                                 for w, lr in zip(ws, lrs)])
    return new_ws, sts, ex


@_lower(DCASGD)
def _low_dcasgd(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    g = _prep(opt, gs, rescale, ws, wds)
    moms, prev = [s[0] for s in sts], [s[1] for s in sts]
    comp = torch._foreach_sub(ws, prev)
    torch._foreach_mul_(comp, torch._foreach_mul(g, g))
    torch._foreach_mul_(comp, opt.lamda)
    torch._foreach_add_(comp, g)  # g + lamda g^2 (w - w_prev)
    new_m = torch._foreach_mul(moms, opt.momentum)
    torch._foreach_sub_(new_m, torch._foreach_mul(comp, lrs))
    return torch._foreach_add(ws, new_m), list(zip(new_m, ws)), ex


@_lower(LARS)
def _low_lars(opt, ws, gs, sts, lrs, wds, ts, rescale, ex):
    kws = []
    for w, g, lr, wd in zip(ws, gs, lrs, wds):
        trust = lars_trust(w, g, opt.eta, opt.epsilon, wd, rescale,
                           opt.clip_gradient)
        kws.append(dict(lr=(lr * trust).to(w.dtype), momentum=opt.momentum,
                        wd=wd, rescale_grad=rescale,
                        clip_gradient=opt.clip_gradient))
    new_ws, new_sts = _per_param("sgd_mom_update", ws, gs, sts, kws)
    return new_ws, new_sts, ex


def _run_lowering(opt, ws, gs, states, lrs, wds, ts, rescale, ex=None):
    fn = _LOWER.get(type(opt))
    if fn is None:
        raise NotImplementedError(
            f"no fused lowering for {type(opt).__name__}")
    if ex is None:
        ex = {"m_schedule": opt.m_schedule} if isinstance(opt, Nadam) \
            else {}
    return fn(opt, list(ws), list(gs), list(states), [float(x) for x in lrs],
              [float(x) for x in wds], [float(x) for x in ts],
              float(rescale), ex)


def _leaves(s, out: list):
    if s is None:
        return out
    if isinstance(s, (tuple, list)):
        for x in s:
            _leaves(x, out)
    else:
        out.append(s)
    return out


@torch.no_grad()
def lower_update(opt, weights: List[torch.Tensor],
                 grads: List[torch.Tensor], states: list, lr, wd=0.0, t=1,
                 rescale=1.0):
    """Apply one step of ``opt`` to every weight, in place.

    ``states`` holds one entry per weight in the layout of
    ``opt.create_state``; they too update in place. One lr, wd and update
    count ``t`` for all. Returns (weights, states)."""
    weights, grads, states = list(weights), list(grads), list(states)
    if weights:
        n = len(weights)
        new_ws, new_sts, _ = _run_lowering(opt, weights, grads, states,
                                           [lr] * n, [wd] * n, [t] * n,
                                           rescale)
        torch._foreach_copy_(weights, new_ws)
        olds, news = [], []
        for s, ns in zip(states, new_sts):
            _leaves(s, olds)
            _leaves(ns, news)
        if olds:
            torch._foreach_copy_(olds, news)
    return weights, states


def _as_tensor_list(xs):
    return [x._data if isinstance(x, NDArray) else x for x in xs]


class FusedUpdateEngine:
    """Runs the update of a whole parameter set as list operations.

    One engine per :class:`~.optimizer.Updater`. ``exec_count`` counts the
    steps applied.
    """

    # hyperparameters that are values of a step, not its shape (the
    # reference's list): left out of the program's statics
    _TRACED_ATTRS = frozenset({"lr", "rescale_grad", "num_update",
                               "begin_num_update", "m_schedule", "wd",
                               "multi_precision"})

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.exec_count = 0
        self.compile_log: List[dict] = []
        self.last_health = None
        self._sig_cost: Dict[tuple, dict] = {}

    def supported(self) -> bool:
        return type(self.optimizer) in _LOWER

    def _static_key(self):
        opt = self.optimizer
        return tuple(sorted(
            (k, v) for k, v in opt.__dict__.items()
            if k not in self._TRACED_ATTRS
            and isinstance(v, (int, float, bool, str))))

    def _signature(self, weights, grads, states, loss_scaler,
                   clip_global_norm, health_on) -> tuple:
        """The step program's statics (the reference's key): optimizer
        class and static hyperparameters, state structure, multi-precision
        flags, weight/gradient/state avals, scaler, clip and stats."""
        opt = self.optimizer
        ws = _as_tensor_list(weights)

        def aval(t):
            return (tuple(t.shape), str(t.dtype).replace("torch.", ""))

        specs = tuple(_state_spec(s) for s in states)
        scaler_on = loss_scaler is not None
        factor, window = ((float(loss_scaler._factor),
                           int(loss_scaler._window)) if scaler_on
                          else (2.0, 0))
        return (type(opt), self._static_key(), specs,
                tuple(bool(opt._use_mp(w)) for w in ws),
                tuple(aval(w) for w in ws),
                tuple(aval(g) for g in _as_tensor_list(grads)),
                tuple(tuple(aval(x) for x in _as_tensor_list(_leaves(s, [])))
                      for s in states),
                scaler_on, factor, window,
                bool(clip_global_norm and clip_global_norm > 0), health_on)

    def _program_key(self, sig):
        """The step's ``progcache.ProgramKey``: site ``update``, label the
        optimizer's class name, statics the signature."""
        return _progcache.program_key("update", type(self.optimizer).__name__,
                                      sig)

    def _first(self, sig, n_params, health_on, dev, run):
        """Resolve a signature's first run: a cache hit adopts the stored
        cost and ``run(False, None)`` applies the step as always; else
        ``run(True, key)`` runs it (counted by the device plane when
        active, returning its cost) and the record is written. Returns the
        ``compile_log`` entry."""
        from ..ops import _kernels

        opt = self.optimizer
        # the signature's parts that TraceLinter.check_update_engine
        # diagnoses a recompiling loop from (the reference's fields)
        entry = {"site": "update", "optimizer": type(opt).__name__,
                 "static": sig[1], "avals": sig[4],
                 "state_structure": sig[2],
                 "flags": (sig[7], sig[10], sig[11]),
                 "n_params": n_params, "health": health_on,
                 "cache_hit": False}
        pc = _progcache.cache()
        pk = hit = None
        if pc is not None:
            pk = self._program_key(sig)
            entry["program_key"] = pk.digest
            hit = _progcache.load_program(pc, pk, dev)
        if hit is not None:
            entry["cache_hit"] = True
            cost = obs.device.adopt_cached_cost(pk, hit.cost)
            run(False, None)
        else:
            with _kernels.recording() as launched:
                cost = run(True, pk)
            if pc is not None:
                _progcache.store_program(pc, pk, cost, launched, dev)
        entry.update(cost or {})
        self._sig_cost[sig] = cost or {}
        self.compile_log.append(entry)
        obs.inc("update.cache_hit" if hit is not None else "update.compile")
        return entry

    def apply(self, indices, weights, grads, states, loss_scaler=None,
              clip_global_norm=None):
        """One update of the given parameter set. ``weights``, ``grads``
        and ``states`` are parallel lists of NDArrays (states in the
        Updater's slot layout); weights and state arrays are rebound to
        the new values."""
        opt = self.optimizer
        if not self.supported():
            raise NotImplementedError(
                f"no fused lowering for {type(opt).__name__}")
        from .. import profiler

        if profiler.counting_dispatches():
            profiler.count_dispatch("compiled")
        health_on = obs.health.stats_for_this_step()
        args = (indices, weights, grads, states, loss_scaler,
                clip_global_norm, health_on)
        rec = obs.enabled()
        t0 = time.monotonic() if rec else 0.0
        dev = _as_tensor_list(weights[:1])[0].device
        sig = None
        if obs.device.active() or _progcache.active() or _TRACKING[0]:
            # the signature's first run is counted and looked up (the
            # zero-cost-when-off contract: no signature is built while
            # capture, the cache and signature tracking are off)
            sig = self._signature(weights, grads, states, loss_scaler,
                                  clip_global_norm, health_on)
        first = sig is not None and sig not in self._sig_cost
        with obs.trace.span("update.fused", optimizer=type(opt).__name__,
                            n_params=len(indices), compile=first) as sp:
            if first:
                def run(count, pk):
                    if count and obs.device.active():
                        return obs.device.capture(
                            self._apply, args, site="update",
                            label=type(opt).__name__, pointwise=True,
                            device=dev, key=pk)[1]
                    self._apply(*args)
                    return None

                entry = self._first(sig, len(indices), health_on, dev, run)
                if isinstance(sp, obs.trace._Span):
                    sp.attrs["cache_hit"] = entry["cache_hit"]
            else:
                self._apply(*args)
            cost = self._sig_cost.get(sig) if rec and not first else None
            if cost:
                # wait for the update before timing it: MFU over the
                # launch latency alone would mean nothing
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                obs.device.annotate_span(sp, "update",
                                         time.monotonic() - t0, cost)
        if rec:
            obs.observe("update.compile_seconds" if first
                        else "update.execute_seconds",
                        time.monotonic() - t0)

    def prewarm(self, indices, weights, grads, states, loss_scaler=None,
                clip_global_norm=None) -> bool:
        """Resolve the step ``apply`` would run on these arrays WITHOUT
        applying it: weights, states, the optimizer's counters and the loss
        scaler stay as they are. A cache hit is adopted as at a first run;
        a miss runs the step once on copies (counted by the device plane
        when active) and writes its record. The elastic rejoiner calls this
        while quarantined, so the real first step finds its program seen.
        Returns True when the signature is now resolved."""
        if not self.supported() or not weights:
            return False
        health_on = obs.health.stats_for_this_step()
        sig = self._signature(weights, grads, states, loss_scaler,
                              clip_global_norm, health_on)
        if sig in self._sig_cost:
            return True
        opt = self.optimizer
        dev = _as_tensor_list(weights[:1])[0].device
        shadow = copy.copy(opt)
        shadow._index_update_count = dict(opt._index_update_count)
        if getattr(opt, "lr_scheduler", None) is not None:
            shadow.lr_scheduler = copy.deepcopy(opt.lr_scheduler)
        args = (list(indices), [NDArray(t.clone())
                                for t in _as_tensor_list(weights)],
                [NDArray(t.clone()) for t in _as_tensor_list(grads)],
                [_clone_state(s) for s in states],
                copy.copy(loss_scaler) if loss_scaler is not None else None,
                clip_global_norm, health_on)

        def run(count, pk):
            if not count:
                return None  # a hit: nothing runs
            saved = (self.optimizer, self.exec_count, self.last_health)
            self.optimizer = shadow
            try:
                if obs.device.active():
                    return obs.device.capture(
                        self._apply, args, site="update",
                        label=type(opt).__name__, pointwise=True,
                        device=dev, key=pk)[1]
                self._apply(*args)
                return None
            finally:
                self.optimizer, self.exec_count, self.last_health = saved

        entry = self._first(sig, len(indices), health_on, dev, run)
        obs.event("progcache.prewarm", optimizer=type(opt).__name__,
                  cache_hit=entry["cache_hit"])
        return True

    @torch.no_grad()
    def _apply(self, indices, weights, grads, states, loss_scaler,
               clip_global_norm, health_on):
        opt = self.optimizer
        for i in indices:  # host bookkeeping, the eager order
            opt._update_count(i)
        lrs = [opt._get_lr(i) for i in indices]
        wds = [opt._get_wd(i) for i in indices]
        ts = [opt._index_update_count[i] for i in indices]
        rescale = float(opt.rescale_grad)

        ws = _as_tensor_list(weights)
        gs = _as_tensor_list(grads)
        mp = [opt._use_mp(w) for w in ws]
        eff_ws, eff_gs, eff_sts = [], [], []
        for w, g, st, m in zip(ws, gs, states, mp):
            if m:
                inner, w32 = st
                eff_ws.append(w32._data)
                eff_gs.append(g.float())
                eff_sts.append(_unwrap_state(inner))
            else:
                eff_ws.append(w)
                eff_gs.append(g)
                eff_sts.append(_unwrap_state(st))
        dev = ws[0].device

        scaler_on = loss_scaler is not None
        if scaler_on:
            scale = _dev_scalar(loss_scaler.loss_scale, dev)
            eff_gs = _scale_all(eff_gs, 1.0 / scale)
            maxes = torch._foreach_norm(eff_gs, math.inf)
            found = ~torch.isfinite(torch.stack(maxes).float().sum())
        if health_on:
            # per-gradient non-finite counts, after the unscale
            nonfinite = torch.stack([(~torch.isfinite(g)).sum()
                                     for g in eff_gs])
        clip_on = clip_global_norm is not None and clip_global_norm > 0
        if clip_on or health_on:
            # one reduction serves the clip and the health plane's
            # global and per-parameter grad norms (before the clip)
            norms = torch._foreach_norm(eff_gs, 2, dtype=torch.float32)
            gnorm = torch.linalg.vector_norm(torch.stack(norms)) * rescale
        if clip_on:
            coef = torch.clamp_max(clip_global_norm / (gnorm + 1e-6), 1.0)
            eff_gs = _scale_all(eff_gs, coef)

        ex = None
        if isinstance(opt, Nadam):
            ms = opt.m_schedule
            ex = {"m_schedule": _dev_scalar(ms, dev) if scaler_on
                  else float(_scalar(ms))}
        ex_in = dict(ex) if ex is not None else None
        new_eff_ws, new_eff_sts, ex = _run_lowering(
            opt, eff_ws, eff_gs, eff_sts, lrs, wds, ts, rescale, ex)

        # a multi-precision state is (inner state, f32 master weight)
        new_ws = [nw.to(w.dtype) for w, nw in zip(ws, new_eff_ws)]
        new_sts = [(ns, nw) if m else ns
                   for m, nw, ns in zip(mp, new_eff_ws, new_eff_sts)]

        if scaler_on:
            old_sts = [_unwrap_state(s) for s in states]
            new_ws = [torch.where(found, w, nw) for w, nw in zip(ws, new_ws)]
            new_sts = [_select_state(found, o, n)
                       for o, n in zip(old_sts, new_sts)]
            if ex_in is not None:
                ex = {"m_schedule": torch.where(found, ex_in["m_schedule"],
                                                ex["m_schedule"])}
            self._scaler_step(loss_scaler, scale, found, dev)

        self.last_health = None
        if health_on:
            # the applied step's norms (0 on a scaler skip), in f32
            pnorms = torch._foreach_norm(ws, 2, dtype=torch.float32)
            unorms = torch._foreach_norm(
                torch._foreach_sub([nw.float() for nw in new_ws],
                                   [w.float() for w in ws]), 2)
            self.last_health = {
                "global_grad_norm": gnorm,
                "grad_norms": torch.stack(norms) * rescale,
                "param_norms": torch.stack(pnorms),
                "update_norms": torch.stack(unorms),
                "nonfinite": nonfinite, "indices": tuple(indices)}
            if scaler_on:
                self.last_health["found_inf"] = found
                self.last_health["skip_streak"] = loss_scaler.skip_streak

        for w, nw in zip(weights, new_ws):
            w._set_data(nw)
        for s, ns in zip(states, new_sts):
            for old, new in zip(_leaves(s, []), _leaves(ns, [])):
                old._set_data(new)
        if isinstance(opt, Nadam):
            opt.m_schedule = ex["m_schedule"]
        self.exec_count += 1

    def _scaler_step(self, scaler, scale, found, dev):
        """The loss scaler's bookkeeping on the device: halve on a skip,
        double after ``window`` clean steps, count the skip streak."""
        unskipped = _dev_scalar(getattr(scaler, "_unskipped", 0), dev,
                                torch.int32)
        streak = _dev_scalar(getattr(scaler, "skip_streak", 0), dev,
                             torch.int32)
        nskip = unskipped + 1
        grow = nskip >= int(scaler._window)
        factor = float(scaler._factor)
        new_scale = torch.where(
            found, torch.clamp_min(scale / factor, 1e-4),
            torch.where(grow, torch.clamp_max(scale * factor, 2.0 ** 24),
                        scale))
        scaler.loss_scale = NDArray(new_scale)
        scaler._unskipped = NDArray(torch.where(found | grow,
                                                torch.zeros_like(nskip),
                                                nskip))
        scaler.last_overflow = NDArray(found)
        scaler.skip_streak = NDArray(torch.where(found, streak + 1,
                                                 torch.zeros_like(streak)))


def _state_spec(s):
    """The nesting of one parameter's state (None, a leaf, or tuples)."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_state_spec(x) for x in s)
    return "leaf"


def _clone_state(s):
    """A copy of one parameter's state, every leaf a new array."""
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_clone_state(x) for x in s)
    return NDArray(s._data.clone()) if isinstance(s, NDArray) \
        else s.clone()


def _unwrap_state(s):
    if s is None:
        return None
    if isinstance(s, tuple):
        return tuple(_unwrap_state(x) for x in s)
    return s._data if isinstance(s, NDArray) else s


def _select_state(found, old, new):
    if old is None:
        return None
    if isinstance(old, tuple):
        return tuple(_select_state(found, o, n) for o, n in zip(old, new))
    return torch.where(found, old, new)


def _scalar(x):
    if isinstance(x, NDArray):
        x = x._data
    return x.item() if isinstance(x, torch.Tensor) else x


def _dev_scalar(x, dev, dtype=torch.float32):
    """``x`` as a 0-d tensor on ``dev``: a device value stays where it is,
    a host number becomes a fill (no copy from the host)."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=dev)


def _scale_all(gs, s):
    """Each gradient times the 0-d tensor ``s``, in the gradient's dtype."""
    by_dtype = {}
    for i, g in enumerate(gs):
        by_dtype.setdefault(g.dtype, []).append(i)
    out = [None] * len(gs)
    for dt, idx in by_dtype.items():
        scaled = torch._foreach_mul([gs[i] for i in idx], s.to(dt))
        for i, t in zip(idx, scaled):
            out[i] = t
    return out
