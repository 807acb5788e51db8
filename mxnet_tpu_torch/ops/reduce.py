"""Reduction operator family (counterpart of ``mxnet_tpu/ops/reduce.py``).

Semantics kept: ``axis=None`` reduces all; ``exclude=True`` reduces the
axes NOT listed; reductions keep the input dtype (an integer mean is
computed in float32 and cast back); ``argmax``/``argmin`` return float32
indices, as the reference does.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .registry import alias, register


def _norm_axes(axis, ndim, exclude=False):
    if axis is None:
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _sum(x, axes, keepdim):
    if not axes:
        return x.clone()
    return torch.sum(x, dim=axes, keepdim=keepdim, dtype=x.dtype)


def _mean(x, axes, keepdim):
    if not axes:
        return x.clone()
    if x.is_floating_point():
        return torch.mean(x, dim=axes, keepdim=keepdim)
    return torch.mean(x.float(), dim=axes, keepdim=keepdim).to(x.dtype)


def _prod(x, axes, keepdim):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdim, dtype=x.dtype)
    return x


def _amax(x, axes, keepdim):
    return torch.amax(x, dim=axes, keepdim=keepdim) if axes else x.clone()


def _amin(x, axes, keepdim):
    return torch.amin(x, dim=axes, keepdim=keepdim) if axes else x.clone()


def _nansum(x, axes, keepdim):
    return torch.nansum(x, dim=axes, keepdim=keepdim) if axes else x.clone()


def _nanprod(x, axes, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), axes,
                 keepdim)


def _make_reduce(fn):
    def op(data, axis=None, keepdims=False, exclude=False):
        return fn(data, _norm_axes(axis, data.ndim, exclude), bool(keepdims))

    return op


for _name, _fn in {"sum": _sum, "mean": _mean, "prod": _prod, "max": _amax,
                   "min": _amin, "nansum": _nansum,
                   "nanprod": _nanprod}.items():
    register(_name, ndarray_inputs=["data"],
             tags=("reduction",) if _name in ("mean", "max", "min") else ())(
        _make_reduce(_fn))

alias("sum", "sum_axis", "_np_sum")
alias("max", "max_axis")
alias("min", "min_axis")


@register("norm", ndarray_inputs=["data"])
def _norm(data, ord=2, axis=None, keepdims=False, out_dtype=None):
    axes = _norm_axes(axis, data.ndim)
    if not axes:  # axis=() reduces nothing (torch's dim=() would reduce all)
        r = torch.abs(data) if ord == 1 else torch.sqrt(torch.square(data))
    elif ord == 1:
        r = torch.sum(torch.abs(data), dim=axes, keepdim=bool(keepdims))
    else:
        r = torch.sqrt(torch.sum(torch.square(data), dim=axes,
                                 keepdim=bool(keepdims)))
    if out_dtype is not None:
        r = r.to(dtype_torch(out_dtype))
    return r


def _make_arg_reduce(fn):
    def op(data, axis=None, keepdims=False):
        if axis is None:
            r = fn(data.reshape(-1), dim=0)
            if keepdims:
                r = r.reshape((1,) * data.ndim)
        else:
            r = fn(data, dim=int(axis), keepdim=bool(keepdims))
        # the reference returns float32 indices (mshadow legacy)
        return r.to(torch.float32)

    return op


register("argmax", differentiable=False, ndarray_inputs=["data"],
         tags=("reduction",))(_make_arg_reduce(torch.argmax))
register("argmin", differentiable=False, ndarray_inputs=["data"],
         tags=("reduction",))(_make_arg_reduce(torch.argmin))


@register("argmax_channel", differentiable=False, ndarray_inputs=["data"])
def _argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


@register("broadcast_axis", aliases=["broadcast_axes"],
          ndarray_inputs=["data"])
def _broadcast_axis(data, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    size = (size,) if isinstance(size, int) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a % data.ndim] = s
    return torch.broadcast_to(data, tuple(shape))


@register("broadcast_to", ndarray_inputs=["data"])
def _broadcast_to(data, shape=()):
    # 0 in the target shape keeps the input's dim
    tgt = tuple(d if s == 0 else s for s, d in zip(shape, data.shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_like", ndarray_inputs=["lhs", "rhs"])
def _broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return torch.broadcast_to(lhs, rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la % lhs.ndim] = rhs.shape[ra % rhs.ndim]
    return torch.broadcast_to(lhs, tuple(shape))


@register("logsumexp", aliases=["log_sum_exp"], ndarray_inputs=["data"],
          tags=("reduction",))
def _logsumexp(data, axis=None, keepdims=False):
    return torch.logsumexp(data, dim=_norm_axes(axis, data.ndim),
                           keepdim=bool(keepdims))


@register("L2Normalization", ndarray_inputs=["data"])
def _l2_normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, data.ndim))
    elif mode == "channel":
        axes = (1,)
    elif mode == "spatial":
        axes = tuple(range(2, data.ndim))
    else:
        raise ValueError(f"unknown L2Normalization mode {mode!r}")
    norm = torch.sqrt(torch.sum(torch.square(data), dim=axes, keepdim=True)
                      + eps)
    return data / norm
