"""Ordering ops: ``topk``, ``sort``, ``argsort``, ``_unravel_index`` and
``_ravel_multi_index`` (counterpart of ``mxnet_tpu/ops/ordering.py``).

Ties break as the reference's: its ``lax.top_k`` puts the lower index
first among equal values and its ``argsort`` is ``jnp.argsort(stable=True)``,
so every ordering here is ``torch.sort(stable=True)``; a descending
``sort``/``argsort`` is the ascending result flipped, as the reference
flips it. Indices come back in ``dtype`` (float32 by default).
"""
from __future__ import annotations

import math

import torch

from ..base import dtype_torch
from .registry import register


def _topk_n_out(kw):
    return 2 if kw.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_n_out, differentiable=False,
          ndarray_inputs=["data"])
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    ax = data.ndim - 1 if axis is None else int(axis) % data.ndim
    k = int(k)
    if k <= 0:
        k = data.shape[ax]
    vals, idx = torch.sort(data, dim=ax, descending=not is_ascend,
                           stable=True)
    vals, idx = vals.narrow(ax, 0, k), idx.narrow(ax, 0, k)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx.to(dtype_torch(dtype))
    if ret_typ == "both":
        return vals, idx.to(dtype_torch(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(ax, idx, 1.0)
    raise ValueError(f"unknown ret_typ {ret_typ!r}")


@register("sort", ndarray_inputs=["data"])
def _sort(data, axis=-1, is_ascend=True):
    ax = data.ndim - 1 if axis is None else int(axis)
    s = torch.sort(data, dim=ax, stable=True).values
    return s if is_ascend else torch.flip(s, dims=(ax,))


@register("argsort", differentiable=False, ndarray_inputs=["data"])
def _argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    ax = data.ndim - 1 if axis is None else int(axis)
    idx = torch.argsort(data, dim=ax, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, dims=(ax,))
    return idx.to(dtype_torch(dtype))


@register("_unravel_index", aliases=["unravel_index"], differentiable=False,
          ndarray_inputs=["data"])
def _unravel(data, shape=()):
    # jnp.unravel_index: floor divmod per axis; an index past the end
    # reads the last element of every axis, one below -1 the first
    rest = data.to(torch.int32).to(torch.int64)
    outs = [None] * len(shape)
    for i in reversed(range(len(shape))):
        s = int(shape[i])
        outs[i] = torch.remainder(rest, s)
        rest = torch.div(rest, s, rounding_mode="floor")
    oob_pos, oob_neg = rest > 0, rest < -1
    outs = [torch.where(oob_pos, torch.full_like(o, int(s) - 1),
                        torch.where(oob_neg, torch.zeros_like(o), o))
            for s, o in zip(shape, outs)]
    return torch.stack(outs, dim=0).to(torch.float32)


@register("_ravel_multi_index", aliases=["ravel_multi_index"],
          differentiable=False, ndarray_inputs=["data"])
def _ravel(data, shape=()):
    # jnp.ravel_multi_index(mode="clip"): each coordinate clipped to its
    # axis, then row-major strides
    shape = tuple(int(s) for s in shape)
    out = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, s in enumerate(shape):
        c = data[i].to(torch.int32).to(torch.int64).clamp(0, s - 1)
        out = out + c * math.prod(shape[i + 1:])
    return out.to(torch.float32)
