"""Indexing operator family: take/Embedding/one_hot/pick/gather_nd/
scatter_nd (counterpart of ``mxnet_tpu/ops/indexing.py``).

Out-of-range indices follow the reference, whose gathers are JAX's:
``take``/``pick`` (mode ``clip``) and ``Embedding`` clamp the index first,
so the gradient goes to the clamped element; mode ``wrap`` takes it
modulo the size; ``gather_nd`` and array indexing read a clamped value
whose gradient is dropped (:func:`jax_getitem`); ``take_along_axis``
fills with NaN (integers: the type's minimum); a scatter drops writes that
fall outside. Torch would raise instead, and on CUDA assert on the device.
Index tensors may come in any type; they become int64 inside the op only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import dtype_torch
from .registry import register

__all__ = ["jax_getitem", "jax_setitem"]

# ---------------------------------------------------------------------------
# JAX's indexing rules on torch tensors (NDArray __getitem__/__setitem__,
# gather_nd, the scatters)
# ---------------------------------------------------------------------------

def _as_index(k, device):
    """An array-like key as a tensor on ``device`` (bool stays bool), or
    None when ``k`` is not array-like."""
    if isinstance(k, torch.Tensor):
        return k.to(device)
    if isinstance(k, (list, np.ndarray)):
        arr = np.asarray(k)
        if arr.dtype == bool:
            return torch.from_numpy(arr.copy()).to(device)
        return torch.from_numpy(arr.astype(np.int64)).to(device)
    return None


def _norm_key(shape, key, device, for_set):
    """The key as torch reads it, with JAX's semantics folded in. Integer
    indices count from the end when negative; one still out of range goes
    to a pad slot past the end of its dim, which the caller adds: for a
    read, slot n holds a detached copy of element n-1 and slot n+1 one of
    element 0 (the clamped value, with its gradient dropped, as JAX's
    gather gives it); for a write, slot n takes the write and is cut off
    again (a dropped write). Slices with a negative step become forward
    slices of a flipped dim. Returns (key, dims to flip, dims to pad)."""
    key = key if isinstance(key, tuple) else (key,)
    items = []
    for k in key:
        t = _as_index(k, device)
        items.append(k if t is None else t)
    used = sum(k.ndim if isinstance(k, torch.Tensor) and
               k.dtype == torch.bool else (0 if k is None or k is Ellipsis
                                           else 1) for k in items)
    out, flips, pads = [], [], []
    dim = 0
    for k in items:
        if k is None:
            out.append(None)
            continue
        if k is Ellipsis:
            n_fill = len(shape) - used
            out.extend([slice(None)] * n_fill)
            dim += n_fill
            continue
        if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            out.append(k)
            dim += k.ndim
            continue
        n = shape[dim]
        if isinstance(k, slice):
            start, stop, step = k.indices(n)
            if step < 0:  # torch slices step forward: flip, then slice
                flips.append(dim)
                k = slice(n - 1 - start, n - 1 - stop, -step)
            out.append(k)
        elif isinstance(k, torch.Tensor):
            # no host sync: a tensor index always goes through the pad
            idx = k.long()
            idx = torch.where(idx < 0, idx + n, idx)
            pads.append(dim)
            high = torch.full_like(idx, n)
            low = high if for_set else torch.full_like(idx, n + 1)
            out.append(torch.where(idx >= n, high,
                                   torch.where(idx < 0, low, idx)))
        else:
            i = int(k)
            i = i + n if i < 0 else i
            if not 0 <= i < n:
                pads.append(dim)
                i = n if (i >= n or for_set) else n + 1
            out.append(i)
        dim += 1
    return tuple(out), flips, pads


def jax_getitem(data, key):
    """``data[key]`` as JAX reads it: out-of-range integer indices clamp
    (negatives first count from the end) and pass no gradient back."""
    key, flips, pads = _norm_key(tuple(data.shape), key, data.device, False)
    if flips:
        data = torch.flip(data, dims=flips)
    for dim in pads:
        n = data.shape[dim]
        data = torch.cat([data, data.narrow(dim, n - 1, 1).detach(),
                          data.narrow(dim, 0, 1).detach()], dim)
    return data[key]


def jax_setitem(data, key, value):
    """A new tensor: ``data`` with ``key`` set to ``value`` as JAX's
    ``.at[key].set`` does it; writes out of range are dropped."""
    shape = tuple(data.shape)
    key, flips, pads = _norm_key(shape, key, data.device, True)
    if pads:
        new = torch.nn.functional.pad(data, _pad_arg(data.ndim, pads))
    else:
        new = data.clone()
    if flips:
        new = torch.flip(new, dims=flips)
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value) if isinstance(
            value, (list, np.ndarray)) else value)
    new[key] = value.to(device=data.device, dtype=data.dtype)
    if flips:
        new = torch.flip(new, dims=flips)
    if pads:
        new = new[tuple(slice(0, n) for n in shape)]
    return new


def _pad_arg(ndim, dims):
    """torch.nn.functional.pad's list for one slot after each dim in
    ``dims``."""
    flat = []
    for dim in reversed(range(ndim)):
        flat += [0, 1] if dim in dims else [0, 0]
    return flat




def _index(indices, n, mode="clip"):
    """Integer index tensor into a dim of size n, as the reference reads
    it: ``clip`` clamps into [0, n-1]; ``wrap`` takes it modulo n."""
    idx = indices.to(torch.int32).long()
    if mode == "wrap":
        return torch.remainder(idx, n)
    return idx.clamp(0, n - 1)


def _fill_value(dtype):
    """What JAX's fill mode reads out of range: NaN, or the integer type's
    minimum (maximum when unsigned)."""
    if dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.max if dtype == torch.uint8 else info.min


def _filled(data, ax, idx, gather):
    """gather(safe index) where ``idx`` (negatives from the end) is in
    range along ``ax``, the fill value elsewhere."""
    n = data.shape[ax]
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    got = gather(torch.where(ok, idx, torch.zeros_like(idx)))
    if got.shape != ok.shape:  # take: ok broadcasts over the other dims
        ok = ok.reshape((1,) * ax + tuple(ok.shape)
                        + (1,) * (got.ndim - ax - ok.ndim))
    return torch.where(ok, got, torch.full((), _fill_value(data.dtype),
                                           dtype=data.dtype,
                                           device=data.device))


@register("take", ndarray_inputs=["a", "indices"])
def _take(a, indices, axis=0, mode="clip"):
    ax = int(axis) % a.ndim
    tail = a.shape[ax + 1:]

    def gather(idx):
        out = torch.index_select(a, ax, idx.reshape(-1))
        return out.reshape(a.shape[:ax] + tuple(indices.shape) + tail)

    if mode in ("clip", "wrap"):
        return gather(_index(indices, a.shape[ax], mode))
    # any other mode reads as jnp.take's default: out of range is filled
    return _filled(a, ax, indices.to(torch.int32).long(), gather)


@register("Embedding", ndarray_inputs=["data", "weight"])
def _embedding(data, weight, input_dim=None, output_dim=None,
               dtype="float32", sparse_grad=False):
    idx = data.to(torch.int32).long().clamp(0, weight.shape[0] - 1)
    placements = getattr(weight, "placements", None)
    if placements is not None and any(p.is_shard() for p in placements):
        # a table sharded over a mesh (a DTensor): gathered whole, so that
        # the lookup and its backward take DTensor's plainest strategies
        from torch.distributed.tensor import Replicate

        weight = weight.redistribute(weight.device_mesh,
                                     [Replicate()] * len(placements))
    # the embedding op, not weight[idx]: its backward is embedding_dense_
    # backward, which DTensor shards on every version; index_put's (the
    # indexing backward) fails on torch 2.11 with a batch sharded over dp
    return torch.nn.functional.embedding(idx, weight)


@register("one_hot", differentiable=False, ndarray_inputs=["indices"])
def _one_hot(indices, depth=None, on_value=1.0, off_value=0.0,
             dtype="float32"):
    d = int(depth)
    idx = indices.to(torch.int32)
    oh = torch.arange(d, dtype=torch.int32, device=indices.device) == \
        idx[..., None]
    dt = dtype_torch(dtype)
    return torch.where(oh, torch.tensor(on_value, dtype=dt,
                                        device=indices.device),
                       torch.tensor(off_value, dtype=dt,
                                    device=indices.device))


@register("pick", ndarray_inputs=["data", "index"])
def _pick(data, index, axis=-1, keepdims=False, mode="clip"):
    ax = int(axis) % data.ndim
    idx = _index(index, data.shape[ax], "clip" if mode == "clip" else "wrap")
    picked = torch.gather(data, ax, idx.unsqueeze(ax))
    return picked if keepdims else picked.squeeze(ax)


@register("gather_nd", ndarray_inputs=["data", "indices"])
def _gather_nd(data, indices):
    # indices (M, ...): the first axis indexes the leading M dims of data
    return jax_getitem(data, tuple(indices[i].to(torch.int32)
                                   for i in range(indices.shape[0])))


def _scatter(base, indices, values, accumulate):
    """``base`` with ``values`` scattered at ``indices`` (M, ...) on its
    first M dims (added with ``accumulate``); writes out of range are
    dropped, through a pad slot on each of those dims."""
    m = indices.shape[0]
    idx = []
    for i in range(m):
        n = base.shape[i]
        j = indices[i].to(torch.int32).long()
        j = torch.where(j < 0, j + n, j)
        idx.append(torch.where((j >= 0) & (j < n), j, torch.full_like(j, n)))
    padded = torch.nn.functional.pad(base, _pad_arg(base.ndim, range(m)))
    out = padded.index_put(tuple(idx), values.to(base.dtype),
                           accumulate=accumulate)
    return out[tuple(slice(0, base.shape[i]) for i in range(m))]


@register("scatter_nd", ndarray_inputs=["data", "indices"])
def _scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return _scatter(out, indices, data, accumulate=False)


@register("_scatter_set_nd", ndarray_inputs=["lhs", "rhs", "indices"])
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    return _scatter(lhs, indices, rhs, accumulate=False)


@register("_backward_gather_nd", aliases=["gather_nd_grad"],
          ndarray_inputs=["data", "indices"])
def _gather_nd_accumulate(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return _scatter(out, indices, data, accumulate=True)


@register("take_along_axis", ndarray_inputs=["data", "indices"])
def _take_along_axis(data, indices, axis=0):
    # JAX's take_along_axis fills out-of-range reads by default
    ax = int(axis) % data.ndim
    return _filled(data, ax, indices.to(torch.int32).long(),
                   lambda idx: torch.gather(data, ax, idx))


# boolean_mask, index_copy and allclose as the reference's contrib family
# defines them (it registers these names last, over its indexing ones)

@register("_contrib_boolean_mask", aliases=["boolean_mask"],
          ndarray_inputs=["data", "index"])
def _boolean_mask(data, index, axis=0):
    """A static shape: the selected rows compacted to the front in order,
    the rest zero (callers that need the count sum the index)."""
    mask = index.to(torch.bool)
    ax = int(axis) % data.ndim
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    gathered = torch.index_select(data, ax, order)
    keep = torch.arange(data.shape[ax], device=data.device) < mask.sum()
    shape = [1] * data.ndim
    shape[ax] = -1
    return torch.where(keep.reshape(shape), gathered,
                       torch.zeros((), dtype=data.dtype, device=data.device))


@register("_contrib_index_copy", aliases=["index_copy"],
          ndarray_inputs=["old_tensor", "index_vector", "new_tensor"])
def _index_copy(old_tensor, index_vector, new_tensor):
    return _scatter(old_tensor, index_vector.reshape(1, -1), new_tensor,
                    accumulate=False)


@register("_contrib_index_array", differentiable=False,
          ndarray_inputs=["data"])
def _index_array(data, axes=None):
    shape = data.shape
    axes = tuple(axes) if axes is not None else tuple(range(len(shape)))
    grids = torch.meshgrid(*[torch.arange(shape[a], device=data.device)
                             for a in axes], indexing="ij")
    return torch.stack(grids, dim=-1).to(torch.int32)


@register("_contrib_allclose", aliases=["allclose"], differentiable=False,
          ndarray_inputs=["a", "b"])
def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    ok = torch.allclose(a, b, rtol=rtol, atol=atol,
                        equal_nan=bool(equal_nan))
    return torch.tensor([float(ok)], dtype=torch.float32, device=a.device)
