"""Matrix / shape-manipulation operator family (counterpart of
``mxnet_tpu/ops/matrix.py``): ``Reshape`` with the reference's magic
codes (0 / -1 / -2 / -3 / -4, ``reverse``), transposes, the slice family,
``Concat``/``stack``/``SliceChannel``, ``dot``/``batch_dot`` (cuBLAS
through ``torch.matmul``, true f32 unless the inputs are 16-bit) and the
``linalg`` subset."""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .indexing import _filled
from .registry import register


# ---------------------------------------------------------------------------
# Reshape with the reference's magic codes (docs: mx.nd.reshape).
# ---------------------------------------------------------------------------

def _infer_reshape(data_shape, shape, reverse=False):
    if reverse:
        # right-to-left inference: reverse the dims and the token list, a
        # (-4, d1, d2) triple kept whole with d1/d2 swapped so that the
        # final un-reversal restores the requested order
        groups, j = [], 0
        shape = list(shape)
        while j < len(shape):
            if shape[j] == -4:
                groups.append([-4, shape[j + 2], shape[j + 1]])
                j += 3
            else:
                groups.append([shape[j]])
                j += 1
        data_shape = tuple(reversed(data_shape))
        shape = [t for g in reversed(groups) for t in g]
    out = []
    i = 0  # index into data_shape
    j = 0
    shape = list(shape)
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(data_shape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(data_shape[i:])
            i = len(data_shape)
        elif s == -3:
            out.append(data_shape[i] * data_shape[i + 1])
            i += 2
        elif s == -4:
            d1, d2 = shape[j + 1], shape[j + 2]
            if d1 == -1:
                d1 = data_shape[i] // d2
            elif d2 == -1:
                d2 = data_shape[i] // d1
            out.extend([d1, d2])
            i += 1
            j += 2
        else:
            out.append(s)
            i += 1
        j += 1
    if out.count(-1) == 1:
        known = 1
        for v in out:
            if v != -1:
                known *= v
        total = 1
        for v in data_shape:
            total *= v
        out[out.index(-1)] = int(total // known) if known else 0
    if reverse:
        out = list(reversed(out))
    return tuple(out)


# (input shape, output shape, placements) -> the placements a DTensor
# takes before that reshape, for the reshapes DTensor cannot shard through
_GATHER_BEFORE: dict = {}


def _reshape_dtensor(data, shape):
    """``data`` (a ``DTensor``) reshaped to ``shape``. Where ``DTensor``
    cannot keep a shard through the reshape (a tp-sharded fused QKV
    projection split into (3, heads, dim): its shards cut through q, k
    and v), every mesh dimension sharding an array dimension past the
    unchanged leading ones is gathered first, as GSPMD's reshape does;
    the others keep their shards."""
    key = (tuple(data.shape), shape, tuple(data.placements))
    pl = _GATHER_BEFORE.get(key)
    if pl is None:
        try:
            return torch.reshape(data, shape)
        except RuntimeError:
            from torch.distributed.tensor import Replicate

            keep = 0
            while (keep < min(data.ndim, len(shape))
                   and data.shape[keep] == shape[keep]):
                keep += 1
            pl = _GATHER_BEFORE[key] = tuple(
                Replicate() if p.is_shard() and p.dim % data.ndim >= keep
                else p for p in data.placements)
    return torch.reshape(data.redistribute(data.device_mesh, pl), shape)


@register("Reshape", aliases=["reshape"], ndarray_inputs=["data"])
def _reshape(data, shape=None, reverse=False, target_shape=None,
             keep_highest=False):
    if shape is None and target_shape is not None:  # legacy param
        shape = target_shape
    shape = _infer_reshape(tuple(data.shape), tuple(shape),
                           reverse=bool(reverse))
    if hasattr(data, "placements"):
        return _reshape_dtensor(data, shape)
    return torch.reshape(data, shape)


@register("Flatten", aliases=["flatten"], ndarray_inputs=["data"])
def _flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("transpose", ndarray_inputs=["data"])
def _transpose(data, axes=None):
    if axes is None or axes == ():
        axes = tuple(reversed(range(data.ndim)))
    return data.permute(*axes)


@register("expand_dims", ndarray_inputs=["data"])
def _expand_dims(data, axis=0):
    axis = int(axis)
    return torch.unsqueeze(data, axis if axis >= 0 else data.ndim + 1 + axis)


@register("squeeze", ndarray_inputs=["data"])
def _squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    for a in axis:
        if data.shape[a] != 1:
            raise ValueError(f"cannot squeeze axis {a} of size "
                             f"{data.shape[a]}")
    return torch.squeeze(data, dim=axis)


@register("swapaxes", aliases=["SwapAxis"], ndarray_inputs=["data"])
def _swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, int(dim1), int(dim2))


@register("flip", aliases=["reverse"], ndarray_inputs=["data"])
def _flip(data, axis=()):
    axis = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, dims=axis)


@register("tile", ndarray_inputs=["data"])
def _tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat", ndarray_inputs=["data"])
def _repeat(data, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), int(repeats))
    return torch.repeat_interleave(data, int(repeats), dim=int(axis))


@register("Pad", aliases=["pad"], ndarray_inputs=["data"])
def _pad(data, mode="constant", pad_width=(), constant_value=0.0):
    pw = tuple(pad_width)
    # torch.nn.functional.pad lists (before, after) from the last dim
    flat = []
    for i in reversed(range(len(pw) // 2)):
        flat += [pw[2 * i], pw[2 * i + 1]]
    mode_t = {"constant": "constant", "edge": "replicate",
              "reflect": "reflect"}[mode]
    if mode_t == "constant":
        return torch.nn.functional.pad(data, flat, mode="constant",
                                       value=constant_value)
    # replicate/reflect take the trailing padded dims only
    while len(flat) > 2 and flat[-2:] == [0, 0]:
        flat = flat[:-2]
    return torch.nn.functional.pad(data, flat, mode=mode_t)


@register("Concat", aliases=["concat"], ndarray_inputs="*")
def _concat(*data, dim=1, num_args=None):
    return torch.cat(data, dim=int(dim))


@register("stack", ndarray_inputs="*")
def _stack(*data, axis=0, num_args=None):
    return torch.stack(data, dim=int(axis))


def _chunks(data, n, axis):
    size = data.shape[axis]
    if size % n:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {size} into {n}")
    return torch.split(data, size // n, dim=axis)


def _squeezed(parts, axis, squeeze_axis):
    if squeeze_axis:
        parts = [torch.squeeze(p, dim=axis) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


@register("SliceChannel", aliases=["split"],
          num_outputs=lambda kw: int(kw.get("num_outputs", 1)),
          ndarray_inputs=["data"])
def _split(data, num_outputs=1, axis=1, squeeze_axis=False):
    axis = int(axis)
    return _squeezed(_chunks(data, int(num_outputs), axis), axis,
                     squeeze_axis)


def _split_v2_n(kw):
    if kw.get("sections"):
        return int(kw["sections"])
    return len(tuple(kw.get("indices", ()))) + 1


@register("split_v2", num_outputs=_split_v2_n,
          ndarray_inputs=["data", "indices"])
def _split_v2(data, indices=(), axis=1, squeeze_axis=False, sections=0):
    axis = int(axis)
    if sections:
        parts = _chunks(data, int(sections), axis)
    else:
        bounds = [0, *indices, data.shape[axis]]
        parts = [data.narrow(axis, a, max(b - a, 0))
                 for a, b in zip(bounds[:-1], bounds[1:])]
    return _squeezed(parts, axis, squeeze_axis)


def _slice_index(begin, end, step, shape):
    """A tuple of slices for the reference's slice op; a negative step is
    returned as the dims to flip first and the slice on the flipped dim."""
    ndim = len(shape)
    begin = tuple(begin) + (None,) * (ndim - len(begin))
    end = tuple(end) + (None,) * (ndim - len(end))
    step = (tuple(step) + (None,) * (ndim - len(step)) if step
            else (None,) * ndim)
    idx, flips = [], []
    for dim, (b, e, s) in enumerate(zip(begin, end, step)):
        sl = slice(b, e, s if s != 0 else None)
        start, stop, st = sl.indices(shape[dim])
        if st < 0:  # torch slices step forward: flip, then step forward
            n = shape[dim]
            flips.append(dim)
            sl = slice(n - 1 - start, n - 1 - stop, -st)
        idx.append(sl)
    return tuple(idx), flips


@register("slice", aliases=["crop"], ndarray_inputs=["data"])
def _slice(data, begin=(), end=(), step=None):
    idx, flips = _slice_index(begin, end, step, tuple(data.shape))
    if flips:
        data = torch.flip(data, dims=flips)
    return data[idx]


@register("slice_axis", ndarray_inputs=["data"])
def _slice_axis(data, axis=0, begin=0, end=None):
    idx = [slice(None)] * data.ndim
    idx[int(axis)] = slice(begin, end)
    return data[tuple(idx)]


@register("slice_like", ndarray_inputs=["data", "shape_like"])
def _slice_like(data, shape_like, axes=()):
    axes = tuple(axes) if axes else tuple(range(min(data.ndim,
                                                    shape_like.ndim)))
    idx = [slice(None)] * data.ndim
    for a in axes:
        idx[a % data.ndim] = slice(0, shape_like.shape[a % shape_like.ndim])
    return data[tuple(idx)]


@register("where", ndarray_inputs=["condition", "x", "y"])
def _where(condition, x, y):
    return torch.where(condition != 0, x, y)


@register("diag", ndarray_inputs=["data"])
def _diag(data, k=0, axis1=0, axis2=1):
    if data.ndim == 1:
        return torch.diag(data, int(k))
    return torch.diagonal(data, offset=int(k), dim1=int(axis1),
                          dim2=int(axis2))


@register("depth_to_space", ndarray_inputs=["data"])
def _depth_to_space(data, block_size=1):
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth", ndarray_inputs=["data"])
def _space_to_depth(data, block_size=1):
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# dot / batch_dot
# ---------------------------------------------------------------------------

def _t(x):
    return x.permute(*reversed(range(x.ndim)))


@register("dot", ndarray_inputs=["lhs", "rhs"])
def _dot(lhs, rhs, transpose_a=False, transpose_b=False, forward_stype=None):
    a = _t(lhs) if transpose_a else lhs
    b = _t(rhs) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    # the reference's dot contracts a's last axis with b's first
    return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))


@register("batch_dot", ndarray_inputs=["lhs", "rhs"])
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False,
               forward_stype=None):
    a = torch.swapaxes(lhs, -1, -2) if transpose_a else lhs
    b = torch.swapaxes(rhs, -1, -2) if transpose_b else rhs
    return torch.matmul(a, b)


# linalg subset
@register("_linalg_gemm2", aliases=["linalg_gemm2"],
          ndarray_inputs=["A", "B"])
def _linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                  axis=-2):
    a = torch.swapaxes(A, -1, -2) if transpose_a else A
    b = torch.swapaxes(B, -1, -2) if transpose_b else B
    return alpha * torch.matmul(a, b)


@register("_linalg_gemm", aliases=["linalg_gemm"],
          ndarray_inputs=["A", "B", "C"])
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-2):
    a = torch.swapaxes(A, -1, -2) if transpose_a else A
    b = torch.swapaxes(B, -1, -2) if transpose_b else B
    return alpha * torch.matmul(a, b) + beta * C


@register("_linalg_potrf", aliases=["linalg_potrf"], ndarray_inputs=["A"])
def _linalg_potrf(A, lower=True):
    L = torch.linalg.cholesky(A)
    return L if lower else torch.swapaxes(L, -1, -2)


@register("_linalg_trsm", aliases=["linalg_trsm"], ndarray_inputs=["A", "B"])
def _linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    a = torch.swapaxes(A, -1, -2) if transpose else A
    low = bool(lower) != bool(transpose)
    return torch.linalg.solve_triangular(a, alpha * B, upper=not low,
                                         left=not rightside)


@register("_linalg_syrk", aliases=["linalg_syrk"], ndarray_inputs=["A"])
def _linalg_syrk(A, transpose=False, alpha=1.0):
    a = torch.swapaxes(A, -1, -2) if transpose else A
    return alpha * torch.matmul(a, torch.swapaxes(a, -1, -2))


@register("khatri_rao", ndarray_inputs="*")
def _khatri_rao(*args):
    out = args[0]
    for m in args[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            -1, out.shape[-1])
    return out


@register("moments", num_outputs=2, ndarray_inputs=["data"])
def _moments(data, axes=None, keepdims=False):
    dims = tuple(axes) if axes is not None else tuple(range(data.ndim))
    mean = torch.mean(data, dim=dims, keepdim=bool(keepdims))
    var = torch.var(data, dim=dims, keepdim=bool(keepdims), unbiased=False)
    return mean, var


@register("histogram", num_outputs=2, differentiable=False,
          ndarray_inputs=["data"])
def _histogram(data, bins=None, bin_cnt=None, range=None):
    flat = data.reshape(-1).float()
    if bin_cnt is not None:
        lo, hi = (float(r) for r in range)
        edges = torch.linspace(lo, hi, int(bin_cnt) + 1, device=data.device)
    else:
        edges = bins.float() if torch.is_tensor(bins) else torch.tensor(
            bins, dtype=torch.float32, device=data.device)
    inner = torch.bucketize(flat, edges[1:-1], right=True)
    keep = (flat >= edges[0]) & (flat <= edges[-1])
    cnt = torch.bincount(inner[keep], minlength=len(edges) - 1)
    return cnt.to(torch.float32), edges  # counts as floats, as jnp's


@register("_linalg_det", aliases=["linalg_det"], ndarray_inputs=["A"])
def _linalg_det(A):
    return torch.linalg.det(A)


@register("_linalg_slogdet", aliases=["linalg_slogdet"], num_outputs=2,
          ndarray_inputs=["A"])
def _linalg_slogdet(A):
    sign, logabsdet = torch.linalg.slogdet(A)
    return sign, logabsdet


@register("_linalg_inverse", aliases=["linalg_inverse"], ndarray_inputs=["A"])
def _linalg_inverse(A):
    return torch.linalg.inv(A)


@register("_linalg_trmm", aliases=["linalg_trmm"], ndarray_inputs=["A", "B"])
def _linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    tri = torch.tril(A) if lower else torch.triu(A)
    if transpose:
        tri = torch.swapaxes(tri, -1, -2)
    out = (B @ tri) if rightside else (tri @ B)
    return alpha * out


@register("_linalg_extractdiag", aliases=["linalg_extractdiag"],
          ndarray_inputs=["A"])
def _linalg_extractdiag(A, offset=0):
    return torch.diagonal(A, offset=int(offset), dim1=-2, dim2=-1)


@register("_linalg_makediag", aliases=["linalg_makediag"],
          ndarray_inputs=["A"])
def _linalg_makediag(A, offset=0):
    return torch.diag_embed(A, offset=int(offset))


def _trian_indices(n, offset, lower, device):
    """The reference's packing (linalg.extracttrian docs): offset > 0 packs
    the triangle above the main diagonal from that superdiagonal, offset
    < 0 the one below; ``lower`` only disambiguates offset 0. Row-major
    order, as numpy's triu/tril_indices give it."""
    k = int(offset)
    upper = k > 0 or (k == 0 and not lower)
    if upper:
        idx = torch.triu_indices(n, n, offset=k, device=device)
    else:
        idx = torch.tril_indices(n, n, offset=k, device=device)
    return idx[0], idx[1]


@register("_linalg_extracttrian", aliases=["linalg_extracttrian"],
          ndarray_inputs=["A"])
def _linalg_extracttrian(A, offset=0, lower=True):
    rows, cols = _trian_indices(A.shape[-1], offset, lower, A.device)
    return A[..., rows, cols]


@register("_linalg_maketrian", aliases=["linalg_maketrian"],
          ndarray_inputs=["A"])
def _linalg_maketrian(A, offset=0, lower=True):
    m = A.shape[-1]
    n = 1  # packed length grows strictly with n
    while len(_trian_indices(n, offset, lower, A.device)[0]) < m:
        n += 1
    rows, cols = _trian_indices(n, offset, lower, A.device)
    if len(rows) != m:
        raise ValueError(f"packed length {m} matches no n for "
                         f"offset={offset}")
    out = torch.zeros(A.shape[:-1] + (n, n), dtype=A.dtype, device=A.device)
    out[..., rows, cols] = A
    return out


def _accumulate(fn, a, axis, dtype):
    if axis is None:
        a = a.reshape(-1)
        axis = 0
    out = fn(a, dim=int(axis))
    return out.to(dtype_torch(dtype)) if dtype else out


@register("cumsum", aliases=["_np_cumsum"], ndarray_inputs=["a"])
def _cumsum(a, axis=None, dtype=None):
    return _accumulate(torch.cumsum, a, axis, dtype)


@register("cumprod", aliases=["_np_cumprod"], ndarray_inputs=["a"])
def _cumprod(a, axis=None, dtype=None):
    return _accumulate(torch.cumprod, a, axis, dtype)


@register("batch_take", differentiable=False, ndarray_inputs=["a", "indices"])
def _batch_take(a, indices):
    """a (N, ...) with indices (N,): per-row take (reference batch_take).
    Indices are read as the reference's ``take_along_axis`` reads them: a
    negative index counts from the end of the row, and one past the end
    reads the fill value (NaN for floats)."""
    flat = a.reshape(a.shape[0], -1)
    idx = indices.reshape(-1, 1).long()
    return _filled(flat, 1, idx, lambda i: torch.gather(flat, 1, i)
                   ).reshape(indices.shape)


@register("cast_storage", ndarray_inputs=["data"])
def _cast_storage(data, stype="default"):
    """Storage casts are the identity: the port has dense arrays only."""
    return data


@register("_linalg_potri", aliases=["linalg_potri"], ndarray_inputs=["A"])
def _linalg_potri(A, lower=True):
    """Inverse of an SPD matrix from its Cholesky factor:
    (L L^T)^-1 = L^-T L^-1."""
    # only the factor's triangle is read (and differentiated)
    L = torch.tril(A if lower else torch.swapaxes(A, -1, -2))
    return torch.cholesky_inverse(L, upper=False)


@register("_linalg_sumlogdiag", aliases=["linalg_sumlogdiag"],
          ndarray_inputs=["A"])
def _linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("_linalg_gelqf", aliases=["linalg_gelqf"], num_outputs=2,
          ndarray_inputs=["A"])
def _linalg_gelqf(A):
    """LQ factorization A = L Q (Q orthonormal rows): returns (Q, L)."""
    q, r = torch.linalg.qr(torch.swapaxes(A, -1, -2), mode="reduced")
    return torch.swapaxes(q, -1, -2), torch.swapaxes(r, -1, -2)


@register("_linalg_syevd", aliases=["linalg_syevd"], num_outputs=2,
          ndarray_inputs=["A"])
def _linalg_syevd(A):
    """Symmetric eigendecomposition with eigenvector rows: (U, w)."""
    w, v = torch.linalg.eigh(A)
    return torch.swapaxes(v, -1, -2), w
