"""Flash attention (training) and paged decode attention (serving).

Counterpart of ``mxnet_tpu/ops/flash_attention.py``. Each function that
reached a Pallas kernel there reaches a hand-written CUDA kernel here
(``csrc/``), with a plain PyTorch version beside it: the CPU path and the
yardstick the kernel is held to on the card. A wrapper computes the plain
version only for a tensor on the CPU (or on ``meta``, where the plain
version gives the output's shape to symbolic shape inference and nothing
is computed); on a CUDA tensor it launches its kernel, counts the launch
in its ``.launches`` (and in ``.by_offset``, by causal offset) and never
falls back.

Flash attention
---------------

``flash_attention_with_lse(q, k, v, causal, scale, offset, block_q,
block_k)`` -> (out, lse) and ``flash_attention`` -> out, on (B, H, S, D)
tensors, with the reference's semantics: causal visibility is
``row + offset >= col``; a row that sees nothing gets out 0 and lse -1e30.
``_Flash`` (a ``torch.autograd.Function``, the reference's ``custom_vjp``)
runs :func:`flash_attention_fwd` forward and :func:`flash_attention_bwd`
backward; it takes a cotangent for lse too, or none.

``block_q``/``block_k`` and ``MXNET_FLASH_BLOCK_Q/K`` (argument first,
then the environment) set the plain version's tiles, shrunk to divide S
as the reference's ``_pick_block`` does; its default is the reference's
512. The CUDA kernels have their own tiles (the TPU's ``_BLOCK_TABLE``
does not carry over), per kernel, type and head dim
(:func:`_kernel_tiles`): the bf16/f16 forward 128 query rows by 64 keys;
the bf16/f16 backward 128 by 64 at D 64, 64 by 128 at D 16, 64 by 32 at
D 256, else 64 by 64; the FFMA kernels 64 by 64, the FFMA forward 128 by
64 up to D 64. On a CUDA tensor, a requested tile that a kernel the call
reaches was not built for raises: the wrappers check their own kernel,
``_Flash`` the backward's too before it returns from the forward.

The kernels take every head dim d >= 1. f32 at any d, and bf16/f16 above
256, go to the FFMA kernels (:func:`_ffma_route`), which take d at run
time: they loop over it in chunks and spread wide output columns over
slabs of the grid. bf16/f16 up to 256 go to the tensor-core kernels, one
built for the next power of two from 16 (:func:`_kernel_dim`), which read
the columns past the true head dim as zeros and write none of them. The
tensors are passed as they are.

Determinism: the backward kernels sum dK and dV in one order, but add dQ
into an f32 accumulator by atomic reductions in the order the blocks reach
them, so two calls on the same inputs may differ in dQ's last bits (f32
included); the forward is bitwise repeatable.

Backward path, ``MXNET_FLASH_BWD`` (the reference reads
``pallas|auto|else``, ``flash_attention.py:486-488``):

============  ==========================  =================================
value         reference meaning           here
============  ==========================  =================================
``auto``      Pallas on TPU, blocked      kernel on a CUDA tensor, plain
              scan else                   version on a CPU tensor
``kernel``    ``pallas``                  kernel; a CPU tensor raises
``plain``     anything else: blocked      plain version on any device
============  ==========================  =================================

Paged decode attention
----------------------

One query position per sequence against its page table. The CUDA kernel
(``csrc/paged_decode_attention.cu``) never gathers: it reads page
``table[b, j]`` straight from the pool through the strides of the view it
is given, so the engine passes ``kv[:, layer, 0]`` of its 6-d pool without
a copy. It splits every row into chunks of :func:`_decode_chunk`
positions (picked from the static shapes and the SM count, never from the
lengths, which live on the device), one block per chunk, head and
sequence, and merges a long row's per-chunk partials in chunk order, so
repeated calls are bitwise equal. :func:`_decode_attention_plain`
materializes the gather instead; it is the CPU path and the yardstick the
kernel is held to, and with ``chunk`` it computes the kernel's per-chunk
partials and merge.

Path selection, ``MXNET_DECODE_ATTN`` (the reference's ``auto|pallas|xla``):

============  ==========================  =================================
value         reference meaning           here
============  ==========================  =================================
``auto``      Pallas on TPU, XLA else     kernel on a CUDA tensor, plain
                                          version on a CPU tensor
``kernel``    ``pallas``                  kernel; a CPU tensor raises
``plain``     ``xla``                     plain version on any device
============  ==========================  =================================

There is no fallback: a kernel that fails to build or launch raises.

Device cost
-----------

Under a device-plane capture (``obs/device.py``) each wrapper counts its
call once by its analytic formula, whatever ran (the kernel on the card,
the plain version on the CPU), and hides the ops of its body from the
capture: :func:`flash_fwd_cost`, :func:`flash_bwd_cost` and
:func:`paged_decode_cost` (the work each function must do: every input
read once, every output written once, and its multiply-adds), the
formulas of ``chip_smoke.py``'s bounds.

Length-0 rows (inactive decode slots): the output is finite, never NaN,
and otherwise unspecified. The kernel (and the plain version with
``chunk``) writes 0 there; the plain version, like the reference's XLA
path, averages whatever the padded page table points at; the reference's
Pallas kernel gives yet another value. Callers discard these rows.
"""
from __future__ import annotations

import functools
import math
import os

import torch

from ..base import MXNetError
from ..obs import device as _obs_device
from . import _kernels

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_fwd", "flash_attention_bwd",
           "decode_attention", "flash_decode_attention", "flash_fwd_cost",
           "flash_bwd_cost", "paged_decode_cost"]

_NEG_INF = -1e30  # avoids -inf NaN propagation for fully-masked rows
_LOG2E = math.log2(math.e)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_PLAIN_BLOCK = 512        # the plain version's default tile (reference's)
_MAX_TC_DIM = 256         # the widest head dim of the tensor-core kernels
# the FFMA kernels' tiles and slabs (csrc/flash_common.cuh): kFfmaBM x
# kFfmaBN, the forward's kFfmaFwdBM rows to D 64, kFfmaBwdSlab
_FFMA_TILES = (64, 64)
_FFMA_FWD_BM = 128
_FFMA_BWD_SLAB = 64


def _ffma_route(dtype, d):
    """Whether head dim ``d`` in ``dtype`` runs on the FFMA kernels
    (``ffma_route`` of ``csrc/flash_common.cuh``): f32 always, bf16/f16
    above the tensor-core kernels' 256."""
    return dtype == torch.float32 or d > _MAX_TC_DIM


def _kernel_dim(d):
    """The head dim the bf16/f16 tensor-core kernels that run head dim
    ``d`` (at most 256) are built for (``padded_dim`` of
    ``csrc/flash_common.cuh``): the least power of two of at least 16 that
    holds d."""
    return max(16, 1 << (int(d) - 1).bit_length())


def _kernel_tiles(which, dtype, d):
    """(block_q, block_k) of the CUDA kernel ``which`` ("fwd" or "bwd") for
    ``dtype`` and head dim ``d``: kFfmaBM/kFfmaBN of
    ``csrc/flash_common.cuh`` on the FFMA route; else kFwdBM/kFwdBN of
    ``csrc/flash_attention_fwd.cu``, kWgBM/kWgBN (D 64) or
    kBwdBM/BwdLayout::BN of ``csrc/flash_attention_bwd.cu``."""
    if _ffma_route(dtype, d):
        if which == "fwd" and d <= 64:
            return _FFMA_FWD_BM, _FFMA_TILES[1]
        return _FFMA_TILES
    if which == "fwd":
        return 128, 64
    kd = _kernel_dim(d)
    return {16: (64, 128), 64: (128, 64), 256: (64, 32)}.get(kd, (64, 64))


def _dq_acc_width(dtype, d):
    """Row width of the backward's f32 dQ accumulator: whole slabs of
    ``_FFMA_BWD_SLAB`` on the FFMA route, the built head dim else."""
    if _ffma_route(dtype, d):
        return -(-int(d) // _FFMA_BWD_SLAB) * _FFMA_BWD_SLAB
    return _kernel_dim(d)


# ---------------------------------------------------------------------------
# Flash attention: tiles
# ---------------------------------------------------------------------------

def _pick_block(s, target):
    blk = min(s, target)
    while s % blk:
        blk //= 2
    return max(blk, 1)


def _block_request(block_q, block_k):
    """The tiles asked for: explicit argument, else ``MXNET_FLASH_BLOCK_Q/K``,
    else None."""
    if block_q is None:
        env_q = os.environ.get("MXNET_FLASH_BLOCK_Q")
        block_q = int(env_q) if env_q else None
    if block_k is None:
        env_k = os.environ.get("MXNET_FLASH_BLOCK_K")
        block_k = int(env_k) if env_k else None
    return block_q, block_k


def _resolve_blocks(s, d, block_q, block_k):
    """The plain version's (block_q, block_k) for sequence length ``s``."""
    block_q, block_k = _block_request(block_q, block_k)
    return (_pick_block(s, block_q or _PLAIN_BLOCK),
            _pick_block(s, block_k or _PLAIN_BLOCK))


# ---------------------------------------------------------------------------
# Flash attention: plain PyTorch versions
# ---------------------------------------------------------------------------

def _flash_attention_plain(q, k, v, causal=False, scale=None, offset=0,
                           block_q=None, block_k=None):
    """Blocked online-softmax forward (the reference's ``_fwd_core`` over
    all Q blocks at once). Scores are f32 products of the inputs; P is
    rounded to v's dtype before P V, as the reference casts it. Returns
    (out in q's dtype, lse f32 (B, H, S))."""
    b, h, s, d = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    offset = int(offset)
    bq, bk = _resolve_blocks(s, d, block_q, block_k)
    qf, kf, vf = q.float(), k.float(), v.float()
    c = scale * _LOG2E
    nk = s // bk
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, bq):
        if causal:
            nk_full = min(max((q0 + offset - bk + 1) // bk + 1, 0), nk)
            nk_run = min(max((q0 + bq + offset + bk - 1) // bk, 0), nk)
        else:
            nk_full = nk_run = nk
        qb = qf[:, :, q0:q0 + bq]
        acc = torch.zeros((b, h, bq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, bq), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq), device=q.device)
        rows = torch.arange(q0, q0 + bq, device=q.device)[:, None]
        for j in range(nk_run):
            sc = qb @ kf[:, :, j * bk:(j + 1) * bk].transpose(-1, -2)
            if j >= nk_full:
                cols = torch.arange(j * bk, (j + 1) * bk, device=q.device)
                sc = torch.where(rows + offset >= cols[None, :], sc,
                                 torch.full_like(sc, _NEG_INF))
            new_m = torch.maximum(m, sc.amax(dim=-1))
            corr = torch.exp2((m - new_m) * c)
            p = torch.exp2((sc - new_m[..., None]) * c)
            acc = acc * corr[..., None] + \
                p.to(v.dtype).float() @ vf[:, :, j * bk:(j + 1) * bk]
            l = l * corr + p.sum(dim=-1)
            m = new_m
        # rows that never saw a visible column: one per-row repair
        row_ok = m > _NEG_INF / 2
        safe_l = l.clamp_min(1e-30)
        out[:, :, q0:q0 + bq] = torch.where(row_ok[..., None],
                                            acc / safe_l[..., None], 0.0)
        lse[:, :, q0:q0 + bq] = torch.where(row_ok & (l > 0),
                                            m * scale + torch.log(safe_l),
                                            _NEG_INF)
    return out.to(q.dtype), lse


def _flash_bwd_plain(q, k, v, out, lse, dout, g_lse=None, causal=False,
                     scale=None, offset=0, block_k=None):
    """Blocked backward, the counterpart of the reference's
    ``_bwd_blocked``: dS = P * (dP - delta + dlse) * scale with
    delta = rowsum(dO * O). Memory O(S * block_k). Returns (dq, dk, dv) in
    the inputs' dtypes."""
    b, h, s, d = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    offset = int(offset)
    _bq, bk = _resolve_blocks(s, d, None, block_k)
    dt = q.dtype  # products take operands rounded to the storage dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.to(dt).float()
    dl = (dout.float() * out.float()).sum(dim=-1)  # delta - dlse
    if g_lse is not None:
        dl = dl - g_lse.float()
    lse = lse.float()
    dq = torch.zeros((b, h, s, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    rows = torch.arange(s, device=q.device)[:, None]
    for j in range(s // bk):
        blk = slice(j * bk, (j + 1) * bk)
        kb, vb = kf[:, :, blk], vf[:, :, blk]
        sc = (qf @ kb.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(j * bk, (j + 1) * bk, device=q.device)
            sc = torch.where(rows + offset >= cols[None, :], sc,
                             torch.full_like(sc, _NEG_INF))
        p = torch.exp(sc - lse[..., None])
        p = torch.where(sc <= _NEG_INF / 2, torch.zeros_like(p), p)
        dv[:, :, blk] = p.to(dt).float().transpose(-1, -2) @ dof
        dp = dof @ vb.transpose(-1, -2)
        ds = (p * (dp - dl[..., None]) * scale).to(dt).float()
        dq += ds @ kb
        dk[:, :, blk] = ds.transpose(-1, -2) @ qf
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Flash attention: kernel wrappers
# ---------------------------------------------------------------------------

def _check_tiles(name, which, q, block_q, block_k):
    """Raise unless the CUDA kernel ``which`` ("fwd" or "bwd") was built
    for the requested tiles (argument, else ``MXNET_FLASH_BLOCK_Q/K``)."""
    tiles = _kernel_tiles(which, q.dtype, q.shape[-1])
    for blk, tile in zip(_block_request(block_q, block_k), tiles):
        if blk not in (None, tile):
            raise MXNetError(f"{name}: the CUDA {which} kernel's tiles are "
                             f"{tiles[0]} x {tiles[1]} (block_q x block_k) "
                             f"for {q.dtype}; {blk} was requested")


def _check_flash(name, which, q, others, block_q, block_k):
    """Raise unless the CUDA kernel ``which`` ("fwd" or "bwd") takes these
    (B, H, S, D) tensors and the requested tiles."""
    if q.dim() != 4:
        raise MXNetError(f"{name}: q must be (B, H, S, D); got "
                         f"{tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise MXNetError(f"{name}: dtype {q.dtype} not in "
                         "float32/bfloat16/float16")
    if q.shape[-1] < 1:
        raise MXNetError(f"{name}: head dim {q.shape[-1]}; the kernels "
                         "take any head dim of at least 1")
    for t in others:
        if t.shape != q.shape:
            raise MXNetError(f"{name}: shapes {tuple(t.shape)} and "
                             f"{tuple(q.shape)} differ (self-attention "
                             "over one length only)")
        if t.dtype != q.dtype:
            raise MXNetError(f"{name}: q, k and v dtypes differ")
        if t.device != q.device:
            raise MXNetError(f"{name}: all inputs must be on {q.device}")
    if any(t.stride(-1) != 1 for t in (q, *others)):
        raise MXNetError(f"{name}: inputs need a contiguous last dim")
    _check_tiles(name, which, q, block_q, block_k)
    b, h, s, d = q.shape
    if b * h > 65535:
        raise MXNetError(f"{name}: B * H = {b * h} exceeds the grid's "
                         "65535")
    # the grid's other dimensions: row tiles (y) and column slabs (z)
    if -(-s // min(_kernel_tiles(which, q.dtype, d))) > 65535 or \
            -(-d // _FFMA_BWD_SLAB) > 65535:
        raise MXNetError(f"{name}: S {s} or head dim {d} needs more than "
                         "the grid's 65535 tiles or slabs")


def _strides(*tensors):
    """The (b, h, s) element strides of each tensor, in one tuple."""
    return tuple(st for t in tensors for st in t.stride()[:3])


def _empty_bshd(q):
    """A (B, H, S, D) output whose memory is (B, S, H, D): the model's
    transpose back to (B, S, H*D) is then free."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


# the devices whose tensors take a wrapper's plain version: the CPU, and
# meta, which carries shapes and computes nothing (symbolic shape
# inference, analysis/shape_infer.py), so no kernel is skipped there
_PLAIN_DEVICES = ("cpu", "meta")


# ---------------------------------------------------------------------------
# Analytic cost (the device plane's count of a wrapper call)
# ---------------------------------------------------------------------------

def _pairs(b, h, s, causal, offset):
    """(query, key) pairs a head computes: all S x S, or, causal, those
    with ``row + offset >= col``."""
    if not causal:
        return b * h * s * s
    offset = int(offset)
    seen = sum(min(max(i + offset + 1, 0), s) for i in range(s))
    return b * h * seen


def flash_fwd_cost(q, k, v, causal=False, scale=None, offset=0, *_a,
                   **_k):
    """(flops, bytes) of :func:`flash_attention_fwd`: q, k, v read and out
    written in q's dtype, lse written in f32; 4 D flops a (query, key)
    pair (QK^T and PV)."""
    b, h, s, d = q.shape
    it = q.element_size()
    return (4 * d * _pairs(b, h, s, causal, offset),
            4 * b * h * s * d * it + b * h * s * 4)


def flash_bwd_cost(q, k, v, out, lse, dout, g_lse=None, causal=False,
                   scale=None, offset=0, *_a, **_k):
    """(flops, bytes) of :func:`flash_attention_bwd`: q, k, v, out, dout
    read and dq, dk, dv written in q's dtype, lse read and dl formed in
    f32; 10 D flops a pair (the recomputed QK^T, dV, dP, dQ and dK)."""
    b, h, s, d = q.shape
    it = q.element_size()
    return (10 * d * _pairs(b, h, s, causal, offset),
            8 * b * h * s * d * it + 2 * b * h * s * 4)


def paged_decode_cost(lengths, page, heads, head_dim, itemsize):
    """(flops, bytes) of one paged-decode call over rows of ``lengths``
    (host ints): the pages each row touches, K and V, read once; q read
    and out written; 4 D flops a visible position and head."""
    lengths = [int(n) for n in lengths]
    pages = sum(-(-n // page) for n in lengths)
    b = len(lengths)
    return (4 * sum(lengths) * heads * head_dim,
            pages * page * heads * head_dim * 2 * itemsize
            + 2 * b * heads * head_dim * itemsize)


def _decode_cost(q, k_pages, v_pages, page_table, lengths, scale=None):
    # a device-to-host read of the lengths: only under a capture, which
    # runs on a signature's first call, never on the steady path
    b, h, d = q.shape
    return paged_decode_cost(lengths.tolist(), k_pages.shape[1], h, d,
                             q.element_size())


def _costed(name, cost):
    """Report each call of the wrapped kernel wrapper into the active
    device-plane capture by ``cost(*args)`` -> (flops, bytes), and hide
    its body and the formula's reads (the lengths' copy to the host) from
    the capture's dispatch counting."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            cap = _obs_device.capturing()
            if cap is None:
                return fn(*args, **kwargs)
            with cap.hidden():
                flops, nbytes = cost(*args, **kwargs)
                cap.add_kernel(name, flops, nbytes,
                               str(args[0].dtype).replace("torch.", ""))
                return fn(*args, **kwargs)
        return wrapper
    return deco


@_costed("flash_attention_fwd", flash_fwd_cost)
def flash_attention_fwd(q, k, v, causal=False, scale=None, offset=0,
                        block_q=None, block_k=None):
    """Flash-attention forward -> (out, lse), q/k/v (B, H, S, D).

    On CUDA tensors this launches ``csrc/flash_attention_fwd.cu`` and adds
    one to ``flash_attention_fwd.launches``; q/k/v may be strided views
    with a contiguous last dim. On CPU tensors it computes
    :func:`_flash_attention_plain` and counts nothing."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if not q.is_cuda:
        if q.device.type in _PLAIN_DEVICES:
            return _flash_attention_plain(q, k, v, causal, scale, offset,
                                          block_q, block_k)
        raise MXNetError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    _check_flash("flash_attention_fwd", "fwd", q, (k, v), block_q, block_k)
    b, h, s, _ = q.shape
    out = _empty_bshd(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _kernels.entry("flash_attention_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _DTYPE_CODE[q.dtype], b, h, s, d,
        _strides(q, k, v, out), int(bool(causal)), int(offset), scale,
        _kernels.stream(q))
    if err != 0:
        raise MXNetError(f"flash_attention_fwd launch failed: cudaError "
                         f"{err}")
    flash_attention_fwd.launches += 1
    _count_offset(flash_attention_fwd, causal, offset)
    return out, lse


def _count_offset(wrapper, causal, offset):
    """One more launch at this causal offset (``wrapper.by_offset``; the
    key is None for a non-causal launch): ring attention launches the
    kernels at offset 0 and +-S."""
    key = int(offset) if causal else None
    wrapper.by_offset[key] = wrapper.by_offset.get(key, 0) + 1


flash_attention_fwd.launches = 0
flash_attention_fwd.by_offset = {}


@_costed("flash_attention_bwd", flash_bwd_cost)
def flash_attention_bwd(q, k, v, out, lse, dout, g_lse=None, causal=False,
                        scale=None, offset=0, block_q=None, block_k=None):
    """Flash-attention backward -> (dq, dk, dv).

    ``lse`` is the forward's, ``dout`` the cotangent of out and ``g_lse``
    that of lse (None: zero). On CUDA tensors this launches
    ``csrc/flash_attention_bwd.cu`` (its preprocess kernel, which forms
    dl = rowsum(dout * out) - g_lse, then its main pass and the dQ store
    from an f32 accumulator allocated here) and adds one to
    ``flash_attention_bwd.launches``. On CPU tensors it computes
    :func:`_flash_bwd_plain` and counts nothing."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if not q.is_cuda:
        if q.device.type in _PLAIN_DEVICES:
            return _flash_bwd_plain(q, k, v, out, lse, dout, g_lse, causal,
                                    scale, offset, block_k)
        raise MXNetError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    _check_flash("flash_attention_bwd", "bwd", q, (k, v, out, dout),
                 block_q, block_k)
    b, h, s, _ = q.shape
    for name, t in (("lse", lse), ("g_lse", g_lse)):
        if t is not None and (t.shape != (b, h, s) or t.device != q.device):
            raise MXNetError(f"flash_attention_bwd: {name} must be "
                             f"(B, H, S) on {q.device}")
    lse = lse.float().contiguous()
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    # f32 scratch: dl (delta - dlse, the reference's :333-334) per row and
    # the dQ accumulator the kernel's atomics add into (_dq_acc_width)
    dl = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((b, h, s, _dq_acc_width(q.dtype, d)),
                         dtype=torch.float32, device=q.device)
    dq, dk, dv = _empty_bshd(q), _empty_bshd(q), _empty_bshd(q)
    err = _kernels.entry("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        None if g_lse is None else g_lse.data_ptr(), dl.data_ptr(),
        dq_acc.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], b, h, s, d,
        _strides(q, k, v, out, dout, dq, dk, dv), int(bool(causal)),
        int(offset), scale, _kernels.stream(q))
    if err != 0:
        raise MXNetError(f"flash_attention_bwd launch failed: cudaError "
                         f"{err}")
    flash_attention_bwd.launches += 1
    _count_offset(flash_attention_bwd, causal, offset)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.by_offset = {}


# ---------------------------------------------------------------------------
# Flash attention: autograd and public API
# ---------------------------------------------------------------------------

class _Flash(torch.autograd.Function):
    """(out, lse) with a kernel forward and a kernel backward (the
    reference's ``_flash`` ``custom_vjp``). Saves q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, offset, block_q, block_k):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, offset,
                                       block_q, block_k)
        if (q.device.type == "cuda" and any(ctx.needs_input_grad[:3])
                and os.environ.get("MXNET_FLASH_BWD", "auto") != "plain"):
            # the backward kernel's tiles differ from the forward's at some
            # head dims: refuse now rather than in the backward
            _check_tiles("flash_attention", "bwd", q, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, scale, offset, block_q, block_k)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, offset, block_q, block_k = ctx.cfg
        if g_out is None:
            g_out = torch.zeros_like(out)
        impl = os.environ.get("MXNET_FLASH_BWD", "auto")
        if impl == "plain":
            grads = _flash_bwd_plain(q, k, v, out, lse, g_out, g_lse,
                                     causal, scale, offset, block_k)
        elif impl in ("auto", "kernel"):
            if impl == "kernel" and q.device.type != "cuda":
                raise MXNetError("MXNET_FLASH_BWD=kernel needs CUDA "
                                 f"tensors; got q on {q.device}")
            grads = flash_attention_bwd(q, k, v, out, lse, g_out, g_lse,
                                        causal, scale, offset, block_q,
                                        block_k)
        else:
            raise MXNetError(f"MXNET_FLASH_BWD={impl!r}: expected "
                             "auto|kernel|plain")
        return (*grads, None, None, None, None, None)


def flash_attention_with_lse(q, k, v, causal=False, scale=None, offset=0,
                             block_q=None, block_k=None):
    """(out, lse); lse feeds ring attention's cross-device block combine.

    ``offset`` (int): causal visibility is ``row + offset >= col``;
    ignored when causal=False. Differentiable in q, k, v (through out and
    lse)."""
    scale = float(scale) if scale is not None else \
        1.0 / math.sqrt(q.shape[-1])
    return _Flash.apply(q, k, v, bool(causal), scale, int(offset), block_q,
                        block_k)


def flash_attention(q, k, v, causal=False, scale=None, block_q=None,
                    block_k=None):
    """Flash attention. q, k, v: (B, H, S, D) -> (B, H, S, D)."""
    out, _ = flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                      block_q=block_q, block_k=block_k)
    return out


# ---------------------------------------------------------------------------
# Paged decode attention
# ---------------------------------------------------------------------------


# positions per block of the paged kernel, largest first (rounded down to
# whole pages), and the blocks (of 8 warps) an SM the split aims for when
# every row is full: _decode_chunk
_DECODE_CHUNKS = (512, 256, 128, 64)
_DECODE_BLOCKS_PER_SM = 4


def _decode_chunk(batch, heads, max_len, page, sms):
    """Positions per block of the paged-decode kernel, from static shapes
    only (the lengths live on the device): the largest of
    ``_DECODE_CHUNKS``, in whole pages and at least one page, whose split
    of full rows of ``max_len`` positions gives each of ``sms`` SMs
    ``_DECODE_BLOCKS_PER_SM`` blocks; else the smallest."""
    for c in _DECODE_CHUNKS:
        chunk = max(page, c // page * page)
        if batch * heads * -(-max_len // chunk) >= _DECODE_BLOCKS_PER_SM * sms:
            break
    return chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                            scale, chunk=None):
    """Gather-then-attend reference in f32. q (B, H, D); k/v_pages
    (P, page, H, D); page_table (B, max_pages) int; lengths (B,) int.
    Returns (B, H, D) in q's dtype.

    ``chunk`` (positions) computes it the paged kernel's way instead: per
    chunk of the row, a log2-domain partial (max m, denominator l,
    unnormalised output o; an empty chunk is m = -1e30, l = 0, o = 0),
    merged in chunk order with the denominator clamped at 1e-30, so a
    length-0 row gives 0. The main path never passes it."""
    b, h, d = q.shape
    page = k_pages.shape[1]
    table = page_table.long()
    k = k_pages[table].float()  # (B, max_pages, page, H, D)
    v = v_pages[table].float()
    s = k.shape[1] * page
    k = k.reshape(b, s, h, d)
    v = v.reshape(b, s, h, d)
    scores = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    live = (torch.arange(s, device=q.device)[None, :]
            < lengths.to(q.device).long()[:, None])  # (B, S)
    scores = torch.where(live[:, None], scores,
                         torch.full_like(scores, _NEG_INF))
    if chunk is None:
        p = torch.softmax(scores, dim=-1)
        return torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    s2 = torch.nn.functional.pad(scores * _LOG2E, (0, pad), value=_NEG_INF)
    s2 = s2.reshape(b, h, nc, chunk)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    m = s2.amax(dim=-1)  # (B, H, nc)
    p = torch.exp2(s2 - m[..., None])
    p = torch.where(s2 <= _NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    o = torch.einsum("bhcs,bcshd->bhcd", p, v.reshape(b, nc, chunk, h, d))
    big = m.amax(dim=-1)  # (B, H)
    den = torch.zeros_like(big)
    acc = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
    for c in range(nc):  # the kernel's merge order
        w = torch.exp2(m[..., c] - big)
        den = den + l[..., c] * w
        acc = acc + o[:, :, c] * w[..., None]
    return (acc / den.clamp_min(1e-30)[..., None]).to(q.dtype)


@_costed("paged_decode_attention", _decode_cost)
def flash_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None):
    """Paged decode attention; shapes as :func:`decode_attention`.

    On CUDA tensors this launches the hand-written kernel, its sequences
    split into chunks of :func:`_decode_chunk` positions, and adds one to
    ``flash_decode_attention.launches``; on CPU tensors it computes the
    plain version and counts nothing. ``k_pages``/``v_pages`` may be
    strided views (last dimension contiguous, same strides); q may be a
    view with a contiguous last dimension; ``page_table`` (int32,
    contiguous) and ``lengths`` (int32) must be on q's device.
    """
    b, h, d = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if not q.is_cuda:
        if q.device.type in _PLAIN_DEVICES:
            return _decode_attention_plain(q, k_pages, v_pages, page_table,
                                           lengths, scale)
        raise MXNetError(f"flash_decode_attention: unsupported device "
                         f"{q.device}")
    page = k_pages.shape[1]
    chunk = _decode_chunk(b, h, page_table.shape[1] * page, page,
                          _sm_count(q.get_device()))
    return _paged_decode_launch(q, k_pages, v_pages, page_table, lengths,
                                scale, chunk)


flash_decode_attention.launches = 0


def _paged_decode_launch(q, k_pages, v_pages, page_table, lengths, scale,
                         chunk):
    """Check the CUDA inputs and launch the paged kernel with chunks of
    ``chunk`` positions (a multiple of the page); counts the launch on
    ``flash_decode_attention.launches``. ``tools/decode_chunks.py`` calls
    it with each chunk it times."""
    b, h, d = q.shape
    n_pages, page = k_pages.shape[:2]
    max_pages = page_table.shape[1]
    dtype = _DTYPE_CODE.get(q.dtype)
    if dtype is None:
        raise MXNetError(f"flash_decode_attention: dtype {q.dtype} not in "
                         "float32/bfloat16/float16")
    if k_pages.shape != (n_pages, page, h, d) or \
            v_pages.shape != k_pages.shape:
        raise MXNetError(f"flash_decode_attention: k/v pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise MXNetError("flash_decode_attention: q, k and v dtypes differ")
    if k_pages.stride() != v_pages.stride() or k_pages.stride(3) != 1 \
            or q.stride(2) != 1:
        raise MXNetError("flash_decode_attention: k/v views need equal "
                         "strides and a contiguous last dim; q a "
                         "contiguous last dim")
    if page_table.shape != (b, max_pages) or tuple(lengths.shape) != (b,):
        raise MXNetError("flash_decode_attention: page_table must be "
                         "(B, max_pages) and lengths (B,)")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise MXNetError(f"flash_decode_attention: {name} must be "
                             "contiguous int32")
    for t in (k_pages, v_pages, page_table, lengths):
        if t.device != q.device:
            raise MXNetError("flash_decode_attention: all inputs must be "
                             f"on {q.device}")
    if not (0 < d <= 256 and 0 < b <= 65535 and 0 < h <= 65535
            and 0 < max_pages * page < 2 ** 31 and n_pages > 0):
        raise MXNetError(f"flash_decode_attention: the kernel takes D <= "
                         f"256, B and H <= 65535 and fewer than 2**31 "
                         f"positions; got q {tuple(q.shape)}, "
                         f"{max_pages} x {page} positions")
    if chunk <= 0 or chunk % page or chunk // page > 512:
        raise MXNetError(f"flash_decode_attention: chunk {chunk} is not a "
                         f"whole number (at most 512) of pages of {page}")
    n_chunks = -(-max_pages * page // chunk)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    # the partials (o[D], then m and l) of rows longer than one chunk
    ws = torch.empty(b * h * n_chunks * (d + 2), dtype=torch.float32,
                     device=q.device) if n_chunks > 1 else None
    err = _kernels.entry("paged_decode_attention")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), dtype, b, h, d, page,
        max_pages, n_pages, chunk, q.stride(0), q.stride(1),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        scale * _LOG2E, _kernels.stream(q))
    if err != 0:
        raise MXNetError(f"paged_decode_attention launch failed: "
                         f"cudaError {err}")
    flash_decode_attention.launches += 1
    return out


def decode_attention(q, k_pages, v_pages, page_table, lengths, scale=None):
    """Single-position attention against a paged KV cache.

    q (B, H, D) — one query position per live sequence; k_pages/v_pages
    (P, page_size, H, D) — the device page pool (strided views welcome);
    page_table (B, max_pages) int32 — page ids in position order (pad
    unused entries with any valid page, e.g. scratch page 0); lengths (B,)
    int32 — positions visible per sequence (0 = inactive row: finite
    garbage). Returns (B, H, D). ``MXNET_DECODE_ATTN`` picks the path (see
    the module docstring).
    """
    impl = os.environ.get("MXNET_DECODE_ATTN", "auto")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if impl == "plain":
        return _decode_attention_plain(q, k_pages, v_pages, page_table,
                                       lengths, scale)
    if impl not in ("auto", "kernel"):
        raise MXNetError(f"MXNET_DECODE_ATTN={impl!r}: expected "
                         "auto|kernel|plain")
    if impl == "kernel" and q.device.type != "cuda":
        raise MXNetError("MXNET_DECODE_ATTN=kernel needs CUDA tensors; got "
                         f"q on {q.device}")
    return flash_decode_attention(q, k_pages, v_pages, page_table, lengths,
                                  scale=scale)
