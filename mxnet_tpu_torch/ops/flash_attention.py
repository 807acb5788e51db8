"""Flash attention (training) and paged decode attention (serving).

Counterpart of ``mxnet_tpu/ops/flash_attention.py``. Each function that
reached a Pallas kernel there reaches a hand-written CUDA kernel here
(``csrc/``), with a plain PyTorch version beside it: the CPU path and the
yardstick the kernel is held to on the card. A wrapper computes the plain
version only for a tensor on the CPU; on a CUDA tensor it launches its
kernel, counts the launch in its ``.launches`` and never falls back.

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
the bf16/f16 backward 128 by 64 at D 64, 64 by 128 at D 16, else 64 by
64; the f32 kernels 64 by 64. On a CUDA tensor, a requested tile that a
kernel the call reaches was not built for raises: the wrappers check
their own kernel, ``_Flash`` the backward's too before it returns from
the forward.

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
a copy. :func:`_decode_attention_plain` materializes the gather instead;
it is the CPU path and the yardstick the kernel is held to.

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

Length-0 rows (inactive decode slots): the output is finite, never NaN,
and otherwise unspecified. The kernel writes 0 there; the plain version,
like the reference's XLA path, averages whatever the padded page table
points at; the reference's Pallas kernel gives yet another value. Callers
discard these rows.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from ..base import MXNetError

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_fwd", "flash_attention_bwd",
           "decode_attention", "flash_decode_attention"]

_NEG_INF = -1e30  # avoids -inf NaN propagation for fully-masked rows
_LOG2E = math.log2(math.e)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_PLAIN_BLOCK = 512        # the plain version's default tile (reference's)
_KERNEL_DIMS = (16, 32, 64, 128)


def _kernel_tiles(which, dtype, d):
    """(block_q, block_k) of the CUDA kernel ``which`` ("fwd" or "bwd") for
    ``dtype`` and head dim ``d``: kFwdBM/kFwdBN of
    ``csrc/flash_attention_fwd.cu``, kWgBM/kWgBN (D 64) or
    kBwdBM/BwdLayout::BN of ``csrc/flash_attention_bwd.cu``, kBQ/kBK of
    ``csrc/flash_common.cuh`` for f32."""
    if dtype == torch.float32:
        return 64, 64
    if which == "fwd":
        return 128, 64
    return {16: (64, 128), 64: (128, 64)}.get(d, (64, 64))


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
    if q.shape[-1] not in _KERNEL_DIMS:
        raise MXNetError(f"{name}: head dim {q.shape[-1]} not in "
                         f"{_KERNEL_DIMS}")
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
    if q.shape[0] * q.shape[1] > 65535:
        raise MXNetError(f"{name}: B * H = {q.shape[0] * q.shape[1]} "
                         "exceeds the grid's 65535")


def _strides(*tensors):
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _empty_bshd(q):
    """A (B, H, S, D) output whose memory is (B, S, H, D): the model's
    transpose back to (B, S, H*D) is then free."""
    b, h, s, d = q.shape
    return torch.empty((b, s, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def flash_attention_fwd(q, k, v, causal=False, scale=None, offset=0,
                        block_q=None, block_k=None):
    """Flash-attention forward -> (out, lse), q/k/v (B, H, S, D).

    On CUDA tensors this launches ``csrc/flash_attention_fwd.cu`` and adds
    one to ``flash_attention_fwd.launches``; q/k/v may be strided views
    with a contiguous last dim. On CPU tensors it computes
    :func:`_flash_attention_plain` and counts nothing."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _flash_attention_plain(q, k, v, causal, scale, offset,
                                      block_q, block_k)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_attention_fwd: unsupported device "
                         f"{q.device}")
    _check_flash("flash_attention_fwd", "fwd", q, (k, v), block_q, block_k)
    from ._kernels import load

    b, h, s, _ = q.shape
    out = _empty_bshd(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn = load("flash_attention_fwd").flash_attention_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), _DTYPE_CODE[q.dtype], b, h, s, d,
             _strides(q, k, v, out), int(bool(causal)), int(offset), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"flash_attention_fwd launch failed: cudaError "
                         f"{err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, g_lse=None, causal=False,
                        scale=None, offset=0, block_q=None, block_k=None):
    """Flash-attention backward -> (dq, dk, dv).

    ``lse`` is the forward's, ``dout`` the cotangent of out and ``g_lse``
    that of lse (None: zero). On CUDA tensors this launches
    ``csrc/flash_attention_bwd.cu`` (its preprocess kernel, which forms
    dl = rowsum(dout * out) - g_lse, then its main pass and, for bf16/f16,
    the dQ conversion from an f32 accumulator allocated here) and adds one
    to ``flash_attention_bwd.launches``. On CPU tensors it computes
    :func:`_flash_bwd_plain` and counts nothing."""
    d = q.shape[-1]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _flash_bwd_plain(q, k, v, out, lse, dout, g_lse, causal,
                                scale, offset, block_k)
    if q.device.type != "cuda":
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
    from ._kernels import load

    lse = lse.float().contiguous()
    if g_lse is not None:
        g_lse = g_lse.float().contiguous()
    # f32 scratch: dl (delta - dlse, the reference's :333-334) per row and,
    # for bf16/f16, the dQ accumulator the kernel's atomics add into
    dl = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq_acc = None if q.dtype == torch.float32 else torch.empty(
        (b, h, s, d), dtype=torch.float32, device=q.device)
    dq, dk, dv = _empty_bshd(q), _empty_bshd(q), _empty_bshd(q)
    fn = load("flash_attention_bwd").flash_attention_bwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(),
             None if g_lse is None else g_lse.data_ptr(), dl.data_ptr(),
             None if dq_acc is None else dq_acc.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], b, h, s, d,
             _strides(q, k, v, out, dout, dq, dk, dv), int(bool(causal)),
             int(offset), scale,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"flash_attention_bwd launch failed: cudaError "
                         f"{err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


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


def _decode_attention_plain(q, k_pages, v_pages, page_table, lengths,
                            scale):
    """Gather-then-attend reference in f32. q (B, H, D); k/v_pages
    (P, page, H, D); page_table (B, max_pages) int; lengths (B,) int.
    Returns (B, H, D) in q's dtype."""
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
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)


def flash_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           scale=None):
    """Paged decode attention; shapes as :func:`decode_attention`.

    On CUDA tensors this launches the hand-written kernel and adds one to
    ``flash_decode_attention.launches``; on CPU tensors it computes the
    plain version and counts nothing. ``k_pages``/``v_pages`` may be
    strided views (last dimension contiguous, same strides); q may be a
    view with a contiguous last dimension; ``page_table`` (int32,
    contiguous) and ``lengths`` (int32) must be on q's device.
    """
    b, h, d = q.shape
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _decode_attention_plain(q, k_pages, v_pages, page_table,
                                       lengths, scale)
    if q.device.type != "cuda":
        raise MXNetError(f"flash_decode_attention: unsupported device "
                         f"{q.device}")
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

    from ._kernels import load

    fn = load("paged_decode_attention").paged_decode_attention
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             dtype, b, h, d, page, max_pages, n_pages,
             q.stride(0), q.stride(1),
             k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
             scale * _LOG2E, stream)
    if err != 0:
        raise MXNetError(f"paged_decode_attention launch failed: "
                         f"cudaError {err}")
    flash_decode_attention.launches += 1
    return out


flash_decode_attention.launches = 0


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
