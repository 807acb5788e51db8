"""Attention dispatch: plain PyTorch attention vs the flash kernels.

Counterpart of ``mxnet_tpu/ops/attention.py``, with its policy:

- sequences shorter than ``_FLASH_MIN_SEQ``: :func:`plain_attention`, the
  S x S scores materialized;
- sequences of ``_FLASH_MIN_SEQ`` or more: :func:`flash_attention`
  (``flash_attention.py``; the CUDA kernels on a CUDA tensor);
- an explicit mask: plain (the kernels handle causal masks only).

``MXNET_ATTENTION_IMPL`` in {auto, plain, flash} overrides; any other
value raises ``MXNetError`` (the reference treats it as auto). The
threshold 1024 is the reference's, measured on a TPU; it has not been
measured on the card yet.

On a mesh of several ranks the model's q, k and v are ``DTensor``s:
:func:`sharded_attention` runs :func:`fused_attention` on each rank's
shard (B over ``dp``, H over ``tp`` where they divide), so the kernels
only ever see plain tensors.
"""
from __future__ import annotations

import math
import os

import torch

from ..base import MXNetError
from .flash_attention import flash_attention

__all__ = ["fused_attention", "plain_attention", "sharded_attention"]

_FLASH_MIN_SEQ = 1024


def plain_attention(q, k, v, mask=None, causal=False, scale=None):
    """Single-device reference attention. q, k, v: (B, H, S, D). Scores in
    q's dtype, softmax in f32; a causal mask hides columns past
    ``tril(k=s_k - s_q)`` with -inf."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        cm = torch.ones((s_q, s_k), dtype=torch.bool,
                        device=q.device).tril(s_k - s_q)
        scores = scores.masked_fill(~cm, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask.bool(), float("-inf"))
    w = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(w, v)


def _flash_ok(q, k):
    s_q, s_k = q.shape[-2], k.shape[-2]
    return s_q == s_k and s_q % 8 == 0 and q.dim() == 4


def fused_attention(q, k, v, mask=None, causal=False, scale=None, impl=None):
    """The attention entry point of the model zoo (``MultiHeadAttention``).
    ``impl`` (or ``MXNET_ATTENTION_IMPL``) is auto, plain or flash."""
    impl = impl or os.environ.get("MXNET_ATTENTION_IMPL", "auto")
    if impl == "flash":
        use_flash = mask is None and _flash_ok(q, k)
    elif impl == "plain":
        use_flash = False
    elif impl == "auto":
        use_flash = (mask is None and _flash_ok(q, k)
                     and q.shape[-2] >= _FLASH_MIN_SEQ)
    else:
        raise MXNetError(f"MXNET_ATTENTION_IMPL={impl!r}: expected "
                         "auto|plain|flash")
    if use_flash:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    return plain_attention(q, k, v, mask=mask, causal=causal, scale=scale)


def sharded_attention(q, k, v, mesh, mask=None, causal=False, scale=None):
    """:func:`fused_attention` of global (B, H, S, D) ``DTensor``s over
    ``mesh`` (a ``parallel.Mesh`` of several ranks), computed on each
    rank's shard: B over ``dp`` and H over ``tp`` where they divide, the
    rest of the mesh replicated. A mask (B or 1, H or 1, S, S) is sliced
    the same way. Returns the output as a ``DTensor`` in that
    sharding."""
    from torch.distributed.tensor import DTensor, Replicate

    from ..parallel.sharding import NamedSharding, P, _prune

    spec = _prune(P("dp", "tp"), mesh, tuple(q.shape))
    placements = NamedSharding(mesh, spec).placements
    dm = mesh.device_mesh

    def local(t, pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                                   run_check=False)
        return t.redistribute(dm, pl).to_local()

    ql, kl, vl = (local(t, placements) for t in (q, k, v))
    if mask is not None:
        # a broadcast dim of the mask stays whole
        mpl = [pl if not pl.is_shard() or mask.shape[pl.dim] == q.shape[
            pl.dim] else Replicate() for pl in placements]
        mask = local(mask, mpl)
    out = fused_attention(ql, kl, vl, mask=mask, causal=causal, scale=scale)
    return DTensor.from_local(out, dm, placements, run_check=False,
                              shape=q.shape, stride=_contiguous(q.shape))


def _contiguous(shape):
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))
