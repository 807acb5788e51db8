"""Attention dispatch: plain PyTorch attention vs the flash kernels.

Counterpart of ``mxnet_tpu/ops/attention.py``, with its policy:

- sequences shorter than ``_FLASH_MIN_SEQ``: :func:`plain_attention`, the
  S x S scores materialized;
- sequences of ``_FLASH_MIN_SEQ`` or more: :func:`flash_attention`
  (``flash_attention.py``; the CUDA kernels on a CUDA tensor);
- an explicit mask: plain (the kernels handle causal masks only).

``MXNET_ATTENTION_IMPL`` in {auto, plain, flash} overrides. The threshold
1024 is the reference's, measured on a TPU; it has not been measured on
the card yet.
"""
from __future__ import annotations

import math
import os

import torch

from ..base import MXNetError
from .flash_attention import flash_attention

__all__ = ["fused_attention", "plain_attention"]

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
