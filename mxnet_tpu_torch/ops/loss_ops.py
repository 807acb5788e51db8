"""CTC loss, ``ctc_loss`` and its aliases (counterpart of
``mxnet_tpu/ops/loss_ops.py``).

The forward algorithm over the blank-interleaved label lattice, in log
space, one step per time frame, batched over the sequences; its gradient
is autograd's through the recursion, as the reference's is ``jax.grad``'s,
except that a pair of dead lattice entries sums to 1 before its log, so
the gradient is finite where the reference's is NaN.
cuDNN's CTC is not used: its label rules differ. ``gluon.loss.CTCLoss``
computes through :func:`ctc_nll` too.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["ctc_nll"]

_NEG = -1e30


def _logsumexp2(a, b):
    # the reference's, with the sum of a dead pair replaced by 1 before the
    # log: its value is unchanged and its gradient finite (the reference's
    # is NaN there, and so reaches every input)
    m = torch.maximum(a, b)
    dead = m <= _NEG / 2
    m_safe = torch.where(dead, torch.zeros_like(m), m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    out = m_safe + torch.log(torch.where(dead, torch.ones_like(s), s))
    return torch.where(dead, torch.full_like(out, _NEG), out)


def ctc_nll(logprobs, labels, t_lens, l_lens, blank):
    """-log p(label | x) of each sequence. logprobs (T, B, C) log-softmax;
    labels (B, L) class indices (any value past ``l_lens`` is ignored);
    t_lens, l_lens (B,). Frames at or past ``t_lens`` leave alpha as it
    is."""
    T, B, _C = logprobs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev, dt = logprobs.device, logprobs.dtype
    lab = labels.to(torch.int64)
    t_lens = t_lens.to(torch.int64)
    l_lens = l_lens.to(torch.int64)
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    pos = torch.arange(S, device=dev)[None, :]
    valid_s = pos < 2 * l_lens[:, None] + 1
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    neg = torch.full((B, S), _NEG, dtype=dt, device=dev)
    lp0 = torch.gather(logprobs[0], 1, ext)  # (B, S)
    alpha = torch.where(pos == 0, lp0, neg)
    alpha = torch.where((pos == 1) & (l_lens[:, None] > 0), lp0, alpha)
    pad1 = torch.full((B, 1), _NEG, dtype=dt, device=dev)
    pad2 = torch.full((B, 2), _NEG, dtype=dt, device=dev)
    for t in range(1, T):
        a_prev = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_prev2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        a = _logsumexp2(_logsumexp2(alpha, a_prev),
                        torch.where(can_skip, a_prev2, neg))
        a = a + torch.gather(logprobs[t], 1, ext)
        a = torch.where(valid_s, a, neg)
        alpha = torch.where((t < t_lens)[:, None], a, alpha)
    end1 = torch.gather(alpha, 1, (2 * l_lens - 1).clamp_min(0)[:, None])[:, 0]
    end2 = torch.gather(alpha, 1, (2 * l_lens)[:, None])[:, 0]
    ll = _logsumexp2(torch.where(l_lens > 0, end1, torch.full_like(end1,
                                                                   _NEG)),
                     end2)
    return -ll


def _ctc_n_out(kwargs):
    return 2


@register("ctc_loss", aliases=["CTCLoss", "_contrib_ctc_loss",
                               "_contrib_CTCLoss"],
          num_outputs=_ctc_n_out, ndarray_inputs=["data", "label"])
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first", _pad_value=0):
    """data (T, B, C) unnormalized activations; label (B, L).

    Returns (loss (B,), log_softmax(data)), as the reference. With
    ``blank_label="first"`` blank is class 0 and ``_pad_value`` (0) ends a
    label row; with ``"last"`` blank is C-1 and -1 pads. Explicit lengths
    take over when ``use_*_lengths``."""
    T, B, C = data.shape
    logprobs = torch.log_softmax(data.to(torch.float32), dim=-1)
    lab = label.to(torch.int32)
    if blank_label == "first":
        blank = 0
        eff = torch.where(lab == int(_pad_value), torch.full_like(lab, -1),
                          lab)
    else:
        blank = C - 1
        eff = lab
    if use_label_lengths and label_lengths is not None:
        l_lens = label_lengths.to(torch.int32)
    else:
        l_lens = (eff >= 0).to(torch.int32).sum(dim=-1)
    if use_data_lengths and data_lengths is not None:
        t_lens = data_lengths.to(torch.int32)
    else:
        t_lens = torch.full((B,), T, dtype=torch.int32, device=data.device)
    losses = ctc_nll(logprobs, eff.clamp_min(0), t_lens, l_lens, blank)
    return losses.to(data.dtype), logprobs.to(data.dtype)
