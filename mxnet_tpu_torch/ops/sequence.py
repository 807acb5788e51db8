"""Sequence ops: ``SequenceMask``, ``SequenceLast`` and ``SequenceReverse``
(counterpart of ``mxnet_tpu/ops/sequence.py``).

Time-major ``(seq_len, batch, ...)`` unless ``axis=1``, as the reference;
``SequenceReverse`` takes time-major data only, as the reference's does.
Without ``use_sequence_length`` the whole sequence counts; a length past
the end reverses into NaN, as the reference's ``take_along_axis`` fills.
"""
from __future__ import annotations

import torch

from .indexing import _filled
from .registry import register


def _len_mask(seq_len, length):
    """(seq_len, batch) bool: t < length[b]."""
    t = torch.arange(seq_len, device=length.device)[:, None]
    return t < length.to(torch.int32)[None, :]


@register("SequenceMask", ndarray_inputs=["data", "sequence_length"])
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    ax = int(axis)
    x = data.transpose(0, 1) if ax == 1 else data
    m = _len_mask(x.shape[0], sequence_length)
    m = m.reshape(m.shape + (1,) * (x.ndim - 2))
    out = torch.where(m, x, torch.tensor(value, dtype=x.dtype,
                                         device=x.device))
    return out.transpose(0, 1) if ax == 1 else out


@register("SequenceLast", ndarray_inputs=["data", "sequence_length"])
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0):
    ax = int(axis)
    x = data.transpose(0, 1) if ax == 1 else data
    if not use_sequence_length or sequence_length is None:
        return x[-1]
    idx = (sequence_length.to(torch.int64) - 1).clamp(0, x.shape[0] - 1)
    idx = idx.reshape((1, -1) + (1,) * (x.ndim - 2)).expand(
        (1,) + tuple(x.shape[1:]))
    return torch.gather(x, 0, idx)[0]


@register("SequenceReverse", ndarray_inputs=["data", "sequence_length"])
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0):
    x = data
    if not use_sequence_length or sequence_length is None:
        return torch.flip(x, dims=(0,))
    T = x.shape[0]
    ln = sequence_length.to(torch.int64)[None, :]  # (1, batch)
    t = torch.arange(T, device=x.device)[:, None]
    src = torch.where(t < ln, ln - 1 - t, t)  # reverse the first len steps
    src = src.reshape((T, -1) + (1,) * (x.ndim - 2)).expand(x.shape)
    # a length past the end reads the fill value, as take_along_axis does
    return _filled(x, 0, src, lambda i: torch.gather(x, 0, i))
