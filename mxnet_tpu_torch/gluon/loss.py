"""Gluon losses as ``nn.Module``s.

Counterpart of ``_apply_weighting``, ``Loss`` and
``SoftmaxCrossEntropyLoss`` in ``mxnet_tpu/gluon/loss.py``, with their
semantics: per-sample weighting, ``sample_weight`` broadcasting, and a
mean over every axis except ``batch_axis``, so (B, S, V) logits with
(B, S) labels give a (B,) loss. The other losses belong to a later slice.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


def _mean_except(x, axis):
    axis = axis % x.dim()
    dims = [d for d in range(x.dim()) if d != axis]
    return x.mean(dim=dims) if dims else x


class Loss(nn.Module):
    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy with an integrated log-softmax. ``sparse_label``:
    labels are class indices along ``axis`` (clipped into range, as
    ``pick`` does); else a distribution shaped like ``pred``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = torch.log_softmax(pred, dim=self._axis)
        if self._sparse:
            axis = self._axis % pred.dim()
            idx = torch.as_tensor(label, device=pred.device).long()
            idx = idx.clamp(0, pred.shape[axis] - 1).unsqueeze(axis)
            loss = -torch.gather(pred, axis, idx)
        else:
            label = torch.as_tensor(label, device=pred.device)
            loss = -torch.sum(pred * label.reshape(pred.shape),
                              dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_except(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
