"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``).

Each loss is a ``HybridBlock`` over the registered ops, with the
reference's semantics: per-sample weighting, ``sample_weight``
broadcasting, and a mean over every axis except ``batch_axis``, so (B, S,
V) logits with (B, S) labels give a (B,) loss.

A loss also takes plain ``torch.Tensor``s, as ``parallel.ShardedTrainer``
gives it, and then returns one: the tensors are wrapped as arrays for the
call and torch records the ops whenever its grad mode is on.
"""
from __future__ import annotations

import math

import torch

from .. import autograd
from ..ndarray import NDArray
from ..ndarray.ndarray import invoke_fn
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss", "SigmoidBinaryCrossEntropyLoss", "SigmoidBCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss", "CTCLoss",
           "PoissonNLLLoss", "SDMLLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None and weight != 1.0:
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    return x.reshape(y.shape)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __call__(self, *args, **kwargs):
        if not any(isinstance(a, torch.Tensor) for a in args):
            return super().__call__(*args, **kwargs)
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        wrapped = [NDArray(torch.as_tensor(a, device=dev))
                   if a is not None and not isinstance(a, NDArray) else a
                   for a in args]
        with autograd._Scope(torch.is_grad_enabled(), None):
            out = super().__call__(*wrapped, **kwargs)
        return out._data

    def __repr__(self):
        return (f"{self.__class__.__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(label - pred)
        loss = _apply_weighting(F, loss, self._weight / 2, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SoftmaxCrossEntropyLoss(Loss):
    """Cross entropy with an integrated log-softmax. ``sparse_label``:
    labels are class indices along ``axis`` (clipped into range, as
    ``pick`` does); else a distribution shaped like ``pred``."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse:
            loss = -F.pick(pred, label, axis=self._axis, keepdims=True)
        else:
            label = _reshape_like(F, label, pred)
            loss = -F.sum(pred * label, axis=self._axis, keepdims=True)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       pos_weight=None):
        label = _reshape_like(F, label, pred)
        if not self._from_sigmoid:
            # max(x, 0) - x z + log(1 + exp(-|x|)), numerically stable
            loss = F.relu(pred) - pred * label + \
                F.Activation(-F.abs(pred), act_type="softrelu")
        else:
            eps = 1e-12
            loss = -(F.log(pred + eps) * label
                     + F.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (F.log(label + 1e-12) - pred)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HuberLoss(Loss):
    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.abs(label - pred)
        loss = F.where(loss > self._rho, loss - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(loss))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.relu(self._margin - pred * label)
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        loss = F.square(F.relu(self._margin - pred * label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._fmt = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._fmt == "binary":
            label = 2 * label - 1
        loss = F.Activation(-pred * label, act_type="softrelu")
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, pred, positive, negative,
                       sample_weight=None):
        positive = _reshape_like(F, positive, pred)
        negative = _reshape_like(F, negative, pred)
        loss = F.sum(F.square(pred - positive) - F.square(pred - negative),
                     axis=self._batch_axis, exclude=True)
        loss = F.relu(loss + self._margin)
        return _apply_weighting(F, loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def hybrid_forward(self, F, input1, input2, label, sample_weight=None):
        def cos(a, b):
            num = F.sum(a * b, axis=-1)
            den = F.sqrt(F.sum(a * a, axis=-1)) * \
                F.sqrt(F.sum(b * b, axis=-1))
            return num / (den + 1e-12)

        sim = cos(input1, input2)
        label = label.reshape(sim.shape)
        loss = F.where(label == 1, 1 - sim, F.relu(sim - self._margin))
        return _apply_weighting(F, loss, self._weight, sample_weight)


def _ctc(pred, label, ntc):
    """Negative log-likelihood of each label sequence under CTC
    (``ops.loss_ops.ctc_nll``): pred (T, N, C), or (N, T, C) when
    ``ntc``; label (N, L), blank 0, padding <= 0. Returns (N,)."""
    from ..ops.loss_ops import ctc_nll

    x = pred.transpose(0, 1) if ntc else pred  # (T, N, C)
    lab = label.to(torch.int64)
    valid = lab > 0
    lens = torch.full((x.shape[1],), x.shape[0], dtype=torch.int64,
                      device=x.device)
    return ctc_nll(torch.log_softmax(x, dim=-1),
                   torch.where(valid, lab, torch.zeros_like(lab)), lens,
                   valid.sum(dim=1), 0)


class CTCLoss(Loss):
    """Connectionist temporal classification loss: pred (T, N, C) unless
    ``layout='NTC'``; labels (N, L) padded with -1 (or 0)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        ntc = self._layout == "NTC"
        loss = invoke_fn(lambda p, lb: _ctc(p, lb, ntc), [pred, label])
        return _apply_weighting(F, loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log likelihood: pred is the predicted mean (or its
    log when ``from_logits``)."""

    def __init__(self, weight=1.0, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def hybrid_forward(self, F, pred, label, sample_weight=None,
                       epsilon=1e-08):
        label = _reshape_like(F, label, pred)
        if self._from_logits:
            loss = F.exp(pred) - label * pred
        else:
            loss = pred - label * F.log(pred + epsilon)
        if self._compute_full:
            # Stirling approximation of log(label!) for label > 1
            stirling = (label * F.log(label + epsilon) - label
                        + 0.5 * F.log(2.0 * math.pi * (label + epsilon)))
            loss = loss + F.where(label > 1.0, stirling,
                                  F.zeros_like(label))
        loss = _apply_weighting(F, loss, self._weight, sample_weight)
        return F.mean(loss)


class SDMLLoss(Loss):
    """Smoothed deep metric learning loss: row i scores x1[i] against every
    x2[j] by negative euclidean distance; the matching pair is the target,
    with label smoothing over the others."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smooth = smoothing_parameter

    def hybrid_forward(self, F, x1, x2, sample_weight=None):
        smooth = self._smooth

        def pure(a, b):
            n = a.shape[0]
            d = torch.sqrt(torch.sum((a[:, None, :] - b[None, :, :]) ** 2,
                                     dim=-1) + 1e-12)
            logp = torch.log_softmax(-d, dim=1)
            eye = torch.eye(n, dtype=logp.dtype, device=logp.device)
            target = eye * (1.0 - smooth) + (1.0 - eye) * (smooth / (n - 1))
            return -torch.mean(torch.sum(target * logp, dim=1))

        return invoke_fn(pure, [x1, x2])
