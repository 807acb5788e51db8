"""Automatic mixed precision (counterpart of ``mxnet_tpu/amp.py``).

The reference's policy: ``init`` picks the 16-bit type,
``convert_hybrid_block`` casts a block's parameters to it (LayerNorm and
BatchNorm gammas, betas and statistics stay f32), and products of 16-bit
operands accumulate in f32. bfloat16 shares float32's exponent range and
needs no loss scaling; float16, which the card runs at the same rate,
gets a dynamic :class:`LossScaler` from ``init_trainer``. Attached to a
``gluon.Trainer``, the scaler's whole protocol (unscale, found-inf, skip,
scale update) runs inside the multi-tensor update on the device, with no
read of the host a step (``optimizer/fused.py``).
"""
from __future__ import annotations

import torch

from .base import dtype_name

__all__ = ["init", "init_trainer", "convert_model", "convert_hybrid_block",
           "amp_cast", "LossScaler", "scale_loss", "unscale"]

_TARGET = {"dtype": None}
_KEEP_F32 = ("running_mean", "running_var", "moving_mean", "moving_var",
             "gamma", "beta")


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Install the global AMP type (``bfloat16`` or ``float16``)."""
    _TARGET["dtype"] = dtype_name(target_dtype)


def init_trainer(trainer, loss_scaler=None):
    """Attach a dynamic loss scaler to a gluon Trainer: the one given, or a
    new one when AMP runs in float16; bfloat16 needs none. Returns it."""
    if loss_scaler is None and _TARGET["dtype"] == "float16":
        loss_scaler = LossScaler()
    if loss_scaler is not None and hasattr(trainer, "_amp_loss_scaler"):
        trainer._amp_loss_scaler = loss_scaler
    return loss_scaler


def convert_hybrid_block(block, target_dtype="bfloat16", ctx=None,
                         cast_optional_params=False):
    """Cast a Gluon block's parameters to ``target_dtype``; normalization
    gammas, betas and statistics stay f32."""
    for p in block._iter_params():
        if p.name.endswith(_KEEP_F32):
            continue
        p.cast(target_dtype)
    return block


convert_model = convert_hybrid_block


def amp_cast(x, dtype="bfloat16"):
    return x.astype(dtype)


class LossScaler:
    """The dynamic loss scaler: the scale starts at 1, as the reference's
    does, halves on a step with non-finite gradients (which is skipped)
    and doubles after ``scale_window`` clean steps, within [1e-4, 2^24].
    ``loss_scale`` may be a float or, once a fused update ran, a 0-d array
    on the device."""

    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self.loss_scale = 1.0
        self._init_scale = init_scale
        self._factor = scale_factor
        self._window = scale_window
        self._unskipped = 0
        self.skip_streak = 0  # consecutive skipped steps

    def has_overflow(self, params):
        """True when some parameter's gradient is not finite: one batched
        reduction and one read of the device."""
        flags = []
        for p in params:
            g = p.grad() if callable(getattr(p, "grad", None)) else None
            if g is not None:
                flags.append(torch.isfinite(g._data.float()).all())
        if not flags:
            return False
        return not bool(torch.stack(flags).all())

    def update_scale(self, skip):
        if skip:
            self.loss_scale = max(self.loss_scale / self._factor, 1e-4)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._window:
                self.loss_scale = min(self.loss_scale * self._factor,
                                      2 ** 24)
                self._unskipped = 0


def scale_loss(loss, scaler: LossScaler):
    return loss * scaler.loss_scale


def unscale(grads, scaler: LossScaler):
    return [g / scaler.loss_scale for g in grads]
