"""2-bit gradient compression with error feedback (counterpart of
``mxnet_tpu/kvstore/compression.py``).

- Each f32 gradient value quantizes to 2 bits against a threshold: ``01``
  if the residual is >= threshold, ``10`` if it is <= -threshold, ``00``
  otherwise, four values a byte, the first in the low bits.
- Error feedback: the worker keeps a residual per key; each round
  ``residual += grad``, the quantized ``±threshold`` is sent and
  subtracted from the residual, so no gradient mass is dropped, only
  delayed.

Wire format (shared with both parameter servers, the Python one and
``native/ps/ps_server.cc``): dtype code ``16`` in the array framing,
payload ``f32 threshold | packed bytes``.

The packed bytes and the residuals are byte-identical with the
reference's. numpy arrays go through the numpy functions; a ``torch``
tensor (the device store's gradients, on the card or the CPU) is
quantized where it lies by the same f32 arithmetic in PyTorch
(:func:`quantize_2bit_torch`), and its residual stays on that device.
"""
from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np
import torch

from ..base import MXNetError

TWO_BIT_DTYPE_CODE = 16

__all__ = ["GradientCompression", "TWO_BIT_DTYPE_CODE", "quantize_2bit",
           "dequantize_2bit", "quantize_2bit_torch", "dequantize_2bit_torch",
           "validate_compression_params"]


def validate_compression_params(params) -> Optional[dict]:
    """The reference's ``set_gradient_compression`` contract: type in
    {'none', '2bit'}, threshold > 0; anything else raises."""
    if params is None:
        return None
    params = dict(params)
    ctype = params.pop("type", None)
    if ctype in (None, "none"):
        if params:
            raise MXNetError(f"unexpected compression params {params}")
        return None
    if ctype != "2bit":
        raise MXNetError(
            f"gradient compression type {ctype!r} is not supported "
            "(supported: '2bit')")
    threshold = float(params.pop("threshold", 0.5))
    if threshold <= 0:
        raise MXNetError("threshold must be > 0")
    if params:
        raise MXNetError(f"unexpected compression params {params}")
    return {"type": "2bit", "threshold": threshold}


def quantize_2bit(residual: np.ndarray, threshold: float) -> np.ndarray:
    """Quantize ``residual`` in place: returns the packed uint8 codes and
    subtracts the sent amount from ``residual`` (error feedback)."""
    pos = residual >= threshold
    neg = residual <= -threshold
    codes = np.where(pos, np.uint8(1), np.where(neg, np.uint8(2), np.uint8(0)))
    codes = codes.astype(np.uint8).ravel()
    residual -= threshold * (pos.astype(np.float32) - neg.astype(np.float32))
    pad = (-len(codes)) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, np.uint8)])
    c = codes.reshape(-1, 4)
    packed = (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6))
    return packed.astype(np.uint8)


def dequantize_2bit(packed: np.ndarray, threshold: float, size: int,
                    dtype=np.float32) -> np.ndarray:
    """Unpack 2-bit codes to ±threshold / 0 floats (flat, ``size`` long)."""
    p = packed.astype(np.uint8)
    codes = np.empty((len(p), 4), np.uint8)
    codes[:, 0] = p & 3
    codes[:, 1] = (p >> 2) & 3
    codes[:, 2] = (p >> 4) & 3
    codes[:, 3] = (p >> 6) & 3
    flat = codes.ravel()[:size]
    out = np.zeros(size, dtype)
    out[flat == 1] = threshold
    out[flat == 2] = -threshold
    return out


def quantize_2bit_torch(residual: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """:func:`quantize_2bit` on an f32 tensor, on its device: returns the
    packed uint8 codes (a tensor on the same device) and updates
    ``residual`` in place, with the numpy version's f32 arithmetic."""
    pos = residual >= threshold
    neg = residual <= -threshold
    residual -= threshold * (pos.to(torch.float32) - neg.to(torch.float32))
    codes = pos.to(torch.uint8).reshape(-1) | (neg.to(torch.uint8)
                                               .reshape(-1) << 1)
    pad = (-codes.numel()) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    c = codes.reshape(-1, 4)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def dequantize_2bit_torch(packed: torch.Tensor, threshold: float,
                          size: int) -> torch.Tensor:
    """:func:`dequantize_2bit` on a uint8 tensor, on its device (f32)."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=packed.device)
    flat = ((packed.reshape(-1, 1) >> shifts) & 3).reshape(-1)[:size]
    t = torch.tensor(threshold, dtype=torch.float32, device=packed.device)
    zero = torch.zeros((), dtype=torch.float32, device=packed.device)
    return torch.where(flat == 1, t, torch.where(flat == 2, -t, zero))


class GradientCompression:
    """Worker-side state: a residual per key and the pack/unpack helpers.
    numpy gradients keep numpy residuals; tensors keep tensor residuals
    on their own device."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = float(threshold)
        self._residuals: Dict[str, object] = {}

    def compress(self, key: str, grad):
        res = self._residuals.get(key)
        if isinstance(grad, torch.Tensor):
            if not (isinstance(res, torch.Tensor) and res.shape == grad.shape
                    and res.device == grad.device):
                res = self._residuals[key] = torch.zeros(
                    grad.shape, dtype=torch.float32, device=grad.device)
            res += grad.to(torch.float32)
            return quantize_2bit_torch(res, self.threshold)
        if not isinstance(res, np.ndarray) or res.shape != grad.shape:
            res = self._residuals[key] = np.zeros(grad.shape, np.float32)
        res += grad.astype(np.float32)
        return quantize_2bit(res, self.threshold)

    def decompress(self, packed, shape):
        size = int(np.prod(shape)) if len(shape) else 1
        if isinstance(packed, torch.Tensor):
            return dequantize_2bit_torch(packed, self.threshold,
                                         size).reshape(tuple(shape))
        return dequantize_2bit(packed, self.threshold, size).reshape(shape)

    def pack_wire(self, key: str, grad: np.ndarray) -> bytes:
        """The array framing with dtype code 16 (module docstring)."""
        packed = self.compress(key, grad)
        head = struct.pack("<B", grad.ndim) \
            + struct.pack(f"<{grad.ndim}I", *grad.shape) \
            + struct.pack("<B", TWO_BIT_DTYPE_CODE) \
            + struct.pack("<f", self.threshold)
        return head + packed.tobytes()
