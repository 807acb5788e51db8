"""Image operators, ``mx.nd.image.*`` / ``mx.sym.image.*`` (counterpart of
``mxnet_tpu/ops/image_ops.py``).

Layout is HWC, or NHWC batched, as the reference's. The random ops draw
from the framework's generator on the data's device
(``mxnet_tpu_torch.random.generator``), which ``mx.random.seed`` seeds;
torch's generators do not give ``jax.random``'s bits, so they match the
reference in shape, dtype and distribution, not in value. The coin and the
factors stay on the device (no host read).

:func:`resize` is ``jax.image.resize``'s scale-and-translate resampling,
which ``_image_resize``, ``BilinearResize2D`` and ``UpSampling(bilinear)``
share: a triangle kernel widened by 1/scale when it shrinks (the
antialiasing that ``F.interpolate`` does not do), weights renormalized
where the kernel runs past an edge, and half-pixel nearest sampling.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

__all__ = ["resize", "astype"]

_F32_EPS = float(np.finfo(np.float32).eps)


def _t(v, like):
    """``v`` as a 0-d f32 tensor on ``like``'s device: divisions by it stay
    true divisions (a CUDA division by a host scalar multiplies by its
    reciprocal)."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def astype(x, dtype):
    """``x.astype(dtype)`` as XLA converts: a float going to an integer
    type saturates at the type's range and NaN becomes 0 (torch's cast
    wraps out-of-range values)."""
    if x.is_floating_point() and not dtype.is_floating_point \
            and dtype != torch.bool:
        info = torch.iinfo(dtype)
        x = torch.clamp(torch.nan_to_num(x, nan=0.0), info.min, info.max)
    return x.to(dtype)


def _linear_weights(n_in, n_out, device):
    """(n_in, n_out) weights of ``jax.image``'s ``compute_weight_mat`` for
    the triangle kernel with antialiasing, in f32 and its order of
    operations."""
    inv = 1.0 / (n_out / n_in)            # a host f64, used as f32
    inv_t = torch.tensor(inv, dtype=torch.float32, device=device)
    kscale = torch.clamp(inv_t, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_t - 0.0 - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = torch.abs(sample[None, :] - src[:, None]) / kscale
    w = torch.clamp(1.0 - x, min=0.0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(n_in, n_out, device):
    off = (torch.arange(n_out, dtype=torch.float32, device=device)
           + 0.5) * float(n_in)
    off = off / _t(float(n_out), off)
    return torch.floor(off).to(torch.int64)


def resize(data, shape, method="linear"):
    """``jax.image.resize(data, shape, method)`` (antialias on): every dim
    whose size changes is resampled. ``linear``/``bilinear`` returns a
    floating result (integer input computes in f32), ``nearest`` the
    input's dtype."""
    shape = tuple(int(s) for s in shape)
    dims = [d for d in range(data.ndim) if data.shape[d] != shape[d]]
    if method == "nearest":
        out = data
        for d in dims:
            idx = _nearest_index(data.shape[d], shape[d], data.device)
            out = torch.index_select(out, d, idx)
        return out
    if method not in ("linear", "bilinear", "triangle"):
        raise ValueError(f"unknown resize method {method!r}")
    out = data if data.is_floating_point() else data.to(torch.float32)
    for d in dims:
        w = _linear_weights(data.shape[d], shape[d], data.device)
        moved = torch.movedim(out, d, -1)
        out = torch.movedim(torch.matmul(moved, w.to(out.dtype)), -1, d)
    return out


def _hwc_axes(data):
    """(h_axis, w_axis, c_axis) for HWC or NHWC input."""
    if data.ndim == 4:
        return 1, 2, 3
    return 0, 1, 2


def _gen(device):
    from ..random import generator

    return generator(device)


def _uniform(data, low, high):
    """One f32 factor in [low, high) on ``data``'s device."""
    u = torch.rand((), generator=_gen(data.device), device=data.device)
    return u * (float(high) - float(low)) + float(low)


@register("_image_to_tensor", aliases=["image_to_tensor"],
          ndarray_inputs=["data"])
def _to_tensor(data):
    """uint8 HWC [0,255] -> float32 CHW [0,1] (batched: NHWC -> NCHW)."""
    x = data.to(torch.float32) / _t(255.0, data)
    if data.ndim == 4:
        return x.permute(0, 3, 1, 2)
    return x.permute(2, 0, 1)


@register("_image_normalize", aliases=["image_normalize"],
          ndarray_inputs=["data", "mean"])
def _normalize(data, mean=0.0, std=1.0):
    """CHW (or NCHW) float input; mean/std per-channel sequences."""
    mean = torch.as_tensor(mean, dtype=data.dtype, device=data.device)
    std = torch.as_tensor(std, dtype=data.dtype, device=data.device)
    shape = (1, -1, 1, 1) if data.ndim == 4 else (-1, 1, 1)
    return (data - mean.reshape(shape)) / std.reshape(shape)


@register("_image_flip_left_right", aliases=["image_flip_left_right"],
          ndarray_inputs=["data"])
def _flip_lr(data):
    return torch.flip(data, dims=(_hwc_axes(data)[1],))


@register("_image_flip_top_bottom", aliases=["image_flip_top_bottom"],
          ndarray_inputs=["data"])
def _flip_tb(data):
    return torch.flip(data, dims=(_hwc_axes(data)[0],))


def _coin(data, p):
    return torch.rand((), generator=_gen(data.device),
                      device=data.device) < float(p)


@register("_image_random_flip_left_right",
          aliases=["image_random_flip_left_right"], ndarray_inputs=["data"])
def _random_flip_lr(data, p=0.5):
    return torch.where(_coin(data, p), _flip_lr(data), data)


@register("_image_random_flip_top_bottom",
          aliases=["image_random_flip_top_bottom"], ndarray_inputs=["data"])
def _random_flip_tb(data, p=0.5):
    return torch.where(_coin(data, p), _flip_tb(data), data)


@register("_image_resize", aliases=["image_resize"], ndarray_inputs=["data"])
def _resize(data, size=0, keep_ratio=False, interp=1):
    ha, wa, _ = _hwc_axes(data)
    h, w = data.shape[ha], data.shape[wa]
    if isinstance(size, int):
        if keep_ratio:
            if h < w:
                nh, nw = size, max(1, int(w * size / h))
            else:
                nh, nw = max(1, int(h * size / w)), size
        else:
            nh = nw = size
    else:
        nw, nh = size  # reference order: (w, h)
    shape = list(data.shape)
    shape[ha], shape[wa] = nh, nw
    method = "nearest" if interp == 0 else "linear"
    return astype(resize(data, shape, method), data.dtype)


@register("_image_crop", aliases=["image_crop"],
          ndarray_inputs=["data", "x", "y"])
def _crop(data, x=0, y=0, width=1, height=1):
    # x/y are host ints by contract (slice bounds), as the reference's
    ha, wa, _ = _hwc_axes(data)
    idx = [slice(None)] * data.ndim
    idx[ha] = slice(int(y), int(y) + int(height))  # lint: disable=host-call-in-op
    idx[wa] = slice(int(x), int(x) + int(width))  # lint: disable=host-call-in-op
    return data[tuple(idx)]


def _blend(a, b, factor):
    return astype(a.to(torch.float32) * factor + b * (1.0 - factor), a.dtype)


@register("_image_random_brightness", aliases=["image_random_brightness"],
          ndarray_inputs=["data"])
def _random_brightness(data, min_factor=0.0, max_factor=0.0):
    f = _uniform(data, min_factor, max_factor)
    return astype(data.to(torch.float32) * f, data.dtype)


_GRAY = (0.299, 0.587, 0.114)


def _grayscale(data):
    ca = _hwc_axes(data)[2]
    shape = [1] * data.ndim
    shape[ca] = 3
    wts = torch.tensor(_GRAY, dtype=torch.float32, device=data.device)
    return torch.sum(data.to(torch.float32) * wts.reshape(shape), dim=ca,
                     keepdim=True)


@register("_image_random_contrast", aliases=["image_random_contrast"],
          ndarray_inputs=["data"])
def _random_contrast(data, min_factor=0.0, max_factor=0.0):
    f = _uniform(data, min_factor, max_factor)
    return _blend(data, torch.mean(_grayscale(data)), f)


@register("_image_random_saturation", aliases=["image_random_saturation"],
          ndarray_inputs=["data"])
def _random_saturation(data, min_factor=0.0, max_factor=0.0):
    f = _uniform(data, min_factor, max_factor)
    return _blend(data, _grayscale(data), f)


_T_YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.321),
          (0.211, -0.523, 0.311))


@register("_image_random_hue", aliases=["image_random_hue"],
          ndarray_inputs=["data"])
def _random_hue(data, min_factor=0.0, max_factor=0.0):
    """YIQ-rotation hue shift (the reference's recipe)."""
    theta = _uniform(data, min_factor, max_factor) * np.pi
    ca = _hwc_axes(data)[2]
    t_yiq = torch.tensor(_T_YIQ, dtype=torch.float32, device=data.device)
    t_rgb = torch.linalg.inv(t_yiq)
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    rot = torch.stack([torch.stack([one, zero, zero]),
                       torch.stack([zero, c, -s]),
                       torch.stack([zero, s, c])])
    m = t_rgb @ rot @ t_yiq
    x = torch.movedim(data.to(torch.float32), ca, -1)
    return astype(torch.movedim(x @ m.T, -1, ca), data.dtype)


@register("_image_random_color_jitter",
          aliases=["image_random_color_jitter"], ndarray_inputs=["data"])
def _random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                         hue=0.0):
    if brightness:
        data = _random_brightness(data, 1.0 - brightness, 1.0 + brightness)
    if contrast:
        data = _random_contrast(data, 1.0 - contrast, 1.0 + contrast)
    if saturation:
        data = _random_saturation(data, 1.0 - saturation, 1.0 + saturation)
    if hue:
        data = _random_hue(data, -hue, hue)
    return data


_EIGVAL = np.asarray([55.46, 4.794, 1.148], np.float32)
_EIGVEC = np.asarray([[-0.5675, 0.7192, 0.4009],
                      [-0.5808, -0.0045, -0.8140],
                      [-0.5836, -0.6948, 0.4203]], np.float32)


@register("_image_adjust_lighting", aliases=["image_adjust_lighting"],
          ndarray_inputs=["data"])
def _adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """AlexNet-style PCA lighting with fixed alpha (RGB channel shift =
    eigvec @ (eigval * alpha))."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=data.device)
    shift = torch.from_numpy(_EIGVEC).to(data.device) @ (
        torch.from_numpy(_EIGVAL).to(data.device) * alpha)
    ca = _hwc_axes(data)[2]
    shape = [1] * data.ndim
    shape[ca] = 3
    return astype(data.to(torch.float32) + shift.reshape(shape), data.dtype)


@register("_image_random_lighting", aliases=["image_random_lighting"],
          ndarray_inputs=["data"])
def _random_lighting(data, alpha_std=0.05):
    alpha = torch.randn((3,), generator=_gen(data.device),
                        device=data.device) * alpha_std
    return _adjust_lighting(data, alpha)
