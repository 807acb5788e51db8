"""Neural-net operators of the main path (counterpart of the
``FullyConnected``, activation, softmax, ``SoftmaxOutput``,
``softmax_cross_entropy``, ``LayerNorm``, ``RMSNorm`` and ``Dropout`` part
of ``mxnet_tpu/ops/nn.py``). Products go to cuBLAS through
``torch.matmul``; normalisations and softmax are open-coded as the
reference writes them. Train/test behaviour (``Dropout``) is read from
autograd's train-mode scope at call time. Convolution, pooling and batch
normalisation are not ported yet.
"""
from __future__ import annotations

import torch

from ..base import dtype_torch
from .registry import register


def _is_training():
    from .. import autograd

    return autograd.is_training()


@register("FullyConnected", ndarray_inputs=["data", "weight", "bias"])
def _fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                     flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten and data.ndim > 2 \
        else data
    if x.dtype != weight.dtype:  # promote, as jnp.matmul does
        dt = torch.promote_types(x.dtype, weight.dtype)
        x, weight = x.to(dt), weight.to(dt)
    out = torch.matmul(x, weight.T)
    if bias is not None and not no_bias:
        out = out + bias
    return out


@register("Activation", ndarray_inputs=["data"])
def _activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, torch.zeros_like(data))
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    if act_type == "gelu":
        return torch.nn.functional.gelu(data, approximate="none")
    if act_type in ("silu", "swish"):
        return data * torch.sigmoid(data)
    if act_type == "relu6":
        return torch.clamp(data, 0, 6)
    raise ValueError(f"unknown act_type {act_type!r}")


@register("LeakyReLU", ndarray_inputs=["data", "gamma"])
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334):
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * (torch.exp(data) - 1))
    if act_type == "prelu":
        g = gamma
        if g.ndim < data.ndim and g.numel() > 1:  # per channel, on axis 1
            g = g.reshape((1, -1) + (1,) * (data.ndim - 2))
        return torch.where(data >= 0, data, g * data)
    if act_type == "selu":
        a, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data, a * (torch.exp(data) - 1))
    if act_type == "gelu":
        return torch.nn.functional.gelu(data, approximate="none")
    if act_type == "rrelu":
        s = (lower_bound + upper_bound) / 2.0  # eval-mode slope
        return torch.where(data >= 0, data, s * data)
    raise ValueError(f"unknown act_type {act_type!r}")


# ---------------------------------------------------------------------------
# Softmax family
# ---------------------------------------------------------------------------

def _length_mask(data, length, axis):
    # positions >= length along `axis` are masked; length has data's shape
    # without that axis
    ax = axis % data.ndim
    pos = torch.arange(data.shape[ax], device=data.device).reshape(
        (-1,) + (1,) * (data.ndim - 1 - ax))
    if length.ndim == data.ndim - 1:
        ln = length.unsqueeze(ax)
    elif length.ndim == data.ndim:
        ln = length
    else:
        raise ValueError(f"length ndim {length.ndim} incompatible with data "
                         f"ndim {data.ndim}")
    return pos < ln


@register("softmax", ndarray_inputs=["data"], tags=("softmax",))
def _softmax(data, length=None, axis=-1, temperature=None, dtype=None,
             use_length=False):
    x = data
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    if length is not None:
        mask = _length_mask(x, length.to(torch.int32), int(axis))
        x = torch.where(mask, x, torch.full_like(x, float("-inf")))
        out = torch.softmax(x, dim=int(axis))
        out = torch.where(mask, out, torch.zeros_like(out))
    else:
        out = torch.softmax(x, dim=int(axis))
    if dtype is not None:
        out = out.to(dtype_torch(dtype))
    return out


@register("log_softmax", ndarray_inputs=["data"])
def _log_softmax(data, axis=-1, temperature=None, dtype=None,
                 use_length=False):
    x = data if not temperature or temperature == 1.0 else data / temperature
    out = torch.log_softmax(x, dim=int(axis))
    if dtype is not None:
        out = out.to(dtype_torch(dtype))
    return out


@register("softmin", ndarray_inputs=["data"])
def _softmin(data, axis=-1, temperature=None, dtype=None):
    return _softmax(-data, axis=axis, temperature=temperature, dtype=dtype)


@register("SoftmaxActivation", ndarray_inputs=["data"], tags=("softmax",))
def _softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward with the fused cross-entropy gradient
    ``(p - onehot(label)) * scale`` backward, whatever the head gradient
    (the reference's ``custom_vjp``); the label gets none."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output,
                use_ignore, preserve_shape, normalization, smooth_alpha):
        if multi_output:
            out = torch.softmax(data, dim=1)
        elif preserve_shape:
            out = torch.softmax(data, dim=-1)
        else:
            out = torch.softmax(data.reshape(data.shape[0], -1),
                                dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, ignore_label, multi_output, use_ignore,
                   normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        (grad_scale, ignore_label, multi_output, use_ignore, normalization,
         smooth_alpha) = ctx.cfg
        lab = label.to(torch.int32).long()
        if multi_output:
            axis, nclass = 1, out.shape[1]
            oh = torch.nn.functional.one_hot(lab.clamp(0, nclass - 1),
                                             nclass).movedim(-1, 1)
            oh = oh * ((lab >= 0) & (lab < nclass)).unsqueeze(1)
        else:
            axis, nclass = out.ndim - 1, out.shape[-1]
            lab = lab.reshape(out.shape[:-1])
            oh = torch.nn.functional.one_hot(lab.clamp(0, nclass - 1), nclass)
            oh = oh * ((lab >= 0) & (lab < nclass)).unsqueeze(-1)
        oh = oh.to(out.dtype)
        if smooth_alpha:
            oh = oh * (1 - smooth_alpha) + smooth_alpha / (nclass - 1) * (
                1 - oh)
        grad = out - oh
        if use_ignore:
            keep = (label != ignore_label).to(out.dtype)
            keep = keep.unsqueeze(axis) if keep.ndim < out.ndim else keep
            grad = grad * keep
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid" and use_ignore:
            nvalid = torch.clamp_min(torch.sum(label != ignore_label),
                                     1).to(out.dtype)
            grad = grad / nvalid
        return grad * scale, None, None, None, None, None, None, None, None


@register("SoftmaxOutput", aliases=["Softmax"],
          ndarray_inputs=["data", "label"], tags=("softmax",))
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """Fused softmax + cross-entropy-gradient op."""
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(multi_output),
                                bool(use_ignore), bool(preserve_shape),
                                normalization, float(smooth_alpha))


@register("softmax_cross_entropy", ndarray_inputs=["data", "label"])
def _softmax_cross_entropy(data, label):
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int32).long().clamp(0, data.shape[-1] - 1)
    nll = -torch.gather(logp, -1, lab[:, None])
    return torch.sum(nll).reshape(1)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def _bshape(data, ax):
    return tuple(data.shape[i] if i == ax else 1 for i in range(data.ndim))


@register("LayerNorm", ndarray_inputs=["data", "gamma", "beta"])
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    ax = int(axis) % data.ndim
    mean = torch.mean(data, dim=ax, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=ax, keepdim=True)
    inv = torch.rsqrt(var + eps)
    bshape = _bshape(data, ax)
    return (data - mean) * inv * gamma.reshape(bshape) + beta.reshape(bshape)


@register("RMSNorm", ndarray_inputs=["data", "gamma"])
def _rms_norm(data, gamma, axis=-1, eps=1e-6):
    ax = int(axis) % data.ndim
    ms = torch.mean(torch.square(data), dim=ax, keepdim=True)
    return data * torch.rsqrt(ms + eps) * gamma.reshape(_bshape(data, ax))


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

@register("Dropout", ndarray_inputs=["data"])
def _dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False,
             _train=None):
    train = _is_training() if _train is None else _train
    if (not train and mode != "always") or p <= 0.0:
        return data
    from ..random import generator

    if axes:
        shape = tuple(1 if i in tuple(axes) else s
                      for i, s in enumerate(data.shape))
    else:
        shape = data.shape
    keep = torch.rand(shape, generator=generator(data.device),
                      device=data.device) < 1.0 - p
    return torch.where(keep, data / (1.0 - p),
                       torch.zeros((), dtype=data.dtype,
                                   device=data.device)).to(data.dtype)
