"""Neural-net operators (counterpart of the ``FullyConnected``,
activation, softmax, ``SoftmaxOutput``, ``softmax_cross_entropy``,
normalisation, ``Dropout``, convolution and pooling part of
``mxnet_tpu/ops/nn.py``). Products go to cuBLAS through ``torch.matmul``
and convolutions to cuDNN through ``torch.nn.functional.conv*d`` /
``conv_transpose*d`` (no TF32: the package's precision policy);
normalisations and softmax are open-coded as the reference writes them,
with explicit statistics. Pooling pads explicitly where torch's
``ceil_mode`` and padding rules differ from the reference's ``full``
convention. Train/test behaviour (``Dropout``, ``BatchNorm``) is read
from autograd's train-mode scope at call time. Beside them: the
regression outputs and ``SVMOutput``, ``UpSampling`` (bilinear through
``image_ops.resize``), ``BilinearSampler``/``GridGenerator``/
``SpatialTransformer``, ``Correlation`` and ``LRN``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import dtype_torch
from .indexing import _filled
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
    """Summed cross-entropy. Labels are read as the reference's
    ``take_along_axis`` reads them: a negative label counts from the
    end, and one of C or more reads NaN."""
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int32).long()[:, None]
    nll = -_filled(logp, 1, lab, lambda i: torch.gather(logp, -1, i))
    return torch.sum(nll).reshape(1)


# ---------------------------------------------------------------------------
# Regression outputs (identity or sigmoid forward, fused gradients)
# ---------------------------------------------------------------------------

class _RegressionOutput(torch.autograd.Function):
    """Identity (``linear``, ``mae``) or sigmoid (``logistic``) forward;
    backward ``(out - label) * grad_scale / num_out``, its sign for
    ``mae``, whatever the head gradient (the reference's ``custom_vjp``);
    the label's gradient is zero."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, err_grad):
        out = torch.sigmoid(data) if err_grad == "logistic" else data
        ctx.save_for_backward(out, label)
        ctx.cfg = (grad_scale, err_grad)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, err_grad = ctx.cfg
        diff = out - label.reshape(out.shape)
        grad = torch.sign(diff) if err_grad == "mae" else diff
        num_out = out.numel() // out.shape[0]
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad * (grad_scale / num_out), dlabel, None, None


def _make_regression_output(err_grad):
    def op(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, float(grad_scale),
                                       err_grad)

    return op


register("LinearRegressionOutput", ndarray_inputs=["data", "label"])(
    _make_regression_output("linear"))
register("MAERegressionOutput", ndarray_inputs=["data", "label"])(
    _make_regression_output("mae"))
register("LogisticRegressionOutput", ndarray_inputs=["data", "label"])(
    _make_regression_output("logistic"))


@register("SVMOutput", ndarray_inputs=["data", "label"])
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    return data


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def _var_mean(x, dims, keepdim):
    """Biased (variance, mean) over ``dims``. No dims is no reduction, as
    the reference's ``jnp.var``/``jnp.mean`` over ``axis=()`` mean it
    (torch would reduce every dim): (0, x)."""
    if not dims:
        return torch.zeros_like(x), x
    if hasattr(x, "placements"):
        # a DTensor: torch 2.11 has no sharding rule for var_mean; the
        # means shard (their partial sums reduce over the ranks)
        mean = torch.mean(x, dim=dims, keepdim=True)
        var = torch.mean(torch.square(x - mean), dim=dims, keepdim=keepdim)
        return var, (mean if keepdim else mean.reshape(var.shape))
    return torch.var_mean(x, dim=dims, correction=0, keepdim=keepdim)


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


def _bn_n_out(kw):
    return 3 if kw.get("output_mean_var") else 1


@register("BatchNorm", num_outputs=_bn_n_out,
          ndarray_inputs=["data", "gamma", "beta", "moving_mean",
                          "moving_var"])
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False,
                min_calib_range=None, max_calib_range=None, _train=None):
    """out, or (out, batch mean, batch variance) with ``output_mean_var``.
    The batch statistics are computed in at least f32 and the variance is
    the biased one; on a mesh of several ranks they are the global
    batch's (``data`` is a ``DTensor`` sharded over ``dp``, and the
    means reduce over every rank's rows), as GSPMD gives the
    reference; the caller (the Gluon layer) folds them into the
    moving averages, as the reference does. Normalisation runs in the
    data's dtype, so f32 statistics do not promote a bf16 activation."""
    ax = int(axis) % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    train = _is_training() if _train is None else _train
    if fix_gamma:
        gamma = torch.ones_like(gamma)
    bshape = _bshape(data, ax)
    if train and not use_global_stats:
        stat_t = torch.promote_types(data.dtype, torch.float32)
        var, mean = _var_mean(data.to(stat_t), red, keepdim=False)
    else:
        mean, var = moving_mean, moving_var
    dt = data.dtype
    scale = torch.rsqrt(var + eps).to(dt) * gamma.to(dt)
    out = torch.addcmul(beta.to(dt).reshape(bshape),
                        data - mean.to(dt).reshape(bshape),
                        scale.reshape(bshape))
    if output_mean_var:
        return out, mean, var
    return out


@register("InstanceNorm", ndarray_inputs=["data", "gamma", "beta"])
def _instance_norm(data, gamma, beta, eps=1e-3):
    red = tuple(range(2, data.ndim))
    var, mean = _var_mean(data, red, keepdim=True)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape)
            + beta.reshape(bshape))


@register("GroupNorm", ndarray_inputs=["data", "gamma", "beta"])
def _group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    n, c = data.shape[0], data.shape[1]
    g = int(num_groups)
    x = data.reshape((n, g, c // g) + tuple(data.shape[2:]))
    red = tuple(range(2, x.ndim))
    var, mean = torch.var_mean(x, dim=red, correction=0, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    bshape = (1, c) + (1,) * (data.ndim - 2)
    return x * gamma.reshape(bshape) + beta.reshape(bshape)


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


# ---------------------------------------------------------------------------
# Convolution / Deconvolution / Pooling
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _spatial(v, nsp, default):
    return tuple(int(x) for x in v) if v else (default,) * nsp


@register("Convolution", ndarray_inputs=["data", "weight", "bias"])
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, workspace=1024,
                 no_bias=False, cudnn_tune=None, cudnn_off=False,
                 layout=None):
    """N-d convolution, NC + spatial layout, weight (out, in/g, *k); on
    a mesh, each rank's rows of a batch-sharded input on their own
    (``parallel.sharding.batch_local``)."""
    from ..parallel.sharding import batch_local

    nsp = data.ndim - 2

    def conv(x, w, *b):
        return _CONV[nsp](x, w, b[0] if b else None,
                          stride=_spatial(stride, nsp, 1),
                          padding=_spatial(pad, nsp, 0),
                          dilation=_spatial(dilate, nsp, 1),
                          groups=int(num_group))

    has_bias = bias is not None and not no_bias
    return batch_local(conv, data, weight, *([bias] if has_bias else []))


@register("Deconvolution", ndarray_inputs=["data", "weight", "bias"])
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), target_shape=(), num_filter=0,
                   num_group=1, workspace=512, no_bias=True, cudnn_tune=None,
                   cudnn_off=False, layout=None):
    """Transposed convolution (the gradient of Convolution with respect to
    its input); weight (in, out/g, *k), the reference's layout and
    torch's. Along each spatial dim the output is the full transposed
    convolution (no padding) with ``pad`` cropped from the front and
    ``full - 2 pad + adj`` positions kept, zeros past the end where
    ``adj > pad``: the reference's padding of the dilated input by
    (keff-1-pad, keff-1-pad+adj), for any ``adj`` (torch's
    ``output_padding`` must stay below the stride or the dilation)."""
    nsp = data.ndim - 2
    pad = _spatial(pad, nsp, 0)
    adj = _spatial(adj, nsp, 0)
    out = _DECONV[nsp](data, weight, None, stride=_spatial(stride, nsp, 1),
                       padding=0, groups=int(num_group),
                       dilation=_spatial(dilate, nsp, 1))
    grow = [(0, max(0, a - p)) for p, a in zip(pad, adj)]
    if any(g for _, g in grow):
        out = F.pad(out, [x for pair in reversed(grow) for x in pair])
    keep = tuple(slice(p, p + n - 2 * p + a) for p, a, n in
                 zip(pad, adj, out.shape[2:]))
    out = out[(slice(None), slice(None)) + keep]
    if bias is not None and not no_bias:
        out = out + bias.reshape((1, -1) + (1,) * nsp)
    return out


def _sum_pool(x, kernel, stride):
    """Window sums without padding. ``divisor_override`` exists for 2-D
    and 3-D pooling only, so 1-D runs as 2-D over a unit height."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("Pooling", ndarray_inputs=["data"])
def _pooling(data, kernel=(), stride=(), pad=(), pool_type="max",
             global_pool=False, pooling_convention="valid", cudnn_off=False,
             p_value=2, count_include_pad=True, layout=None):
    """:func:`_pool`; on a mesh, each rank's rows of a batch-sharded
    input on their own (``parallel.sharding.batch_local``)."""
    from ..parallel.sharding import batch_local

    return batch_local(lambda x: _pool(
        x, kernel, stride, pad, pool_type, global_pool, pooling_convention,
        p_value, count_include_pad), data)


def _pool(data, kernel, stride, pad, pool_type, global_pool,
          pooling_convention, p_value, count_include_pad):
    """max, avg, sum and lp pooling over 1-3 spatial dims. ``valid``
    windows fit the symmetrically padded input; ``full`` (ceil) windows
    may run past it, the right edge padded to fit, as in the reference.
    Torch's own padding is used where it means the same (``valid``, pad
    at most half the window); otherwise the input is padded explicitly
    (``-inf`` for max), so every window and divisor is the reference's."""
    nsp = data.ndim - 2
    if global_pool and nsp == 0:
        # no spatial dims: every window is one element, as the
        # reference's reductions over axis=() give (torch would reduce
        # every dim)
        return data.abs() if pool_type == "lp" else data.clone()
    if global_pool:
        red = tuple(range(2, data.ndim))
        if pool_type == "max":
            return torch.amax(data, dim=red, keepdim=True)
        if pool_type in ("avg", "sum"):
            r = torch.sum(data, dim=red, keepdim=True)
            if pool_type == "avg":
                r = r / (data.numel() // (data.shape[0] * data.shape[1]))
            return r
        if pool_type == "lp":
            return torch.pow(torch.sum(torch.pow(torch.abs(data), p_value),
                                       dim=red, keepdim=True),
                             1.0 / p_value)
        raise ValueError(f"unknown pool_type {pool_type!r}")
    kernel = tuple(int(k) for k in kernel)
    stride = _spatial(stride, nsp, 1)
    pad = _spatial(pad, nsp, 0)
    if pooling_convention == "full":
        right = tuple(
            (int(math.ceil((x + 2 * p - k) / s))) * s + k - x - p
            for x, p, k, s in zip(data.shape[2:], pad, kernel, stride))
    else:
        right = pad
    native = (pooling_convention != "full"
              and all(2 * p <= k for p, k in zip(pad, kernel)))
    if pool_type == "max" and native:
        return (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nsp - 1](
            data, kernel, stride, pad)
    if pool_type == "avg" and native:
        return (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[nsp - 1](
            data, kernel, stride, pad,
            count_include_pad=bool(count_include_pad))
    widths = []  # F.pad's order: (before, after) from the last dim
    for p, r in zip(reversed(pad), reversed(right)):
        widths += [p, r]
    if pool_type == "max":
        low = (float("-inf") if data.is_floating_point()
               else torch.iinfo(data.dtype).min)
        return (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nsp - 1](
            F.pad(data, widths, value=low), kernel, stride)
    if pool_type in ("avg", "sum"):
        s = _sum_pool(F.pad(data, widths), kernel, stride)
        if pool_type == "sum":
            return s
        if count_include_pad:
            return s / math.prod(kernel)
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        return s / _sum_pool(F.pad(ones, widths), kernel, stride)
    if pool_type == "lp":
        s = _sum_pool(F.pad(torch.pow(torch.abs(data), p_value), widths),
                      kernel, stride)
        return torch.pow(s, 1.0 / p_value)
    raise ValueError(f"unknown pool_type {pool_type!r}")



# ---------------------------------------------------------------------------
# UpSampling, the spatial transformer family, Correlation, LRN
# ---------------------------------------------------------------------------

@register("UpSampling", ndarray_inputs="*")
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    data = args[0]
    s = int(scale)
    if sample_type == "nearest":
        def rep(x, k):
            return x.repeat_interleave(k, dim=2).repeat_interleave(k, dim=3)

        out = rep(data, s)
        if len(args) > 1 and multi_input_mode == "concat":
            outs = [out] + [rep(d, out.shape[2] // d.shape[2])
                            for d in args[1:]]
            out = torch.cat(outs, dim=1)
        return out
    if sample_type == "bilinear":
        from .image_ops import resize

        n, c, h, w = data.shape
        return resize(data, (n, c, h * s, w * s), "bilinear")
    raise ValueError(f"unknown sample_type {sample_type!r}")


@register("BilinearSampler", ndarray_inputs=["data", "grid"])
def _bilinear_sampler(data, grid, cudnn_off=False):
    """``grid`` (N, 2, H, W) in [-1, 1]; samples outside the input are
    zero."""
    n, c, hin, win = data.shape
    gx = (grid[:, 0] + 1) * (win - 1) / 2
    gy = (grid[:, 1] + 1) * (hin - 1) / 2
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx, wy = gx - x0, gy - y0
    flat = data.reshape(n, c, hin * win)

    def gather(yy, xx):
        yi = yy.to(torch.int32).clamp(0, hin - 1).long()
        xi = xx.to(torch.int32).clamp(0, win - 1).long()
        valid = ((yy >= 0) & (yy <= hin - 1) & (xx >= 0)
                 & (xx <= win - 1)).to(data.dtype)
        idx = (yi * win + xi).reshape(n, 1, -1).expand(n, c, -1)
        v = torch.gather(flat, 2, idx).reshape((n, c) + tuple(yy.shape[1:]))
        return v * valid[:, None]

    return (gather(y0, x0) * ((1 - wy) * (1 - wx))[:, None]
            + gather(y0, x1) * ((1 - wy) * wx)[:, None]
            + gather(y1, x0) * (wy * (1 - wx))[:, None]
            + gather(y1, x1) * (wy * wx)[:, None])


def _linspace(num, device):
    """``jnp.linspace(-1, 1, num)`` in f32 and its order of operations:
    start (1 - t) + stop t with t = i / (num - 1), the end point exact."""
    if num == 1:
        return torch.full((1,), -1.0, device=device)
    div = torch.tensor(float(num - 1), device=device)
    t = torch.arange(num - 1, dtype=torch.float32, device=device) / div
    return torch.cat([-1.0 * (1 - t) + 1.0 * t,
                      torch.ones(1, device=device)])


@register("GridGenerator", ndarray_inputs=["data"])
def _grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    h, w = int(target_shape[0]), int(target_shape[1])
    if transform_type == "affine":
        n = data.shape[0]
        theta = data.reshape(n, 2, 3)
        ys, xs = torch.meshgrid(_linspace(h, data.device),
                                _linspace(w, data.device), indexing="ij")
        base = torch.stack([xs, ys, torch.ones_like(xs)], dim=0) \
            .reshape(3, -1).to(data.dtype)
        return torch.matmul(theta, base).reshape(n, 2, h, w)
    return data  # warp type passes through


@register("SpatialTransformer", ndarray_inputs=["data", "loc"])
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    grid = _grid_generator(loc, "affine", target_shape)
    return _bilinear_sampler(data, grid)


@register("Correlation", num_outputs=1, ndarray_inputs=["data1", "data2"])
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """FlowNet correlation: for each displacement (p, q) on the stride2
    grid within max_displacement, the kernel_size^2 patch product (or
    absolute difference) of data1 and shifted data2, averaged over K^2 C.
    Each displacement is one shifted product, a channel sum and a window
    sum of static slices; autograd differentiates it."""
    ks, md = int(kernel_size), int(max_displacement)
    s1, s2, pad = int(stride1), int(stride2), int(pad_size)
    mult = is_multiply in (True, 1, "1", "true", "True")
    if ks % 2 != 1:
        raise ValueError("Correlation kernel_size must be odd")
    n, c, h, w = data1.shape
    kr = (ks - 1) // 2
    border = md + kr
    ph, pw = h + 2 * pad, w + 2 * pad
    out_h = int(math.ceil((ph - 2 * border) / s1))
    out_w = int(math.ceil((pw - 2 * border) / s1))
    if out_h <= 0 or out_w <= 0:
        raise ValueError("Correlation output size is empty; reduce "
                         "max_displacement/kernel_size or raise pad_size")
    ngr = md // s2
    p1 = F.pad(data1, (pad, pad, pad, pad))
    # an extra md margin, so every shifted view is a slice (zeros beyond)
    big2 = F.pad(data2, (pad + md,) * 4)
    ys = border + s1 * torch.arange(out_h, device=data1.device)
    xs = border + s1 * torch.arange(out_w, device=data1.device)
    scale = 1.0 / (ks * ks * c)
    chans = []
    for p in range(-ngr, ngr + 1):
        for q in range(-ngr, ngr + 1):
            dy, dx = p * s2, q * s2
            shifted = big2[:, :, md + dy:md + dy + ph, md + dx:md + dx + pw]
            m = (p1 * shifted if mult else torch.abs(p1 - shifted)).sum(1)
            if ks == 1:
                win = m
            else:
                mp = F.pad(m, (kr, kr, kr, kr))
                win = sum(mp[:, u:u + ph, v:v + pw]
                          for u in range(ks) for v in range(ks))
            chans.append(win[:, ys, :][:, :, xs] * scale)
    return torch.stack(chans, dim=1).to(data1.dtype)


@register("LRN", ndarray_inputs=["data"])
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    n = int(nsize)
    pad = n // 2
    sqp = F.pad(torch.square(data), (0, 0, 0, 0, pad, pad))
    win = sum(sqp[:, i:i + data.shape[1]] for i in range(n))
    return data / torch.pow(knorm + alpha / n * win, beta)
