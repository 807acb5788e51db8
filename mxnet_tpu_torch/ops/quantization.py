"""INT8 quantization operators (counterpart of
``mxnet_tpu/ops/quantization.py``): symmetric int8 with per-tensor scales,
the (value, scale) bookkeeping carried as the reference's (min_range,
max_range) output pair.

The f32 bookkeeping keeps the reference's order of operations and types,
so quantize and dequantize agree with it bitwise: a division stays a true
division by a tensor on the data's device (a CUDA division by a host
scalar multiplies by its reciprocal, and ``scalar / tensor`` is
``reciprocal() * scalar`` in torch), and ``torch.round`` rounds half to
even as ``jnp.round`` does.

``quantized_fully_connected`` and ``quantized_conv`` accumulate exactly in
int32. On a CUDA tensor the product runs on the int8 tensor cores through
``torch._int_mm`` (the convolution as an im2col of the int8 activations),
with zero rows and columns padded to the shapes it takes (more than 16
rows, k and n multiples of 8); it raises rather than run any other way.
On the CPU (and on meta tensors, for shapes) the plain version is an f64
convolution or product of the int8 values: every partial sum is an
integer below 2^53, so it is exact, and it is the card route's oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["int8_matmul", "int8_conv", "int8_matmul_plain",
           "int8_conv_plain"]

_I32_MAX = 2.0 ** 31 - 1


def _t(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _scalar(x):
    return x.reshape(())


def _range_scale(min_r, max_r):
    """Symmetric scale mapping [-m, m] to int8, ``127 / m`` in f32."""
    m = torch.maximum(torch.abs(min_r), torch.abs(max_r))
    return torch.where(m > 0, torch.div(_t(127.0, m), m), _t(1.0, m))


def _q8(x, scale):
    return torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)


def _ranges(scale):
    m = torch.div(_t(127.0, scale), scale)
    return -m.reshape(1), m.reshape(1)


@register("_contrib_quantize", aliases=["quantize"], num_outputs=3,
          differentiable=False,
          ndarray_inputs=["data", "min_range", "max_range"])
def _quantize(data, min_range, max_range, out_type="int8"):
    """f32 -> int8 against a given calibration range: (quantized,
    min_output, max_output)."""
    scale = _range_scale(_scalar(min_range), _scalar(max_range))
    return (_q8(data, scale),) + _ranges(scale)


def _q_v2_n_out(kwargs):
    return 3


@register("_contrib_quantize_v2", aliases=["quantize_v2"],
          num_outputs=_q_v2_n_out, differentiable=False,
          ndarray_inputs=["data"])
def _quantize_v2(data, out_type="int8", min_calib_range=None,
                 max_calib_range=None):
    """Like quantize, with the range from the calibration kwargs or, when
    they are absent, from the data (the reference's online mode; the
    min and max stay on the device)."""
    if min_calib_range is not None and max_calib_range is not None:
        mn, mx = _t(float(min_calib_range), data), \
            _t(float(max_calib_range), data)
    else:
        mn = torch.amin(data).to(torch.float32)
        mx = torch.amax(data).to(torch.float32)
    scale = _range_scale(mn, mx)
    return (_q8(data, scale),) + _ranges(scale)


def _absmax(min_r, max_r):
    return torch.maximum(torch.abs(_scalar(min_r)), torch.abs(_scalar(max_r)))


@register("_contrib_dequantize", aliases=["dequantize"],
          differentiable=False,
          ndarray_inputs=["data", "min_range", "max_range"])
def _dequantize(data, min_range, max_range, out_type="float32"):
    """(min_range, max_range) give the real value of the integer type's
    extreme: 127 for int8, 2^31 - 1 for the int32 accumulators."""
    m = _absmax(min_range, max_range)
    qmax = 127.0 if data.dtype == torch.int8 else _I32_MAX
    return data.to(torch.float32) * torch.div(m, _t(qmax, m))


@register("_contrib_requantize", aliases=["requantize"], num_outputs=3,
          differentiable=False,
          ndarray_inputs=["data", "min_range", "max_range"])
def _requantize(data, min_range, max_range, min_calib_range=None,
                max_calib_range=None, out_type="int8"):
    """int32 accumulator -> int8; min/max_range are the int32 scale."""
    m = _absmax(min_range, max_range)
    real = data.to(torch.float32) * torch.div(m, _t(_I32_MAX, m))
    if min_calib_range is not None and max_calib_range is not None:
        mn, mx = _t(float(min_calib_range), real), \
            _t(float(max_calib_range), real)
    else:
        mn, mx = torch.amin(real), torch.amax(real)
    scale = _range_scale(mn, mx)
    return (_q8(real, scale),) + _ranges(scale)


def _int32_range(min_a, max_a, min_b, max_b):
    """Value range of the int32 accumulator in real units, the reference's
    (min_out, max_out)."""
    ma, mb = _absmax(min_a, max_a), _absmax(min_b, max_b)
    m = torch.div(ma * mb, _t(127.0 * 127.0, ma)) * _t(_I32_MAX, ma)
    return -m.reshape(1), m.reshape(1)


def _bias_acc(bias, min_data, max_data, min_weight, max_weight, min_bias,
              max_bias):
    """An int8 bias with its own scale, on the accumulator's
    (data scale x weight scale) grid."""
    sd = _range_scale(_scalar(min_data), _scalar(max_data))
    sw = _range_scale(_scalar(min_weight), _scalar(max_weight))
    min_bias, max_bias = (torch.as_tensor(v, dtype=torch.float32,
                                          device=bias.device)
                          for v in (min_bias, max_bias))
    sb = _range_scale(_scalar(min_bias), _scalar(max_bias))
    return torch.round(torch.div(bias.to(torch.float32), sb) * (sd * sw)) \
        .to(torch.int32)


# ---------------------------------------------------------------------------
# int8 products: int8 tensor cores on the card, exact f64 on the CPU
# ---------------------------------------------------------------------------

def _pad_to(n, m):
    return -n % m


def int8_matmul_plain(a, b):
    """a (M, K) int8 @ b (K, N) int8 -> int32, as an f64 product (exact:
    partial sums are integers below 2^53)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)) \
        .to(torch.int32)


def int8_matmul(a, b):
    """a (M, K) int8 @ b (K, N) int8 -> int32 (M, N). On CUDA: one
    ``torch._int_mm`` on zero-padded operands (rows above 16, k and n
    multiples of 8); ``int8_matmul.launches`` counts the calls. On the
    CPU or meta: :func:`int8_matmul_plain`."""
    if not a.is_cuda:
        return int8_matmul_plain(a, b)
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul: operands {a.dtype}, {b.dtype}, "
                        "want int8")
    m, k = a.shape
    n = b.shape[1]
    pm = max(17 - m, 0) + _pad_to(max(m, 17), 8)
    pk, pn = _pad_to(k, 8), _pad_to(n, 8)
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    out = torch._int_mm(a, b)
    int8_matmul.launches += 1
    return out[:m, :n] if (pm or pn) else out


int8_matmul.launches = 0


def _im2col_int8(x, kernel, stride, pad, dilate):
    """(N, C, H, W) -> (N*Ho*Wo, C*kh*kw) columns (any dtype), by strides
    over the zero-padded input; returns the columns and (Ho, Wo)."""
    n, c, h, w = x.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel, stride, pad, dilate
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    xp = F.pad(x, (pw, pw, ph, ph)).contiguous()
    s = xp.stride()
    cols = xp.as_strided((n, ho, wo, c, kh, kw),
                         (s[0], s[2] * sh, s[3] * sw, s[1], s[2] * dh,
                          s[3] * dw))
    return cols.reshape(n * ho * wo, c * kh * kw), (ho, wo)


def _conv_args(kernel, stride, pad, dilate):
    def two(v, d):
        if v is None or v == ():
            return (d, d)
        return tuple(int(x) for x in v) if isinstance(v, (tuple, list)) \
            else (int(v), int(v))
    return two(kernel, 1), two(stride, 1), two(pad, 0), two(dilate, 1)


def int8_conv_plain(data, weight, stride, pad, dilate, groups):
    """NCHW int8 convolution -> int32 through an f64 convolution (exact)."""
    return F.conv2d(data.to(torch.float64), weight.to(torch.float64),
                    stride=stride, padding=pad, dilation=dilate,
                    groups=groups).to(torch.int32)


def int8_conv(data, weight, stride, pad, dilate, groups):
    """NCHW int8 convolution with int32 accumulation: on CUDA an im2col of
    the int8 activations and :func:`int8_matmul` per group; on the CPU or
    meta :func:`int8_conv_plain`."""
    if not data.is_cuda:
        return int8_conv_plain(data, weight, stride, pad, dilate, groups)
    n = data.shape[0]
    f, cg, kh, kw = weight.shape
    outs = []
    for g in range(groups):
        x = data[:, g * cg:(g + 1) * cg]
        cols, (ho, wo) = _im2col_int8(x, (kh, kw), stride, pad, dilate)
        wg = weight[g * (f // groups):(g + 1) * (f // groups)]
        outs.append(int8_matmul(cols, wg.reshape(f // groups, -1).t()))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(n, ho, wo, f).permute(0, 3, 1, 2).contiguous()


@register("_contrib_quantized_fully_connected",
          aliases=["quantized_fully_connected"], num_outputs=3,
          differentiable=False,
          ndarray_inputs=["data", "weight", "bias", "min_data", "max_data",
                          "min_weight", "max_weight"])
def _quantized_fc(data, weight, bias, min_data, max_data, min_weight,
                  max_weight, min_bias=None, max_bias=None, num_hidden=1,
                  no_bias=False, flatten=True):
    """int8 data (B, K) x int8 weight (N, K) -> int32 (B, N)."""
    x = data
    if flatten and x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    lead = x.shape[:-1]
    acc = int8_matmul(x.reshape(-1, x.shape[-1]).to(torch.int8),
                      weight.to(torch.int8).t()) \
        .reshape(lead + (weight.shape[0],))
    if bias is not None and not no_bias:
        acc = acc + _bias_acc(bias, min_data, max_data, min_weight,
                              max_weight, min_bias, max_bias)
    return (acc,) + _int32_range(min_data, max_data, min_weight, max_weight)


@register("_contrib_quantized_conv", aliases=["quantized_conv"],
          num_outputs=3, differentiable=False,
          ndarray_inputs=["data", "weight", "bias", "min_data", "max_data",
                          "min_weight", "max_weight"])
def _quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                    max_weight, min_bias=None, max_bias=None, kernel=(1, 1),
                    stride=(1, 1), pad=(0, 0), dilate=(1, 1), num_filter=1,
                    num_group=1, no_bias=False, layout="NCHW"):
    """int8 NCHW convolution with int32 accumulation."""
    _, stride, pad, dilate = _conv_args(kernel, stride, pad, dilate)
    acc = int8_conv(data.to(torch.int8), weight.to(torch.int8), stride, pad,
                    dilate, int(num_group))
    if bias is not None and not no_bias:
        acc = acc + _bias_acc(bias, min_data, max_data, min_weight,
                              max_weight, min_bias, max_bias) \
            .reshape(1, -1, 1, 1)
    return (acc,) + _int32_range(min_data, max_data, min_weight, max_weight)


@register("_contrib_quantized_pooling", aliases=["quantized_pooling"],
          num_outputs=3, differentiable=False,
          ndarray_inputs=["data", "min_data", "max_data"])
def _quantized_pooling(data, min_data, max_data, kernel=(2, 2),
                       stride=None, pad=(0, 0), pool_type="max",
                       global_pool=False):
    from .nn import _pooling

    out = _pooling(data.to(torch.float32), kernel=kernel, stride=stride,
                   pad=pad, pool_type=pool_type, global_pool=global_pool)
    if pool_type != "max":  # max pooling is exact on the integer grid
        out = torch.round(out)
    return out.to(data.dtype), min_data, max_data


@register("_contrib_quantized_flatten", aliases=["quantized_flatten"],
          num_outputs=3, differentiable=False,
          ndarray_inputs=["data", "min_data", "max_data"])
def _quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data
