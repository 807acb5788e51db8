"""Gluon convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv1D``-``3D`` and their
``Transpose`` forms over ``Convolution``/``Deconvolution`` (cuDNN), the
max, average and global pools over ``Pooling``, and ``ReflectionPad2D``.
Layouts are the reference's default NC + spatial; ``in_channels`` 0
defers the weight's shape to the first input.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", ndim=2, transpose=False,
                 output_padding=0, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._kernel = _tup(kernel_size, ndim)
        self._strides = _tup(strides, ndim)
        self._padding = _tup(padding, ndim)
        self._dilation = _tup(dilation, ndim)
        self._groups = groups
        self._act = activation
        self._transpose = transpose
        self._output_padding = _tup(output_padding, ndim)
        if transpose:
            wshape = (in_channels, channels // groups) + self._kernel
        else:
            wshape = (channels, in_channels // groups if in_channels
                      else 0) + self._kernel
        self.weight = self.params.get("weight", shape=wshape,
                                      init=weight_initializer,
                                      allow_deferred_init=True)
        self.bias = self.params.get("bias", shape=(channels,),
                                    init=bias_initializer) \
            if use_bias else None

    def infer_shape(self, x, *args):
        c_in = x.shape[1]
        if self._transpose:
            shape = (c_in, self._channels // self._groups)
        else:
            shape = (self._channels, c_in // self._groups)
        self.weight.shape_inferred(shape + self._kernel)

    def hybrid_forward(self, F, x, weight, bias=None):
        b = [bias] if bias is not None else []
        kw = dict(kernel=self._kernel, stride=self._strides,
                  pad=self._padding, dilate=self._dilation,
                  num_filter=self._channels, num_group=self._groups,
                  no_bias=bias is None)
        if self._transpose:
            out = F.Deconvolution(x, weight, *b, adj=self._output_padding,
                                  **kw)
        else:
            out = F.Convolution(x, weight, *b, **kw)
        if self._act:
            out = F.Activation(out, act_type=self._act)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=1, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=2, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=3, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=1, transpose=True,
                         output_padding=output_padding, **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout="NCHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=2, transpose=True,
                         output_padding=output_padding, **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW", **kwargs):
        super().__init__(channels, kernel_size, strides, padding, dilation,
                         groups, layout, ndim=3, transpose=True,
                         output_padding=output_padding, **kwargs)


class _Pool(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, pool_type,
                 ndim, global_pool=False, count_include_pad=True, **kwargs):
        super().__init__(**kwargs)
        self._kernel = _tup(pool_size, ndim)
        self._strides = _tup(strides if strides is not None else pool_size,
                             ndim)
        self._padding = _tup(padding, ndim)
        self._ceil = ceil_mode
        self._ptype = pool_type
        self._global = global_pool
        self._cip = count_include_pad

    def hybrid_forward(self, F, x):
        return F.Pooling(x, kernel=self._kernel, stride=self._strides,
                         pad=self._padding, pool_type=self._ptype,
                         global_pool=self._global,
                         pooling_convention="full" if self._ceil
                         else "valid",
                         count_include_pad=self._cip)


class MaxPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False, **kw):
        super().__init__(pool_size, strides, padding, ceil_mode, "max", 1,
                         **kw)


class MaxPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, **kw):
        super().__init__(pool_size, strides, padding, ceil_mode, "max", 2,
                         **kw)


class MaxPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, **kw):
        super().__init__(pool_size, strides, padding, ceil_mode, "max", 3,
                         **kw)


class AvgPool1D(_Pool):
    def __init__(self, pool_size=2, strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(pool_size, strides, padding, ceil_mode, "avg", 1,
                         count_include_pad=count_include_pad, **kw)


class AvgPool2D(_Pool):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(pool_size, strides, padding, ceil_mode, "avg", 2,
                         count_include_pad=count_include_pad, **kw)


class AvgPool3D(_Pool):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, count_include_pad=True, **kw):
        super().__init__(pool_size, strides, padding, ceil_mode, "avg", 3,
                         count_include_pad=count_include_pad, **kw)


class GlobalMaxPool1D(_Pool):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, False, "max", 1, global_pool=True, **kw)


class GlobalMaxPool2D(_Pool):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, False, "max", 2, global_pool=True, **kw)


class GlobalMaxPool3D(_Pool):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, False, "max", 3, global_pool=True, **kw)


class GlobalAvgPool1D(_Pool):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, False, "avg", 1, global_pool=True, **kw)


class GlobalAvgPool2D(_Pool):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, False, "avg", 2, global_pool=True, **kw)


class GlobalAvgPool3D(_Pool):
    def __init__(self, **kw):
        super().__init__(1, 1, 0, False, "avg", 3, global_pool=True, **kw)


class ReflectionPad2D(HybridBlock):
    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        self._padding = _tup(padding, 2) if isinstance(padding, int) \
            else tuple(padding)

    def hybrid_forward(self, F, x):
        p = self._padding
        pw = (0, 0, 0, 0, p[0], p[0], p[1], p[1]) if len(p) == 2 else p
        return F.Pad(x, mode="reflect", pad_width=pw)
