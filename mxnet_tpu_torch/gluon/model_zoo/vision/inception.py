"""Inception v3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


class _Branches(HybridBlock):
    """Run children in parallel on the same input and concat on channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        for i, b in enumerate(branches):
            self.register_child(b, f"branch{i}")

    def hybrid_forward(self, F, x):
        return F.concat(*[b(x) for b in self._children.values()], dim=1)


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for channels, kernel, stride, pad in conv_settings:
        kw = {"channels": channels, "kernel_size": kernel}
        if stride:
            kw["strides"] = stride
        if pad is not None:
            kw["padding"] = pad
        out.add(_make_basic_conv(**kw))
    return out


def _make_A(pool_features):
    return _Branches([
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1), (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)),
    ])


def _make_B():
    return _Branches([
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1), (96, 3, 2, None)),
        _make_branch("max"),
    ])


def _make_C(channels_7x7):
    return _Branches([
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (channels_7x7, 1, None, None),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (channels_7x7, (1, 7), None, (0, 3)),
                     (channels_7x7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)),
    ])


def _make_D():
    return _Branches([
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None), (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        _make_branch("max"),
    ])


def _make_E():
    return _Branches([
        _make_branch(None, (320, 1, None, None)),
        _SplitConcat(_make_basic_conv(channels=384, kernel_size=1),
                     [_make_basic_conv(channels=384, kernel_size=(1, 3),
                                       padding=(0, 1)),
                      _make_basic_conv(channels=384, kernel_size=(3, 1),
                                       padding=(1, 0))]),
        _SplitConcat(
            _seq(_make_basic_conv(channels=448, kernel_size=1),
                 _make_basic_conv(channels=384, kernel_size=3, padding=1)),
            [_make_basic_conv(channels=384, kernel_size=(1, 3), padding=(0, 1)),
             _make_basic_conv(channels=384, kernel_size=(3, 1), padding=(1, 0))]),
        _make_branch("avg", (192, 1, None, None)),
    ])


def _seq(*blocks):
    out = nn.HybridSequential()
    out.add(*blocks)
    return out


class _SplitConcat(HybridBlock):
    """stem -> [branch_a, branch_b] -> concat (Inception-E fan-out)."""

    def __init__(self, stem, branches, **kwargs):
        super().__init__(**kwargs)
        self.stem = stem
        for i, b in enumerate(branches):
            self.register_child(b, f"split{i}")
        self._n = len(branches)

    def hybrid_forward(self, F, x):
        x = self.stem(x)
        outs = [self._children[f"split{i}"](x) for i in range(self._n)]
        return F.concat(*outs, dim=1)


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(_make_basic_conv(channels=32, kernel_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=32, kernel_size=3))
        self.features.add(_make_basic_conv(channels=64, kernel_size=3, padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=80, kernel_size=1))
        self.features.add(_make_basic_conv(channels=192, kernel_size=3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32))
        self.features.add(_make_A(64))
        self.features.add(_make_A(64))
        self.features.add(_make_B())
        self.features.add(_make_C(128))
        self.features.add(_make_C(160))
        self.features.add(_make_C(160))
        self.features.add(_make_C(192))
        self.features.add(_make_D())
        self.features.add(_make_E())
        self.features.add(_make_E())
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable (no network)")
    return Inception3(**kwargs)
