"""SqueezeNet 1.0/1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(squeeze_channels, kernel_size=1, activation="relu"))
    out.add(_FireExpand(expand1x1_channels, expand3x3_channels))
    return out


class _FireExpand(HybridBlock):
    def __init__(self, e1, e3, **kwargs):
        super().__init__(**kwargs)
        self.conv1 = nn.Conv2D(e1, kernel_size=1, activation="relu")
        self.conv3 = nn.Conv2D(e3, kernel_size=3, padding=1, activation="relu")

    def hybrid_forward(self, F, x):
        return F.concat(self.conv1(x), self.conv3(x), dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1")
        self.features = nn.HybridSequential()
        if version == "1.0":
            self.features.add(nn.Conv2D(96, kernel_size=7, strides=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(64, 256, 256))
        else:
            self.features.add(nn.Conv2D(64, kernel_size=3, strides=2,
                                        activation="relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(_make_fire(16, 64, 64))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(_make_fire(32, 128, 128))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(48, 192, 192))
            self.features.add(_make_fire(64, 256, 256))
            self.features.add(_make_fire(64, 256, 256))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable (no network)")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable (no network)")
    return SqueezeNet("1.1", **kwargs)
