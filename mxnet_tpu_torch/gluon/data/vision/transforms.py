"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``). HWC uint8/float in,
per-sample numpy ops on the host, run by the DataLoader's workers: each
result is an NDArray on the CPU (the reference's lands on the default
context), so a batch reaches the card in one copy. Resizes go through PIL
bilinear, as in the reference, so results equal the reference's bitwise."""
from __future__ import annotations

import numpy as np

from ....context import cpu
from ....ndarray import NDArray, array as _array
from ...block import Block
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting", "RandomColorJitter"]


def _to_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def nd_array(arr):
    """A sample on the host."""
    return _array(arr, ctx=cpu())


class Compose(Sequential):
    """Sequentially compose transforms."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (reference ToTensor)."""

    def forward(self, x):
        arr = _to_np(x).astype(np.float32) / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return nd_array(arr)


class Normalize(Block):
    """(x - mean) / std on CHW float input."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        arr = _to_np(x)
        return nd_array((arr - self._mean) / self._std)


def _resize_np(arr, size, interp="bilinear"):
    from PIL import Image

    if isinstance(size, int):
        size = (size, size)
    h, w = arr.shape[:2]
    if (w, h) == tuple(size):
        return arr
    mode = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC}[interp]
    squeeze = arr.shape[-1] == 1
    img = Image.fromarray(arr.squeeze(-1) if squeeze else arr.astype(np.uint8))
    out = np.asarray(img.resize(tuple(size), mode))
    if squeeze:
        out = out[:, :, None]
    return out


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation="bilinear"):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def forward(self, x):
        arr = _to_np(x)
        size = self._size
        if self._keep and isinstance(size, int):
            h, w = arr.shape[:2]
            if h < w:
                size = (int(w * size / h), size)
            else:
                size = (size, int(h * size / w))
        return nd_array(_resize_np(arr, size, self._interp))


class CenterCrop(Block):
    def __init__(self, size, interpolation="bilinear"):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._interp = interpolation

    def forward(self, x):
        arr = _to_np(x)
        w, h = self._size
        H, W = arr.shape[:2]
        if H < h or W < w:
            arr = _resize_np(arr, (max(w, W), max(h, H)), self._interp)
            H, W = arr.shape[:2]
        y0, x0 = (H - h) // 2, (W - w) // 2
        return nd_array(arr[y0:y0 + h, x0:x0 + w])


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation="bilinear"):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._pad = pad
        self._interp = interpolation

    def forward(self, x):
        arr = _to_np(x)
        if self._pad:
            p = self._pad
            arr = np.pad(arr, ((p, p), (p, p), (0, 0)), mode="constant")
        w, h = self._size
        H, W = arr.shape[:2]
        if H < h or W < w:
            arr = _resize_np(arr, (max(w, W), max(h, H)), self._interp)
            H, W = arr.shape[:2]
        y0 = np.random.randint(0, H - h + 1)
        x0 = np.random.randint(0, W - w + 1)
        return nd_array(arr[y0:y0 + h, x0:x0 + w])


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        arr = _to_np(x)
        H, W = arr.shape[:2]
        area = H * W
        for _ in range(10):
            target = np.random.uniform(*self._scale) * area
            ratio = np.exp(np.random.uniform(np.log(self._ratio[0]),
                                             np.log(self._ratio[1])))
            w = int(round(np.sqrt(target * ratio)))
            h = int(round(np.sqrt(target / ratio)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                crop = arr[y0:y0 + h, x0:x0 + w]
                return nd_array(_resize_np(crop, self._size, self._interp))
        return nd_array(_resize_np(arr, self._size, self._interp))


class RandomFlipLeftRight(Block):
    def forward(self, x):
        arr = _to_np(x)
        if np.random.rand() < 0.5:
            arr = arr[:, ::-1]
        return nd_array(np.ascontiguousarray(arr))


class RandomFlipTopBottom(Block):
    def forward(self, x):
        arr = _to_np(x)
        if np.random.rand() < 0.5:
            arr = arr[::-1]
        return nd_array(np.ascontiguousarray(arr))


class _RandomJitter(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _factor(self):
        return 1.0 + np.random.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        return nd_array(_to_np(x).astype(np.float32) * self._factor())


class RandomContrast(_RandomJitter):
    def forward(self, x):
        arr = _to_np(x).astype(np.float32)
        mean = arr.mean()
        return nd_array(mean + (arr - mean) * self._factor())


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        arr = _to_np(x).astype(np.float32)
        gray = arr.mean(axis=-1, keepdims=True)
        return nd_array(gray + (arr - gray) * self._factor())


class RandomLighting(Block):
    """AlexNet-style PCA noise."""

    _eigval = np.array([55.46, 4.794, 1.148], np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)

    def __init__(self, alpha=0.1):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        arr = _to_np(x).astype(np.float32)
        alpha = np.random.normal(0, self._alpha, 3).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return nd_array(arr + rgb)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        ts = list(self._ts)
        np.random.shuffle(ts)
        for t in ts:
            x = t(x)
        return x
