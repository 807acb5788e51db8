"""``mx.image``: image io and augmentation (counterpart of
``mxnet_tpu/image.py``). Decoding and resizing go through PIL on the host,
as in the reference; results are NDArrays on the current context.
``ImageIter`` wraps the RecordIO pipeline (``io.ImageRecordIter``).
"""
from __future__ import annotations

import io as _io

import numpy as np

from .ndarray import NDArray, array as nd_array

__all__ = ["imread", "imdecode", "imresize", "fixed_crop", "center_crop",
           "random_crop", "resize_short", "color_normalize", "HorizontalFlipAug",
           "CastAug", "ColorNormalizeAug", "ResizeAug", "RandomCropAug",
           "CenterCropAug", "CreateAugmenter", "ImageIter"]


def _to_np(img):
    return img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)


def imread(filename, flag=1, to_rgb=True):
    from PIL import Image

    img = Image.open(filename)
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return nd_array(arr)


def imdecode(buf, flag=1, to_rgb=True):
    from PIL import Image

    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    img = Image.open(_io.BytesIO(bytes(buf)))
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return nd_array(arr)


def imresize(src, w, h, interp=1):
    from PIL import Image

    arr = _to_np(src).astype(np.uint8)
    mode = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC}.get(interp,
                                                                       Image.BILINEAR)
    sq = arr.shape[-1] == 1
    pil = Image.fromarray(arr.squeeze(-1) if sq else arr)
    out = np.asarray(pil.resize((w, h), mode))
    if sq:
        out = out[:, :, None]
    return nd_array(out)


def resize_short(src, size, interp=1):
    arr = _to_np(src)
    h, w = arr.shape[:2]
    if h < w:
        nh, nw = size, int(w * size / h)
    else:
        nh, nw = int(h * size / w), size
    return imresize(src, nw, nh, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    arr = _to_np(src)[y0:y0 + h, x0:x0 + w]
    out = nd_array(arr)
    if size is not None and (w, h) != tuple(size):
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=1):
    arr = _to_np(src)
    H, W = arr.shape[:2]
    w, h = size
    x0, y0 = max((W - w) // 2, 0), max((H - h) // 2, 0)
    return fixed_crop(src, x0, y0, min(w, W), min(h, H), size, interp), (x0, y0, w, h)


def random_crop(src, size, interp=1):
    arr = _to_np(src)
    H, W = arr.shape[:2]
    w, h = min(size[0], W), min(size[1], H)
    x0 = np.random.randint(0, W - w + 1)
    y0 = np.random.randint(0, H - h + 1)
    return fixed_crop(src, x0, y0, w, h, size, interp), (x0, y0, w, h)


def color_normalize(src, mean, std=None):
    arr = _to_np(src).astype(np.float32)
    arr = arr - _to_np(mean)
    if std is not None:
        arr = arr / _to_np(std)
    return nd_array(arr)


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, (self.size, self.size), self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, (self.size, self.size), self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if np.random.rand() < self.p:
            return nd_array(np.ascontiguousarray(_to_np(src)[:, ::-1]))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean, self.std = np.asarray(mean, np.float32), \
            np.asarray(std, np.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = data_shape[2] if len(data_shape) == 3 else data_shape[1]
    if rand_crop:
        auglist.append(RandomCropAug(crop_size))
    else:
        auglist.append(CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53], np.float32)
    if std is True:
        std = np.array([58.395, 57.12, 57.375], np.float32)
    if mean is not None:
        auglist.append(ColorNormalizeAug(mean, std if std is not None else 1.0))
    return auglist


class ImageIter:
    """Python-side image iterator over .rec or .lst files (reference
    mx.image.ImageIter; the C++-pipeline analog is io.ImageRecordIter)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None, path_imglist=None,
                 path_root="", shuffle=False, aug_list=None, label_width=1,
                 **kwargs):
        from .io.io import ImageRecordIter

        if path_imgrec is None:
            raise ValueError("path_imgrec is required (list-file mode TBD)")
        self._inner = ImageRecordIter(
            path_imgrec=path_imgrec, data_shape=data_shape, batch_size=batch_size,
            shuffle=shuffle, label_width=label_width, **kwargs)
        self.batch_size = batch_size
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def __iter__(self):
        return self

    def reset(self):
        self._inner.reset()

    def __next__(self):
        return self._inner.next()

    next = __next__
