"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``).

The reference auto-downloads; this environment has zero egress, so datasets
read the standard on-disk formats (IDX for MNIST, the python pickle batches
for CIFAR) from ``root`` and fail with a clear message when absent.
``SyntheticImageDataset`` is the benchmark stand-in. Samples are NDArrays
on the CPU (the reference's land on the default context): the DataLoader
stacks them there and moves each batch to the card in one copy.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import warnings

import numpy as np

from .transforms import nd_array
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100", "ImageFolderDataset",
           "ImageRecordDataset", "SyntheticImageDataset"]


def _read_idx(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    zeros, dtype_code, ndim = struct.unpack(">HBB", data[:4])
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    dtype = {8: np.uint8, 9: np.int8, 11: np.int16, 12: np.int32,
             13: np.float32, 14: np.float64}[dtype_code]
    return np.frombuffer(data, dtype=dtype, offset=4 + 4 * ndim).reshape(dims)


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._root = os.path.expanduser(root)
        self._train = train
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        x = nd_array(self._data[idx])
        y = int(self._label[idx])
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST from IDX files in ``root`` (train-images-idx3-ubyte[.gz] etc)."""

    _base = "train"
    _files = {True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
              False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")}

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _find(self, stem):
        for cand in (stem, stem + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(
            f"{stem}[.gz] not found under {self._root}; this environment has no "
            f"network access — place the IDX files there, or use "
            f"SyntheticImageDataset for smoke tests")

    def _get_data(self):
        img, lbl = self._files[self._train]
        images = _read_idx(self._find(img))
        labels = _read_idx(self._find(lbl))
        self._data = images.reshape(-1, 28, 28, 1)
        self._label = labels.astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from the python pickle batches under ``root``."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _batches(self):
        if self._train:
            return [f"data_batch_{i}" for i in range(1, 6)]
        return ["test_batch"]

    def _get_data(self):
        xs, ys = [], []
        for name in self._batches():
            path = None
            for sub in ("", "cifar-10-batches-py", "cifar-100-python"):
                cand = os.path.join(self._root, sub, name)
                if os.path.exists(cand):
                    path = cand
                    break
            if path is None:
                raise FileNotFoundError(
                    f"{name} not found under {self._root}; no network access — "
                    f"place the CIFAR python batches there, or use "
                    f"SyntheticImageDataset")
            with open(path, "rb") as f:
                batch = pickle.load(f, encoding="latin1")
            xs.append(np.asarray(batch["data"], np.uint8).reshape(-1, 3, 32, 32))
            ys.append(np.asarray(batch.get("labels", batch.get("fine_labels")),
                                 np.int32))
        self._data = np.concatenate(xs).transpose(0, 2, 3, 1)  # NHWC like reference
        self._label = np.concatenate(ys)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _batches(self):
        return ["train"] if self._train else ["test"]


class SyntheticImageDataset(Dataset):
    """Deterministic fake images+labels — the zero-egress benchmark feed
    (stands in where reference benchmarks use ``--benchmark 1`` synthetic
    data in example/image-classification/common/data.py)."""

    def __init__(self, length=1024, shape=(3, 224, 224), num_classes=1000,
                 layout="CHW", seed=0):
        self._length = length
        self._shape = tuple(shape)
        self._classes = num_classes
        self._seed = seed

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        rng = np.random.RandomState((self._seed * 1_000_003 + idx) % (2 ** 31))
        img = rng.randint(0, 256, size=self._shape).astype(np.float32) / 255.0
        label = int(rng.randint(self._classes))
        return nd_array(img), label


class ImageFolderDataset(Dataset):
    """root/class_x/xxx.jpg layout; decodes with PIL (reference uses mx.image)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(self._root)):
            path = os.path.join(self._root, folder)
            if not os.path.isdir(path):
                warnings.warn(f"ignoring {path}, not a directory")
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for fname in sorted(os.listdir(path)):
                if os.path.splitext(fname)[1].lower() in (".jpg", ".jpeg", ".png",
                                                          ".bmp"):
                    self.items.append((os.path.join(path, fname), label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        from PIL import Image

        path, label = self.items[idx]
        img = Image.open(path)
        img = img.convert("RGB" if self._flag else "L")
        arr = np.asarray(img, np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        x = nd_array(arr)
        if self._transform is not None:
            return self._transform(x, label)
        return x, label


class ImageRecordDataset(Dataset):
    """Dataset over an image RecordIO file (reference ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from ....io.recordio import MXIndexedRecordIO, unpack_img
        import os as _os

        self._unpack_img = unpack_img
        idx_file = _os.path.splitext(filename)[0] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        record = self._record.read_idx(self._record.keys[idx])
        header, img = self._unpack_img(record, iscolor=self._flag)
        x = nd_array(img)
        label = header.label
        if self._transform is not None:
            return self._transform(x, label)
        return x, label
