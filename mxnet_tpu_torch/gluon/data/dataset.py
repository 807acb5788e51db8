"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``)."""
from __future__ import annotations

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        from .sampler import FilterSampler

        sampler = FilterSampler(fn, self)
        return _SampledDataset(self, sampler)

    def shard(self, num_shards, index):
        """Rank-sharding (the part_index/num_parts analog for dist data)."""
        assert 0 <= index < num_shards
        length = len(self)
        per = length // num_shards
        rest = length % num_shards
        start = per * index + min(index, rest)
        end = start + per + (1 if index < rest else 0)
        return _SampledDataset(self, list(range(start, end)))

    def take(self, count):
        return _SampledDataset(self, list(range(min(count, len(self)))))

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _SampledDataset(Dataset):
    def __init__(self, dataset, sampler):
        self._dataset = dataset
        self._indices = list(sampler)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._dataset[self._indices[idx]]


class ArrayDataset(Dataset):
    """Zip of equal-length arrays/datasets."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for a in args:
            assert len(a) == self._length, "all arrays must have the same length"
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file (reference gluon.data.RecordFileDataset)."""

    def __init__(self, filename):
        from ...io.recordio import MXIndexedRecordIO
        import os

        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = MXIndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
