"""Data iterators: ``DataDesc``, ``DataBatch``, ``DataIter`` and
``NDArrayIter`` (the part of ``mxnet_tpu/io/io.py`` that ``Module``
needs). Batches are NDArrays on the current context (the card unless a
``with mx.cpu():`` scope is open). ``CSVIter``, ``MNISTIter``,
``ImageRecordIter``, ``ResizeIter``, ``PrefetchingIter`` and recordio are
queue item A11.
"""
from __future__ import annotations

from collections import namedtuple
from typing import List

import numpy as np

from ..ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)


class DataBatch:
    def __init__(self, data, label=None, pad=0, index=None, bucket_key=None,
                 provide_data=None, provide_label=None):
        self.data = data if isinstance(data, (list, tuple)) else [data]
        if label is None:
            self.label = []
        else:
            self.label = label if isinstance(label, (list, tuple)) else [label]
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __repr__(self):
        shapes = [d.shape for d in self.data]
        return f"DataBatch: data shapes {shapes} pad={self.pad}"


class DataIter:
    """Base iterator (reference mx.io.DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def __next__(self):
        return self.next()

    def next(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0

    # -- checkpoint/resume hooks -------------------------------------------
    def get_checkpoint_state(self):
        """Snapshot of the iteration position for mid-epoch resume, or None
        when this iterator cannot be positioned (the fit loop then only
        checkpoints at epoch boundaries). Values must be JSON scalars or
        numpy arrays."""
        return None

    def set_checkpoint_state(self, state):
        raise NotImplementedError(
            f"{type(self).__name__} does not support mid-epoch resume")

    # -- elastic-training hook (the elastic fit loop: queue item A14) -----
    def set_partition(self, part_index, num_parts):
        """Recut this iterator's rank shard (``part_index`` of
        ``num_parts`` over the FULL dataset). Called at epoch boundaries
        when fleet membership changed — survivors absorb a dead worker's
        shard, a rejoiner takes its recut slice. Iterators that cannot be
        recut raise; the elastic fit loop treats that as
        "keep the construction-time shard"."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support shard recutting")


def _shard(arr, part_index, num_parts):
    if num_parts <= 1:
        return arr
    n = arr.shape[0]
    per = n // num_parts
    start = per * part_index + min(part_index, n % num_parts)
    end = start + per + (1 if part_index < n % num_parts else 0)
    return arr[start:end]


class NDArrayIter(DataIter):
    """Iterate numpy/NDArray tensors (reference NDArrayIter: pad/discard/
    roll_over last-batch handling, shuffle, optional rank sharding)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label",
                 part_index=0, num_parts=1):
        super().__init__(batch_size)
        # the FULL dataset is retained so elastic training can recut the
        # rank shard at an epoch boundary (set_partition); self.data/label
        # always hold the current shard's view
        self._full_data = _normalize(data, data_name)
        self._full_label = _normalize(label, label_name)
        self._shuffle = shuffle
        self._last = last_batch_handle
        self.part_index, self.num_parts = int(part_index), int(num_parts)
        self._apply_partition()
        if shuffle:
            np.random.shuffle(self._order)

    def _apply_partition(self):
        self.data = [(k, _shard(v, self.part_index, self.num_parts))
                     for k, v in self._full_data]
        self.label = [(k, _shard(v, self.part_index, self.num_parts))
                      for k, v in self._full_label]
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        self.cursor = -self.batch_size
        self._order = np.arange(self.num_data)

    def set_partition(self, part_index, num_parts):
        """Recut the rank shard over the full dataset (elastic fit loops
        call this at epoch boundaries only — it rewinds the cursor and
        resets the shuffle order, which the next ``reset()`` reshuffles).

        Shards are trimmed to the EQUAL size ``n // num_parts`` (drop-last
        over the remainder): elastic sync is lockstep, so every live rank
        must run the same number of batches per epoch — and a user cannot
        pre-size a dataset divisibly for every possible surviving fleet
        size. At most ``num_parts - 1`` trailing samples sit out per
        epoch.

        Always recuts — even for an unchanged ``(part_index, num_parts)``:
        an iterator pre-sharded at construction keeps the remainder-
        unbalanced cut until this runs, and skipping the trim for it would
        quietly reintroduce the unequal batch counts."""
        self.part_index, self.num_parts = int(part_index), int(num_parts)
        self._apply_partition()
        total = self._full_data[0][1].shape[0] if self._full_data else 0
        even = total // max(1, self.num_parts)
        if self.num_data > even:
            self.data = [(k, v[:even]) for k, v in self.data]
            self.label = [(k, v[:even]) for k, v in self.label]
            self.num_data = even
            self._order = np.arange(even)
        if self._shuffle:
            np.random.shuffle(self._order)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self._shuffle:
            np.random.shuffle(self._order)
        if self._last == "roll_over" and 0 < self.cursor < self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data)
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        if self._last == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, arrays):
        out = []
        for k, v in arrays:
            idx = self._order[max(self.cursor, 0):self.cursor + self.batch_size]
            part = v[idx]
            if part.shape[0] < self.batch_size and self._last == "pad":
                wrap = self._order[:self.batch_size - part.shape[0]]
                part = np.concatenate([part, v[wrap]], axis=0)
            out.append(nd_array(np.ascontiguousarray(part)))
        return out

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        if self._last == "pad" and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def get_checkpoint_state(self):
        # cursor + shuffle order fully determine the remaining batches; the
        # global numpy RNG (next epoch's reshuffle) is captured separately
        # by the checkpoint RNG snapshot. The order MUST be copied: reset()
        # reshuffles it in place, and the snapshot may sit on the async
        # writer's queue across that
        return {"cursor": int(self.cursor),
                "order": np.array(self._order, np.int64)}

    def set_checkpoint_state(self, state):
        self.cursor = int(state["cursor"])
        self._order = np.asarray(state["order"], np.int64)


def _normalize(data, default_name) -> List:
    if data is None:
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = {default_name: data}
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}{i if i else ''}": d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        v = np.asarray(v)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        out.append((k, v))
    return out
