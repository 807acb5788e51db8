"""``BucketSentenceIter`` (counterpart of ``mxnet_tpu/rnn/io.py``): the
bucketing iterator the ``BucketingModule`` examples pair with the cell
API. A sentence lands in the smallest bucket that holds it, padded with
``invalid_label``; each batch carries ``bucket_key`` and its bucket's
``provide_data``/``provide_label``; the label is the data shifted by one
token. Bucket contents and the batch order are shuffled with numpy's
global generator, as the reference's, so the same ``np.random.seed``
gives the same batches in both packages.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray import array

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32", layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size and i > 0]
        buckets = sorted(buckets)
        if not buckets:
            raise ValueError(
                "BucketSentenceIter: no buckets could be formed — no "
                "sentence length occurs >= batch_size times; pass an "
                "explicit buckets list")
        self.buckets = buckets
        self.data_name, self.label_name = data_name, label_name
        self.invalid_label = invalid_label
        self.dtype = dtype
        self.layout = layout

        self._data = [[] for _ in buckets]
        ndiscard = 0
        for s in sentences:
            bkt = np.searchsorted(buckets, len(s))
            if bkt == len(buckets):
                ndiscard += 1
                continue
            buf = np.full((buckets[bkt],), invalid_label, dtype=dtype)
            buf[:len(s)] = s
            self._data[bkt].append(buf)
        self._data = [np.asarray(x, dtype=dtype) if x else
                      np.empty((0, b), dtype=dtype)
                      for x, b in zip(self._data, buckets)]
        self.ndiscard = ndiscard
        if ndiscard:
            warnings.warn(
                f"BucketSentenceIter: discarded {ndiscard} sentences "
                f"longer than the largest bucket ({buckets[-1]})")

        self.default_bucket_key = max(buckets)
        self._plan = []
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size, self.default_bucket_key),
                         self.dtype)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.default_bucket_key),
                         self.dtype)]

    def reset(self):
        self._plan = []
        for i, arr in enumerate(self._data):
            np.random.shuffle(arr)
            for start in range(0, len(arr) - self.batch_size + 1,
                               self.batch_size):
                self._plan.append((i, start))
        np.random.shuffle(self._plan)
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        bkt, start = self._plan[self._cursor]
        self._cursor += 1
        data = self._data[bkt][start:start + self.batch_size]
        label = np.full_like(data, self.invalid_label)
        label[:, :-1] = data[:, 1:]
        blen = self.buckets[bkt]
        batch = DataBatch([array(data)], [array(label)], 0, None)
        batch.bucket_key = blen
        batch.provide_data = [DataDesc(self.data_name,
                                       (self.batch_size, blen), self.dtype)]
        batch.provide_label = [DataDesc(self.label_name,
                                        (self.batch_size, blen), self.dtype)]
        return batch
