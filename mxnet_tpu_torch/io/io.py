"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``): ``DataDesc``,
``DataBatch``, ``DataIter``, ``NDArrayIter``, ``CSVIter``, ``MNISTIter``,
``ImageRecordIter``, ``ResizeIter`` and ``PrefetchingIter``. Batches are
NDArrays on the current context (the card unless a ``with mx.cpu():``
scope is open); files are read and images decoded on the host.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque, namedtuple
from typing import List

import numpy as np
import torch

from .. import obs
from ..context import current_context
from ..ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ImageRecordIter", "ResizeIter", "PrefetchingIter"]


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

    # -- elastic-training hook (the elastic fit loop, module/base_module.py)
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


class CSVIter(DataIter):
    """CSV file iterator (reference src/io/iter_csv.cc analog)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, part_index=0, num_parts=1,
                 data_name="data", label_name="softmax_label"):
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32, ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1 and len(label_shape) == 1:
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), np.float32)
        self._inner = NDArrayIter(
            {data_name: data}, {label_name: label}, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            data_name=data_name, label_name=label_name,
            part_index=part_index, num_parts=num_parts)
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def get_checkpoint_state(self):
        return self._inner.get_checkpoint_state()

    def set_checkpoint_state(self, state):
        self._inner.set_checkpoint_state(state)

    def set_partition(self, part_index, num_parts):
        self._inner.set_partition(part_index, num_parts)


class MNISTIter(DataIter):
    """MNIST IDX file iterator (reference src/io/iter_mnist.cc analog)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 part_index=0, num_parts=1, data_name="data",
                 label_name="softmax_label", **kwargs):
        from ..gluon.data.vision.datasets import _read_idx

        imgs = _read_idx(image).astype(np.float32) / 255.0
        lbls = _read_idx(label).astype(np.float32)
        imgs = imgs.reshape(-1, 784) if flat else imgs.reshape(-1, 1, 28, 28)
        self._inner = NDArrayIter({data_name: imgs}, {label_name: lbls},
                                  batch_size=batch_size, shuffle=shuffle,
                                  last_batch_handle="discard",
                                  data_name=data_name, label_name=label_name,
                                  part_index=part_index, num_parts=num_parts)
        super().__init__(batch_size)

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def get_checkpoint_state(self):
        return self._inner.get_checkpoint_state()

    def set_checkpoint_state(self, state):
        self._inner.set_checkpoint_state(state)

    def set_partition(self, part_index, num_parts):
        self._inner.set_partition(part_index, num_parts)


class ImageRecordIter(DataIter):
    """Image RecordIO iterator with decode + augment + batch (the reference's
    C++ ImageRecordIter pipeline: src/io/iter_image_recordio_2.cc).

    Decoding runs on the host: through the C++ decoder
    (``native/io/recordio_jpeg.cc``, built by ``native.io_lib``) for
    3-channel data when it builds, else PIL in a thread pool (PIL releases
    the GIL for JPEG work); ``no_native=True`` opts out of the C++ path,
    and a record it cannot decode (a PNG) drops the iterator to PIL.
    ``_native`` is the library in use, None on the PIL path. Supports rank
    sharding and the augmentations of the ImageNet configs (resize,
    rand_crop, rand_mirror, mean/std, HWC→CHW). Batches arrive on the
    default context.
    """

    def __init__(self, path_imgrec, data_shape, batch_size=1, label_width=1,
                 shuffle=False, rand_crop=False, rand_mirror=False, resize=-1,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0, std_g=1.0,
                 std_b=1.0, part_index=0, num_parts=1, preprocess_threads=4,
                 round_batch=True, data_name="data", label_name="softmax_label",
                 path_imgidx=None, dtype="float32", **kwargs):
        super().__init__(batch_size)
        from .recordio import MXIndexedRecordIO, MXRecordIO, unpack_img

        # dtype="uint8": raw pixels cross the host→device link (4x
        # smaller) and the normalization runs on the card in the train
        # step (parallel.ShardedTrainer's preprocess; .mean/.std expose the
        # deferred constants).
        if dtype not in ("float32", "uint8"):
            raise ValueError(f"dtype must be float32|uint8, got {dtype!r}")
        self.dtype = dtype
        self._unpack_img = unpack_img
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        self._mean = np.array([mean_r, mean_g, mean_b], np.float32).reshape(3, 1, 1)
        self._std = np.array([std_r, std_g, std_b], np.float32).reshape(3, 1, 1)
        self.mean, self.std = self._mean, self._std  # public for fused normalize
        self._shuffle = shuffle
        self._threads = max(1, int(preprocess_threads))

        idx_path = path_imgidx or os.path.splitext(path_imgrec)[0] + ".idx"
        if os.path.exists(idx_path):
            rec = MXIndexedRecordIO(idx_path, path_imgrec, "r")
            keys = list(rec.keys)
            self._rec = rec
            self._offsets = [rec.idx[k] for k in keys]
        else:
            # no index: scan once for record offsets
            rec = MXRecordIO(path_imgrec, "r")
            self._offsets = []
            while True:
                pos = rec.tell()
                if rec.read() is None:
                    break
                self._offsets.append(pos)
            self._rec = rec
        self._full_offsets = np.asarray(self._offsets)
        self.part_index, self.num_parts = int(part_index), int(num_parts)
        self._offsets = _shard(self._full_offsets, part_index, num_parts)
        self._order = np.arange(len(self._offsets))
        self.cursor = 0
        if shuffle:
            np.random.shuffle(self._order)
        self._read_lock = threading.Lock()  # seek+read on the shared handle
        self._path = path_imgrec
        self._native = None
        # The C++ pipeline decodes RGB only; grayscale/other channel counts
        # go through the PIL path, which honors data_shape[0].
        if not kwargs.get("no_native") and self.data_shape[0] == 3:
            from ..native import io_lib

            self._native = io_lib()  # C++ decode pipeline when built
        self._seed_counter = 0

    @property
    def provide_data(self):
        dt = np.uint8 if self.dtype == "uint8" else np.float32
        return [DataDesc("data", (self.batch_size,) + self.data_shape, dt)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        self.cursor = 0
        if self._shuffle:
            np.random.shuffle(self._order)

    def set_partition(self, part_index, num_parts):
        """Recut the record-offset shard (elastic epoch boundary); under the
        read lock because prefetch workers may still be draining. Shards
        are trimmed to the equal ``n // num_parts`` size (drop-last) so
        every live rank runs the same batch count. Always recuts (see
        NDArrayIter.set_partition)."""
        with self._read_lock:
            self.part_index, self.num_parts = int(part_index), int(num_parts)
            self._offsets = _shard(self._full_offsets, self.part_index,
                                   self.num_parts)
            even = len(self._full_offsets) // max(1, self.num_parts)
            if len(self._offsets) > even:
                self._offsets = self._offsets[:even]
            self._order = np.arange(len(self._offsets))
            self.cursor = 0
        if self._shuffle:
            np.random.shuffle(self._order)

    def _load_one(self, offset, rng=None):
        rng = rng if rng is not None else np.random
        with self._read_lock:  # decode below stays parallel; IO is serialized
            self._rec.record.seek(offset)
            blob = self._rec.read()
        header, img = self._unpack_img(blob, iscolor=1)  # HWC uint8
        c, h, w = self.data_shape
        if self._resize > 0:
            img = _resize_short(img, self._resize)
        if self._rand_crop:
            img = _rand_crop(img, h, w, rng)
        else:
            img = _center_crop(img, h, w)
        if self._rand_mirror and rng.rand() < 0.5:
            img = img[:, ::-1]
        if self.dtype == "uint8":
            chw = img.transpose(2, 0, 1)
        else:
            chw = img.astype(np.float32).transpose(2, 0, 1)
            chw = (chw - self._mean) / self._std
        label = header.label
        if np.ndim(label) == 0:
            label = np.float32(label)
        else:
            label = np.asarray(label, np.float32)[:self.label_width]
        return chw, label

    def _advance(self):
        """Reserve the next batch's record offsets + augmentation seed
        (thread-safe): the cursor/seed state mutates under the read lock so
        PrefetchingIter can run several batch loads concurrently without
        racing the cursor, the deterministic seed counter, or the global
        RNG."""
        with self._read_lock:
            n = len(self._offsets)
            if self.cursor + self.batch_size > n:
                raise StopIteration
            idxs = self._order[self.cursor:self.cursor + self.batch_size]
            self.cursor += self.batch_size
            self._seed_counter += 1
            if self._rand_crop or self._rand_mirror:
                seed = int(np.random.randint(0, 2 ** 31))
            else:
                seed = self._seed_counter
        return [int(self._offsets[i]) for i in idxs], seed

    def _host_batch(self, reserved, pinned=False):
        """The reserved batch decoded on the host: (data, label) CPU
        tensors, in pinned memory when ``pinned`` (the C++ decoder writes
        into it directly)."""
        offsets, seed = reserved
        lib = self._native  # read once: another worker may drop it to PIL
        if lib is not None:
            try:
                return self._native_arrays(lib, offsets, seed, pinned)
            except RuntimeError:
                self._native = None  # e.g. PNG records → PIL path
        import concurrent.futures as cf

        # per-image RandomStates derived from the batch's reserved seed:
        # the PIL path stays deterministic per (seed, position) even with
        # concurrent prefetch workers (no global-RNG races). Skipped when
        # nothing draws randomness.
        if self._rand_crop or self._rand_mirror:
            rngs = [np.random.RandomState((seed + 31 * i) % (2 ** 31))
                    for i in range(len(offsets))]
        else:
            rngs = [None] * len(offsets)
        if self._threads > 1:
            with cf.ThreadPoolExecutor(self._threads) as pool:
                results = list(pool.map(self._load_one, offsets, rngs))
        else:
            results = [self._load_one(o, r) for o, r in zip(offsets, rngs)]
        data = torch.from_numpy(np.stack([r[0] for r in results]))
        label = torch.from_numpy(np.stack([r[1] for r in results]))
        if pinned:
            data, label = data.pin_memory(), label.pin_memory()
        return data, label

    def _load_batch(self, reserved):
        data, label = self._host_batch(reserved)
        return DataBatch([nd_array(data)], [nd_array(label)], 0, None)

    def next(self):
        return self._load_batch(self._advance())

    def _native_arrays(self, lib, offsets, seed, pinned=False):
        """Batch decode through the C++ pipeline ``lib``
        (native/io/recordio_jpeg.cc): (data, label) CPU tensors."""
        import ctypes

        bs = len(offsets)
        c, h, w = self.data_shape
        labels = torch.empty((bs, self.label_width), dtype=torch.float32,
                             pin_memory=pinned)
        lab_np = labels.numpy()
        offs = (ctypes.c_int64 * bs)(*offsets)
        if self.dtype == "uint8":
            data = torch.empty((bs, 3, h, w), dtype=torch.uint8,
                               pin_memory=pinned)
            fails = lib.mxtpu_decode_batch_u8(
                self._path.encode(), offs, bs, h, w, int(self._resize),
                int(bool(self._rand_crop)), int(bool(self._rand_mirror)),
                ctypes.c_uint64(seed),
                data.numpy().ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                lab_np.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.label_width, self._threads)
        else:
            data = torch.empty((bs, 3, h, w), dtype=torch.float32,
                               pin_memory=pinned)
            mean = (ctypes.c_float * 3)(*self._mean.ravel())
            std = (ctypes.c_float * 3)(*self._std.ravel())
            fails = lib.mxtpu_decode_batch(
                self._path.encode(), offs, bs, h, w, int(self._resize),
                int(bool(self._rand_crop)), int(bool(self._rand_mirror)),
                ctypes.c_uint64(seed), mean, std,
                data.numpy().ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                lab_np.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.label_width, self._threads)
        if fails:
            raise RuntimeError(f"native decode failed for {fails} records")
        lab = labels[:, 0] if self.label_width == 1 else labels
        return data, lab


def _resize_short(img, size):
    from PIL import Image

    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, int(w * size / h)
    else:
        nh, nw = int(h * size / w), size
    pil = Image.fromarray(img)
    return np.asarray(pil.resize((nw, nh), Image.BILINEAR))


def _center_crop(img, h, w):
    H, W = img.shape[:2]
    if H < h or W < w:
        img = _pad_to(img, max(h, H), max(w, W))
        H, W = img.shape[:2]
    y0, x0 = (H - h) // 2, (W - w) // 2
    return img[y0:y0 + h, x0:x0 + w]


def _rand_crop(img, h, w, rng=None):
    rng = rng if rng is not None else np.random
    H, W = img.shape[:2]
    if H < h or W < w:
        img = _pad_to(img, max(h, H), max(w, W))
        H, W = img.shape[:2]
    y0 = rng.randint(0, H - h + 1)
    x0 = rng.randint(0, W - w + 1)
    return img[y0:y0 + h, x0:x0 + w]


def _pad_to(img, h, w):
    ph, pw = max(0, h - img.shape[0]), max(0, w - img.shape[1])
    return np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches (reference ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur >= self.size:
            raise StopIteration
        self.cur += 1
        try:
            return self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            return self.data_iter.next()


class PrefetchingIter(DataIter):
    """Background-thread prefetch wrapper (reference PrefetchingIter):
    worker threads load batches ahead of the consumer so the device step
    overlaps the host side.

    The batches go to the context current at construction. On a card each
    worker issues its copies on the iterator's own CUDA stream, never on
    the legacy default stream: a split-phase backing iterator
    (``ImageRecordIter``) decodes into pinned host memory and the copy is
    ``non_blocking``; any other backing iterator makes its arrays under
    that stream. ``next`` makes the consumer's current stream wait for the
    batch's copy event and ``record_stream``s its tensors, so the caching
    allocator cannot reuse them early; pinned sources are kept until their
    copy event has completed. A failed load or copy raises from ``next``.
    """

    def __init__(self, iters, rename_data=None, rename_label=None, prefetch=2,
                 num_threads=2):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        assert len(iters) == 1, "single backing iter supported"
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._prefetch = max(prefetch, num_threads)
        # several workers for a split-phase iterator (offsets reserved
        # under its lock by _advance): one batch's decode overlaps
        # another's copy
        self._num_threads = (num_threads
                             if hasattr(self.iter, "_host_batch") else 1)
        self._ctx = current_context()
        self._device = self._ctx.torch_device()
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._inflight = deque()  # (copy event, pinned sources)
        self._pool = None
        self._queue = []
        # kick off the first prefetches NOW: the first next() finds its
        # batch already decoded and in flight to the device
        self._ensure_pool()
        while len(self._queue) < self._prefetch:
            self._submit_one()

    def _fetch(self, reserved):
        """Worker side: one batch on the target context, with the event of
        its copy (None off the card)."""
        with self._ctx:
            if self._stream is None:
                return self._produce(reserved), None
            with torch.cuda.stream(self._stream):
                batch = self._produce(reserved)
                return batch, self._stream.record_event()

    def _produce(self, reserved):
        if reserved is None:
            return self.iter.next()
        on_card = self._stream is not None
        host = self.iter._host_batch(reserved, pinned=on_card)
        arrays = [NDArray(t.to(self._device, non_blocking=on_card),
                          ctx=self._ctx) for t in host]
        batch = DataBatch([arrays[0]], [arrays[1]], 0, None)
        batch._pinned = host if on_card else None
        return batch

    @property
    def provide_data(self):
        return self.iter.provide_data

    @property
    def provide_label(self):
        return self.iter.provide_label

    def reset(self):
        self._drain()
        self.iter.reset()

    def set_partition(self, part_index, num_parts):
        """Recut the backing iterator's shard; in-flight prefetches are
        drained first so no batch from the old cut leaks into the new."""
        self._drain()
        self.iter.set_partition(part_index, num_parts)

    def _drain(self):
        for f in self._queue:
            try:
                f.result()
            except StopIteration:
                pass
        self._queue = []

    def _ensure_pool(self):
        if self._pool is None:
            import concurrent.futures as cf

            self._pool = cf.ThreadPoolExecutor(self._num_threads)

    def _submit_one(self):
        """Queue one batch fetch. Offsets (and the augmentation seed) are
        reserved HERE on the consumer thread — submission order IS
        delivery order, so multi-worker prefetch keeps the backing iter's
        (seeded) batch order and can never drop a trailing batch behind an
        earlier StopIteration."""
        import concurrent.futures as cf

        if self._num_threads > 1:
            try:
                reserved = self.iter._advance()
            except StopIteration as e:
                fut = cf.Future()
                fut.set_exception(e)
                self._queue.append(fut)
                return
            self._queue.append(self._pool.submit(self._fetch, reserved))
        else:
            self._queue.append(self._pool.submit(self._fetch, None))

    def next(self):
        self._ensure_pool()
        while len(self._queue) < self._prefetch:
            self._submit_one()
        fut = self._queue.pop(0)
        self._submit_one()
        rec = obs.enabled()
        if rec:
            # queue depth = batches already made and waiting; a depth
            # pinned at 0 means the consumer is data-bound
            obs.set_gauge("io.prefetch.queue_depth",
                          sum(1 for f in self._queue if f.done()))
            t0 = time.monotonic()
        try:
            batch, event = fut.result()
        except StopIteration:
            self._drain()
            raise
        if rec:
            # producer stall: how long the step loop blocked because the
            # prefetch workers had not finished this batch (~0 when ahead)
            obs.observe("io.prefetch.stall_seconds", time.monotonic() - t0)
            obs.inc("io.prefetch.batches")
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for arr in list(batch.data) + list(batch.label):
                arr._data.record_stream(stream)
            pinned = getattr(batch, "_pinned", None)
            if pinned is not None:
                self._inflight.append((event, pinned))
                batch._pinned = None
        while self._inflight and self._inflight[0][0].query():
            self._inflight.popleft()
        return batch

    def close(self):
        """Stop the prefetch workers and drop pending batches. Call when
        done timing/training — leftover workers otherwise keep decoding up
        to `prefetch` batches and contend with whatever runs next."""
        for f in self._queue:
            f.cancel()
        self._queue = []
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        while self._inflight:
            self._inflight.popleft()[0].synchronize()

    def __del__(self):  # best-effort cleanup
        try:
            self.close()
        except Exception:
            pass
