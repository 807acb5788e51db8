"""DataLoader: batched, shuffled, prefetching loader (counterpart of
``mxnet_tpu/gluon/data/dataloader.py``).

Workers are a thread pool with a bounded prefetch window, as in the
reference (decode and augment are numpy/PIL work that releases the GIL);
``num_workers=0`` is synchronous. A batch arrives on the default context,
the reference's contract, but it is made on the host: the workers index
the dataset and stack the samples there, and the consumer moves each
batch to the context with one copy. Samples that already sit on a device
are stacked there instead.

``pin_memory=True``, which the reference accepts and ignores, is real
here: the workers assemble each batch in pinned host memory and the
consumer issues one ``non_blocking`` copy on its current stream; the
pinned buffer is kept until that copy's event has completed.
"""
from __future__ import annotations

import concurrent.futures as _futures
from collections import deque

import numpy as np
import torch

from ...context import current_context
from ...ndarray import NDArray
from ...ndarray import stack as nd_stack
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _host_batch(data):
    """Stack samples on the host: a numpy array, a CPU tensor, or (for
    samples on a device) an NDArray stacked there; tuples recurse."""
    first = data[0]
    if isinstance(first, NDArray):
        if all(d._data.device.type == "cpu" for d in data):
            return torch.stack([d._data for d in data])
        return nd_stack(*data, axis=0)
    if isinstance(first, (tuple, list)):
        return tuple(_host_batch(list(x)) for x in zip(*data))
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return arr


def _pin(batch):
    if isinstance(batch, tuple):
        return tuple(_pin(b) for b in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if isinstance(batch, torch.Tensor):
        return batch.pin_memory()
    return batch


def _to_context(batch, ctx, keep):
    """``batch`` as NDArrays on ``ctx``; the pinned sources of
    ``non_blocking`` copies are appended to ``keep``."""
    if isinstance(batch, tuple):
        return tuple(_to_context(b, ctx, keep) for b in batch)
    if isinstance(batch, NDArray):
        return batch
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    dev = ctx.torch_device()
    if batch.is_pinned() and dev.type == "cuda":
        keep.append(batch)
        return NDArray(batch.to(dev, non_blocking=True), ctx=ctx)
    return NDArray(batch, ctx=ctx)


def default_batchify_fn(data):
    """Stack samples into a batch on the current context (reference
    default_batchify_fn)."""
    return _to_context(_host_batch(data), current_context(), [])


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None, thread_pool=False,
                 timeout=120):
        self._dataset = dataset
        self._pin_memory = pin_memory
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size is required when batch_sampler is None")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with an explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size, last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError("batch_sampler is mutually exclusive with "
                             "batch_size/shuffle/sampler/last_batch")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn
        self._num_workers = max(0, int(num_workers))
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)

    def _make_batch(self, indices, ctx, pin):
        """Worker side: the samples of ``indices``, batchified (under the
        consumer's context scope, for a batchify_fn that makes arrays)."""
        with ctx:
            samples = [self._dataset[i] for i in indices]
            if self._batchify_fn is not None:
                return self._batchify_fn(samples)
            batch = _host_batch(samples)
            return _pin(batch) if pin else batch

    def __iter__(self):
        ctx = current_context()
        pin = self._pin_memory and ctx.device_type == "gpu"
        inflight = deque()  # (copy event, pinned sources)

        def deliver(batch):
            if self._batchify_fn is not None:
                return batch
            keep = []
            out = _to_context(batch, ctx, keep)
            if keep:
                event = torch.cuda.Event()
                event.record()
                inflight.append((event, keep))
            while inflight and inflight[0][0].query():
                inflight.popleft()
            return out

        try:
            if self._num_workers == 0:
                for indices in self._batch_sampler:
                    yield deliver(self._make_batch(indices, ctx, pin))
                return
            with _futures.ThreadPoolExecutor(self._num_workers) as pool:
                pending = []
                it = iter(self._batch_sampler)
                try:
                    for _ in range(self._prefetch):
                        pending.append(pool.submit(self._make_batch, next(it),
                                                   ctx, pin))
                except StopIteration:
                    pass
                while pending:
                    fut = pending.pop(0)
                    try:
                        pending.append(pool.submit(self._make_batch, next(it),
                                                   ctx, pin))
                    except StopIteration:
                        pass
                    yield deliver(fut.result())
        finally:
            for event, _keep in inflight:
                event.synchronize()

    def __len__(self):
        return len(self._batch_sampler)

