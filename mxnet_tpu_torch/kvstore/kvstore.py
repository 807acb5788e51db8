"""KVStore: gradient aggregation and parameter distribution (counterpart
of ``mxnet_tpu/kvstore/kvstore.py``).

- ``local`` / ``device`` / ``nccl`` / ``ici`` (and the reference's
  ``local_*`` spellings): one process. The reference's push/pull
  semantics hold: several values pushed to a key merge by sum, an
  optimizer set on the store (``set_optimizer``) updates the stored value
  on every push (a multi-key push as one batched update), ``pull`` and
  ``row_sparse_pull`` copy out, ``device``/``nccl``/``ici`` take 2-bit
  compression (quantize and dequantize with error feedback, so the
  numbers match the distributed wire). Values stay on their device: a
  push of CUDA arrays sums on the card.
- ``dist_sync`` / ``dist_device_sync`` / ``dist_async``: many processes,
  ``dist.DistKVStore``.
"""
from __future__ import annotations

from typing import Dict

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL_NAMES = ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device", "nccl", "ici")
_DIST_NAMES = ("dist_sync", "dist_device_sync", "dist_sync_device",
               "dist_async", "dist")


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _owned(v: NDArray) -> NDArray:
    """A copy of ``v`` that shares no storage with it (the store's
    value is updated in place by the optimizer)."""
    return NDArray(v._data.detach().clone(), ctx=v.context)


def _copy_into(out: NDArray, t) -> None:
    """Set ``out`` to a copy of tensor ``t`` on ``out``'s device."""
    out._set_data(t.detach().to(out._data.device, copy=True))


class KVStore:
    """Single-process key-value store (modes local, device, nccl, ici)."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store: Dict = {}
        self._pending: Dict = {}
        self._updater = None
        self._optimizer = None
        self._compression = None

    # -- identity ---------------------------------------------------------
    @property
    def type(self):
        return self._kind

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    # -- core API ---------------------------------------------------------
    def init(self, key, value):
        for k, v in zip(_as_list(key), _as_list(value)):
            k = str(k)
            if k not in self._store:
                self._store[k] = _owned(v)

    def push(self, key, value, priority=0):
        """Merge the pushed value(s) into the key by sum; with an optimizer
        on the store, update the stored value instead (a multi-key push
        as one batched update)."""
        keys, values = _as_list(key), _as_list(value)
        if len(keys) == 1 and len(values) > 1:
            keys = keys * len(values)
        batch = []  # (key, merged gradient) bound for the updater
        for k, v in zip(keys, values):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized in kvstore")
            vs = _as_list(v)
            merged = vs[0]
            for extra in vs[1:]:
                merged = merged + extra
            # DistKVStore keeps its raw params dict in _compression and
            # compresses on its own wire; only the device store holds a
            # GradientCompression here
            comp = self._compression
            if comp is not None and hasattr(comp, "compress"):
                g = merged._data.detach().float()
                merged = NDArray(comp.decompress(comp.compress(k, g),
                                                 tuple(g.shape)),
                                 ctx=merged.context)
            if self._updater is not None:
                batch.append((k, merged))
            else:
                self._pending.setdefault(k, []).append(merged)
        if len(batch) > 1 and hasattr(self._updater, "update_batch"):
            idxs = [int(k) if k.isdigit() else k for k, _ in batch]
            self._updater.update_batch(idxs, [m for _, m in batch],
                                       [self._store[k] for k, _ in batch])
        else:
            for k, merged in batch:
                self._updater(int(k) if k.isdigit() else k, merged,
                              self._store[k])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _as_list(key), _as_list(out)
        if len(keys) == 1 and len(outs) > 1:
            keys = keys * len(outs)
        for k, o in zip(keys, outs):
            k = str(k)
            if k not in self._store:
                raise MXNetError(f"key {k} not initialized in kvstore")
            self._flush(k)
            for oo in _as_list(o):
                _copy_into(oo, self._store[k]._data)

    def _flush(self, k):
        pending = self._pending.pop(k, None)
        if pending:
            merged = pending[0]._data.clone()  # the store owns its value
            for extra in pending[1:]:
                merged += extra._data
            self._store[k]._set_data(merged)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out=out if out is not None else value,
                  priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows named by ``row_ids`` (the sparse embedding
        path): the stored value's rows, gathered."""
        for k, o, r in zip(_as_list(key), _as_list(out), _as_list(row_ids)):
            k = str(k)
            self._flush(k)
            rows = self._store[k].take(
                r.astype("int32") if hasattr(r, "astype") else r)
            for oo in _as_list(o):
                _copy_into(oo, rows._data)

    # -- optimizer on the store ------------------------------------------
    def set_optimizer(self, optimizer):
        from ..optimizer import Updater

        self._optimizer = optimizer
        self._updater = Updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """The reference's contract: the device and distributed stores take
        compression; the CPU-only ``local`` store raises."""
        from .compression import (GradientCompression,
                                  validate_compression_params)

        params = validate_compression_params(compression_params)
        if params is None:
            self._compression = None
            return
        if self._kind not in ("device", "ici", "nccl"):
            raise MXNetError(
                f"gradient compression is not supported for kvstore type "
                f"{self._kind!r}; use device or dist_sync/dist_async")
        # one process has no wire to shrink: quantize and dequantize each
        # pushed gradient (with error feedback) so the numbers match the
        # distributed wire's
        self._compression = GradientCompression(params["threshold"])

    # -- persistence / misc ----------------------------------------------
    def save_optimizer_states(self, fname, dump_optimizer=False):
        from ..checkpoint.atomic import atomic_write_bytes

        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        atomic_write_bytes(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "rb") as f:
            data = f.read()
        ctx = next(iter(self._store.values())).context if self._store \
            else None
        self._updater.set_states(data, ctx=ctx)

    def barrier(self):
        pass

    def _barrier(self):
        pass


def create(name="local") -> KVStore:
    """Create a kvstore (the reference's ``kvstore.create``):
    local/device/nccl/ici and the ``local_*`` names make a one-process
    :class:`KVStore`; dist_sync/dist_device_sync/dist_sync_device/dist a
    ``DistKVStore`` over a ``torch.distributed`` process group (or the
    elastic PS wire under ``MXNET_ELASTIC=1``); dist_async a
    ``DistKVStore`` over the parameter server."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name in _LOCAL_NAMES:
        return KVStore(name)
    if name in _DIST_NAMES:
        from .dist import DistKVStore

        return DistKVStore(name)
    if name == "horovod":
        raise MXNetError("horovod kvstore is not applicable on TPU; use "
                         "dist_sync")
    raise MXNetError(f"unknown kvstore type {name!r}")
