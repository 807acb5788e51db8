"""Distributed KVStore: ``dist_sync`` over a ``torch.distributed`` process
group, ``dist_async`` over the parameter server, elastic ``dist_sync``
over the PS wire (counterpart of ``mxnet_tpu/kvstore/dist.py``).

- ``dist_sync`` / ``dist_device_sync``: each process is one rank of a
  ``torch.distributed`` process group formed from the launcher's
  environment (``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID`` and
  ``MXNET_COORDINATOR``, or ``DMLC_PS_ROOT_URI`` + ``DMLC_PS_ROOT_PORT``;
  ``tools/launch.py`` sets them). The backend follows from the ranks that
  share a card: NCCL when each rank has a card of its own, gloo when ranks
  share one (NCCL refuses two ranks on one card) or there is no card,
  formed as ``parallel/host_staged.py``'s ``gloo_host`` group.
  gloo's ``all_reduce`` and ``broadcast`` take CUDA tensors, so values
  stay on their device; its ``all_gather`` takes host tensors, so the
  2-bit codes are gathered as host bytes. A rank that cannot form the
  group raises; it never falls back to a one-process store.
  Semantics as the reference's: rank 0's value wins at ``init``; a push
  replaces the value with the cross-worker sum; pushes buffer and move
  in one fused collective at the next pull or barrier (the batched
  flush); with 2-bit compression every worker's packed uint8 codes are
  gathered and their decoded sum taken; an optimizer on the store applies
  the same update on every rank.
- ``dist_async``: a host-side parameter server (``ps_server.py`` or
  ``native/ps/ps_server.cc``) over TCP: workers push gradients, the
  server applies the optimizer on arrival, workers pull with no barrier;
  with ``MXNET_ASYNC_STALENESS`` the pulls are gated by the committed
  clocks (bounded staleness).
- elastic ``dist_sync`` (``MXNET_ELASTIC=1`` and a PS address): the sum
  rides the PS wire as a generation-scoped allreduce (``elastic.py``),
  so a SIGKILLed worker releases every wait over the survivors.

An elastic store pins the training-fleet plane's rank
(``obs.fleetstats.set_rank``) and the straggler injector's
(``chaos.slow.set_rank``) to its fleet rank when it joins.
"""
from __future__ import annotations

import datetime
import sys

import numpy as np
import torch

from .. import obs
from ..base import MXNetError, get_env
from ..ndarray import NDArray
from . import elastic as elastic_mod
from .kvstore import KVStore, _as_list, _copy_into

__all__ = ["DistKVStore", "hierarchical_allreduce", "choose_backend",
           "join_process_group", "launcher_rank"]

_GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def choose_backend(world_size: int):
    """``(backend, ranks_per_card)`` for ``world_size`` ranks on this host:
    NCCL when every rank has a card of its own, gloo when ranks share a
    card (NCCL refuses two ranks on one) or there is none (0 a card)."""
    if not torch.cuda.is_available():
        return "gloo", 0
    per_card = -(-int(world_size) // torch.cuda.device_count())
    return ("nccl" if per_card == 1 else "gloo"), per_card


def _init_backend(backend: str) -> str:
    """The ``init_process_group`` backend for ``backend``: every gloo group
    is ``parallel/host_staged.py``'s ``gloo_host``, which finishes gloo's
    work inside each call and moves point-to-point through host copies
    (gloo's CUDA point-to-point aborts, and its CUDA work crashes
    ``DTensor``'s functional collectives), so ranks on the CPU and ranks
    sharing a card take one route."""
    from ..parallel import host_staged

    if backend != "gloo":
        return backend
    host_staged.register()
    return host_staged.BACKEND


def launcher_rank():
    """``(rank, world size)`` from the launcher's environment
    (``DMLC_WORKER_ID``/``DMLC_NUM_WORKER``, or the ``MXNET_`` names);
    ``(0, 1)`` outside a job."""
    rank = int(get_env("DMLC_WORKER_ID",
                       get_env("MXNET_WORKER_ID", 0, int), int) or 0)
    n = int(get_env("DMLC_NUM_WORKER",
                    get_env("MXNET_NUM_WORKER", 1, int), int) or 1)
    return rank, n


def _family(backend: str) -> str:
    """"nccl" or "gloo" for an ``init_process_group`` backend name."""
    return "nccl" if "nccl" in str(backend) else "gloo"


def join_process_group(rank: int, num_workers: int, who: str = "dist_sync",
                       timeout: datetime.timedelta = _GROUP_TIMEOUT):
    """Join the job's ``torch.distributed`` group as ``rank`` of
    ``num_workers``, forming it at ``MXNET_COORDINATOR`` (or
    ``DMLC_PS_ROOT_URI`` + ``DMLC_PS_ROOT_PORT``) if this process has none
    yet, with :func:`choose_backend`'s backend; ``timeout`` bounds its
    rendezvous and each collective's wait. Returns ``(backend,
    ranks_per_card, formed_here)``, or None for one worker without a
    coordinator. A group of another size or rank, a missing coordinator
    for several workers, or a group that does not form raises
    ``MXNetError`` (``who`` names the caller)."""
    import torch.distributed as dist

    backend, per_card = choose_backend(num_workers)
    if dist.is_initialized():
        if dist.get_world_size() != num_workers or dist.get_rank() != rank:
            raise MXNetError(
                f"a torch.distributed group of world size "
                f"{dist.get_world_size()} (rank {dist.get_rank()}) is "
                f"already formed; {who} is rank {rank} of {num_workers}")
        return _family(dist.get_backend()), per_card, False
    coord = get_env("MXNET_COORDINATOR", None)
    if not coord:
        uri = get_env("DMLC_PS_ROOT_URI", None)
        port = get_env("DMLC_PS_ROOT_PORT", None)
        if uri and port:
            coord = f"{uri}:{port}"
    if not coord:
        if num_workers <= 1:
            return None
        raise MXNetError(
            f"{who} needs MXNET_COORDINATOR (or DMLC_PS_ROOT_URI + "
            "DMLC_PS_ROOT_PORT); launch the workers through "
            "python -m mxnet_tpu_torch.tools.launch")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        dist.init_process_group(
            _init_backend(backend), init_method=f"tcp://{coord}",
            world_size=num_workers, rank=rank, timeout=timeout)
    except (RuntimeError, ValueError) as e:
        raise MXNetError(
            f"{who} rank {rank} of {num_workers} could not form its "
            f"{backend} process group at {coord}: {e}") from e
    return backend, per_card, True


def hierarchical_allreduce(session, key: str, flat, group_size: int,
                           round_id: int, part: int, nparts: int,
                           packer=None):
    """Group-tree sum over the elastic wire: a group-local sum on
    ``key@g<gid>`` (``packer`` may 2-bit-compress this widest stage), a
    cross-group sum on ``key@x`` among the leaders (each group's
    contributor count riding as an extra element), and a broadcast back on
    ``key@b<gid>``. ``round_id`` is the caller's per-key counter. Returns
    ``(summed, contributors)``; a stage timeout raises
    :class:`~.elastic.ElasticError` (callers fall back to the flat
    reduce)."""
    flat = np.ascontiguousarray(np.asarray(flat, np.float32).ravel())
    G = max(2, int(group_size))
    gid, lane = part // G, part % G
    ngroups = (nparts + G - 1) // G
    gsize = max(1, min(G, nparts - gid * G))
    payload = packer(flat) if packer is not None else None
    gsum, n1 = session.allreduce_scoped(f"{key}@g{gid}", flat, gsize,
                                        round_id, payload=payload)
    gsum = np.asarray(gsum, np.float32)
    if lane == 0:
        ext = np.concatenate([gsum, np.float32([n1])])
        xsum, _nx = session.allreduce_scoped(f"{key}@x", ext, ngroups,
                                             round_id)
        bcast_in = np.asarray(xsum, np.float32)
    else:
        bcast_in = np.zeros(flat.size + 1, np.float32)
    total, _nb = session.allreduce_scoped(f"{key}@b{gid}", bcast_in,
                                          gsize, round_id)
    total = np.asarray(total, np.float32)
    return total[:-1], max(1, int(round(float(total[-1]))))


class DistKVStore(KVStore):
    """Multi-process kvstore: sync modes over collectives, async over the
    parameter server."""

    def __init__(self, kind="dist_sync"):
        super().__init__(kind)
        self._is_async = "async" in kind
        self._rank, self._num_workers = launcher_rank()
        self._ps = None
        self._elastic = None
        self._gc = None
        self._group = None          # the torch.distributed backend name
        self._owns_group = False
        self._coll_device = None    # NCCL: this rank's card
        self._batch = {}  # local merges awaiting the fused collective
        # bounded-staleness async (MXNET_ASYNC_STALENESS): the step this
        # rank last committed, the fleet clock bounds off every reply, and
        # the staleness-aware lr compensation (worker-side, so the
        # server's WAL replay stays byte-exact)
        env = get_env("MXNET_ASYNC_STALENESS", None)
        self._async_staleness = int(env) if env is not None else None
        self._async_step = 0
        self._clock_floor = 0
        self._clock_max = 0
        self._clock_widen = 0
        self._lr_comp = str(get_env("MXNET_ASYNC_LR_COMP", "1")).lower() \
            not in ("0", "false", "")
        # hierarchical elastic reduction: group size (0/1 = flat) and the
        # per-key round counters its stages are paced by
        self._hier_group = get_env("MXNET_ASYNC_GROUP", 0, int) or 0
        self._hier_rounds = {}
        addr = get_env("MXNET_PS_ADDR", get_env("DMLC_PS_ROOT_URI", None))
        port = int(get_env("MXNET_PS_PORT",
                           get_env("DMLC_PS_ROOT_PORT", 9091, int), int)
                   or 9091)
        if self._is_async:
            if addr:
                from .ps_client import PSClient

                self._ps = PSClient(addr, port)
        elif elastic_mod.elastic_enabled() and addr:
            # joined at creation (the create-first ordering); a restarted
            # worker lands quarantined and Module.fit resolves the rejoin
            self._elastic = elastic_mod.ElasticWorkerSession(
                addr, port, rank=self._rank, expected=self._num_workers)
            self._elastic.ensure_joined()
            # this process is fleet rank r: pin the step accounting and the
            # straggler injector to it (both fall back to DMLC_WORKER_ID)
            from ..chaos import slow as _chaos_slow
            from ..obs import fleetstats as _fleetstats

            _fleetstats.set_rank(self._rank)
            _chaos_slow.set_rank(self._rank)
        else:
            self._init_process_group()

    # -- the process group -------------------------------------------------
    def _init_process_group(self):
        joined = join_process_group(self._rank, self._num_workers,
                                    who="dist_sync")
        if joined is None:
            return  # one process and no launcher: nothing to reduce
        backend, per_card, self._owns_group = joined
        if backend == "nccl":
            self._coll_device = torch.device(
                "cuda", self._rank % torch.cuda.device_count())
        self._group = backend
        share = f"{per_card} ranks a card" if per_card else "no card"
        sys.stderr.write(f"dist_sync: rank {self._rank} of "
                         f"{self._num_workers} over torch.distributed "
                         f"{backend} ({share})\n")

    @property
    def backend(self):
        """The process group's backend ("gloo", "nccl"), or None."""
        return self._group

    def _collective(self) -> bool:
        """Whether sync pushes go through a cross-process sum."""
        return self._group is not None or (self._elastic is not None
                                           and self._num_workers > 1)

    def _coll_tensor(self, t):
        """``t`` on the device the backend's collectives take."""
        if self._coll_device is not None and t.device != self._coll_device:
            return t.to(self._coll_device)
        return t

    def _reduce_tensor(self, t, bcast_from=None, key="__allreduce__"):
        """The cross-process sum of tensor ``t`` (or rank ``bcast_from``'s
        value), on ``t``'s device; ``t`` is not modified."""
        if self._elastic is not None:
            local = t.detach().cpu().numpy()
            if bcast_from is not None and self._rank != bcast_from:
                local = np.zeros_like(local)
            summed, _n = self._elastic.allreduce(key, local)
            return torch.from_numpy(
                np.asarray(summed, local.dtype).reshape(local.shape)).to(
                    t.device)
        if self._group is None:
            return t
        import torch.distributed as dist

        out = self._coll_tensor(t.detach()).clone()
        if bcast_from is not None:
            dist.broadcast(out, src=bcast_from)
        else:
            dist.all_reduce(out)
        return out.to(t.device)

    def _allreduce(self, nd_arr, bcast_from=None):
        """Global sum (or one rank's value) of an NDArray across
        processes."""
        return NDArray(self._reduce_tensor(nd_arr._data,
                                           bcast_from=bcast_from),
                       ctx=nd_arr.context)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._num_workers

    @property
    def elastic(self):
        """The :class:`~.elastic.ElasticWorkerSession` of elastic
        ``dist_sync``, else None; ``Module.fit`` keys its elastic hooks
        off it."""
        return self._elastic

    def step_complete(self, step: int):
        """Commit "this rank FINISHED ``step``" to the PS clock table (the
        worker half of bounded staleness); a no-op outside that mode.
        ``Module.fit`` calls it after every optimizer step."""
        if self._ps is None or self._async_staleness is None:
            return
        self._async_step = int(step)
        floor, maxc, widen = self._ps.push_clock(self._rank, int(step))
        self._clock_floor, self._clock_max = floor, maxc
        self._clock_widen = widen  # the straggler policy's widening
        if obs.enabled():
            obs.set_gauge("kvstore.async.clock_floor", floor)
            obs.set_gauge(f"kvstore.async.rank{self._rank}_lag",
                          max(0, maxc - int(step)))

    def _lr_comp_scale(self) -> float:
        """A gradient ``lag`` steps behind the fleet's fastest committed
        clock is scaled by ``1 / (1 + lag)``."""
        if self._async_staleness is None or not self._lr_comp:
            return 1.0
        lag = max(0, self._clock_max - self._async_step)
        return 1.0 / (1.0 + lag)

    def _fused_flat_reduce(self, arrays, key: str, zero_local: bool):
        """One fused sum of many numpy arrays: flatten-concat, reduce over
        the fleet, split back. ``zero_local`` contributes zeros (the
        broadcast idiom). Returns ``(summed_arrays, contributors)``."""
        shapes = [a.shape for a in arrays]
        sizes = [int(np.prod(s)) if len(s) else 1 for s in shapes]
        flat = np.concatenate(
            [np.asarray(a, np.float32).ravel() for a in arrays]) \
            if arrays else np.zeros(0, np.float32)
        if zero_local:
            flat = np.zeros_like(flat)
        if self._elastic is not None:
            summed, n = self._elastic_reduce(key, flat)
        else:
            summed = self._reduce_tensor(torch.from_numpy(flat)).numpy()
            n = self._num_workers
        summed = np.asarray(summed, np.float32)
        out, off = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(summed[off:off + size].reshape(shape))
            off += size
        return out, n

    def _elastic_reduce(self, key: str, flat):
        """One elastic sum: the group tree (``MXNET_ASYNC_GROUP`` > 1 and a
        fleet larger than one group) or the flat generation-scoped reduce,
        which a tree-stage timeout falls back to."""
        joined = getattr(self._elastic, "_joined", None)
        if (self._hier_group > 1 and joined is not None
                and joined.num_parts > self._hier_group):
            rid = self._hier_rounds.get(key, 0)
            self._hier_rounds[key] = rid + 1
            try:
                return hierarchical_allreduce(
                    self._elastic, key, flat, self._hier_group, rid,
                    joined.part_index, joined.num_parts)
            except elastic_mod.StaleMemberError:
                raise
            except elastic_mod.ElasticError:
                obs.inc("kvstore.hier.fallbacks")
                obs.event("kvstore.hier.fallback", key=key, round=rid)
        return self._elastic.allreduce(key, flat)

    def allreduce_mean(self, arrays):
        """Mean over the LIVE fleet of a list of numpy arrays, in one fused
        reduction: ``(means, contributors)``; the divisor is the count
        that contributed."""
        summed, n = self._fused_flat_reduce(arrays, "__grads__",
                                            zero_local=False)
        return [s / max(1, n) for s in summed], n

    def broadcast_arrays(self, arrays, root: bool):
        """One fused broadcast over the live fleet: the root's values win
        (the others contribute zeros)."""
        out, _n = self._fused_flat_reduce(arrays, "__bcast__",
                                          zero_local=not root)
        return out

    def close(self):
        """Leave the fleet (elastic: the generation bumps now, not after K
        missed heartbeats) or tear down the process group this store
        formed."""
        if self._elastic is not None:
            self._elastic.close()
            self._elastic = None
        if self._ps is not None:
            self._ps.close()
        if self._owns_group:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self._owns_group = False
            self._group = None

    # -- the store API -----------------------------------------------------
    def init(self, key, value):
        if self._ps is not None:
            for k, v in zip(_as_list(key), _as_list(value)):
                self._ps.init(str(k), v.asnumpy())
            return
        if self._collective():
            # rank 0's init value wins everywhere
            for k, v in zip(_as_list(key), _as_list(value)):
                super().init(str(k), self._allreduce(v, bcast_from=0))
            return
        super().init(key, value)

    def set_gradient_compression(self, compression_params):
        from .compression import (GradientCompression,
                                  validate_compression_params)

        params = validate_compression_params(compression_params)
        self._gc = (GradientCompression(params["threshold"])
                    if params else None)
        self._compression = params

    def push(self, key, value, priority=0):
        if self._ps is not None:
            self._push_async(key, value)
            return
        if self._collective():
            # pushes buffer here; one fused collective moves every pending
            # key at the next pull or barrier (pull before exiting)
            for k, v in zip(_as_list(key), _as_list(value)):
                vs = _as_list(v)
                merged = vs[0]
                for e in vs[1:]:
                    merged = merged + e
                k = str(k)
                self._batch[k] = (self._batch[k] + merged
                                  if k in self._batch else merged)
            if self._updater is not None:
                # an optimizer on the store: each push is its own step
                self._flush_batch()
            return
        super().push(key, value, priority)

    def _push_async(self, key, value):
        from ..ndarray.sparse import RowSparseNDArray

        for k, v in zip(_as_list(key), _as_list(value)):
            vs = _as_list(v)
            if all(isinstance(e, RowSparseNDArray) for e in vs):
                # the sparse wire: concatenated (indices, rows); the
                # server scatter-merges them
                idx = np.concatenate(
                    [e.indices.asnumpy().astype(np.int32) for e in vs])
                rows = np.concatenate([e.data.asnumpy() for e in vs])
                self._ps.push_row_sparse(str(k), idx, rows)
                continue
            merged = vs[0]
            for e in vs[1:]:
                merged = merged + e
            arr = merged.asnumpy()
            scale = self._lr_comp_scale()
            if scale != 1.0:
                arr = arr * scale
                obs.inc("kvstore.async.lr_comp_applied")
            self._ps.push(str(k), arr, compressor=self._gc)

    def _flush_batch(self):
        """The fused collective of every pending key: one flat f32 vector
        (uint8-packed under 2-bit compression) crosses one collective and
        splits back, on the values' device."""
        if not self._batch:
            return
        items = list(self._batch.items())
        self._batch = {}
        shapes = [tuple(v.shape) for _, v in items]
        sizes = [int(np.prod(s)) if len(s) else 1 for s in shapes]
        gc = self._gc
        if gc is None:
            flat = torch.cat([v._data.detach().reshape(-1).float()
                              for _, v in items])
            summed = self._reduce_tensor(flat)
        else:
            packs = [gc.compress(k, v._data.detach().float())
                     for k, v in items]
            full = self._allgather_sum_packed(torch.cat(packs), gc.threshold)
            segs, off = [], 0
            for pack, size in zip(packs, sizes):
                segs.append(full[off * 4:off * 4 + size])
                off += pack.numel()
            summed = torch.cat(segs)
        off = 0
        for (k, v), shape, size in zip(items, shapes, sizes):
            part = summed[off:off + size].reshape(shape).to(v._data.dtype)
            off += size
            super().push(k, NDArray(part, ctx=v.context))

    def _allgather_sum_packed(self, packed, threshold: float):
        """The sum of every worker's decoded 2-bit codes (``packed``: this
        worker's uint8 tensor; the gather moves 1 byte per 4 values).
        Returns a flat f32 tensor on ``packed``'s device."""
        from .compression import dequantize_2bit_torch

        n = packed.numel() * 4
        if self._elastic is not None:
            # the quantization and error feedback already happened in
            # compress(): the decoded floats sum through the elastic reduce
            decoded = dequantize_2bit_torch(packed, threshold, n)
            return self._reduce_tensor(decoded, key="__packed__")
        if self._group is None:
            return dequantize_2bit_torch(packed, threshold, n)
        import torch.distributed as dist

        # gloo's all_gather takes host tensors only
        src = packed.cpu() if self._group == "gloo" \
            else self._coll_tensor(packed)
        rows = [torch.empty_like(src) for _ in range(self._num_workers)]
        dist.all_gather(rows, src)
        decoded = [dequantize_2bit_torch(r.to(packed.device), threshold, n)
                   for r in rows]
        return torch.stack(decoded).sum(0)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        if self._ps is not None:
            for k, o, r in zip(_as_list(key), _as_list(out),
                               _as_list(row_ids)):
                idx = (r.asnumpy() if hasattr(r, "asnumpy")
                       else np.asarray(r)).astype(np.int32)
                rows = torch.from_numpy(self._ps.pull_row_sparse(str(k),
                                                                 idx))
                for oo in _as_list(o):
                    _copy_into(oo, rows)
            return
        self._flush_batch()
        super().row_sparse_pull(key, out=out, priority=priority,
                                row_ids=row_ids)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if self._ps is not None:
            for k, o in zip(_as_list(key), _as_list(out)):
                if self._async_staleness is not None:
                    # gated: blocks server-side while this rank would run
                    # more than s steps ahead of the fleet's clock floor
                    arr, floor, maxc = self._ps.pull_stale(
                        str(k), self._rank, self._async_step,
                        self._async_staleness)
                    self._clock_floor, self._clock_max = floor, maxc
                else:
                    arr = self._ps.pull(str(k))
                t = torch.from_numpy(np.ascontiguousarray(arr))
                for oo in _as_list(o):
                    _copy_into(oo, t)
            return
        self._flush_batch()
        super().pull(key, out=out, priority=priority)

    def set_optimizer(self, optimizer):
        if self._ps is not None:
            self._ps.set_optimizer(optimizer)
            return
        super().set_optimizer(optimizer)

    def barrier(self):
        if self._ps is not None:
            self._ps.barrier()
            return
        self._flush_batch()
        if self._elastic is not None:
            # the server counts LIVE members: a dead rank releases it
            self._elastic.barrier()
            return
        if self._group is not None:
            import torch.distributed as dist

            dist.barrier()
