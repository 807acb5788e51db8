"""The ``torch.distributed`` process group of every gloo job: gloo, with
its work finished inside each call and point-to-point staged through
host memory.

NCCL refuses two ranks on one card, so such ranks form a gloo group, as
ranks on the CPU do. On CUDA tensors gloo's collectives are right when
waited on where they are called (``dist.all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``), but the functional collectives that ``DTensor``
redistributes with crash in ``wait_tensor`` on gloo's CUDA work (a
segmentation fault), and gloo's point-to-point transport aborts the
process on a CUDA tensor (``gloo::IoException``, writev "Bad address";
NVIDIA H100, torch 2.11). So ``kvstore.dist.join_process_group`` forms
every gloo group with the ``gloo_host`` backend, :class:`HostStagedGloo`,
on the CPU too, so that the CPU's jobs take the card's route: a Python
process group (the only kind PyTorch lets Python implement, so it serves
every device) over a gloo group of its own. Each collective runs gloo's
and waits for it before returning completed work; a send or receive
moves a host copy and returns at once, its work copying a received block
back when waited on. The collectives run one at a time, in the order
every rank calls them, as gloo's do. Both the old and the new names of
the overridable collectives are defined, for the PyTorch versions on
either side.
"""
from __future__ import annotations

import torch.distributed as dist

__all__ = ["BACKEND", "HostStagedGloo", "register"]

BACKEND = "gloo_host"


def _done(result):
    from torch._C._distributed_c10d import _create_work_from_future
    from torch.futures import Future

    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(t):
    return t.detach().to("cpu", copy=True)


class HostStagedGloo(dist.ProcessGroup):
    """A gloo group (on a prefix of the group's store) whose work is done
    when a collective returns, and whose point-to-point goes through host
    copies."""

    def __init__(self, store, rank, size, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(
            dist.PrefixStore(BACKEND, store), rank, size, timeout)
        self._name = self._desc = ""

    def getBackendName(self):
        return BACKEND

    def setGroupName(self, name):
        self._name = name

    def getGroupName(self):
        return self._name

    def setGroupDesc(self, desc):
        self._desc = desc

    def getGroupDesc(self):
        return self._desc

    # -- collectives: gloo's, waited on here --------------------------------
    def allreduce(self, tensors, opts=None):
        self._gloo.allreduce(tensors, opts or dist.AllreduceOptions()).wait()
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        for t in tensors:
            self.allreduce([t], _reduce_opts(opts))
        return _done(tensors)

    def broadcast(self, tensors, opts=None):
        self._gloo.broadcast(tensors, opts or dist.BroadcastOptions()).wait()
        return _done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier().wait()
        return _done([])

    def allgather(self, outputs, inputs, opts=None):
        self._gloo.allgather(outputs, inputs).wait()
        return _done(outputs)

    def _allgather_base(self, output, input, opts=None):
        self._gloo._allgather_base(output, input).wait()
        return _done([output])

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def reduce_scatter(self, outputs, inputs, opts=None):
        self._gloo.reduce_scatter(outputs, inputs, _scatter_opts(opts)).wait()
        return _done(outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        self._gloo._reduce_scatter_base(output, input,
                                        _scatter_opts(opts)).wait()
        return _done([output])

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=None):
        self._gloo.alltoall_base(output, input, list(output_split_sizes),
                                 list(input_split_sizes)).wait()
        return _done([output])

    all_to_all_single = alltoall_base

    def alltoall(self, outputs, inputs, opts=None):
        self._gloo.alltoall(outputs, inputs).wait()
        return _done(outputs)

    # -- point-to-point: host copies ----------------------------------------
    def send(self, tensors, dst, tag=0):
        return _Staged(self._gloo.send([_host(t) for t in tensors], dst,
                                       tag))

    def recv(self, tensors, src, tag=0):
        hs = [_host(t) for t in tensors]
        return _Staged(self._gloo.recv(hs, src, tag), zip(tensors, hs))


class _Staged(dist.Work):
    """The work of a staged send or receive: waits for gloo's, then
    copies each received host block into its destination."""

    def __init__(self, work, pairs=()):
        super().__init__()
        self._work, self._pairs = work, list(pairs)

    def wait(self, timeout=None):
        self._work.wait()
        for dst, host in self._pairs:
            dst.copy_(host)
        self._pairs = []
        return True

    def is_completed(self):
        return self._work.is_completed() and not self._pairs


def _reduce_opts(opts):
    out = dist.AllreduceOptions()
    if opts is not None:
        out.reduceOp = opts.reduceOp
    return out


def _scatter_opts(opts):
    out = dist.ReduceScatterOptions()
    if opts is not None:
        out.reduceOp = opts.reduceOp
    return out


def _create(store, rank, size, timeout):
    return HostStagedGloo(store, rank, size, timeout)


_registered = False


def register():
    """Register the ``gloo_host`` backend with ``torch.distributed`` (once
    a process)."""
    global _registered
    if not _registered:
        dist.Backend.register_backend(BACKEND, _create,
                                      devices=["cpu", "cuda"])
        _registered = True
