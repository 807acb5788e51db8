"""``mx.monitor.Monitor``: tap intermediate outputs during training
(counterpart of ``mxnet_tpu/monitor.py``).

``install_gluon`` puts a forward hook on every block of a Gluon net. A
hybridized block's ``CachedOp`` runs the eager forward on every call, so
the hooks fire on hybridized calls too, with real tensors. While a batch
is active (``tic``), each hook queues ``stat_func`` of each output,
computed on the output's device with autograd paused. ``toc`` moves every
queued stat to the host in one transfer per device (one ``torch.cat`` of
the flattened stats and one ``.cpu()``), the reference's single batched
fetch, never one sync per block.

``install(exe)`` sets ``exe._monitor`` and nothing reads it, as in the
reference: ``toc(exe)`` reads an Executor's outputs when it is passed one.
The reference also writes each scalar stat to a ``health.monitor.<tag>``
gauge of its observability registry; that registry is the health plane,
queue item A15, and is not ported yet.
"""
from __future__ import annotations

import logging
import re

import numpy as np
import torch

from . import autograd
from .base import dtype_np
from .ndarray import NDArray

__all__ = ["Monitor"]


def _default_stat(x):
    """abs().mean() over NDArray ops (on the output's device)."""
    if isinstance(x, NDArray):
        return x.abs().mean()
    return np.abs(np.asarray(x)).mean()


def _fetch(tensors):
    """Host numpy copies of ``tensors``: one ``torch.cat`` of the flattened
    tensors and one ``.cpu()`` per device. Each comes back in its own
    dtype (bfloat16 as float32, as ``asnumpy`` gives it)."""
    out = [None] * len(tensors)
    by_device = {}
    for i, t in enumerate(tensors):
        by_device.setdefault(t.device, []).append(i)
    for idx in by_device.values():
        ts = [tensors[i].detach() for i in idx]
        common = ts[0].dtype
        for t in ts[1:]:
            common = torch.promote_types(common, t.dtype)
        if common == torch.bfloat16:
            common = torch.float32
        flat = torch.cat([t.reshape(-1).to(common) for t in ts]).cpu().numpy()
        off = 0
        for i, t in zip(idx, ts):
            n = t.numel()
            want = np.float32 if t.dtype == torch.bfloat16 \
                else dtype_np(t.dtype)
            out[i] = flat[off:off + n].reshape(tuple(t.shape)).astype(
                want, copy=False)
            off += n
    return out


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.pattern = re.compile(pattern)
        self.sort = sort
        self.step = 0
        self.activated = False
        self.queue = []
        self._gluon_handles = []

    # -- symbolic path ---------------------------------------------------
    def install(self, exe):
        """Attach to an Executor (the reference's contract: the attribute
        is set and never read; pass the executor to ``toc``)."""
        exe._monitor = self
        return exe

    def install_gluon(self, block):
        """Attach forward hooks to the block and every child."""

        def hook(blk, inputs, output):
            if not self.activated or not self.pattern.match(blk.name):
                return
            outs = output if isinstance(output, (list, tuple)) else [output]
            with autograd.pause():
                for i, o in enumerate(outs):
                    if isinstance(o, NDArray):
                        self.queue.append((self.step, f"{blk.name}_output{i}",
                                           self.stat_func(o)))

        def walk(b):
            b.register_forward_hook(hook)
            self._gluon_handles.append((b, hook))
            for c in b._children.values():
                walk(c)

        walk(block)
        return block

    def uninstall_gluon(self):
        """Remove the installed hooks."""
        for b, h in self._gluon_handles:
            try:
                b._forward_hooks.remove(h)
            except ValueError:
                pass
        self._gluon_handles = []

    def tic(self):
        if self.step % self.interval == 0:
            self.activated = True
            self.queue = []
        self.step += 1

    def toc(self, exe=None):
        """The queued (step, tag, stat) triples, stats as numpy arrays."""
        if not self.activated:
            return []
        if exe is not None:
            for name, out in zip(exe._symbol.list_outputs(), exe.outputs):
                if self.pattern.match(name):
                    with autograd.pause():
                        self.queue.append((self.step, name,
                                           self.stat_func(out)))
        self.activated = False
        res = list(self.queue)
        self.queue = []
        device_idx = [i for i, (_, _, v) in enumerate(res)
                      if isinstance(v, NDArray)]
        if device_idx:
            fetched = _fetch([res[i][2].astorch() for i in device_idx])
            for i, val in zip(device_idx, fetched):
                step, tag, _ = res[i]
                res[i] = (step, tag, val)
        if self.sort:
            res.sort(key=lambda t: t[1])
        return res

    def toc_print(self, exe=None):
        for step, name, value in self.toc(exe):
            logging.info("Batch: %7d %30s %s", step, name, value)
