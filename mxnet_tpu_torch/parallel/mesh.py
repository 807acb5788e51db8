"""Device meshes over the ranks of a job (counterpart of
``mxnet_tpu/parallel/mesh.py``).

The reference is one process that sees every device. The port runs one
process per mesh device, as multi-controller JAX does: a mesh's devices
are the ranks of the ``torch.distributed`` group that the launcher's
environment describes (``tools/launch.py``; ``kvstore.dist.
join_process_group`` forms it, NCCL when every rank has a card of its
own, gloo when ranks share one or run on the CPU). Outside a job the world
is the one local device.

A :class:`Mesh` is an array of ranks with named axes, laid out in the
reference's axis order (``pp``, ``dp``, ``sp``, ``tp``, ``ep``; ``tp``
innermost), beside the ``torch.device`` of each rank. Its
``torch.distributed`` ``DeviceMesh``, over which parameters and batches
become ``DTensor``s (the counterpart of GSPMD's shardings), is made at
first use, the job's group with it: every rank of the world takes part
in forming them; building a mesh or counting devices forms nothing. So
a rank array can be pruned against and sliced (:func:`mesh_slices`)
without processes. ``mesh_scope`` lets model code find the active mesh, as the
reference's attention layers do.
"""
from __future__ import annotations

import contextlib
import threading
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context

__all__ = ["Mesh", "make_mesh", "mesh_axes", "local_device_count",
           "mesh_scope", "current_mesh", "mesh_slices", "world"]

AXIS_ORDER = ("pp", "dp", "sp", "tp", "ep")


def _job():
    """``(rank, world size)`` of this process, forming nothing: those of
    the ``torch.distributed`` group if one is formed, else the launcher's
    environment's; ``(0, 1)`` outside a job."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    from ..kvstore.dist import launcher_rank

    rank, n = launcher_rank()
    return (rank, n) if n > 1 else (0, 1)


def world():
    """``(rank, world size)`` of this process, as :func:`_job`, with the
    job's ``torch.distributed`` group formed here from the launcher's
    environment if it has several workers and none is formed yet."""
    import torch.distributed as dist

    rank, n = _job()
    if n > 1 and not dist.is_initialized():
        from ..kvstore.dist import join_process_group

        join_process_group(rank, n, who="make_mesh")
    return rank, n


def _rank_device(rank: int) -> torch.device:
    """The device rank ``rank`` computes on: the current context's kind,
    a card shared round-robin (``rank % cards``) or the CPU inside
    ``with mx.cpu():``."""
    if current_context().device_type == "gpu":
        if not torch.cuda.is_available():
            raise MXNetError("make_mesh: a card was asked for but CUDA is "
                             "not available (use `with mx.cpu():`)")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


class Mesh:
    """Ranks laid out on named axes (the reference's
    ``jax.sharding.Mesh``): ``devices`` is an object array of each rank's
    ``torch.device`` and ``ranks`` the matching integer array; their shape
    is the axes' sizes."""

    def __init__(self, devices, axis_names, ranks=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")
        self.ranks = (np.arange(self.devices.size).reshape(
            self.devices.shape) if ranks is None
            else np.asarray(ranks, dtype=np.int64).reshape(
                self.devices.shape))
        self._device_mesh = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans several ranks (its arrays are
        ``DTensor``s over :attr:`device_mesh`)."""
        return self.size > 1

    @property
    def local_device(self) -> torch.device:
        """The device of this process's rank in the mesh."""
        if not self.distributed:
            return self.devices.flat[0]
        rank, _ = _job()
        hit = np.flatnonzero(self.ranks.ravel() == rank)
        if not hit.size:
            raise MXNetError(f"rank {rank} is not in {self!r}")
        return self.devices.flat[int(hit[0])]

    @property
    def device_mesh(self):
        """The ``torch.distributed.DeviceMesh`` over :attr:`ranks`,
        dimensions named by :attr:`axis_names`; formed at first use by
        every rank of the world."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            _rank, n = world()
            if int(self.ranks.max()) >= n:
                raise MXNetError(
                    f"{self!r} spans {self.size} ranks; this job has {n} "
                    "(launch it with python -m mxnet_tpu_torch.tools."
                    f"launch -n {self.size})")
            self._device_mesh = DeviceMesh(
                self.devices.flat[0].type, torch.as_tensor(self.ranks),
                mesh_dim_names=self.axis_names)
        return self._device_mesh

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return (f"Mesh({self.shape}, ranks={self.ranks.ravel().tolist()}, "
                f"devices={sorted({str(d) for d in self.devices.flat})})")


def local_device_count() -> int:
    """The devices a mesh can span: the job's ranks (1 outside a job).
    A query: it forms no group."""
    return _job()[1]


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """Build a Mesh from an axis-size dict, e.g. ``{"dp": 2, "tp": 4}``.

    ``devices`` lists the members: ranks (ints) or one ``torch.device``
    per rank (rank ``i`` is the ``i``-th); the default is every rank of
    the job, each on its device (:func:`_job`, :func:`_rank_device`).
    A single ``-1`` axis absorbs the remaining ranks; a mesh smaller than
    the members takes the first ones and warns; a larger one raises
    ``ValueError``. Axes are laid out in AXIS_ORDER, ``tp`` innermost."""
    if devices is None:
        _rank, n_world = _job()
        devices = list(range(n_world))
    devices = list(devices)
    n = len(devices)
    axes = dict(axes or {"dp": n})
    known, wild = 1, None
    for k, v in axes.items():
        if v == -1:
            if wild is not None:
                raise ValueError("only one axis may be -1")
            wild = k
        else:
            known *= v
    if wild is not None:
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        axes[wild] = n // known
        known *= axes[wild]
    if known > n:
        raise ValueError(f"mesh axes {axes} need {known} devices, have {n}")
    if known < n:
        warnings.warn(
            f"make_mesh: axes {axes} cover {known} of {n} available devices; "
            f"using the first {known} (pass an axis of -1 to absorb the "
            "rest)", stacklevel=2)
    members = devices[:known]
    ranks = [m if isinstance(m, (int, np.integer)) else i
             for i, m in enumerate(members)]
    devs = np.empty(known, dtype=object)
    devs[:] = [_rank_device(int(m)) if isinstance(m, (int, np.integer))
               else torch.device(m) for m in members]
    names = [a for a in AXIS_ORDER if a in axes] + \
            [a for a in axes if a not in AXIS_ORDER]
    shape = tuple(axes[a] for a in names)
    return Mesh(devs.reshape(shape), names, np.asarray(ranks).reshape(shape))


def mesh_axes(mesh: Mesh) -> Dict[str, int]:
    return mesh.shape


def mesh_slices(mesh: Mesh, axis: str = "dp") -> List[Mesh]:
    """Split ``mesh`` along ``axis`` into submeshes, one per index along
    it, each keeping every remaining axis (the serving plane's replica
    groups). A mesh without ``axis`` is one slice (itself); a pure-``axis``
    mesh yields 1-rank slices with a trivial ``("tp",)`` axis, so rule
    tables prune against them unchanged."""
    if axis not in mesh.axis_names:
        return [mesh]
    i = mesh.axis_names.index(axis)
    names = tuple(a for a in mesh.axis_names if a != axis)
    out = []
    for k in range(mesh.devices.shape[i]):
        devs = np.take(mesh.devices, k, axis=i)
        ranks = np.take(mesh.ranks, k, axis=i)
        if not names:
            out.append(Mesh(np.asarray([devs], dtype=object).reshape(1),
                            ("tp",), np.asarray(ranks).reshape(1)))
        else:
            out.append(Mesh(devs, names, ranks))
    return out


class _MeshState(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None


_STATE = _MeshState()


def current_mesh() -> Optional[Mesh]:
    return _STATE.mesh


@contextlib.contextmanager
def mesh_scope(mesh: Mesh):
    prev, _STATE.mesh = _STATE.mesh, mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev
