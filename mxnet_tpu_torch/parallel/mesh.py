"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``): the
one-device subset.

A :class:`Mesh` is an array of ``torch.device``s with named axes, laid out
in the reference's axis order (``pp``, ``dp``, ``sp``, ``tp``, ``ep``).
The port trains on one card: a mesh of more than one device raises, since
data and tensor parallelism over several cards is queue item A14, and so
does every rule of a sharding table collapse to "replicated", as it does
in the reference on a mesh without ``tp``. ``mesh_scope`` lets model code
find the active mesh, as the reference's attention layers do.
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
           "mesh_scope", "current_mesh"]

AXIS_ORDER = ("pp", "dp", "sp", "tp", "ep")


class Mesh:
    """Devices laid out on named axes (the reference's
    ``jax.sharding.Mesh``): ``devices`` is an object array whose shape is
    the axes' sizes."""

    def __init__(self, devices, axis_names):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.ravel().tolist()})"


def _local_devices() -> List[torch.device]:
    """The devices of the current context's kind: every CUDA card, or the
    CPU inside ``with mx.cpu():``."""
    ctx = current_context()
    if ctx.device_type == "gpu":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def local_device_count() -> int:
    return len(_local_devices())


def make_mesh(axes: Optional[Dict[str, int]] = None, devices=None) -> Mesh:
    """Build a Mesh from an axis-size dict, e.g. ``{"dp": 1}``. A single
    ``-1`` axis absorbs the remaining devices; a mesh smaller than the
    devices given takes the first ones. More than one device raises
    ``MXNetError`` (queue item A14)."""
    devices = list(devices if devices is not None else _local_devices())
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
    if known > 1:
        raise MXNetError(
            f"make_mesh: axes {axes} span {known} devices; meshes of more "
            "than one device (data and tensor parallelism over several "
            "cards, queue item A14) are not ported yet")
    if known > n:
        raise ValueError(f"mesh axes {axes} need {known} devices, have {n}")
    if known < n:
        warnings.warn(
            f"make_mesh: axes {axes} cover {known} of {n} available devices; "
            f"using the first {known} (pass an axis of -1 to absorb the "
            "rest)", stacklevel=2)
    names = [a for a in AXIS_ORDER if a in axes] + \
            [a for a in axes if a not in AXIS_ORDER]
    arr = np.empty(known, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:known]]
    return Mesh(arr.reshape(tuple(axes[a] for a in names)), names)


def mesh_axes(mesh: Mesh) -> Dict[str, int]:
    return mesh.shape


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
