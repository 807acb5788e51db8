"""Devices: ``Context``, ``gpu(i)``, ``cpu()``, ``current_context()``,
``default_device()``.

Counterpart of ``mxnet_tpu/context.py``. A :class:`Context` names a device
(``device_type`` ``gpu`` or ``cpu``, ``device_id``) and scopes the default
one: ``with mx.cpu(): ...`` makes arrays created inside it land on the
CPU. The reference's default falls back to the CPU when no accelerator
exists; the port's does not: with no scope the default is ``gpu(0)``, the
CUDA device ``cuda:0``, and with no CUDA device :func:`current_context`
raises, so that a run meant for the card never quietly carries on on the
CPU. The CPU is used only when the caller names it.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "default_device", "as_device"]


class Context:
    """A device; usable as a context manager that sets the default one."""

    devtype2num = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}
    devnum2type = {v: k for k, v in devtype2num.items()}

    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        elif isinstance(device_type, torch.device):
            device_id = device_type.index or 0
            device_type = "gpu" if device_type.type == "cuda" else \
                device_type.type
        if device_type not in self.devtype2num:
            raise ValueError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self) -> int:
        return self.devtype2num[self.device_type]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    @property
    def pinned(self) -> bool:
        """Whether arrays on this context are pinned host tensors
        (``cpu_pinned``; plain host memory on a machine with no card,
        where nothing can be pinned)."""
        return self.device_type == "cpu_pinned" and torch.cuda.is_available()

    def torch_device(self) -> torch.device:
        """The ``torch.device``; a ``gpu`` context needs the CUDA device."""
        if self.device_type == "gpu":
            return as_device(torch.device("cuda", self.device_id))
        return torch.device("cpu")

    def __enter__(self):
        stack = getattr(Context._default, "stack", None)
        if stack is None:
            stack = Context._default.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        Context._default.stack.pop()


def cpu(device_id: int = 0) -> Context:
    """The host CPU (reference ``mx.cpu()``)."""
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """CUDA device ``device_id`` (reference ``mx.gpu(i)``)."""
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Pinned host memory (reference ``mx.cpu_pinned()``): arrays made on
    it are page-locked host tensors, which copy to the card
    asynchronously."""
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The number of CUDA cards (reference ``mx.context.num_gpus()``; 0
    on a machine with none)."""
    return torch.cuda.device_count()


def default_device() -> torch.device:
    """``cuda:0``. Raises :class:`MXNetError` when no CUDA device exists."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device: mxnet_tpu_torch runs on the GPU by default; "
            "pass device='cpu' (or ctx=mx.cpu()) to run on the CPU "
            "explicitly")
    return torch.device("cuda", 0)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope, else ``gpu(0)``; raises with no
    scope and no CUDA device."""
    stack = getattr(Context._default, "stack", None)
    if stack:
        return stack[-1]
    return Context(default_device())


def as_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument (None, a
    :class:`Context`, a ``torch.device`` or its string): None is
    :func:`default_device`; a CUDA device must exist."""
    if device is None:
        return default_device()
    if isinstance(device, Context):
        return device.torch_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError(f"device {dev} requested but CUDA is not "
                             "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
