"""Misc utilities (counterpart of ``mxnet_tpu/util.py``).

Two documented differences: :func:`get_gpu_count` counts the CUDA devices
(the reference's TPU build returns 0), and :func:`get_gpu_memory` returns
a card's ``(free, total)`` bytes (the reference's raises).
"""
from __future__ import annotations

import os

import torch

__all__ = ["use_np", "use_np_shape", "use_np_array", "is_np_array",
           "set_module", "makedirs", "get_gpu_count", "get_gpu_memory",
           "default_array"]


_np_array = False


def is_np_array():
    """False, as the reference's: its numpy-mode state is ``npx``'s."""
    return _np_array


def use_np_shape(fn):
    return fn


def use_np_array(fn):
    return fn


def use_np(fn):
    return fn


def set_module(module):
    def deco(fn):
        fn.__module__ = module
        return fn

    return deco


def makedirs(d):
    os.makedirs(d, exist_ok=True)


def get_gpu_count() -> int:
    """The number of CUDA devices."""
    return torch.cuda.device_count()


def get_gpu_memory(dev_id: int = 0):
    """``(free, total)`` bytes of CUDA device ``dev_id``."""
    free, total = torch.cuda.mem_get_info(dev_id)
    return int(free), int(total)


def default_array(source, ctx=None, dtype=None):
    from .ndarray import array

    return array(source, ctx=ctx, dtype=dtype)
