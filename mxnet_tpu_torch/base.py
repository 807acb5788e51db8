"""Framework error type, the ``MXNET_*`` env-var config reader and dtype
names (counterparts of ``mxnet_tpu/base.py`` ``MXNetError``, ``get_env``,
``dtype_np`` and ``dtype_name``)."""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

__all__ = ["MXNetError", "GraphAnalysisError", "get_env", "mx_real_t",
           "dtype_np", "dtype_name", "dtype_torch"]

mx_real_t = np.float32  # the default real type, as the reference's

_BY_NAME = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with reference ``MXNetError``)."""


class GraphAnalysisError(MXNetError, ValueError):
    """Shape or type inference failure naming where the graph broke:
    ``node``, ``op``, ``rule_id`` and the node's ``input_shapes``. A
    ValueError as well, as the reference's."""

    def __init__(self, message, node=None, op=None, rule_id=None,
                 input_shapes=None):
        super().__init__(message)
        self.node = node
        self.op = op
        self.rule_id = rule_id
        self.input_shapes = input_shapes


def get_env(name: str, default=None, typ=str):
    """Read an ``MXNET_*`` config env var with type coercion. Reads accept
    both the ``MXNET_`` prefix and no prefix."""
    raw = os.environ.get(name)
    if raw is None and not name.startswith("MXNET_"):
        raw = os.environ.get("MXNET_" + name)
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() not in ("0", "false", "off", "")
    return typ(raw)


def dtype_name(dtype: Any) -> str:
    """Canonical string name of a dtype given as a string, a numpy dtype or
    type, or a ``torch.dtype``; None is the default real type."""
    if dtype is None:
        return np.dtype(mx_real_t).name
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAME_OF:
            raise TypeError(f"unsupported dtype {dtype}")
        return _NAME_OF[dtype]
    if isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _BY_NAME:
        raise TypeError(f"unknown dtype {dtype!r}")
    return name


def dtype_torch(dtype: Any) -> torch.dtype:
    """The ``torch.dtype`` of a user-facing dtype (see :func:`dtype_name`)."""
    return _BY_NAME[dtype_name(dtype)]


def dtype_np(dtype: Any):
    """The numpy dtype of a user-facing dtype (reference ``dtype_np``).
    numpy has no bfloat16: that one is returned as ``torch.bfloat16``."""
    name = dtype_name(dtype)
    return torch.bfloat16 if name == "bfloat16" else np.dtype(name)
