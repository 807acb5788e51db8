"""Framework error type, the ``MXNET_*`` env-var config reader, dtype
names and the wire's dtype codes, and the retry and keepalive policies of
the socket planes (counterparts of ``mxnet_tpu/base.py`` ``MXNetError``,
``get_env``, ``dtype_np``, ``dtype_name``, ``DTYPE_TO_CODE``,
``capped_backoff`` and ``configure_socket_keepalive``)."""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

__all__ = ["MXNetError", "GraphAnalysisError", "get_env", "set_env",
           "mx_real_t", "string_types", "numeric_types", "integer_types",
           "dtype_np", "dtype_name", "dtype_torch", "capped_backoff",
           "configure_socket_keepalive", "DTYPE_TO_CODE", "CODE_TO_DTYPE"]

mx_real_t = np.float32  # the default real type, as the reference's

string_types = (str,)
numeric_types = (float, int, np.generic)
integer_types = (int, np.integer)

_BY_NAME = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAME_OF = {v: k for k, v in _BY_NAME.items()}

# mshadow type flags (the reference's table): the wire's and the .params
# container's dtype codes; 12 is bfloat16
DTYPE_TO_CODE = {
    "float32": 0, "float64": 1, "float16": 2, "uint8": 3, "int32": 4,
    "int8": 5, "int64": 6, "bool": 7, "int16": 8, "uint16": 9,
    "uint32": 10, "uint64": 11, "bfloat16": 12,
}
CODE_TO_DTYPE = {v: k for k, v in DTYPE_TO_CODE.items()}


def capped_backoff(attempt: int, base_interval: float,
                   max_interval: float) -> float:
    """Capped exponential backoff with jitter: attempt 0 is about
    ``base_interval``, doubling up to ``max_interval``, scaled by a
    uniform draw in [0.5, 1.0] so that clients retrying one restarted
    peer spread out."""
    import random

    delay = min(float(max_interval), float(base_interval) * (2.0 ** attempt))
    return delay * (0.5 + random.random() / 2.0)


def configure_socket_keepalive(sock, idle: int = 30, interval: int = 5,
                               count: int = 3) -> None:
    """TCP keepalive on ``sock``: a peer that vanished without a FIN is
    noticed after ``idle + interval * count`` seconds. Options the
    platform lacks keep their defaults, and an ``OSError`` is ignored:
    keepalive is an optimization, the RPCs carry their own timeouts."""
    import socket as _socket

    try:
        sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_KEEPALIVE, 1)
        for opt, val in (("TCP_KEEPIDLE", idle), ("TCP_KEEPINTVL", interval),
                         ("TCP_KEEPCNT", count)):
            if hasattr(_socket, opt):
                sock.setsockopt(_socket.IPPROTO_TCP,
                                getattr(_socket, opt), val)
    except OSError:
        pass


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with reference ``MXNetError``)."""


class GraphAnalysisError(MXNetError, ValueError):
    """Shape or type inference failure, or a lint report's errors
    (``Report.raise_if_errors``, ``bind(lint="error")``), naming where the
    graph broke: ``node``, ``op``, ``rule_id``, the node's
    ``input_shapes`` and the error ``findings``. A ValueError as well, as
    the reference's."""

    def __init__(self, message, node=None, op=None, rule_id=None,
                 input_shapes=None, findings=None):
        super().__init__(message)
        self.node = node
        self.op = op
        self.rule_id = rule_id
        self.input_shapes = input_shapes
        self.findings = findings or []


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


def set_env(name: str, value) -> None:
    """Set an environment variable (as a string), as the reference's."""
    os.environ[name] = str(value)


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
