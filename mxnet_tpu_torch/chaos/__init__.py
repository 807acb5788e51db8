"""Deterministic fault injection (counterpart of ``mxnet_tpu/chaos/``).

Ported: :mod:`.nan`, which poisons a named tensor with NaN at a counted
occurrence of it entering an Executor forward (``MXNET_CHAOS_NAN``), so
that the training-health plane's detection, provenance and rollback
(``obs/health.py``) can be tested end to end.

The reference's other injectors (``rpc``: parameter-server RPC drops and
delays; ``proc``: SIGKILL at named code points; ``platform``: a hung
first touch of the accelerator; ``slow``: a delayed rank) are queue items
A15(c) and A15(f) of the port: each raises ``MXNetError`` naming it.

Determinism is the point: every injector fires on a counted occurrence of
a named event, never on a timer or a random draw.
"""
from __future__ import annotations

from ..base import MXNetError
from . import nan

__all__ = ["nan"]

_LATER = {"rpc": "A15(f)", "proc": "A15(f)", "platform": "A15(f)",
          "slow": "A15(c)"}


def __getattr__(name):
    if name in _LATER:
        raise MXNetError(f"chaos.{name} is queue item {_LATER[name]} of the "
                         "port, not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
