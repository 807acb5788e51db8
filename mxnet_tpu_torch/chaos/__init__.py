"""Deterministic fault injection (counterpart of ``mxnet_tpu/chaos/``).

Ported: :mod:`.nan`, which poisons a named tensor with NaN at a counted
occurrence of it entering an Executor forward (``MXNET_CHAOS_NAN``), so
that the training-health plane's detection, provenance and rollback
(``obs/health.py``) can be tested end to end; :mod:`.slow`, which delays
a named rank's step phase at counted occurrences (``MXNET_CHAOS_SLOW``),
so that the training-fleet straggler detector (``obs/fleetstats.py``)
must name the injected rank and blame the injected phase.

The reference's other injectors (``rpc``: parameter-server RPC drops and
delays; ``proc``: SIGKILL at named code points; ``platform``: a hung
first touch of the accelerator) are queue item A15(f) of the port: each
raises ``MXNetError`` naming it.

Determinism is the point: every injector fires on a counted occurrence of
a named event, never on a timer or a random draw.
"""
from __future__ import annotations

from ..base import MXNetError
from . import nan, slow

__all__ = ["nan", "slow"]

_LATER = {"rpc": "A15(f)", "proc": "A15(f)", "platform": "A15(f)"}


def __getattr__(name):
    if name in _LATER:
        raise MXNetError(f"chaos.{name} is queue item {_LATER[name]} of the "
                         "port, not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
