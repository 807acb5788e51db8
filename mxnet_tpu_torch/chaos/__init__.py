"""Deterministic fault injection (counterpart of ``mxnet_tpu/chaos/``).

Five injector families, each env-gated so that production code paths cost
one lookup when chaos is off:

- :mod:`.rpc` — drop / delay / duplicate parameter-server and serve RPCs
  at exact occurrence counts (``MXNET_CHAOS_RPC`` or programmatic rules).
  Hooks live in ``kvstore/ps_client.py`` and ``serve/client.py``.
- :mod:`.proc` — SIGKILL the current process at named code points
  (``MXNET_CHAOS_KILL``, e.g. the checkpoint writer mid-rename or a serve
  replica's ``serve:pre_reply``), and helpers to run a training
  subprocess and kill it at a chosen step. The serving fleet
  (``serve/fleet.py``) forwards ``MXNET_CHAOS_KILL_REPLICA<i>`` to replica
  *i* as its ``MXNET_CHAOS_KILL``, so one env var SIGKILLs exactly one
  member of a fleet at a named point.
- :mod:`.platform` — hang the guarded platform entry points
  (``MXNET_CHAOS_TUNNEL_HANG``) the way a dead accelerator does, so every
  tool's bounded exit with its platform-error artifact is testable.
- :mod:`.nan` — poison a named tensor with NaN at a counted occurrence of
  it entering an Executor forward (``MXNET_CHAOS_NAN``), so the
  training-health plane's detection, provenance and rollback
  (``obs/health.py``) can be tested end to end.
- :mod:`.slow` — delay a named rank's step phase at counted occurrences
  (``MXNET_CHAOS_SLOW``), so the training-fleet straggler detector
  (``obs/fleetstats.py``) must name the injected rank and blame the
  injected phase.

Determinism is the point: every injector fires on a counted occurrence of
a named event, never on a timer or a random draw.
"""
from __future__ import annotations

from . import nan, platform, proc, rpc, slow

__all__ = ["rpc", "proc", "platform", "nan", "slow"]
