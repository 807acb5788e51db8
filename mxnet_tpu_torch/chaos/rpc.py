"""RPC fault injection for the parameter-server and serve clients
(counterpart of ``mxnet_tpu/chaos/rpc.py``).

``kvstore/ps_client.py`` and ``serve/client.py`` call :func:`on_send`
before writing a frame and :func:`on_reply` after reading one. Rules match an opcode name and fire on
exact 1-based occurrence counts of that (op, action) pair, so a test can say
"drop the reply of the 2nd PUSH_SEQ" and get that, every run.

Actions
-------
- ``drop_request``: raise ConnectionError *before* the frame is sent — the
  server never sees it (models a lost request packet).
- ``drop_reply``: raise ConnectionError *after* the reply was read — the
  server HAS processed the RPC, the client believes it failed (models a lost
  ack; the retry is where at-least-once becomes double-apply unless the
  server dedups).
- ``delay``: sleep ``seconds`` before sending (models congestion; lets a test
  restart the server during an in-flight RPC).
- ``dup``: send the frame twice back-to-back (models a duplicating network);
  the client drains both replies.

Configuration
-------------
Programmatic (tests): ``configure([Rule("push_seq", "drop_reply", {1})])``
then ``reset()``. Env (subprocesses): ``MXNET_CHAOS_RPC`` as semicolon-
separated ``op:action@occ1,occ2[:seconds]`` — e.g.
``MXNET_CHAOS_RPC="push_seq:drop_reply@1;pull:delay@2:0.5"``. An empty
occurrence list means every occurrence.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set

from .. import obs

__all__ = ["Rule", "configure", "reset", "on_send", "on_reply", "enabled"]

# opcode value -> canonical rule name (mirrors kvstore/ps_server.py opcodes;
# ps_server.py adds its full table, the elastic range included).
# The serving plane (opcodes 32+) registers its names here on import —
# serve/server.py does OP_NAMES.update(SERVE_OP_NAMES), ONE source of truth —
# so one rule table fault-injects both training and inference RPCs.
OP_NAMES = {0: "init", 1: "push", 2: "pull", 3: "set_opt", 4: "barrier",
            5: "shutdown", 6: "push_sparse", 7: "pull_sparse", 8: "push_seq",
            9: "push_sparse_seq"}

_SEND_ACTIONS = ("drop_request", "delay", "dup")
_REPLY_ACTIONS = ("drop_reply",)


class ChaosConnectionError(ConnectionError):
    """Marks an injected fault (subclass of what the retry path catches)."""


class Rule:
    def __init__(self, op: str, action: str, occurrences: Optional[Set[int]] = None,
                 seconds: float = 0.0):
        if action not in _SEND_ACTIONS + _REPLY_ACTIONS:
            raise ValueError(f"unknown chaos action {action!r}")
        self.op = op.lower()
        self.action = action
        self.occurrences = set(occurrences) if occurrences else None
        self.seconds = float(seconds)

    def __repr__(self):
        occ = sorted(self.occurrences) if self.occurrences else "all"
        return f"Rule({self.op}:{self.action}@{occ})"


class _State(threading.local):
    """Thread-local so concurrent client threads in one test can't race the
    counters; env parsing happens once per thread on first use."""

    def __init__(self):
        self.rules: Optional[List[Rule]] = None
        self.counters: Dict[int, int] = {}  # id(rule) -> match count


_STATE = _State()
_PROGRAMMATIC: Optional[List[Rule]] = None


def parse_env(spec: str) -> List[Rule]:
    rules = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        fields = part.split(":")
        if len(fields) not in (2, 3):
            raise ValueError(f"bad MXNET_CHAOS_RPC entry {part!r}")
        op, action_occ = fields[0], fields[1]
        seconds = float(fields[2]) if len(fields) == 3 else 0.0
        action, _, occs = action_occ.partition("@")
        occurrences = ({int(o) for o in occs.split(",") if o}
                       if occs else None)
        rules.append(Rule(op, action, occurrences, seconds))
    return rules


def configure(rules: List[Rule]) -> None:
    """Install rules for this process (all threads); resets counters."""
    global _PROGRAMMATIC
    _PROGRAMMATIC = list(rules)
    _STATE.rules = None
    _STATE.counters = {}


def reset() -> None:
    global _PROGRAMMATIC
    _PROGRAMMATIC = None
    _STATE.rules = None
    _STATE.counters = {}


def _active_rules() -> List[Rule]:
    if _PROGRAMMATIC is not None:
        return _PROGRAMMATIC
    if _STATE.rules is None:
        spec = os.environ.get("MXNET_CHAOS_RPC", "")
        _STATE.rules = parse_env(spec) if spec else []
    return _STATE.rules


def enabled() -> bool:
    return bool(_active_rules())


def _fire(rule: Rule, opname: str) -> bool:
    # keyed per RULE, not per (op, action): two rules targeting the same
    # op+action at different occurrences must each count every matching
    # event exactly once, or occurrence specs drift nondeterministically
    key = id(rule)
    _STATE.counters[key] = _STATE.counters.get(key, 0) + 1
    fired = (rule.occurrences is None
             or _STATE.counters[key] in rule.occurrences)
    if fired:
        # tag the injection in the SAME timeline the training step writes
        # to, so a fault experiment reads as "RPC span, then chaos.rpc
        # event, then the retry" instead of an invisible stall
        obs.event("chaos.rpc", action=rule.action, op=opname,
                  occurrence=_STATE.counters[key],
                  seconds=rule.seconds or None)
        obs.inc("chaos.injected")
        obs.inc(f"chaos.rpc.{rule.action}")
    return fired


def on_send(opcode: int, key: str) -> Optional[str]:
    """Hook before a frame is sent. Raises to drop the request, sleeps to
    delay it, or returns "dup" to ask the client to send it twice."""
    rules = _active_rules()
    if not rules:
        return None
    opname = OP_NAMES.get(opcode, str(opcode))
    verdict = None
    for rule in rules:
        if rule.op != opname or rule.action not in _SEND_ACTIONS:
            continue
        if not _fire(rule, opname):
            continue
        if rule.action == "drop_request":
            raise ChaosConnectionError(
                f"chaos: dropped {opname} request (key={key!r})")
        if rule.action == "delay":
            time.sleep(rule.seconds)
        elif rule.action == "dup":
            verdict = "dup"
    return verdict


def on_reply(opcode: int, key: str) -> None:
    """Hook after a reply was read. Raising here models a lost ack: the
    server applied the RPC but the client will retry it."""
    rules = _active_rules()
    if not rules:
        return
    opname = OP_NAMES.get(opcode, str(opcode))
    for rule in rules:
        if rule.op != opname or rule.action not in _REPLY_ACTIONS:
            continue
        if _fire(rule, opname):
            raise ChaosConnectionError(
                f"chaos: dropped {opname} reply (key={key!r})")
