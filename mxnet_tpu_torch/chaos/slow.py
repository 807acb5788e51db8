"""Deterministic straggler injection: delay a named rank's step phase at
counted occurrences (counterpart of ``mxnet_tpu/chaos/slow.py``).

The training-fleet plane (``obs/fleetstats.py``) promises that a rank
lagging the fleet is *detected* (a ``StragglerDetector`` verdict within K
windows) and *blamed* (the lagging phase named). A rule names a rank and a
step phase and fires a fixed sleep on exact 1-based occurrence counts of
that phase completing on that rank; the flagged rank and the blamed phase
must then match the injection.

The delay fires INSIDE the phase's span (``obs/fleetstats.py``
``_PhaseCtx``), so the injected lag shows on the merged timeline as the
stretched phase the detector blames.

Configuration
-------------
Programmatic (tests): ``configure([Rule(1, "forward", {5, 6}, 0.25)])``
then ``reset()``. Env (subprocesses): ``MXNET_CHAOS_SLOW`` as semicolon-
separated ``rank:phase@occs:seconds``; occurrences are 1-based counts of
that (rank, phase) pair, a comma list and/or ``lo-hi`` ranges, empty for
every occurrence::

    MXNET_CHAOS_SLOW="1:forward@5-40:0.25"    # rank 1, forwards 5..40
    MXNET_CHAOS_SLOW="0:data_wait::0.1"       # rank 0, every data_wait
    MXNET_CHAOS_SLOW="2:update@3,7:0.5"       # rank 2, 3rd and 7th update

The seconds field also takes a ramp form ``base+step``: ``base`` at the
rule's first matching occurrence, growing by ``step`` per occurrence after
it (a worsening straggler)::

    MXNET_CHAOS_SLOW="1:forward@5-40:0.1+0.02"  # 0.1s at occ 5, +0.02/occ

The rank comes from :func:`set_rank` (the elastic store calls it with the
fleet rank), else ``DMLC_WORKER_ID``. With no rule installed the hook
costs one check.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set

from .. import obs

__all__ = ["Rule", "configure", "reset", "enabled", "maybe_delay",
           "set_rank", "parse_env"]


class Rule:
    def __init__(self, rank: int, phase: str,
                 occurrences: Optional[Set[int]] = None,
                 seconds: float = 0.0, ramp: float = 0.0):
        self.rank = int(rank)
        self.phase = phase
        self.occurrences = set(occurrences) if occurrences else None
        self.seconds = float(seconds)
        # per-occurrence growth (the ``base+step`` env form): a worsening
        # straggler instead of a constant one
        self.ramp = float(ramp)

    def delay_for(self, occ: int) -> float:
        """Injected seconds at 1-based occurrence ``occ``: constant, or
        ``base + (occ - first_occurrence) * ramp`` for a ramp rule."""
        if not self.ramp:
            return self.seconds
        first = min(self.occurrences) if self.occurrences else 1
        return self.seconds + max(0, occ - first) * self.ramp

    def __repr__(self):
        occ = sorted(self.occurrences) if self.occurrences else "all"
        secs = (f"{self.seconds}+{self.ramp}" if self.ramp
                else f"{self.seconds}")
        return f"SlowRule(rank{self.rank}:{self.phase}@{occ}:{secs}s)"


class _State(threading.local):
    """Thread-local counters (the RPC-chaos idiom): concurrent step loops
    in one test must not race each other's occurrence counts."""

    def __init__(self):
        self.rules: Optional[List[Rule]] = None
        self.counters: Dict[int, int] = {}


_STATE = _State()
_PROGRAMMATIC: Optional[List[Rule]] = None
_RANK: Optional[int] = None


def set_rank(r: int) -> None:
    """Pin this process's fleet rank (the elastic session calls it); the
    ``DMLC_WORKER_ID`` env var is the fallback."""
    global _RANK
    _RANK = int(r)


def _rank() -> int:
    if _RANK is not None:
        return _RANK
    return int(os.environ.get(
        "DMLC_WORKER_ID", os.environ.get("MXNET_WORKER_ID", 0)) or 0)


def _parse_occs(spec: str) -> Optional[Set[int]]:
    if not spec:
        return None
    out: Set[int] = set()
    for tok in filter(None, (t.strip() for t in spec.split(","))):
        lo, dash, hi = tok.partition("-")
        if dash:
            out.update(range(int(lo), int(hi) + 1))
        else:
            out.add(int(tok))
    return out or None


def parse_env(spec: str) -> List[Rule]:
    rules = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        fields = part.split(":")
        # canonical rank:phase@occs:seconds; an empty occurrence list may
        # be written rank:phase:seconds (or rank:phase::seconds)
        if len(fields) == 4 and fields[2] == "":
            fields = [fields[0], fields[1], fields[3]]
        if len(fields) != 3:
            raise ValueError(f"bad MXNET_CHAOS_SLOW entry {part!r} "
                             "(want rank:phase@occs:seconds)")
        rank_s, phase_occ, seconds = fields
        phase, _, occs = phase_occ.partition("@")
        if not phase:
            raise ValueError(f"bad MXNET_CHAOS_SLOW entry {part!r}")
        try:
            # ramp form base+step (a worsening straggler); plain floats —
            # including exponent notation like 1e+3 — stay constant rules
            base_s, plus, step_s = seconds.partition("+")
            ramp = 0.0
            if plus and base_s and step_s:
                try:  # both halves must parse, else (e.g. "1e+3") it's
                    _base, ramp = float(base_s), float(step_s)  # constant
                except ValueError:
                    ramp = 0.0
                else:
                    seconds = base_s
            rules.append(Rule(int(rank_s), phase, _parse_occs(occs),
                              float(seconds), ramp=ramp))
        except ValueError as e:
            raise ValueError(
                f"bad MXNET_CHAOS_SLOW entry {part!r}: {e}") from e
    return rules


def configure(rules: List[Rule]) -> None:
    global _PROGRAMMATIC
    _PROGRAMMATIC = list(rules)
    _STATE.rules = None
    _STATE.counters = {}


def reset() -> None:
    global _PROGRAMMATIC, _RANK
    _PROGRAMMATIC = None
    _RANK = None
    _STATE.rules = None
    _STATE.counters = {}


def _active_rules() -> List[Rule]:
    if _PROGRAMMATIC is not None:
        return _PROGRAMMATIC
    if _STATE.rules is None:
        spec = os.environ.get("MXNET_CHAOS_SLOW", "")
        _STATE.rules = parse_env(spec) if spec else []
    return _STATE.rules


def enabled() -> bool:
    return bool(_active_rules())


def maybe_delay(phase: str) -> float:
    """Hook at the end of a step phase on this rank: sleeps (and tags the
    injection in the same timeline the step writes to) when a rule
    matches this (rank, phase) at this occurrence. Returns the injected
    seconds (0.0 when nothing fired)."""
    rules = _active_rules()
    if not rules:
        return 0.0
    my_rank = _rank()
    injected = 0.0
    for rule in rules:
        if rule.rank != my_rank or rule.phase != phase:
            continue
        key = id(rule)
        _STATE.counters[key] = _STATE.counters.get(key, 0) + 1
        occ = _STATE.counters[key]
        if rule.occurrences is not None and occ not in rule.occurrences:
            continue
        secs = rule.delay_for(occ)
        obs.event("chaos.slow", rank=my_rank, phase=phase,
                  occurrence=occ, seconds=secs)
        obs.inc("chaos.injected")
        obs.inc("chaos.slow.injected")
        time.sleep(secs)
        injected += secs
    return injected
