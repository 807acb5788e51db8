"""NaN fault injection: poison a named tensor at a counted occurrence
(counterpart of ``mxnet_tpu/chaos/nan.py``).

The training-health plane (``obs/health.py``) promises that a non-finite
blowup is detected (a sentinel breach), attributed (the blame pass names
the first non-finite node) and recovered from (rollback to the newest
finite checkpoint, replayed bitwise). A rule names a tensor and fires on
exact 1-based occurrence counts of that tensor being bound into an
Executor forward. Occurrence counting is what makes the replay clean: the
rollback re-runs the poisoned batch with its occurrence already consumed.

Configuration
-------------
Programmatic (tests): ``configure([Rule("data", {5})])`` then ``reset()``.
Env (subprocesses): ``MXNET_CHAOS_NAN`` as semicolon-separated
``tensor@occ1,occ2`` — ``MXNET_CHAOS_NAN="data@5"`` poisons the 5th
forward's ``data`` input. No occurrence list means every occurrence.
Only float tensors are poisoned (element 0 becomes NaN, in a copy); an
integer tensor matches but is skipped with a warning.

The hook (``executor.Executor.forward``) costs one ``enabled()`` check
when no rule is installed.
"""
from __future__ import annotations

import os
import threading
import warnings
from typing import Dict, List, Optional, Set

from .. import obs

__all__ = ["Rule", "configure", "reset", "enabled", "poison", "parse_env"]


class Rule:
    def __init__(self, tensor: str, occurrences: Optional[Set[int]] = None):
        self.tensor = tensor
        self.occurrences = set(occurrences) if occurrences else None

    def __repr__(self):
        occ = sorted(self.occurrences) if self.occurrences else "all"
        return f"NanRule({self.tensor}@{occ})"


class _State(threading.local):
    """Thread-local counters: concurrent executors must not race each
    other's occurrence counts."""

    def __init__(self):
        self.rules: Optional[List[Rule]] = None
        self.counters: Dict[int, int] = {}


_STATE = _State()
_PROGRAMMATIC: Optional[List[Rule]] = None


def parse_env(spec: str) -> List[Rule]:
    rules = []
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        tensor, _, occs = part.partition("@")
        if not tensor:
            raise ValueError(f"bad MXNET_CHAOS_NAN entry {part!r}")
        occurrences = ({int(o) for o in occs.split(",") if o}
                       if occs else None)
        rules.append(Rule(tensor, occurrences))
    return rules


def configure(rules: List[Rule]) -> None:
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
        spec = os.environ.get("MXNET_CHAOS_NAN", "")
        _STATE.rules = parse_env(spec) if spec else []
    return _STATE.rules


def enabled() -> bool:
    return bool(_active_rules())


def poison(names, values) -> list:
    """Given parallel (names, tensors) about to enter a forward, return
    the tensors with every matching one poisoned (a copy whose element 0
    is NaN). Call only after ``enabled()``: the hot path pays one check."""
    import torch

    rules = _active_rules()
    out = list(values)
    if not rules:
        return out
    by_name = {n: i for i, n in enumerate(names)}
    for rule in rules:
        i = by_name.get(rule.tensor)
        if i is None:
            continue
        key = id(rule)
        _STATE.counters[key] = _STATE.counters.get(key, 0) + 1
        occ = _STATE.counters[key]
        if rule.occurrences is not None and occ not in rule.occurrences:
            continue
        v = out[i]
        if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
            warnings.warn(f"MXNET_CHAOS_NAN: tensor {rule.tensor!r} has "
                          f"non-float dtype {getattr(v, 'dtype', type(v))} "
                          "— not poisoned")
            continue
        poisoned = v.detach().clone(memory_format=torch.contiguous_format)
        poisoned.view(-1)[0] = float("nan")
        out[i] = poisoned.requires_grad_(v.requires_grad)
        # tagged in the same timeline as the breach, blame and rollback
        obs.event("chaos.nan", tensor=rule.tensor, occurrence=occ)
        obs.inc("chaos.injected")
        obs.inc("chaos.nan.injected")
    return out
