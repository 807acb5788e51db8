"""Shared env-knob parsing for the obs package — fail-soft by design: a
garbled value falls back to the default instead of taking telemetry (and
the process it watches) down at import (copy of the reference's
``obs/_env.py``).
"""
from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    return int(env_float(name, default))
