"""``mxnet_tpu_torch.obs`` — runtime telemetry (counterpart of
``mxnet_tpu/obs``): the metrics registry, the SLO monitor that reads it,
and the switch that gates every instrumentation call site.

- :mod:`.metrics` — named counters, gauges and fixed-bucket histograms;
  ``obs.metrics.snapshot()`` returns them as data in the reference's
  schema, ``dump()`` as a table or json;
- :mod:`.slo` — :class:`~.slo.SLOMonitor`: deadline attainment, error-
  budget burn (cumulative and windowed) and p99 over snapshots, the
  autoscaler's signal;
- :mod:`.export` (``obs.export_mod``) — ``hist_quantile`` and
  ``merge_metrics`` over snapshots.

The layer is off by default and cheap when off: ``inc``/``observe``/
``set_gauge`` return at once unless ``enable()`` ran or ``MXNET_OBS=1``
was set at import. The registry itself always works.

The span tracer and the rest of the reference's planes (``span``,
``event``, ``trace``, ``tail``, ``profile``, ``blackbox``, ``device``,
``health``, ``fleetstats``, ``context``, ``telemetry_part`` and the
chrome-trace ``export``) are queue item A15 of the port: each raises
``MXNetError`` naming it.
"""
from __future__ import annotations

import os

from ..base import MXNetError
from . import export as export_mod
from . import metrics, slo

__all__ = ["metrics", "slo", "export_mod", "enable", "disable", "enabled",
           "reset", "inc", "observe", "set_gauge", "span", "event",
           "export", "telemetry_part"]

_ENABLED = False

# the reference's planes that are queue item A15 of the port
_A15 = ("trace", "tail", "profile", "blackbox", "device", "health",
        "fleetstats", "context")


def _later(what: str):
    return MXNetError(f"obs.{what}: the span and black-box planes of "
                      "telemetry are queue item A15 of the port")


def __getattr__(name):
    if name in _A15:
        raise _later(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def enabled() -> bool:
    """True when telemetry is recording (the one module flag)."""
    return _ENABLED


def enable(jsonl=None) -> None:
    """Turn recording on. ``jsonl`` (the reference's span stream) is part
    of the span plane, queue item A15, and raises when given."""
    global _ENABLED
    if jsonl:
        raise _later("enable(jsonl=)")
    _ENABLED = True


def disable() -> None:
    """Turn recording off; recorded metrics are kept until :func:`reset`."""
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop every metric."""
    metrics.reset()


# self-gating helpers for instrumentation call sites: one flag check when
# telemetry is off

def inc(name: str, n: int = 1) -> None:
    if _ENABLED:
        metrics.registry.counter(name).inc(n)


def observe(name: str, value: float) -> None:
    if _ENABLED:
        metrics.registry.histogram(name).observe(value)


def set_gauge(name: str, value: float) -> None:
    if _ENABLED:
        metrics.registry.gauge(name).set(value)


def span(*args, **kwargs):
    raise _later("span")


def event(*args, **kwargs):
    raise _later("event")


def export(path: str) -> str:
    raise _later("export")


def telemetry_part(drain: bool = True, role=None) -> dict:
    raise _later("telemetry_part")


# MXNET_OBS=1 enables at import, as in the reference; its span stream
# (MXNET_OBS_JSONL) and the black-box switches are A15
if os.environ.get("MXNET_OBS", "").lower() not in ("", "0", "false", "no",
                                                    "off"):
    enable()
