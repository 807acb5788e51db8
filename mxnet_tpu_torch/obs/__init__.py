"""``mxnet_tpu_torch.obs`` — runtime telemetry (counterpart of
``mxnet_tpu/obs``). Two surfaces, one switch:

- :mod:`.trace` — the span tracer: ``obs.span("phase")`` context managers
  build a framework timeline (RPCs, serve batches, decode steps), exported
  as chrome-trace JSON (Perfetto) or a JSONL stream;
- :mod:`.metrics` — named counters, gauges and fixed-bucket histograms;
  ``obs.metrics.snapshot()`` returns them in the reference's schema.

Around them: :mod:`.context` (the W3C trace context on the wire's key
field, head sampling), :mod:`.tail` (retention decided at root close),
:mod:`.profile` (the sampling profiler), :mod:`.blackbox` (the flight
recorder), :mod:`.device` (the cost, roofline and memory accounting of
the card), :mod:`.slo` (the SLO monitor) and :mod:`.export`
(``obs.export_mod``: Prometheus text, the multi-process trace merge).

The whole layer is off by default and cheap when off: one module flag
(``trace._ENABLED``) guards every entry point; ``span()`` returns a shared
no-op, ``inc``/``observe``/``set_gauge`` return at once. Turn it on with
``MXNET_OBS=1`` or ``obs.enable()``; ``MXNET_OBS_JSONL=<path>`` (or
``enable(jsonl=)``) also streams every event to a file::

    import mxnet_tpu_torch as mx
    mx.obs.enable()
    ...                                  # serve, fleet, decode
    mx.obs.export("trace.json")          # spans + metrics, one file
    # then: python -m mxnet_tpu_torch.tools.trace_report trace.json

The training-health plane (``health``), the training-fleet plane
(``fleetstats``) and the regression dossier (``regress``) are queue item
A15 (its training half) of the port: each raises ``MXNetError`` naming it.
"""
from __future__ import annotations

import os
from typing import Optional

from ..base import MXNetError
from . import context, metrics, trace
# the package attribute ``obs.export`` is the chrome-trace export FUNCTION
# below; the export MODULE is ``obs.export_mod`` (or its dotted path)
from . import export as export_mod
from . import tail, profile, blackbox, slo, device

__all__ = ["trace", "metrics", "context", "export_mod", "tail", "profile",
           "blackbox", "slo", "device", "enable", "disable", "enabled",
           "span", "event", "inc", "observe", "set_gauge", "export",
           "reset", "telemetry_part"]

# the reference's planes of the training half of queue item A15
_LATER = {"health": "the training-health plane",
          "fleetstats": "the training-fleet plane",
          "regress": "the regression dossier"}


def __getattr__(name):
    if name in _LATER:
        raise MXNetError(f"obs.{name}: {_LATER[name]} is queue item A15 "
                         "(the training half of its item 1) of the port")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# re-exported hot-path helpers (obs.span is obs.trace.span)
span = trace.span
event = trace.event


def enabled() -> bool:
    """True when telemetry is recording (the one module flag)."""
    return trace._ENABLED


def enable(jsonl: Optional[str] = None) -> None:
    """Turn telemetry on. ``jsonl`` additionally streams every completed
    span/event to that path (appended, flushed per event: it survives
    SIGKILL). A literal ``%p`` in the path expands to this process's pid,
    so a fleet of ProcReplicas sharing one template get a file each."""
    trace._ENABLED = True
    if jsonl:
        trace.stream_to(jsonl.replace("%p", str(os.getpid())))


def disable() -> None:
    """Turn telemetry off and close any JSONL stream (after appending a
    final metrics-snapshot record to it). Recorded events and metrics are
    kept until :func:`reset`."""
    was_streaming = trace.tracer._stream is not None
    trace._ENABLED = False
    if was_streaming:
        trace.tracer.stream_metrics(metrics.snapshot())
    trace.stream_to(None)


def reset() -> None:
    """Clear the span ring, drop every metric, and empty the device
    plane's cost registry and leak monitor (plus the tail plane's pending
    buffer and exemplars when tail mode is on)."""
    trace.reset()
    metrics.reset()
    device.reset()
    tail.reset()


# self-gating helpers for instrumentation call sites: one flag check when
# telemetry is off

def inc(name: str, n: int = 1) -> None:
    if trace._ENABLED:
        metrics.registry.counter(name).inc(n)


def observe(name: str, value: float) -> None:
    if trace._ENABLED:
        metrics.registry.histogram(name).observe(value)


def set_gauge(name: str, value: float) -> None:
    if trace._ENABLED:
        metrics.registry.gauge(name).set(value)


def export(path: str) -> str:
    """Write the chrome-trace JSON (spans + instant events + a metrics
    snapshot in ``otherData``) to ``path``."""
    return trace.export_chrome_trace(path, metrics=metrics.snapshot())


def telemetry_part(drain: bool = True, role: Optional[str] = None) -> dict:
    """This process's contribution to a fleet-wide collection: the drained
    span ring (a copy with ``drain=False``), the metrics snapshot, and the
    clock anchor that merges many processes onto one timeline
    (``export.merge_chrome_parts``). What a server returns over
    ``OP_TELEMETRY``."""
    if drain:
        spans = trace.tracer.drain()
    else:
        spans = [trace.tracer._event_dict(r) for r in trace.tracer.events()]
    part = {"pid": os.getpid(), "role": role,
            "wall_epoch": trace.tracer.wall_epoch,
            "sample_rate": context.sample_rate(),
            "spans": spans, "metrics": metrics.snapshot()}
    if tail.enabled():
        # exemplars and the buffer's state ride the part
        part["exemplars"] = tail.exemplars_snapshot()
        part["tail"] = tail.stats()
    return part


# environment switches: MXNET_OBS=1 enables at import, MXNET_OBS_JSONL
# names the stream file (implies enable)
_env = os.environ.get("MXNET_OBS", "").lower()
_jsonl = os.environ.get("MXNET_OBS_JSONL")
if _jsonl or _env not in ("", "0", "false", "no", "off"):
    enable(jsonl=_jsonl)

# the black-box plane's switches: tail retention, the profiler, the flight
# recorder — each independent, all inherited by ProcReplica children
if os.environ.get("MXNET_OBS_TAIL", "").lower() not in (
        "", "0", "false", "no", "off"):
    tail.enable()
if os.environ.get("MXNET_OBS_PROF", "").lower() not in (
        "", "0", "false", "no", "off"):
    profile.start()
if os.environ.get("MXNET_OBS_BLACKBOX", "").lower() not in (
        "", "0", "false", "no", "off") \
        or os.environ.get("MXNET_OBS_BLACKBOX_DIR"):
    blackbox.enable()
