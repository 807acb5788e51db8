"""Span tracer — a low-overhead framework-level timeline.

Counterpart of ``mxnet_tpu/obs/trace.py``: the same records, the same
chrome-trace and JSONL schemas. It records the *framework* phases
(data_wait / forward / backward / update / metric / checkpoint, RPCs,
checkpoint commits, chaos injections) and exports them as:

- **chrome-trace JSON** (``export_chrome_trace``): load the file in Perfetto
  (ui.perfetto.dev) or ``chrome://tracing`` — one track per thread, so the
  async checkpoint writer and prefetch workers show up beside the step loop;
- **JSONL event stream** (``stream_to``): one JSON object per line, appended
  and flushed as each span closes — survives SIGKILL mid-run (the chaos
  harness's process kills), tail -f-able on headless workers.

Overhead contract:

- **Disabled** (the default): ``span()`` returns a shared no-op singleton —
  no event, no allocation retained, one module-flag check. The whole layer
  is gated on this ONE flag (``_ENABLED``), flipped by ``obs.enable()`` /
  ``MXNET_OBS=1``.
- **Enabled**: ``__enter__``/``__exit__`` cost two ``time.monotonic()``
  calls and one deque append into a bounded ring buffer (old events drop,
  newest win — a long run cannot OOM the tracer).

Spans nest per thread (a thread-local stack records depth); the context
manager is reentrant across threads because each thread owns its stack.

Distributed tracing (obs/context.py): when a :class:`~.context.TraceContext`
is active on the thread, each span allocates its own ``span_id``, records
``trace_id``/``span_id``/``parent_id`` in its attrs, and re-activates itself
as the current context for its body — so spans on the far side of an RPC
become children of the exact span that sent it. An active-but-UNSAMPLED
context short-circuits ``span()`` to the shared no-op (head-based sampling:
the whole trace is either recorded on every hop or costs one thread-local
read per span site).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import IO, List, Optional

from . import context as _context

__all__ = ["Tracer", "span", "event", "counter", "complete", "events",
           "reset", "drain", "stream_to", "to_chrome_trace",
           "export_chrome_trace", "tracer"]

# THE module flag: obs.enable()/disable() flip it; every instrumentation
# entry point checks it first. Plain module global — one LOAD_GLOBAL on the
# hot path, no function call.
_ENABLED = False

# routing sinks, installed by their owners (None = inactive):
# - _TAIL_SINK(trace_id, rec): obs/tail.py — spans of a tail-pending trace
#   go to the per-trace pending buffer instead of the durable ring; the
#   retention verdict at root close promotes them back through _record.
# - _BLACKBOX_SINK(rec, tracer): obs/blackbox.py — the flight recorder's
#   always-on ring sees EVERY event exactly once at creation time
#   (including tail-held ones that may later be dropped — the crash
#   bundle wants "what was this process doing", retained or not).
_TAIL_SINK = None
_BLACKBOX_SINK = None


def _trace_epoch() -> float:
    return time.monotonic()


class _NoopSpan:
    """Shared do-nothing context manager for disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """A live span: records (name, start, duration, thread, depth, attrs)
    on exit. Created only while tracing is enabled. When a (sampled)
    trace context is active, the span allocates a child span_id, runs its
    body AS the current context, and stamps trace/span/parent ids into its
    attrs — the cross-process parent chain."""

    __slots__ = ("_tracer", "name", "attrs", "t0", "_ctx", "_parent")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict],
                 parent=None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._parent = parent
        self._ctx = None

    def __enter__(self):
        if self._parent is not None:
            self._ctx = self._parent.child()
            _context._set(self._ctx)
        self._tracer._stack().append(self)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # unbalanced exit (generator teardown etc.) — drop to self
            while stack and stack[-1] is not self:
                stack.pop()
            if stack:
                stack.pop()
        if not stack:
            self._tracer._release_stack(stack)
        attrs = self.attrs
        if self._ctx is not None:
            _context._set(self._parent)
            attrs = dict(attrs) if attrs else {}
            attrs["trace_id"] = self._ctx.trace_id
            attrs["span_id"] = self._ctx.span_id
            attrs["parent_id"] = self._parent.span_id
        self._tracer._route(
            ("X", self.name, self.t0, t1 - self.t0,
             threading.get_ident(), len(stack), attrs), self._ctx)
        return False


class Tracer:
    """Bounded ring buffer of trace events + optional JSONL stream.

    Event records (tuples, cheapest to append):
      ("X", name, t_start, duration, tid, depth, attrs)   — completed span
      ("i", name, t,        None,    tid, depth, attrs)   — instant event
    Timestamps are ``time.monotonic()`` seconds; exporters rebase to the
    tracer's epoch so traces start near t=0.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._local = threading.local()
        # tid -> the thread's live span stack (the same list object the
        # thread-local holds) — how the sampling profiler (obs/profile.py)
        # tags another thread's samples with its active span phase; a
        # cross-thread read of the last element is GIL-atomic (worst case
        # one sample period stale)
        self._thread_stacks: dict = {}
        # the two epochs are taken at the same instant: an event's unix
        # time is wall_epoch + ts — how multi-process traces merge onto
        # one timeline (obs/export.py, tools/trace_report.py)
        self._epoch = _trace_epoch()
        self._wall_epoch = time.time()
        self._stream: Optional[IO[str]] = None
        self._stream_path: Optional[str] = None
        self._stream_lock = threading.Lock()

    @property
    def stream_path(self) -> Optional[str]:
        """The JSONL path currently streamed to (None when not streaming)
        — lets a tool that must toggle telemetry restore the caller's
        stream afterwards (serve_bench.run_obs_overhead)."""
        return self._stream_path

    @property
    def wall_epoch(self) -> float:
        """Unix time of the tracer's t=0 (the cross-process clock anchor)."""
        return self._wall_epoch

    # -- hot path ----------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
            self._thread_stacks[threading.get_ident()] = st
        return st

    def _depth(self) -> int:
        """Current span depth WITHOUT registering a stack — instant
        events outside any span must not re-grow ``_thread_stacks``."""
        st = getattr(self._local, "stack", None)
        return len(st) if st else 0

    def _release_stack(self, stack: list) -> None:
        """Root closed on this thread: drop its ``_thread_stacks``
        registration. A serve plane spawning one handler thread per
        connection would otherwise grow the dict (and keep every dead
        thread's list alive) without bound; the next span on this thread
        re-registers a fresh list via ``_stack()``."""
        if getattr(self._local, "stack", None) is stack:
            self._local.stack = None
        self._thread_stacks.pop(threading.get_ident(), None)

    def thread_phases(self) -> dict:
        """``{tid: innermost active span name}`` across threads — the
        profiler's phase-attribution source."""
        out = {}
        for tid, st in list(self._thread_stacks.items()):
            try:
                out[tid] = st[-1].name
            except IndexError:
                pass  # the owner popped its last span mid-read
        return out

    def _route(self, rec: tuple, ctx) -> None:
        """One emit point for every completed event: feed the flight
        recorder (exactly once, at creation), then either hold the record
        in the tail-pending buffer (tail-flagged trace, verdict later) or
        record it durably. Promotion re-enters through ``_record`` so the
        blackbox never sees a promoted record twice."""
        bb = _BLACKBOX_SINK
        if bb is not None:
            bb(rec, self)
        if (ctx is not None and ctx.tail and not ctx.force
                and not ctx.sampled):
            sink = _TAIL_SINK
            if sink is not None:
                sink(ctx.trace_id, rec)
            # else drop: the tail bit arrived over the wire but THIS
            # process never enabled tail mode — it has no pending buffer
            # to hold the span and no verdict will ever promote it.
            # Recording durably here would bypass this process's own
            # head-sampling rate (a tail-mode client must not turn a
            # sample-0.05 replica into record-everything)
        else:
            self._record(rec)

    def _record(self, rec: tuple) -> None:
        self._events.append(rec)  # deque.append is atomic under the GIL
        stream = self._stream
        if stream is not None:
            line = json.dumps(self._event_dict(rec), default=str)
            with self._stream_lock:
                if self._stream is not None:
                    try:
                        self._stream.write(line + "\n")
                        self._stream.flush()  # survive SIGKILL mid-run
                    except (OSError, ValueError):
                        self._stream = None  # never fail training over a log

    def span(self, name: str, **attrs) -> "_Span | _NoopSpan":
        if not _ENABLED:
            return _NOOP
        ctx = _context.current()
        if ctx is not None and not ctx.records:
            return _NOOP  # head-based sampling: whole trace or nothing
        return _Span(self, name, attrs or None, parent=ctx)

    def event(self, name: str, **attrs) -> None:
        """Record an instant (zero-duration) event — chaos injections,
        preemption signals, retries. Carries the active trace context's
        ids so a tagged event lands inside its request's trace."""
        if not _ENABLED:
            return
        ctx = _context.current()
        if ctx is not None:
            if not ctx.records:
                return
            attrs = dict(attrs)
            attrs["trace_id"] = ctx.trace_id
            attrs["parent_id"] = ctx.span_id
        self._route(("i", name, time.monotonic(), None,
                     threading.get_ident(), self._depth(),
                     attrs or None), ctx)

    def counter(self, name: str, value: float) -> None:
        """Record one sample of a counter track (a Perfetto counter lane —
        ``device.live_bytes`` is the memory lane). Exported as a chrome
        ``"C"`` event; ``tools/trace_report.py`` renders the series."""
        if not _ENABLED:
            return
        self._route(("C", name, time.monotonic(), None,
                     threading.get_ident(), 0, {"value": float(value)}),
                    None)

    def complete(self, name: str, t_start: float, duration: float,
                 ctx=None, **attrs) -> None:
        """Record an already-measured span with an explicit start and
        duration (``time.monotonic()`` seconds) — for phases whose
        endpoints live on different threads, e.g. a serve request's
        queue_wait measured between the submitter's enqueue and the
        batcher's dispatch. ``ctx`` pins the span to a trace context
        captured on another thread (the batcher passes the request's)."""
        if not _ENABLED:
            return
        if ctx is None:
            ctx = _context.current()
        if ctx is not None:
            if not ctx.records:
                return
            attrs = dict(attrs)
            attrs["trace_id"] = ctx.trace_id
            attrs["span_id"] = _context.new_span_id()
            attrs["parent_id"] = ctx.span_id
        self._route(("X", name, t_start, max(duration, 0.0),
                     threading.get_ident(), self._depth(),
                     attrs or None), ctx)

    # -- introspection / export -------------------------------------------
    def events(self) -> List[tuple]:
        return list(self._events)

    def drain(self) -> List[dict]:
        """Atomically remove and return every buffered event as a list of
        normalized dicts (the JSONL/event schema). The telemetry plane's
        pull primitive: repeated ``OP_TELEMETRY`` collections each see only
        what happened since the last one, and a bounded ring drained
        periodically loses nothing."""
        out = []
        events = self._events
        while True:
            try:
                out.append(events.popleft())  # atomic under the GIL
            except IndexError:
                break
        return [self._event_dict(rec) for rec in out]

    def reset(self) -> None:
        self._events.clear()
        self._epoch = _trace_epoch()
        self._wall_epoch = time.time()
        # an attached stream's first clock record anchored the OLD epoch;
        # events after this reset are relative to the new one — append a
        # fresh anchor or every post-reset event would be rebased wrong
        # in a merged timeline (readers take the last clock record)
        with self._stream_lock:
            if self._stream is not None:
                try:
                    self._stream.write(json.dumps(
                        {"ph": "M", "name": "clock", "pid": os.getpid(),
                         "wall_epoch": self._wall_epoch}) + "\n")
                    self._stream.flush()
                except (OSError, ValueError):
                    self._stream = None

    def stream_to(self, path: Optional[str]) -> None:
        """Append completed events to ``path`` as JSONL (None closes)."""
        with self._stream_lock:
            if self._stream is not None:
                try:
                    self._stream.close()
                except OSError:
                    pass
                self._stream = None
            self._stream_path = path
            if path is not None:
                self._stream = open(path, "a", buffering=1)
                # clock anchor first: readers (trace_report/fleet_report)
                # rebase this file's events onto unix time with it, so
                # per-replica JSONL streams merge onto one timeline even
                # when the writer was SIGKILLed mid-run
                try:
                    self._stream.write(json.dumps(
                        {"ph": "M", "name": "clock", "pid": os.getpid(),
                         "wall_epoch": self._wall_epoch}) + "\n")
                    self._stream.flush()
                except (OSError, ValueError):
                    self._stream = None

    def stream_metrics(self, snapshot: dict) -> None:
        """Append a metrics-snapshot record to the JSONL stream (written by
        ``obs.disable()`` so a finished headless run's stream carries its
        final metrics table; tools/trace_report.py reads it back)."""
        with self._stream_lock:
            if self._stream is not None:
                try:
                    self._stream.write(json.dumps(
                        {"ph": "M", "name": "metrics",
                         "metrics": snapshot}, default=float) + "\n")
                    self._stream.flush()
                except (OSError, ValueError):
                    self._stream = None

    def _event_dict(self, rec: tuple) -> dict:
        ph, name, ts, dur, tid, depth, attrs = rec
        d = {"ph": ph, "name": name, "ts": ts - self._epoch, "tid": tid,
             "depth": depth, "pid": os.getpid()}
        if dur is not None:
            d["dur"] = dur
        if attrs:
            d["args"] = attrs
        return d

    def to_chrome_trace(self, metrics: Optional[dict] = None) -> dict:
        """Chrome Trace Event Format dict (Perfetto/about:tracing loadable).

        Durations use "X" complete events; instants use "i". A metrics
        snapshot rides along in ``otherData`` so one file carries the whole
        observability state (tools/trace_report.py reads it back).
        """
        pid = os.getpid()
        trace_events = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "mxnet_tpu"},
        }]
        tids = {}
        for rec in list(self._events):
            ph, name, ts, dur, tid, depth, attrs = rec
            tids.setdefault(tid, len(tids))
            ev = {"name": name, "ph": ph, "pid": pid, "tid": tid,
                  "ts": (ts - self._epoch) * 1e6}
            if ph == "X":
                ev["dur"] = (dur or 0.0) * 1e6
            elif ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            # "C" counter samples carry only their args series
            if attrs:
                ev["args"] = dict(attrs)
            trace_events.append(ev)
        for tid, idx in tids.items():
            trace_events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"thread-{idx}"
                         if idx else "main"}})
        out = {"traceEvents": trace_events, "displayTimeUnit": "ms",
               "otherData": {"pid": pid, "wall_epoch": self._wall_epoch}}
        if metrics is not None:
            out["otherData"]["metrics"] = metrics
        return out

    def export_chrome_trace(self, path: str,
                            metrics: Optional[dict] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(metrics), f, default=str)
        return path


# the process-global tracer; module-level helpers delegate here
tracer = Tracer(capacity=int(os.environ.get("MXNET_OBS_BUFFER", "65536")))


def span(name: str, **attrs):
    """``with obs.trace.span("forward", epoch=3): ...`` — no-op singleton
    when tracing is disabled OR when the active trace context neither
    samples (head-based) nor tail-pends (obs/tail.py)."""
    if not _ENABLED:
        return _NOOP
    ctx = _context.current()
    if ctx is not None and not ctx.records:
        return _NOOP
    return _Span(tracer, name, attrs or None, parent=ctx)


def event(name: str, **attrs) -> None:
    if _ENABLED:
        tracer.event(name, **attrs)


def counter(name: str, value: float) -> None:
    """Module-level passthrough to :meth:`Tracer.counter`."""
    if _ENABLED:
        tracer.counter(name, value)


def complete(name: str, t_start: float, duration: float, ctx=None,
             **attrs) -> None:
    """Module-level passthrough to :meth:`Tracer.complete`."""
    if _ENABLED:
        tracer.complete(name, t_start, duration, ctx=ctx, **attrs)


def events() -> List[tuple]:
    return tracer.events()


def drain() -> List[dict]:
    return tracer.drain()


def reset() -> None:
    tracer.reset()


def stream_to(path: Optional[str]) -> None:
    tracer.stream_to(path)


def to_chrome_trace(metrics: Optional[dict] = None) -> dict:
    return tracer.to_chrome_trace(metrics)


def export_chrome_trace(path: str, metrics: Optional[dict] = None) -> str:
    return tracer.export_chrome_trace(path, metrics)
