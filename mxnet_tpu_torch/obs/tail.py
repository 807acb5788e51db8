"""Tail-based trace retention — decide what to keep AFTER the request
finishes (counterpart of ``mxnet_tpu/obs/tail.py``).

Head-based sampling (``obs/context.py``) decides at the trace ROOT,
before anything is known about the request: at ``MXNET_OBS_SAMPLE=0.1`` the p99 outlier or
the deadline-exceeded request you need to debug is 90% likely to have
recorded nothing. Tail mode inverts the decision:

- **every** request records its spans — but into a bounded per-trace
  *pending* buffer, not the durable ring/JSONL;
- when the root span closes, a :class:`RetentionPolicy` looks at what the
  request actually WAS (latency, error / shed / deadline / hedged /
  breaker outcome, explicit force-retain) and either **promotes** the
  whole trace into the durable ring + JSONL stream or drops it;
- "interesting" retention is bounded by a token bucket (an error storm
  must not become a telemetry storm) and a small uniform baseline keeps a
  trickle of healthy-request traces for comparison. Budget exhaustion
  never starves the baseline; force-retain bypasses the bucket entirely.

Cross-process (the serve plane): the tail-pending bit rides the existing
wire context (``obs/context.py`` flags bit 1), so the front and every
replica a request touches hold their spans pending under the same
trace_id. The root's verdict is formed from what rode the existing reply
path (the INFER reply's shed/deadline/error status IS the front's verdict
on the request) and is *distributed* on the telemetry plane: retained
trace ids ride the ``OP_TELEMETRY`` request (client → front → every
replica via the fleet fan-out), promoting the matching pending spans into
the collected part. Pending traces that never hear a verdict expire after
``MXNET_OBS_TAIL_HOLD_S`` and drop cleanly — a replica buffers briefly,
never forever. Force-retained traces (flags bit 2) skip the pending hop
and stream durably at once on every hop.

Everything here is O(1) per span and bounded: ``MXNET_OBS_TAIL_TRACES``
pending traces of ``MXNET_OBS_TAIL_SPANS`` spans each, oldest evicted
(counted) on overflow.

OpenMetrics exemplars ride along: each retained trace with a latency
verdict stamps itself as the exemplar of the latency-histogram bucket it
landed in, so a p99 bucket in the Prometheus exposition links straight to
a kept trace id.
"""
from __future__ import annotations

import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from . import context as _context
from . import metrics as _metrics
from . import trace as _trace
from ._env import env_float as _env_float, env_int as _env_int

__all__ = ["RetentionPolicy", "TailBuffer", "enabled", "enable", "disable",
           "buffer", "hold", "finish_root", "finish_remote", "resolve",
           "retained_ids", "note", "take_notes", "forced",
           "exemplars_snapshot", "stats", "reset", "EXEMPLAR_HISTOGRAMS"]

# latency histograms that get trace-id exemplars from retained traces
EXEMPLAR_HISTOGRAMS = ("serve.latency_seconds",
                       "fleet.request_latency_seconds")

_OUTCOME_INTERESTING = ("error", "shed", "deadline")


class RetentionPolicy:
    """The keep-or-drop decision as a (nearly) pure function.

    ``decide(duration_s, outcome, flags, forced, now)`` returns
    ``(retain, reason)``. Determinism knobs for tests: pass ``now`` to
    drive the token bucket's clock and ``rng`` (a ``random.Random``) to
    pin the uniform baseline.

    Rules, in order:

    1. ``forced`` → retain ("forced"); never consumes budget;
    2. interesting — outcome in {error, shed, deadline}, a hedged /
       breaker / deadline_exceeded flag, or latency ≥ ``slow_ms`` —
       retains while the token bucket (``budget_per_s`` steady rate,
       ``burst`` cap) has tokens;
    3. the uniform ``baseline`` probability retains regardless (applies
       to fast requests AND to interesting ones past the budget — budget
       exhaustion degrades tail sampling to baseline sampling, never to
       zero);
    4. drop ("fast_path" below the bar, "budget" past it).
    """

    def __init__(self, slow_ms: Optional[float] = None,
                 budget_per_s: Optional[float] = None,
                 burst: Optional[float] = None,
                 baseline: Optional[float] = None,
                 rng: Optional[random.Random] = None):
        self.slow_ms = slow_ms if slow_ms is not None \
            else _env_float("MXNET_OBS_TAIL_SLOW_MS", 250.0)
        self.budget_per_s = budget_per_s if budget_per_s is not None \
            else _env_float("MXNET_OBS_TAIL_BUDGET", 20.0)
        self.burst = float(burst) if burst is not None \
            else max(2.0 * self.budget_per_s, 1.0)
        self.baseline = baseline if baseline is not None \
            else _env_float("MXNET_OBS_TAIL_BASELINE", 0.01)
        self._rng = rng or random.Random(
            int.from_bytes(os.urandom(8), "little"))
        self._tokens = self.burst
        self._refill_at: Optional[float] = None
        self._lock = threading.Lock()

    def _take_token(self, now: float) -> bool:
        with self._lock:
            if self._refill_at is None:
                self._refill_at = now
            self._tokens = min(
                self.burst,
                self._tokens + (now - self._refill_at) * self.budget_per_s)
            self._refill_at = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def decide(self, duration_s: float, outcome: str = "ok",
               flags: Sequence[str] = (), forced: bool = False,
               now: Optional[float] = None) -> Tuple[bool, str]:
        if forced:
            return True, "forced"
        now = time.monotonic() if now is None else now
        reason = None
        if outcome in _OUTCOME_INTERESTING:
            reason = outcome
        elif flags:
            reason = str(next(iter(flags)))
        elif duration_s * 1e3 >= self.slow_ms:
            reason = "slow"
        if reason is not None:
            if self._take_token(now):
                return True, reason
            # budget exhausted: fall through to the baseline — tail
            # sampling degrades to uniform sampling, never to nothing
            if self._rng.random() < self.baseline:
                return True, "baseline"
            return False, "budget"
        if self.baseline > 0.0 and self._rng.random() < self.baseline:
            return True, "baseline"
        return False, "fast_path"


class TailBuffer:
    """Bounded per-trace pending store + retained-verdict log.

    ``hold`` files a span record under its trace id; ``finish`` applies
    the policy at root close (promote or drop); ``resolve`` applies a
    verdict list arriving over the telemetry plane AND expires traces
    past their hold window. All promotion goes through the process-global
    tracer, so promoted spans land in the ring and any attached JSONL
    stream exactly like head-sampled ones.
    """

    def __init__(self, policy: Optional[RetentionPolicy] = None,
                 max_traces: Optional[int] = None,
                 max_spans: Optional[int] = None,
                 hold_s: Optional[float] = None):
        self.policy = policy or RetentionPolicy()
        self.max_traces = max_traces if max_traces is not None \
            else _env_int("MXNET_OBS_TAIL_TRACES", 512)
        self.max_spans = max_spans if max_spans is not None \
            else _env_int("MXNET_OBS_TAIL_SPANS", 256)
        self.hold_s = hold_s if hold_s is not None \
            else _env_float("MXNET_OBS_TAIL_HOLD_S", 20.0)
        # trace_id -> {"recs": [rec], "t0": monotonic}
        self._pending: "OrderedDict[str, dict]" = OrderedDict()
        # recent retained ids (the verdict log distributed over
        # OP_TELEMETRY) and an LRU of ids already settled either way, so
        # a late span / late verdict after expiry resolves cleanly.
        # The log must cover everything the policy can retain within one
        # hold window (budget*hold + burst): a smaller cap forgets
        # verdicts before the telemetry fan-out carries them, and the
        # replicas' held spans for RETAINED traces expire as drops.
        # Bounded above so a test's effectively-infinite budget stays sane
        log_n = int(min(65536.0, max(
            256.0, self.policy.budget_per_s * self.hold_s
            + self.policy.burst + 64.0)))
        self._retained_log: deque = deque(maxlen=log_n)
        self._settled: "OrderedDict[str, bool]" = OrderedDict()
        self._lock = threading.Lock()
        # counters kept unconditionally (STATS works with obs gating off)
        self.retained = 0
        self.dropped = 0
        self.expired = 0
        self.overflow = 0

    # -- span intake ----------------------------------------------------
    def hold(self, trace_id: str, rec: tuple) -> None:
        # lock-free fast path: dict get + list append are GIL-atomic, and
        # EVERY span of EVERY request comes through here under tail mode
        # — a contended lock at this site convoys the whole serve plane.
        # The race it admits (finish() settles the trace between the get
        # and the append → this span misses the promotion flush) is the
        # straggler-drop the verdict plane already tolerates everywhere
        ent = self._pending.get(trace_id)
        if ent is not None:
            recs = ent["recs"]
            if len(recs) < self.max_spans:
                recs.append(rec)
            return
        evicted = 0
        straggler_retained = False
        with self._lock:
            ent = self._pending.get(trace_id)
            if ent is None:
                settled = self._settled.get(trace_id)
                if settled is not None:
                    # verdict already landed (a straggler span racing the
                    # root close / buffer expiry): retained traces take
                    # the span durably, dropped ones drop it — cleanly.
                    # The durable record (ring + JSONL write) happens
                    # OUTSIDE the lock, like every other flush site — a
                    # slow stream write must not convoy hold()/resolve()
                    straggler_retained = settled
                    ent = None
                else:
                    while len(self._pending) >= self.max_traces:
                        self._pending.popitem(last=False)
                        self.overflow += 1
                        evicted += 1
                    ent = self._pending[trace_id] = {
                        "recs": [], "t0": time.monotonic()}
            if ent is not None and len(ent["recs"]) < self.max_spans:
                ent["recs"].append(rec)
        if straggler_retained:
            _trace.tracer._record(rec)
        if evicted:
            self._count("tail.overflow", evicted)

    # -- verdicts -------------------------------------------------------
    def _promote_locked(self, trace_id: str, ent: Optional[dict],
                        retain: bool) -> List[tuple]:
        """Settle one trace (caller holds the lock); returns the records
        to promote (flushed to the tracer OUTSIDE the lock)."""
        self._settled[trace_id] = retain
        while len(self._settled) > 4096:
            self._settled.popitem(last=False)
        if retain:
            self.retained += 1
            self._retained_log.append(trace_id)
            return ent["recs"] if ent else []
        self.dropped += 1
        return []

    def finish(self, trace_id: str, duration_s: float, outcome: str = "ok",
               flags: Sequence[str] = (), forced: bool = False
               ) -> Tuple[bool, str]:
        """Root-span close: apply the policy and settle the trace."""
        retain, reason = self.policy.decide(duration_s, outcome=outcome,
                                            flags=flags, forced=forced)
        with self._lock:
            ent = self._pending.pop(trace_id, None)
            recs = self._promote_locked(trace_id, ent, retain)
        for rec in recs:
            _trace.tracer._record(rec)
        self._count(f"tail.retained.{reason}" if retain
                    else f"tail.dropped.{reason}")
        if retain:
            _record_exemplar(trace_id, duration_s)
        return retain, reason

    def resolve(self, retained_ids: Sequence[str]) -> int:
        """A verdict list from the telemetry plane: promote every pending
        trace named in it, then expire everything past the hold window.
        Ids that already expired here resolve to a no-op (the verdict
        lost the race; the spans are gone — counted, never an error)."""
        promoted = 0
        flush: List[tuple] = []
        with self._lock:
            for tid in retained_ids:
                ent = self._pending.pop(tid, None)
                if ent is None:
                    continue
                flush.extend(self._promote_locked(tid, ent, True))
                promoted += 1
        for rec in flush:
            _trace.tracer._record(rec)
        if promoted:
            self._count("tail.resolved", promoted)
        self.expire()
        return promoted

    def expire(self, now: Optional[float] = None) -> int:
        """Drop pending traces older than the hold window (no verdict is
        a verdict: the root never promoted them)."""
        now = time.monotonic() if now is None else now
        dropped = 0
        with self._lock:
            while self._pending:
                tid, ent = next(iter(self._pending.items()))
                if now - ent["t0"] < self.hold_s:
                    break
                self._pending.popitem(last=False)
                self._promote_locked(tid, None, False)
                self.expired += 1
                dropped += 1
        if dropped:
            self._count("tail.dropped.expired", dropped)
        return dropped

    # -- views ----------------------------------------------------------
    def retained_ids(self) -> List[str]:
        with self._lock:
            return list(self._retained_log)

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> dict:
        with self._lock:
            return {"pending": len(self._pending),
                    "retained": self.retained, "dropped": self.dropped,
                    "expired": self.expired, "overflow": self.overflow,
                    "hold_s": self.hold_s, "max_traces": self.max_traces,
                    "max_spans": self.max_spans}

    def _count(self, name: str, n: int = 1) -> None:
        if _trace._ENABLED:
            _metrics.registry.counter(name).inc(n)


# ---------------------------------------------------------------------------
# module state — the process-global buffer + thread-local outcome notes
# ---------------------------------------------------------------------------

_buffer: Optional[TailBuffer] = None
_tls = threading.local()
# exemplars: {histogram_name: {bucket_upper_repr: {"trace_id", "value",
# "ts"}}} — the most recent retained trace per latency bucket
_exemplars: Dict[str, Dict[str, dict]] = {}
_ex_lock = threading.Lock()


def enabled() -> bool:
    return _buffer is not None


def buffer() -> Optional[TailBuffer]:
    return _buffer


def enable(policy: Optional[RetentionPolicy] = None, **buffer_kw
           ) -> TailBuffer:
    """Turn tail mode on: new trace roots carry the tail-pending bit,
    spans route into the pending buffer, and root closes apply the
    retention policy. Implies nothing about ``obs.enable()`` — tail mode
    only matters while telemetry records at all."""
    global _buffer
    _buffer = TailBuffer(policy=policy, **buffer_kw)
    _context.set_tail_mode(True)
    _trace._TAIL_SINK = _buffer.hold
    return _buffer


def disable() -> None:
    global _buffer
    _context.set_tail_mode(False)
    _trace._TAIL_SINK = None
    _buffer = None


def reset() -> None:
    """Fresh buffer (same config) + cleared exemplars/notes (tests)."""
    global _buffer
    if _buffer is not None:
        _buffer = TailBuffer(policy=_buffer.policy,
                             max_traces=_buffer.max_traces,
                             max_spans=_buffer.max_spans,
                             hold_s=_buffer.hold_s)
        _trace._TAIL_SINK = _buffer.hold
    with _ex_lock:
        _exemplars.clear()
    if getattr(_tls, "notes", None):
        _tls.notes = None


def hold(trace_id: str, rec: tuple) -> None:
    b = _buffer
    if b is not None:
        b.hold(trace_id, rec)


# -- thread-local outcome notes (set on the request's own thread between
# root open and root close: shed/deadline branches, hedge/breaker events)

def note(outcome: Optional[str] = None, **flags) -> None:
    """Annotate the current thread's in-flight root: an outcome
    ("error"/"shed"/"deadline") and/or boolean flags ("hedged",
    "breaker"). Read + cleared by :func:`finish_root`. No-op with tail
    mode off — a note written while nothing will ever consume it would
    sit in this thread's TLS and contaminate the first request after a
    later ``enable()``."""
    if _buffer is None:
        return
    n = getattr(_tls, "notes", None)
    if n is None:
        n = _tls.notes = {"outcome": None, "flags": set()}
    if outcome is not None:
        n["outcome"] = outcome
    for k, v in flags.items():
        if v:
            n["flags"].add(k)


def take_notes() -> Tuple[Optional[str], set]:
    n = getattr(_tls, "notes", None)
    _tls.notes = None
    if n is None:
        return None, set()
    return n["outcome"], n["flags"]


class forced:
    """``with obs.tail.forced(): client.infer(...)`` — roots born in the
    block carry the force-retain bit: recorded durably at once on every
    hop, no pending buffer, no budget (the "keep THIS one" escape hatch
    for repro runs)."""

    def __enter__(self):
        self._prev = _context.get_force_retain()
        _context.set_force_retain(True)
        return self

    def __exit__(self, *exc):
        _context.set_force_retain(self._prev)
        return False


def finish_root(ctx, duration_s: float, outcome: Optional[str] = None
                ) -> Optional[Tuple[bool, str]]:
    """Called where a tail-mode root was born, when it closes. Merges the
    explicit ``outcome`` with the thread-local notes and applies the
    policy. No-op (None) for non-tail contexts or with tail mode off."""
    noted_outcome, flags = take_notes()
    if ctx is None or not (getattr(ctx, "tail", False)
                           or getattr(ctx, "force", False)):
        return None
    b = _buffer
    if b is None:
        return None
    if getattr(ctx, "force", False):
        # already durably recorded span by span; log the verdict so the
        # telemetry plane distributes it to the other hops' buffers
        with b._lock:
            recs = b._promote_locked(ctx.trace_id, None, True)
        for rec in recs:  # pragma: no cover — force traces never pend
            _trace.tracer._record(rec)
        b._count("tail.retained.forced")
        _record_exemplar(ctx.trace_id, duration_s)
        return True, "forced"
    return b.finish(ctx.trace_id, duration_s,
                    outcome=outcome or noted_outcome or "ok",
                    flags=sorted(flags))


def finish_remote(ctx, duration_s: float) -> Optional[Tuple[bool, str]]:
    """A NON-root hop's request end (the serve front handling a
    client-rooted trace). The verdict belongs to the remote root — but
    the root never sees this hop's thread-local notes: a hedge or
    breaker trip happens at the router, *after* the reply status the
    root will decide from was already determined. Flags noted here make
    the trace interesting locally: apply the policy with them, and a
    retain settles THIS hop's pending spans durably and logs the verdict
    so the telemetry fan-out promotes the replicas' too (the root's own
    rpc span still follows the root's verdict — an unavoidable
    asymmetry without widening the reply frame). Outcome notes
    (shed/deadline/error) are NOT re-decided here: they rode the reply
    status to the root, whose verdict stays authoritative — deciding
    them twice would spend retention budget twice. Always clears the
    thread's notes (they must never leak into the next request)."""
    noted_outcome, flags = take_notes()
    b = _buffer
    if (b is None or ctx is None or not getattr(ctx, "tail", False)
            or getattr(ctx, "force", False) or not flags):
        return None
    retain, reason = b.policy.decide(duration_s, outcome="ok",
                                     flags=sorted(flags))
    if not retain:
        # leave the trace pending: the root's verdict (slow/error at the
        # client) may still promote it before the hold window closes
        return None
    with b._lock:
        ent = b._pending.pop(ctx.trace_id, None)
        recs = b._promote_locked(ctx.trace_id, ent, True)
    for rec in recs:
        _trace.tracer._record(rec)
    b._count(f"tail.retained.{reason}")
    _record_exemplar(ctx.trace_id, duration_s)
    return True, reason


def resolve(retained_ids: Sequence[str]) -> int:
    """Apply a verdict list arriving over the telemetry plane."""
    b = _buffer
    if b is None or not retained_ids:
        return 0
    return b.resolve(list(retained_ids))


def retained_ids() -> List[str]:
    b = _buffer
    return b.retained_ids() if b is not None else []


def stats() -> Optional[dict]:
    b = _buffer
    return b.stats() if b is not None else None


# ---------------------------------------------------------------------------
# OpenMetrics exemplars — retained trace ids pinned to latency buckets
# ---------------------------------------------------------------------------

def _record_exemplar(trace_id: str, duration_s: float) -> None:
    """Stamp ``trace_id`` as the exemplar of the bucket ``duration_s``
    lands in, for every configured latency histogram that exists in the
    registry — the exposition then links a p99 bucket straight to a kept
    tail trace."""
    if duration_s is None:
        return
    for name in EXEMPLAR_HISTOGRAMS:
        h = _metrics.registry.get(name)
        if h is None or not hasattr(h, "buckets"):
            continue
        le = "+Inf"
        for b in h.buckets:
            if duration_s <= b:
                le = repr(b)
                break
        with _ex_lock:
            _exemplars.setdefault(name, {})[le] = {
                "trace_id": trace_id, "value": round(float(duration_s), 6),
                "ts": time.time()}


def exemplars_snapshot() -> Dict[str, Dict[str, dict]]:
    """``{histogram_name: {le: {"trace_id", "value", "ts"}}}`` — shipped
    in the telemetry part, rendered by ``obs/export.py``."""
    with _ex_lock:
        return {name: dict(by_le) for name, by_le in _exemplars.items()}


def set_buffer(b: Optional[TailBuffer]) -> None:
    """Swap the process buffer (tests)."""
    global _buffer
    _buffer = b
    _trace._TAIL_SINK = b.hold if b is not None else None
    _context.set_tail_mode(b is not None)
