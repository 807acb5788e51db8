"""Distributed trace context — one trace_id across client, router, and
every replica (counterpart of ``mxnet_tpu/obs/context.py``, byte for byte
on the wire).

The tracer (``obs/trace.py``) is per-process: spans nest on a thread-local
stack and land in that process's ring buffer. One INFER crosses 3+
processes (client → FleetServer front → ProcReplica over the serve wire),
so the per-process timelines are fragments of the same request. This
module stitches them: a W3C-traceparent-style
context (``trace_id``, parent ``span_id``, sampled flag) that

- rides the **existing wire framing's key field** (``u16 key_len | key`` —
  empty on every serve opcode, the parameter name on PS RPCs), appended
  after an ASCII unit separator (``\\x1f``). Old-format frames have no
  separator and parse unchanged (context optional, absent = new root at
  the server); a context-bearing key is split before any key lookup, so
  the server *strips* context it does not want. No frame layout changed.
- is carried per **thread** (the tracer's nesting idiom): ``use(ctx)``
  activates a context for a block, every span opened inside allocates a
  child ``span_id`` and re-activates itself, so remote children hang off
  the exact span that sent the RPC.
- implements **head-based sampling**: the decision is made ONCE where the
  trace is born (``new_root()``) and propagated in the flags byte —
  ``MXNET_OBS_SAMPLE=0.1`` traces 1 request in 10 end to end and the other
  9 cost one thread-local read per span site on every hop. That is what
  lets tracing stay on under production load (the ``obs_overhead_pct``
  bench gain measures it).

Wire header format (W3C traceparent, version 00)::

    00-<32 hex trace_id>-<16 hex span_id>-<2 hex flags>

flags bit 0 = sampled. Unknown versions/garbage parse to ``None`` (treated
as absent — a malformed header must never fail an RPC).

``MXNET_OBS_WIRE=0`` suppresses injection entirely (escape hatch for
peers that predate context, e.g. the native C++ PS server, which would
treat a suffixed key as a different parameter).
"""
from __future__ import annotations

import os
import random
import re
import threading
from typing import Optional, Tuple

__all__ = ["TraceContext", "current", "use", "new_root", "new_span_id",
           "new_trace_id", "from_header", "inject_key", "extract_key",
           "sample_rate", "set_sample_rate", "set_tail_mode", "tail_mode",
           "set_force_retain", "get_force_retain", "CTX_SEP"]

# ASCII unit separator: cannot appear in a sane parameter name, invisible
# to old parsers (they see one longer key only if a NEW client talks to an
# OLD server — which MXNET_OBS_WIRE=0 exists for)
CTX_SEP = "\x1f"

_HEADER_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# head-based sampling rate for NEW roots (children inherit the flag)
_sample_rate = 1.0
_v = os.environ.get("MXNET_OBS_SAMPLE")
if _v:
    try:
        _sample_rate = min(max(float(_v), 0.0), 1.0)
    except ValueError:
        pass

# escape hatch: never put context on the wire (old peers)
_WIRE = os.environ.get("MXNET_OBS_WIRE", "1").lower() not in (
    "0", "false", "no", "off")

# tail mode (obs/tail.py): new roots carry the TAIL flag — spans record
# into the pending buffer and the keep-or-drop decision moves to root
# close. Flipped by tail.enable()/disable(); this module only owns the bit
_tail_mode = False

_local = threading.local()
_rng = random.Random(int.from_bytes(os.urandom(8), "little"))


def set_tail_mode(on: bool) -> None:
    global _tail_mode
    _tail_mode = bool(on)


def tail_mode() -> bool:
    return _tail_mode


def set_force_retain(on: bool) -> None:
    """Thread-local force-retain: roots born while set carry the FORCE
    flag (recorded durably on every hop, bypassing the tail policy)."""
    _local.force = bool(on)


def get_force_retain() -> bool:
    return getattr(_local, "force", False)


def sample_rate() -> float:
    return _sample_rate


def set_sample_rate(rate: float) -> None:
    """Set the head-sampling probability for new roots (0.0–1.0)."""
    global _sample_rate
    _sample_rate = min(max(float(rate), 0.0), 1.0)


def _id_rng() -> random.Random:
    # one PRNG per thread, OS-seeded once: a urandom SYSCALL per id was
    # the single hottest instruction on the span path (36% of it), and
    # under tail mode every request mints a root — tolerable at
    # head-sample 0.1, not at record-everything. 128 bits of OS entropy
    # seed each thread's stream; ids only need uniqueness, not secrecy.
    r = getattr(_local, "idrng", None)
    if r is None:
        r = _local.idrng = random.Random(
            int.from_bytes(os.urandom(16), "little"))
    return r


def new_trace_id() -> str:
    return f"{_id_rng().getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_id_rng().getrandbits(64):016x}"


class TraceContext:
    """An immutable (trace_id, span_id, flags) triple. ``span_id`` is
    the *current parent*: a span opened under this context records it as
    its parent and substitutes its own id for the duration.

    Flags (the wire header's 2-hex byte): bit 0 ``sampled`` (head-based —
    record durably on every hop), bit 1 ``tail`` (tail-pending: record
    into the pending buffer, verdict at root close — obs/tail.py), bit 2
    ``force`` (force-retain: record durably AND log a retain verdict)."""

    __slots__ = ("trace_id", "span_id", "sampled", "tail", "force")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True,
                 tail: bool = False, force: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)
        self.tail = bool(tail)
        self.force = bool(force)

    def child(self) -> "TraceContext":
        """Same trace, fresh span id, inherited sampling decision."""
        return TraceContext(self.trace_id, new_span_id(), self.sampled,
                            tail=self.tail, force=self.force)

    @property
    def records(self) -> bool:
        """Does a span under this context record at all (durably or
        pending)? The span-site gate: NOT records → shared no-op."""
        return self.sampled or self.tail or self.force

    def to_header(self) -> str:
        flags = ((0x01 if self.sampled else 0)
                 | (0x02 if self.tail else 0)
                 | (0x04 if self.force else 0))
        return f"00-{self.trace_id}-{self.span_id}-{flags:02x}"

    def __repr__(self):
        return (f"TraceContext({self.trace_id[:8]}…/{self.span_id}, "
                f"sampled={self.sampled}, tail={self.tail}, "
                f"force={self.force})")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.sampled == other.sampled
                and self.tail == other.tail
                and self.force == other.force)


def from_header(header: str) -> Optional[TraceContext]:
    """Parse a traceparent header; tolerant — anything malformed is
    ``None`` (absent), never an error."""
    if not header:
        return None
    m = _HEADER_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None  # the spec's all-zero ids are invalid
    try:
        bits = int(flags, 16)
    except ValueError:
        return None
    return TraceContext(trace_id, span_id, bool(bits & 0x01),
                        tail=bool(bits & 0x02), force=bool(bits & 0x04))


def new_root(sampled: Optional[bool] = None) -> TraceContext:
    """Start a new trace. The head-based sampling decision happens HERE
    and only here — every downstream hop inherits the flag. Under tail
    mode (obs/tail.py) the decision MOVES to root close instead: the root
    carries the tail-pending bit, spans record into the pending buffer,
    and the retention policy rules when the root span closes. A
    force-retain block (``tail.forced()``) records durably at once."""
    if get_force_retain():
        return TraceContext(new_trace_id(), new_span_id(), True, force=True)
    if _tail_mode:
        return TraceContext(new_trace_id(), new_span_id(), False, tail=True)
    if sampled is None:
        rate = _sample_rate
        sampled = rate >= 1.0 or (rate > 0.0 and _rng.random() < rate)
    return TraceContext(new_trace_id(), new_span_id(), sampled)


def current() -> Optional[TraceContext]:
    """The thread's active context (None outside any traced flow)."""
    return getattr(_local, "ctx", None)


def _set(ctx: Optional[TraceContext]) -> None:
    _local.ctx = ctx


class use:
    """``with context.use(ctx): ...`` — activate ``ctx`` on this thread
    for the block. ``use(None)`` is a no-op (so call sites need no branch).
    Plain class, not a generator: this sits on the per-RPC hot path."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self.ctx = ctx

    def __enter__(self):
        if self.ctx is not None:
            self._prev = getattr(_local, "ctx", None)
            _local.ctx = self.ctx
        return self.ctx

    def __exit__(self, *exc):
        if self.ctx is not None:
            _local.ctx = self._prev
        return False


# ---------------------------------------------------------------------------
# wire key injection — context through the existing framing, zero layout
# change
# ---------------------------------------------------------------------------

def inject_key(key: str, ctx: Optional[TraceContext]) -> str:
    """Append ``ctx`` to a frame's key field (``key\\x1fheader``). With no
    context — or with ``MXNET_OBS_WIRE=0`` — the key goes out untouched,
    byte-identical to the old wire format."""
    if ctx is None or not _WIRE:
        return key
    return key + CTX_SEP + ctx.to_header()


def extract_key(key: str) -> Tuple[str, Optional[TraceContext]]:
    """Split a received key into ``(clean_key, ctx_or_None)``. Servers call
    this FIRST, before any key lookup — so a context-stripping server and
    an old-format client are the same code path (no separator → no
    context)."""
    i = key.find(CTX_SEP)
    if i < 0:
        return key, None
    return key[:i], from_header(key[i + 1:])
