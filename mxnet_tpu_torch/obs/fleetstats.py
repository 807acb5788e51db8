"""Training-fleet telemetry plane: per-rank step attribution, straggler
blame, reduce-plane accounting (counterpart of
``mxnet_tpu/obs/fleetstats.py``).

- :class:`StepAccounting`: windowed per-rank step-phase accounting. The
  fit loop's phase spans (``data_wait`` / ``forward`` / ``backward`` /
  ``elastic.sync_grads`` / ``update`` / ``metric`` / ``checkpoint``) are
  emitted through :func:`phase`, which wraps the ordinary
  ``obs.trace.span`` (same names, same timeline) and folds the durations
  into per-window summaries (``MXNET_OBS_FLEET_WINDOW`` steps a window)
  and ``train.step.*`` histograms. Sealed windows ship to the PS server
  on the worker's heartbeats: no new connection, no new RPC.
- :class:`StragglerDetector`: a pure decision function over the fleet's
  windowed per-rank step times. Elastic ``dist_sync`` is lockstep, so a
  straggler drags every rank's step time up and a raw comparison sees
  nothing; the detector compares each rank's **own time** (step time
  minus reduce-wait). A rank lagging the median of the others by
  ``factor`` for ``k`` consecutive windows is flagged, with the phase
  blamed (compute, data-wait, reduce-wait or host) by its largest excess
  over the fleet median. Hysteresis both ways: flagging needs ``k``
  lagging windows, clearing ``k`` windows below the lower recovery
  threshold.
- :class:`FleetAggregator`: the PS server's side. It caches each worker's
  piggybacked parts, aligns windows by index, runs the detector and
  surfaces verdicts as ``train.straggler.*`` metrics, obs events, an
  entry of the server's STATS and ``on_straggler`` callbacks (the async
  staleness policy of ``kvstore/ps_server.py``).
- :class:`HotKeyTable`: bounded top-N per-key push accounting (pushes,
  bytes, apply time) with space-saving admission.
- :func:`collect`: one ``OP_TELEMETRY`` pull against a PS server: the
  server's own part (its RPC lanes) and every cached worker part, which
  ``tools/train_report.py`` / ``tools/fleet_report.py --ps`` merge into
  one chrome timeline on the wall-clock anchors.

Gated by the one ``MXNET_OBS`` switch (no cost when off);
``MXNET_OBS_FLEET=0`` vetoes just this plane. ``tools/elastic_bench.py
--train-obs`` measures its overhead.

On a card, the module's ``backward`` phase ends with a stream synchronize
while this plane records (``module/base_module.py``): the forward and
backward launches return once queued, and the device time would otherwise
land in the next host read, the gradient sync, booked as reduce-wait.
"""
from __future__ import annotations

import json
import os
import statistics
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

from . import context as _context
from . import metrics as _metrics
from . import trace as _trace
from ._env import env_float, env_int

__all__ = ["StepAccounting", "StragglerDetector", "FleetAggregator",
           "HotKeyTable", "phase", "step_complete", "set_rank", "rank",
           "flush", "wire_part", "enabled", "categorize",
           "summarize_windows", "collect", "PHASE_BLAME",
           "BLAME_CATEGORIES", "reset"]

# span name -> blame category. Spans emitted by the fit loop keep their
# historical names (test_obs asserts them); the detector reasons in the
# four blame categories. Unknown phases fold into "host".
PHASE_BLAME = {
    "data_wait": "data_wait",
    "forward": "compute",
    "backward": "compute",
    "update": "compute",
    "elastic.sync_grads": "reduce_wait",
    "grad_sync": "reduce_wait",
    "kvstore.rpc": "reduce_wait",
    "metric": "host",
    "checkpoint": "host",
}
BLAME_CATEGORIES = ("data_wait", "compute", "reduce_wait", "host")


_VETO_CACHE = (None, False)  # (raw env string, parsed) — phase() is hot


def _fleet_veto() -> bool:
    global _VETO_CACHE
    raw = os.environ.get("MXNET_OBS_FLEET")
    if raw != _VETO_CACHE[0]:
        _VETO_CACHE = (raw, (raw or "").lower() in
                       ("0", "false", "no", "off"))
    return _VETO_CACHE[1]


def enabled() -> bool:
    """Fleet accounting records iff telemetry is on and not vetoed."""
    return _trace._ENABLED and not _fleet_veto()


def summarize_windows(wins) -> Optional[dict]:
    """Step-weighted per-rank summary over a window list: total steps,
    average step time, and the blame-category breakdown. ONE helper for
    the server's STATS and train_report's fallback path, so the report a
    dead server's ``--input`` doc renders can never diverge from the
    live STATS numbers. None when the windows carry no steps."""
    wins = list(wins or ())
    steps = sum(int(w.get("steps", 0)) for w in wins)
    if not steps:
        return None
    tsum = sum(float(w.get("step_time", 0.0)) * int(w.get("steps", 0))
               for w in wins)
    cats = {c: 0.0 for c in BLAME_CATEGORIES}
    for w in wins:
        c = categorize(w)
        for k in cats:
            cats[k] += c[k] * int(w.get("steps", 0))
    return {"windows": len(wins), "steps": steps,
            "step_time_avg": round(tsum / steps, 6),
            "phases": {k: round(v / steps, 6) for k, v in cats.items()}}


def categorize(window: dict) -> Dict[str, float]:
    """A window's per-step phase averages folded into the four blame
    categories; unaccounted step time (callbacks, health sampling, python
    overhead) lands in ``host``."""
    phases = window.get("phases") or {}
    cats = {c: 0.0 for c in BLAME_CATEGORIES}
    for name, v in phases.items():
        cats[PHASE_BLAME.get(name, "host")] += float(v)
    resid = float(window.get("step_time", 0.0)) - sum(
        float(v) for v in phases.values())
    cats["host"] += max(0.0, resid)
    return cats


# ---------------------------------------------------------------------------
# worker side: windowed per-rank step-phase accounting
# ---------------------------------------------------------------------------

class _PhaseCtx:
    """Wraps the ordinary obs span: same name on the timeline, duration
    additionally folded into the step accounting — and the chaos straggler
    injector's delay (``MXNET_CHAOS_SLOW``) fires INSIDE the span, so the
    injected lag is visible as the stretched phase it blames."""

    __slots__ = ("_acc", "_name", "_span", "_t0", "_chaos")

    def __init__(self, acc, name, span, chaos):
        self._acc = acc
        self._name = name
        self._span = span
        self._chaos = chaos

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        if self._chaos is not None:
            self._chaos.maybe_delay(self._name)
        if self._acc is not None:
            self._acc._add_phase(self._name,
                                 time.monotonic() - self._t0)
        return self._span.__exit__(*exc)


_CHAOS_SLOW = None  # resolved lazily: chaos imports obs at package import


def _chaos_slow_mod():
    global _CHAOS_SLOW
    if _CHAOS_SLOW is None:
        from ..chaos import slow as _slow

        _CHAOS_SLOW = _slow
    return _CHAOS_SLOW


class StepAccounting:
    """Per-rank windowed step-phase accumulator.

    One instance per rank: the module-level singleton backs the real fit
    loop; tests and in-process benches construct one per simulated rank
    (then ``own_spans=False`` keeps them from fighting over the process's
    one tracer ring / metrics registry).
    """

    def __init__(self, rank: Optional[int] = None,
                 window: Optional[int] = None, own_spans: bool = True,
                 ship_interval_s: Optional[float] = None):
        self._rank = rank
        self.window = int(window if window is not None
                          else env_int("MXNET_OBS_FLEET_WINDOW", 10))
        self.own_spans = own_spans
        self._ship_s = float(ship_interval_s if ship_interval_s is not None
                             else env_float("MXNET_OBS_FLEET_SHIP_S", 2.0))
        self._max_spans = env_int("MXNET_OBS_FLEET_MAX_SPANS", 4096)
        self._lock = threading.Lock()
        self._reset_state()

    def _reset_state(self):
        self._step_phases: Dict[str, float] = {}
        self._last_step_t: Optional[float] = None
        self._cur_idx: Optional[int] = None
        self._cur = None  # (steps, time_sum, {phase: sum})
        self.windows: deque = deque(maxlen=256)  # sealed, local history
        self._ship: deque = deque(maxlen=256)    # sealed, not yet shipped
        self._last_ship = 0.0
        self._hists: Dict[str, object] = {}  # phase-name -> Histogram

    # -- identity --------------------------------------------------------
    @property
    def rank(self) -> int:
        if self._rank is None:
            self._rank = int(os.environ.get(
                "DMLC_WORKER_ID", os.environ.get("MXNET_WORKER_ID", 0))
                or 0)
        return self._rank

    def set_rank(self, r: int) -> None:
        self._rank = int(r)

    # -- hot path --------------------------------------------------------
    def phase(self, name: str, **attrs):
        """Context manager: the ordinary ``obs.trace.span(name)`` plus
        step accounting (when this plane records) plus the deterministic
        straggler injector's delay point. One flag check each when all
        three are off."""
        mod = _chaos_slow_mod()
        chaos = mod if mod.enabled() else None
        acc = self if enabled() else None
        span = _trace.span(name, **attrs)
        if acc is None and chaos is None:
            return span
        return _PhaseCtx(acc, name, span, chaos)

    def _add_phase(self, name: str, dt: float) -> None:
        self._step_phases[name] = self._step_phases.get(name, 0.0) + dt

    def step_complete(self, step: int) -> None:
        """Close one optimizer step: fold its phases into the current
        window, sealing (and queueing for shipment) when ``step`` crosses
        a window boundary. Step time is wall time since the previous
        ``step_complete`` — callbacks and everything else between phases
        land in the ``host`` residual."""
        if not enabled():
            self._step_phases = {}
            self._last_step_t = None
            return
        now = time.monotonic()
        phases, self._step_phases = self._step_phases, {}
        if self._last_step_t is not None:
            step_time = now - self._last_step_t
        else:
            step_time = sum(phases.values())
        self._last_step_t = now
        idx = (int(step) - 1) // self.window if step > 0 else 0
        if self._cur_idx is None:
            self._cur_idx = idx
        if idx != self._cur_idx:
            self._seal()
            self._cur_idx = idx
        if self._cur is None:
            self._cur = [0, 0.0, {}]
        self._cur[0] += 1
        self._cur[1] += step_time
        for name, dt in phases.items():
            self._cur[2][name] = self._cur[2].get(name, 0.0) + dt
        # per-step histograms (the metric-catalog surface; windows are the
        # wire surface) — Histogram objects cached per name so the hot
        # path skips the registry lookup and the f-string
        hists = self._hists
        h = hists.get("")
        if h is None:
            h = hists[""] = _metrics.registry.histogram(
                "train.step.seconds")
        h.observe(step_time)
        for name, dt in phases.items():
            h = hists.get(name)
            if h is None:
                h = hists[name] = _metrics.registry.histogram(
                    f"train.step.{name}_seconds")
            h.observe(dt)

    def _seal(self) -> None:
        """Close the current window into the sealed/ship queues."""
        if self._cur is None or not self._cur[0]:
            self._cur = None
            return
        steps, total, phases = self._cur
        win = {"w": int(self._cur_idx or 0), "steps": steps,
               "step_time": total / steps,
               "phases": {k: v / steps for k, v in phases.items()},
               "t": time.time()}
        self._cur = None
        with self._lock:
            self.windows.append(win)
            self._ship.append(win)

    def flush(self) -> None:
        """Seal a partial window (end of fit / bench segment)."""
        self._seal()
        self._cur_idx = None
        self._last_step_t = None

    # -- shipping (called from the Heartbeater thread) -------------------
    def wire_part(self) -> Optional[bytes]:
        """The piggyback payload for the next heartbeat: sealed unshipped
        windows plus (for the rank's real accounting) the drained span
        ring, metrics snapshot, and clock anchor — i.e. this rank's
        telemetry part, shipped incrementally. Returns None when there is
        nothing new and the ship interval hasn't elapsed (the common
        heartbeat pays one lock + two compares)."""
        if not enabled():
            return None
        now = time.monotonic()
        with self._lock:
            has_windows = bool(self._ship)
            if not has_windows and now - self._last_ship < self._ship_s:
                return None
            wins = list(self._ship)
            self._ship.clear()
            self._last_ship = now
        part = {"rank": self.rank, "pid": os.getpid(),
                "wall_epoch": _trace.tracer.wall_epoch, "windows": wins}
        if self.own_spans:
            spans = _trace.tracer.drain()
            if len(spans) > self._max_spans:
                spans = spans[-self._max_spans:]
            part["spans"] = spans
            part["metrics"] = _metrics.snapshot()
        try:
            return json.dumps(part, default=float).encode("utf-8")
        except (TypeError, ValueError):
            return None


# the rank's real accounting — Module.fit and the elastic session use it
_ACC = StepAccounting()


def phase(name: str, **attrs):
    return _ACC.phase(name, **attrs)


def step_complete(step: int) -> None:
    _ACC.step_complete(step)


def set_rank(r: int) -> None:
    _ACC.set_rank(r)


def rank() -> int:
    return _ACC.rank


def flush() -> None:
    _ACC.flush()


def wire_part() -> Optional[bytes]:
    return _ACC.wire_part()


def reset() -> None:
    _ACC._reset_state()


# ---------------------------------------------------------------------------
# the pure decision function
# ---------------------------------------------------------------------------

def _median(vals: List[float]) -> float:
    return statistics.median(vals) if vals else 0.0


class StragglerDetector:
    """Flag a lagging rank and blame the phase — a pure function over
    windowed per-rank step summaries, no wire, no clock, no globals.

    Per window index, call :meth:`observe` with ``{rank: window}`` where a
    window is ``{"steps", "step_time", "phases": {span_name: s}}`` (the
    :class:`StepAccounting` schema). Returns the list of NEW verdicts:
    ``{"kind": "straggler"|"recovered", "rank", "window", "streak",
    "ratio", "blame", ...}``.

    Lag metric: *own time* (step time minus reduce-wait) against the
    median of the OTHER ranks' own time — under lockstep sync every rank's
    raw step time equals the slowest rank's, so raw comparison is blind;
    own time isolates each rank's contribution. A rank whose raw step
    time AND reduce-wait both lag the fleet (without its own time
    lagging) is flagged with ``blame="reduce_wait"`` — the async-mode
    shape where one rank's RPC path (not its compute) is slow.

    Hysteresis: flag at ``k`` consecutive lagging windows; clear only
    after ``k`` consecutive windows below the recovery threshold
    (``1 + (factor-1)/2``) — a rank oscillating around ``factor`` cannot
    flap the verdict.
    """

    def __init__(self, factor: Optional[float] = None,
                 k: Optional[int] = None, min_ranks: int = 2):
        self.factor = float(factor if factor is not None
                            else env_float("MXNET_OBS_FLEET_FACTOR", 1.5))
        self.k = int(k if k is not None
                     else env_int("MXNET_OBS_FLEET_K", 3))
        self.min_ranks = max(2, int(min_ranks))
        self.recover = 1.0 + (self.factor - 1.0) / 2.0
        self._streak: Dict[int, int] = {}
        self._clear_streak: Dict[int, int] = {}
        self._blames: Dict[int, Dict[str, int]] = {}
        self.flagged: Dict[int, dict] = {}  # rank -> live verdict

    def observe(self, index: int, per_rank: Dict[int, dict]) -> List[dict]:
        events: List[dict] = []
        usable = {r: w for r, w in per_rank.items()
                  if w and w.get("steps")}
        if len(usable) < self.min_ranks:
            return events
        cats = {r: categorize(w) for r, w in usable.items()}
        own = {r: max(1e-9, usable[r]["step_time"]
                      - cats[r]["reduce_wait"]) for r in usable}
        raw = {r: float(usable[r]["step_time"]) for r in usable}
        for r in sorted(usable):
            others = [o for o in usable if o != r]
            med_own = max(_median([own[o] for o in others]), 1e-9)
            ratio = own[r] / med_own
            lagging = ratio >= self.factor
            blame = None
            if lagging:
                med_cat = {c: _median([cats[o][c] for o in others])
                           for c in ("data_wait", "compute", "host")}
                excess = {c: cats[r][c] - med_cat[c]
                          for c in ("data_wait", "compute", "host")}
                blame = max(excess, key=lambda c: excess[c])
            else:
                raw_ratio = raw[r] / max(
                    _median([raw[o] for o in others]), 1e-9)
                red_ratio = cats[r]["reduce_wait"] / max(
                    _median([cats[o]["reduce_wait"] for o in others]),
                    1e-9)
                if raw_ratio >= self.factor and red_ratio >= self.factor:
                    lagging, ratio, blame = True, raw_ratio, "reduce_wait"
            if lagging:
                self._clear_streak[r] = 0
                self._streak[r] = self._streak.get(r, 0) + 1
                bl = self._blames.setdefault(r, {})
                bl[blame] = bl.get(blame, 0) + 1
                if r in self.flagged:
                    v = self.flagged[r]
                    v["windows"] = v.get("windows", 0) + 1
                    v["ratio"] = round(ratio, 3)
                elif self._streak[r] >= self.k:
                    verdict = {
                        "kind": "straggler", "rank": r, "window": index,
                        "streak": self._streak[r],
                        "ratio": round(ratio, 3),
                        "blame": max(bl, key=lambda c: bl[c]),
                        "step_time": round(raw[r], 6),
                        "own_time": round(own[r], 6),
                        "fleet_median_own": round(med_own, 6),
                        "phases": {c: round(cats[r][c], 6)
                                   for c in BLAME_CATEGORIES},
                        "windows": self._streak[r]}
                    self.flagged[r] = verdict
                    events.append(dict(verdict))
            else:
                self._streak[r] = 0
                if r in self.flagged:
                    if ratio < self.recover:
                        cs = self._clear_streak.get(r, 0) + 1
                        self._clear_streak[r] = cs
                        if cs >= self.k:
                            v = self.flagged.pop(r)
                            self._blames.pop(r, None)
                            self._clear_streak[r] = 0
                            events.append({
                                "kind": "recovered", "rank": r,
                                "window": index,
                                "ratio": round(ratio, 3),
                                "was_blamed": v.get("blame")})
                    else:
                        self._clear_streak[r] = 0  # between recover and
                        # factor: neither extends the lag streak nor
                        # counts toward clearing — the flap guard
                else:
                    self._blames.pop(r, None)
        return events


# ---------------------------------------------------------------------------
# reduce-plane accounting: bounded top-N hot keys (space-saving admission)
# ---------------------------------------------------------------------------

class HotKeyTable:
    """Bounded per-key push accounting. At capacity, a new key evicts the
    coldest entry and inherits its push count + 1 (the space-saving
    sketch), so genuinely hot keys can still surface after the table
    filled while ``len(table)`` never exceeds ``capacity``. Counts for
    late-admitted keys are therefore upper bounds — the table answers
    "which keys are hot", not exact ledgers."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = int(capacity if capacity is not None
                            else env_int("MXNET_OBS_FLEET_HOT_KEYS", 32))
        self._lock = threading.Lock()
        self._t: Dict[str, dict] = {}
        self._t0 = time.monotonic()

    def __len__(self) -> int:
        return len(self._t)

    def record(self, key: str, nbytes: int, apply_s: float = 0.0) -> None:
        with self._lock:
            e = self._t.get(key)
            if e is None:
                inherited = 0
                if len(self._t) >= self.capacity:
                    coldest = min(self._t, key=lambda k:
                                  self._t[k]["pushes"])
                    inherited = self._t.pop(coldest)["pushes"]
                e = self._t[key] = {"pushes": inherited, "bytes": 0,
                                    "apply_s": 0.0}
            e["pushes"] += 1
            e["bytes"] += int(nbytes)
            e["apply_s"] += float(apply_s)

    def snapshot(self, n: Optional[int] = None) -> List[dict]:
        """Top-N by push count, with rates over the table's lifetime."""
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        with self._lock:
            rows = [{"key": k, "pushes": e["pushes"], "bytes": e["bytes"],
                     "push_rate": round(e["pushes"] / elapsed, 3),
                     "apply_ms_avg": round(
                         e["apply_s"] / max(e["pushes"], 1) * 1e3, 3)}
                    for k, e in self._t.items()]
        rows.sort(key=lambda r: (-r["pushes"], r["key"]))
        return rows[:n] if n else rows


# ---------------------------------------------------------------------------
# server side: cache worker parts, run the detector, surface verdicts
# ---------------------------------------------------------------------------

def _sanitize_window(w) -> Optional[dict]:
    """A piggybacked window with coerced numerics, or None when garbage.
    Validation happens at INGEST so a version-skewed or buggy worker can
    neither poison the cache nor crash the detector later — ``add_part``'s
    contract is that telemetry never breaks a heartbeat."""
    try:
        out = {"w": int(w["w"]), "steps": int(w.get("steps", 0)),
               "step_time": float(w.get("step_time", 0.0)),
               "phases": {str(k): float(v)
                          for k, v in (w.get("phases") or {}).items()}}
        if "t" in w and w["t"] is not None:
            out["t"] = float(w["t"])
        return out
    except (KeyError, ValueError, TypeError, AttributeError):
        return None


class _MemberTelemetry:
    __slots__ = ("rank", "pid", "wall_epoch", "windows", "spans", "metrics",
                 "last_seen")

    def __init__(self):
        self.rank = None
        self.pid = None
        self.wall_epoch = None
        self.windows: "OrderedDict" = OrderedDict()  # idx -> window
        self.spans: List[dict] = []
        self.metrics: dict = {}
        self.last_seen = time.monotonic()


class FleetAggregator:
    """PS-server-side cache of per-worker telemetry parts + the straggler
    detector run over them. ``add_part`` is called from the heartbeat
    handler (the piggyback path); ``parts``/``stats`` answer OP_TELEMETRY
    and STATS."""

    MAX_MEMBERS = 64
    MAX_SPANS_PER_MEMBER = 8192
    MAX_WINDOWS_PER_MEMBER = 64
    # a window index waiting on absent reports is force-judged with what
    # arrived after this many seconds — a rank that stopped shipping (obs
    # vetoed there, SIGKILL'd without a membership plane) must not stall
    # the verdict loop forever. NB deliberately wall-clock, not index
    # lag: the straggler is precisely the rank whose windows arrive
    # LAST, so "fast ranks are N windows ahead" is normal, not staleness.
    STALE_S = 15.0

    def __init__(self, detector: Optional[StragglerDetector] = None,
                 member_ranks: Optional[Callable] = None):
        self._lock = threading.Lock()
        self._members: "OrderedDict[int, _MemberTelemetry]" = OrderedDict()
        self.detector = detector or StragglerDetector()
        self.verdicts: deque = deque(maxlen=32)
        self._callbacks: List[Callable] = []
        self._judged_to = -1
        self._pending = (None, 0.0)  # (idx, first seen incomplete)
        # judgeable batches are QUEUED under the main lock (so the queue
        # is globally index-ordered) and drained under this one: the
        # detector's streak logic is order-sensitive and not thread-safe,
        # and two heartbeat handler threads must neither interleave it
        # nor observe window 3 before window 2. Separate from the main
        # lock so an on_straggler callback may call stats()/parts().
        self._judge_queue: deque = deque()
        self._judge_lock = threading.Lock()
        # live-membership view (the PS server wires its elastic state's
        # active ranks here): judging a window index waits for every LIVE
        # rank's report, not just the ranks that happened to ship first —
        # a fast pair must not get judged (and advance the cursor) before
        # the slow rank's window arrives, or the straggler itself would
        # be the one rank the verdict never saw. A dead rank leaves the
        # membership, so it cannot stall judging either.
        self._member_ranks = member_ranks

    def on_straggler(self, fn: Callable) -> "FleetAggregator":
        """Register ``fn(verdict)`` — fired on every straggler/recovered
        verdict (the SLOMonitor ``on_breach`` idiom: exceptions are
        swallowed; a policy hook must never take down the server)."""
        self._callbacks.append(fn)
        return self

    # -- ingest ----------------------------------------------------------
    def add_part(self, cid: int, blob) -> bool:
        """Parse one piggybacked worker part. Returns False (and counts)
        on a garbled blob — a worker's telemetry must never break its
        heartbeat."""
        try:
            part = json.loads(bytes(blob).decode("utf-8"))
            rank = int(part["rank"])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            from . import inc

            inc("train.fleet.bad_parts")
            return False
        with self._lock:
            m = self._members.get(cid)
            if m is None:
                while len(self._members) >= self.MAX_MEMBERS:
                    self._members.popitem(last=False)
                m = self._members[cid] = _MemberTelemetry()
            m.rank = rank
            m.last_seen = time.monotonic()
            if part.get("pid") is not None:
                m.pid = part["pid"]
            if part.get("wall_epoch") is not None:
                m.wall_epoch = part["wall_epoch"]
            for w in part.get("windows") or ():
                w = _sanitize_window(w)
                if w is None:
                    from . import inc

                    inc("train.fleet.bad_parts")
                    continue
                m.windows[w["w"]] = w
                while len(m.windows) > self.MAX_WINDOWS_PER_MEMBER:
                    m.windows.popitem(last=False)
            spans = part.get("spans")
            if spans:
                m.spans.extend(s for s in spans if isinstance(s, dict))
                if len(m.spans) > self.MAX_SPANS_PER_MEMBER:
                    m.spans = m.spans[-self.MAX_SPANS_PER_MEMBER:]
            if part.get("metrics"):
                m.metrics = part["metrics"]
            self._judge_queue.extend(self._judgeable_locked())
        with self._judge_lock:
            while True:
                try:
                    idx, per_rank = self._judge_queue.popleft()
                except IndexError:
                    break
                try:
                    self._judge(idx, per_rank)
                except Exception:  # noqa: BLE001 — belt and braces: a
                    # detector/judging bug must count, never kill the
                    # heartbeat connection handler that ingested the part
                    from . import inc

                    inc("train.fleet.judge_errors")
        return True

    def forget(self, cid: int) -> None:
        """Drop a pruned member's cached telemetry (the membership plane's
        GC calls this alongside its gauge cleanup)."""
        with self._lock:
            self._members.pop(cid, None)

    def _judgeable_locked(self):
        """Window indices ready to judge, in order:

        - every LIVE rank reported the index (the normal case), or
        - every reporting rank has moved PAST it (windows arrive in
          order, so a skipped index can never complete), or
        - the index sat incomplete for ``STALE_S`` wall seconds (a rank
          that silently stopped shipping must not stall verdicts).

        Returns ``[(idx, {rank: window})]``."""
        if not self._members:
            return []
        # newest entry wins per rank: a restarted worker draws a fresh cid
        # and reuses its rank — the corpse's stale window set must not
        # stall (or double-count) the fleet's judging
        by_rank: Dict[int, _MemberTelemetry] = {}
        for m in self._members.values():
            if not m.windows:
                continue
            cur = by_rank.get(m.rank)
            if cur is None or m.last_seen > cur.last_seen:
                by_rank[m.rank] = m
        per_member = [(r, m.windows) for r, m in by_rank.items()]
        if len(per_member) < 2:
            return []
        expected = len(per_member)
        if self._member_ranks is not None:
            try:
                live = self._member_ranks()
            except Exception:  # noqa: BLE001 — judging must not die on a
                live = None    # membership-view hiccup
            if live:
                # wait for every LIVE rank — the straggler reports its
                # windows LAST, and it is exactly the rank a premature
                # judgment would miss. The live view REPLACES the
                # reporting count (never max): a cleanly-departed member
                # keeps its cached telemetry here by design, and counting
                # its corpse toward `expected` would throttle every
                # post-scale-down window to the STALE_S timeout.
                expected = len(set(live))
        newest = max(max(w) for _r, w in per_member)
        out = []
        now = time.monotonic()
        idx = self._judged_to + 1
        while idx <= newest:
            have = {r: w[idx] for r, w in per_member if idx in w}
            # a reporting rank still BEHIND idx may yet deliver it;
            # one already past it never will (in-order shipping)
            some_behind = any(idx not in w and max(w) < idx
                              for _r, w in per_member)
            complete = len(have) >= expected or (
                not some_behind and len(per_member) >= expected)
            if not complete:
                p_idx, p_t0 = self._pending
                if p_idx != idx:
                    self._pending = (idx, now)
                    break
                if now - p_t0 < self.STALE_S:
                    break  # wait for the laggards to report this index
            if len(have) >= 2:
                out.append((idx, have))
            self._judged_to = idx
            self._pending = (None, 0.0)
            idx += 1
        return out

    def _judge(self, idx: int, per_rank: Dict[int, dict]) -> None:
        from . import event, inc, set_gauge

        events = self.detector.observe(idx, per_rank)
        set_gauge("train.straggler.flagged", len(self.detector.flagged))
        for v in events:
            self.verdicts.append(v)
            if v["kind"] == "straggler":
                inc("train.straggler.verdicts")
                set_gauge(f"train.straggler.rank{v['rank']}", 1)
                event("train.straggler", rank=v["rank"], blame=v["blame"],
                      ratio=v["ratio"], window=v["window"],
                      streak=v["streak"])
            else:
                inc("train.straggler.recoveries")
                set_gauge(f"train.straggler.rank{v['rank']}", 0)
                event("train.straggler.recovered", rank=v["rank"],
                      window=v["window"], was_blamed=v.get("was_blamed"))
            for fn in self._callbacks:
                try:
                    fn(dict(v))
                except Exception:  # noqa: BLE001 — policy hooks must never
                    # take down the telemetry plane (the actuation hooks
                    # run on the PS heartbeat handler thread); counted so
                    # a silently-broken policy is visible in STATS
                    inc("train.straggler.callback_errors")

    # -- answers ---------------------------------------------------------
    def parts(self, drain: bool = True) -> List[dict]:
        """Cached worker parts in the ``obs.telemetry_part`` schema (one
        per rank, role ``rank<r>``). ``drain=True`` empties each member's
        accumulated span cache — repeated collections are increments,
        like every other telemetry pull. Windows stay (the detector's
        history is not a ring to drain)."""
        out = []
        with self._lock:
            for cid, m in self._members.items():
                part = {"pid": m.pid, "role": f"rank{m.rank}",
                        "rank": m.rank, "wall_epoch": m.wall_epoch,
                        "spans": list(m.spans),
                        "metrics": m.metrics or {},
                        "windows": list(m.windows.values())}
                if drain:
                    m.spans = []
                out.append(part)
        return out

    def stats(self) -> dict:
        """The structured "Training fleet" entry for the PS server's
        STATS: per-rank window summaries, live straggler verdicts, and
        verdict history."""
        with self._lock:
            ranks = {}
            for m in self._members.values():
                if m.rank is None or not m.windows:
                    continue
                summary = summarize_windows(m.windows.values())
                if summary is not None:
                    ranks[str(m.rank)] = dict(summary, pid=m.pid)
        return {"ranks": ranks,
                "stragglers": [dict(v) for v in self.detector.flagged
                               .values()],
                "verdicts": [dict(v) for v in self.verdicts]}


# ---------------------------------------------------------------------------
# collection client (tools/train_report.py, tools/fleet_report.py --ps)
# ---------------------------------------------------------------------------

def collect(host: str, port: int, drain: bool = True,
            timeout: float = 30.0) -> dict:
    """One OP_TELEMETRY pull against a PS server → ``{"parts": [...]}`` —
    the server's own part (its RPC lanes + STATS) plus every cached
    worker part. Exactly-once under retries: the request carries a fresh
    collection token; a retried frame whose reply was lost re-serves the
    server's cached reply instead of draining a second batch."""
    from ..kvstore.ps_client import PSClient

    cli = PSClient(host, int(port), timeout=timeout, retries=5,
                   retry_interval=0.2)
    try:
        return cli.telemetry(drain=drain)
    finally:
        cli.close()
