"""Runtime lock-order sanitizer and stall watchdog, ``MXNET_TSAN=1``
(counterpart of ``mxnet_tpu/tsan.py``).

The static half of the concurrency plane (``analysis/concurrency.py``)
reads the source; this is the dynamic half: instrumented
``Lock``/``RLock``/``Condition`` wrappers that record each thread's lock
acquisition order into one process-global order graph and detect a cycle
the moment a thread acquires B while holding A after any thread ever
acquired A while holding B, before the interleaving that would deadlock
happens (lockdep style).

The serve and PS planes create every lock through the factories below
(:func:`lock` / :func:`rlock` / :func:`condition`), which return plain
``threading`` primitives when the sanitizer is off and instrumented ones
under ``MXNET_TSAN=1``. A ``ProcReplica`` child, a PS server child and an
elastic worker inherit the environment, so a chaos subprocess runs
sanitized too. Each lock is named by its plane and role
(``serve.router``, ``ps.key``, ...): the graph's nodes are names, so
every lock of one role is one node.

Violations are recorded (``violations()``), counted
(``tsan.lock_order_violations``), surfaced as obs events, and raised as
:class:`LockOrderViolation` under ``MXNET_TSAN_RAISE=1`` (or
:func:`set_strict`).

The **watchdog** (armed when the first instrumented lock is made; stall
threshold ``MXNET_TSAN_STALL_S``, default 20 s, 0 disarms it) scans for
threads that have been blocked acquiring a tracked lock, parked in a
``Condition.wait``, or holding a tracked lock (blocked in a socket
``recv`` under it, say) for longer than the threshold, and dumps every
thread's stack with held-lock attribution, then triggers the flight
recorder (``obs/blackbox.py``) with that reason.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from _thread import allocate_lock as _raw_lock
from typing import Callable, Dict, List, Optional, Tuple

from .base import get_env

__all__ = ["enabled", "lock", "rlock", "condition", "SanLock", "SanRLock",
           "SanCondition", "LockOrderViolation", "violations", "reset",
           "set_strict", "arm_watchdog", "disarm_watchdog", "dump_stacks",
           "Watchdog"]


def enabled() -> bool:
    return bool(get_env("MXNET_TSAN", False, bool))


class LockOrderViolation(RuntimeError):
    """Acquiring this lock closes a cycle in the global lock-order graph:
    some interleaving of the participating threads can deadlock."""


# ---------------------------------------------------------------------------
# global sanitizer state (its own RAW lock: the bookkeeping must never
# participate in the graph it maintains)
# ---------------------------------------------------------------------------

_mu = _raw_lock()
_edges: Dict[str, Dict[str, dict]] = {}     # name -> {succ: first-edge info}
_violations: List[dict] = []
_violation_pairs: set = set()   # (holding, acquiring) pairs that cycled
_warned_pairs: set = set()
_strict = [bool(get_env("MXNET_TSAN_RAISE", False, bool))]
# watchdog-visible tables, keyed by thread ident
_holds: Dict[int, List[Tuple["SanLock", float]]] = {}   # held (lock, since)
_waiting: Dict[int, Tuple[str, float]] = {}             # acquiring (name, t)
_cv_waits: Dict[int, Tuple[str, float, Optional[float]]] = {}
_tls = threading.local()

_watchdog: Optional["Watchdog"] = None
_armed = [False]


def set_strict(flag: bool) -> None:
    """Raise :class:`LockOrderViolation` on cycle detection (tests; also
    ``MXNET_TSAN_RAISE=1``) instead of record-and-continue."""
    _strict[0] = bool(flag)


def violations() -> List[dict]:
    with _mu:
        return list(_violations)


def reset() -> None:
    """Drop the order graph, violation log, and watchdog tables (tests)."""
    with _mu:
        _edges.clear()
        _violations.clear()
        _violation_pairs.clear()
        _warned_pairs.clear()
        _holds.clear()
        _waiting.clear()
        _cv_waits.clear()
    held = getattr(_tls, "held", None)
    if held:
        held.clear()


def _held() -> List["SanLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _path_exists(src: str, dst: str) -> Optional[List[str]]:
    """BFS over the order graph; returns the node path src..dst or None.
    Caller holds ``_mu``."""
    if src == dst:
        return [src]
    frontier = [[src]]
    seen = {src}
    while frontier:
        path = frontier.pop(0)
        for succ in _edges.get(path[-1], ()):
            if succ == dst:
                return path + [dst]
            if succ not in seen:
                seen.add(succ)
                frontier.append(path + [succ])
    return None


def _record_acquired(lk: "SanLock") -> None:
    tid = threading.get_ident()
    held = _held()
    now = time.monotonic()
    new_cycle = None
    with _mu:
        _waiting.pop(tid, None)
        for h, _depth in held:
            if h.name == lk.name:
                continue  # reentrancy / same-named peer: not an order edge
            succs = _edges.setdefault(h.name, {})
            if lk.name in succs:
                succs[lk.name]["count"] += 1
                # a REPEAT of a known-bad ordering must keep reporting
                # (and keep raising under strict) — the first offender may
                # have been a daemon thread whose raise nobody saw
                if (h.name, lk.name) in _violation_pairs:
                    back = _path_exists(lk.name, h.name)
                    if back is not None and new_cycle is None:
                        new_cycle = {
                            "cycle": back + [lk.name],
                            "thread": threading.current_thread().name,
                            "holding": h.name, "acquiring": lk.name,
                            "stack": "".join(
                                traceback.format_stack(limit=12))}
                continue
            # NEW edge h -> lk: a cycle exists iff lk already reaches h
            back = _path_exists(lk.name, h.name)
            succs[lk.name] = {"count": 1,
                              "stack": traceback.format_stack(limit=8)}
            if back is not None:
                cycle = back + [lk.name]
                info = {"cycle": cycle, "thread": threading.current_thread().name,
                        "holding": h.name, "acquiring": lk.name,
                        "stack": "".join(traceback.format_stack(limit=12))}
                _violations.append(info)
                _violation_pairs.add((h.name, lk.name))
                if new_cycle is None:
                    new_cycle = info
        _holds.setdefault(tid, []).append((lk, now))
    held.append((lk, 1))
    if new_cycle is not None:
        _report_violation(new_cycle)


def _report_violation(info: dict) -> None:
    pair = (info["holding"], info["acquiring"])
    first = False
    with _mu:
        if pair not in _warned_pairs:
            _warned_pairs.add(pair)
            first = True
    msg = ("lock-order violation: acquiring %r while holding %r closes the "
           "cycle %s (thread %s)" % (info["acquiring"], info["holding"],
                                     " -> ".join(info["cycle"]),
                                     info["thread"]))
    try:  # lazy: obs pulls in the full runtime; the sanitizer must not
        from . import obs

        obs.inc("tsan.lock_order_violations")
        obs.event("tsan.lock_order_violation", cycle=info["cycle"],
                  thread=info["thread"])
    except Exception:  # noqa: BLE001 — reporting must never deadlock/raise
        pass
    if first:
        sys.stderr.write("[tsan] " + msg + "\n")
    if _strict[0]:
        raise LockOrderViolation(msg + "\n" + info["stack"])


def _record_released(lk: "SanLock") -> None:
    tid = threading.get_ident()
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] is lk:
            del held[i]
            break
    with _mu:
        stack = _holds.get(tid)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] is lk:
                    del stack[i]
                    break
            if not stack:
                _holds.pop(tid, None)


def _record_waiting(name: str) -> None:
    tid = threading.get_ident()
    with _mu:
        _waiting[tid] = (name, time.monotonic())


def _clear_waiting() -> None:
    tid = threading.get_ident()
    with _mu:
        _waiting.pop(tid, None)


# ---------------------------------------------------------------------------
# instrumented primitives
# ---------------------------------------------------------------------------

class SanLock:
    """Instrumented non-reentrant lock (wraps a raw ``_thread`` lock)."""

    _reentrant = False

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"anon-lock@{id(self):x}"
        self._inner = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _record_waiting(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                _record_acquired(self)
            except LockOrderViolation:
                # strict mode: leave the world as if the acquire never
                # happened, or the raise would leak a held lock
                _record_released(self)
                self._inner.release()
                raise
        else:
            _clear_waiting()
        return got

    def release(self) -> None:
        _record_released(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<{type(self).__name__} {self.name}>"


class SanRLock(SanLock):
    """Instrumented reentrant lock. Re-acquisition by the owner bumps a
    depth counter and adds no order edges (not a hazard)."""

    _reentrant = True

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"anon-rlock@{id(self):x}"
        self._inner = threading.RLock()
        self._owner: Optional[int] = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self._owner == me:
            got = self._inner.acquire(blocking, timeout)
            if got:
                self._depth += 1
            return got
        _record_waiting(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._owner = me
            self._depth = 1
            try:
                _record_acquired(self)
            except LockOrderViolation:
                self._owner = None
                self._depth = 0
                _record_released(self)
                self._inner.release()
                raise
        else:
            _clear_waiting()
        return got

    def release(self) -> None:
        if self._owner == threading.get_ident() and self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        self._owner = None
        self._depth = 0
        _record_released(self)
        self._inner.release()

    # Condition integration: full release/restore across a wait, with the
    # sanitizer's held-bookkeeping kept in sync
    def _release_save(self):
        depth, self._depth, self._owner = self._depth, 0, None
        _record_released(self)
        state = self._inner._release_save()  # type: ignore[attr-defined]
        return (state, depth)

    def _acquire_restore(self, saved):
        state, depth = saved
        _record_waiting(self.name)
        self._inner._acquire_restore(state)  # type: ignore[attr-defined]
        self._owner = threading.get_ident()
        self._depth = depth
        _record_acquired(self)

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()


class SanCondition(threading.Condition):
    """Instrumented condition variable: its underlying lock participates
    in the order graph, and every ``wait`` registers with the watchdog so
    a stalled waiter shows up in the stack dump with its held locks."""

    def __init__(self, name: Optional[str] = None, lock=None):
        self.name = name or f"anon-cv@{id(self):x}"
        super().__init__(lock if lock is not None
                         else SanRLock(self.name))

    def wait(self, timeout: Optional[float] = None) -> bool:
        tid = threading.get_ident()
        with _mu:
            _cv_waits[tid] = (self.name, time.monotonic(), timeout)
        try:
            return super().wait(timeout)
        finally:
            with _mu:
                _cv_waits.pop(tid, None)


# ---------------------------------------------------------------------------
# factories — what the serve/kvstore planes actually call
# ---------------------------------------------------------------------------

def lock(name: Optional[str] = None):
    """A mutex: plain ``threading.Lock`` normally, :class:`SanLock` under
    ``MXNET_TSAN=1`` (the watchdog is armed on first creation)."""
    if enabled():
        _auto_arm()
        return SanLock(name)
    return threading.Lock()


def rlock(name: Optional[str] = None):
    if enabled():
        _auto_arm()
        return SanRLock(name)
    return threading.RLock()


def condition(name: Optional[str] = None, lock=None):
    if enabled():
        _auto_arm()
        return SanCondition(name, lock=lock)
    return threading.Condition(lock)


def _auto_arm() -> None:
    """Each instrumented primitive a factory makes counts
    ``tsan.instrumented_locks`` (a process's telemetry shows the sanitizer
    ran); the first one arms the watchdog."""
    try:
        from . import obs

        obs.inc("tsan.instrumented_locks")
    except Exception:  # noqa: BLE001 — accounting must never break a lock
        pass
    if not _armed[0]:
        _armed[0] = True
        if float(get_env("MXNET_TSAN_STALL_S", 20.0, float)) > 0:
            arm_watchdog()


# ---------------------------------------------------------------------------
# deadlock watchdog
# ---------------------------------------------------------------------------

def dump_stacks(reason: str = "manual") -> str:
    """Every thread's stack with held-lock attribution. Written to stderr
    and returned (tests and the watchdog's sinks consume the text)."""
    now = time.monotonic()
    names = {t.ident: t.name for t in threading.enumerate()}
    with _mu:
        holds = {tid: [(lk.name, round(now - t0, 3)) for lk, t0 in stack]
                 for tid, stack in _holds.items() if stack}
        waits = dict(_waiting)
        cvw = dict(_cv_waits)
    lines = [f"[tsan] watchdog stack dump ({reason})"]
    frames = sys._current_frames()
    for tid, frame in frames.items():
        header = f"-- thread {names.get(tid, '?')} (ident {tid})"
        attribution = []
        for lname, age in holds.get(tid, ()):
            attribution.append(f"HOLDS {lname} for {age}s")
        if tid in waits:
            lname, t0 = waits[tid]
            attribution.append(
                f"BLOCKED acquiring {lname} for {round(now - t0, 3)}s")
        if tid in cvw:
            cname, t0, tmo = cvw[tid]
            attribution.append(
                f"WAITING on condition {cname} for {round(now - t0, 3)}s"
                + (" (no timeout)" if tmo is None else f" (timeout {tmo})"))
        if attribution:
            header += " [" + "; ".join(attribution) + "]"
        lines.append(header)
        lines.extend(line.rstrip("\n")
                     for line in traceback.format_stack(frame, limit=12))
    text = "\n".join(lines)
    sys.stderr.write(text + "\n")
    try:
        from . import obs

        obs.inc("tsan.watchdog_dumps")
        obs.event("tsan.watchdog_dump", reason=reason,
                  threads=len(frames))
        # a stalled fleet is exactly the "last seconds" question the
        # flight recorder answers: snapshot the telemetry ring + profiler
        # + these stacks as a bundle (throttled; no-op when disarmed)
        obs.blackbox.trigger(f"watchdog:{reason}"[:120])
    except Exception:  # noqa: BLE001 — diagnosis must never crash the host
        pass
    return text


class Watchdog:
    """Scans the sanitizer tables every ``interval`` and dumps all-thread
    stacks (once per offender) when any thread has been blocked acquiring
    a lock, parked in a Condition.wait, or holding a lock for longer than
    ``stall_s`` — the "fleet stalled" tripwire."""

    def __init__(self, stall_s: float = 20.0, interval: Optional[float] = None,
                 sink: Optional[Callable[[str], None]] = None):
        self.stall_s = float(stall_s)
        self.interval = float(interval if interval is not None
                              else max(self.stall_s / 4, 0.05))
        self.sink = sink
        self.dumps = 0
        self._reported: set = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxtpu-tsan-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            if self._thread.is_alive():  # scan wedged: nothing left to do
                sys.stderr.write("[tsan] watchdog thread did not stop\n")
            self._thread = None

    def check(self) -> Optional[str]:
        """One scan (callable from tests without the thread)."""
        now = time.monotonic()
        offenders = []
        with _mu:
            for tid, (lname, t0) in _waiting.items():
                if now - t0 > self.stall_s:
                    offenders.append(("acquire", tid, lname))
            for tid, (cname, t0, _tmo) in _cv_waits.items():
                if now - t0 > self.stall_s:
                    offenders.append(("cv-wait", tid, cname))
            for tid, stack in _holds.items():
                for lk, t0 in stack:
                    if now - t0 > self.stall_s:
                        offenders.append(("hold", tid, lk.name))
        # forget offenders that recovered: a future stall on the same
        # (thread, lock) key — or a reused thread ident — must dump again
        self._reported &= set(offenders)
        fresh = [o for o in offenders if o not in self._reported]
        if not fresh:
            return None
        self._reported.update(fresh)
        reason = "; ".join(f"{kind} {name} (thread {tid})"
                           for kind, tid, name in fresh)
        text = dump_stacks(f"stall: {reason}")
        self.dumps += 1
        if self.sink is not None:
            try:
                self.sink(text)
            except Exception:  # noqa: BLE001 — sink is observer-only
                pass
        return text

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check()
            except Exception:  # noqa: BLE001 — the watchdog outlives scans
                pass


def arm_watchdog(stall_s: Optional[float] = None,
                 interval: Optional[float] = None,
                 sink: Optional[Callable[[str], None]] = None) -> Watchdog:
    """Start (or replace) the process watchdog. Default threshold:
    ``MXNET_TSAN_STALL_S`` (20s)."""
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
    if stall_s is None:
        stall_s = float(get_env("MXNET_TSAN_STALL_S", 20.0, float))
    _watchdog = Watchdog(stall_s, interval=interval, sink=sink).start()
    return _watchdog


def disarm_watchdog() -> None:
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None
