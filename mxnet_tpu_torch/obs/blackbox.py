"""Crash flight recorder — "what was this process doing in its last
seconds" as an artifact (counterpart of ``mxnet_tpu/obs/blackbox.py``).

A crashed or watchdogged process used to leave only whatever JSONL
happened to flush. This module keeps a cheap **always-on ring** of the
most recent telemetry — every completed span / instant event / counter
sample (fed once, at creation, from ``obs.trace`` — including tail-held
spans that would later be dropped) — and can serialize it plus a metrics
snapshot, the continuous profiler's recent samples + folded stacks, every
thread's python stack, and the tail buffer's state into one timestamped
**bundle**:

- ``dump(reason)`` — explicit, and wired into: fatal-signal hooks
  (SIGTERM/SIGABRT, chained to any existing handler), the
  uncaught-exception hook, and the serve wire's ``DUMP`` opcode (``wire.py``, ``serve/server.py``) so an
  operator can snapshot a live replica remotely;
- a **periodic flush** (``MXNET_OBS_BLACKBOX_FLUSH_S``, default 2s)
  atomically rewrites ``blackbox-<pid>-last.json`` in the bundle dir — a
  SIGKILL cannot be hooked, so the recorder leaves a ≤flush-period-stale
  bundle behind instead; ``faulthandler`` is armed at the same path root
  (``blackbox-<pid>.stacks``) for C-level faults python never sees.

Bundles are plain JSON with a ``{"blackbox": 1}`` marker;
``tools/trace_report.py`` and ``tools/fleet_report.py`` read them back
into the merged timeline (span lanes + a ``prof:<phase>`` profiler lane
attributing the corpse's last seconds by phase).

The bundle's metrics carry the device plane's ``device.live_bytes``
gauge (``obs/device.py``: the card's allocated bytes, sampled per served
batch), so a corpse's bundle shows its last device footprint.

Repeated automatic dumps are throttled (``MXNET_OBS_BLACKBOX_COOLDOWN_S``,
default 30s) so a breach storm cannot turn the recorder into the outage.
"""
from __future__ import annotations

import faulthandler
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import List, Optional

from . import metrics as _metrics
from . import trace as _trace
from ._env import env_float as _env_float

__all__ = ["FlightRecorder", "recorder", "enabled", "enable", "disable",
           "bundle", "dump", "trigger", "is_bundle", "read_bundle"]


class FlightRecorder:
    """Bounded ring of recent telemetry + bundle serialization."""

    def __init__(self, capacity: Optional[int] = None,
                 dirpath: Optional[str] = None,
                 flush_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 role: Optional[str] = None):
        cap = int(capacity) if capacity \
            else int(_env_float("MXNET_OBS_BLACKBOX_EVENTS", 4096))
        self._ring: deque = deque(maxlen=cap)
        self.dirpath = dirpath
        self.flush_s = flush_s if flush_s is not None \
            else _env_float("MXNET_OBS_BLACKBOX_FLUSH_S", 2.0)
        self.cooldown_s = cooldown_s if cooldown_s is not None \
            else _env_float("MXNET_OBS_BLACKBOX_COOLDOWN_S", 30.0)
        self.role = role
        self.dumps = 0
        self.flushes = 0
        self._last_trigger = 0.0
        self._dirty = False
        self._stop_evt = threading.Event()
        self._writer: Optional[threading.Thread] = None

    # -- intake (the trace._BLACKBOX_SINK) ------------------------------
    def feed(self, rec: tuple, tracer) -> None:
        # raw tuples: one deque append on the span hot path; normalization
        # is deferred to bundle time (rare)
        self._ring.append(rec)
        self._dirty = True

    # -- bundle ---------------------------------------------------------
    def bundle_dict(self, reason: str = "manual",
                    thread_stacks: bool = True) -> dict:
        tracer = _trace.tracer
        events = [tracer._event_dict(r) for r in list(self._ring)]
        out = {
            "blackbox": 1,
            "reason": reason,
            "pid": os.getpid(),
            "role": self.role,
            "wall_epoch": tracer.wall_epoch,
            "dumped_at": time.time(),
            "events": events,
            "metrics": _metrics.snapshot(),
        }
        try:
            from . import profile as _profile
            if _profile.profiler is not None:
                p = _profile.profiler
                # a bounded slice, not the whole ring: the 65536-sample
                # buffer covers ~16 min at 67 Hz, and the periodic flush
                # runs every flush_s — copying/coalescing it all each
                # time makes the "cheap always-on" path O(ring) forever.
                # The bundle promises the LAST SECONDS anyway
                prof_s = _env_float("MXNET_OBS_BLACKBOX_PROF_S", 10.0)
                out["profiler"] = {
                    "stats": p.stats(),
                    "phase_seconds": p.phase_seconds(),
                    "folded": p.folded(top=200),
                    "samples": p.chrome_events(seconds=prof_s),
                }
        except Exception:  # noqa: BLE001 — a bundle with less beats none
            pass
        try:
            from . import tail as _tail
            st = _tail.stats()
            if st is not None:
                out["tail"] = st
        except Exception:  # noqa: BLE001
            pass
        if thread_stacks:
            try:
                names = {t.ident: t.name for t in threading.enumerate()}
                stacks = {}
                for tid, frame in sys._current_frames().items():
                    stacks[f"{names.get(tid, '?')} ({tid})"] = \
                        traceback.format_stack(frame, limit=16)
                out["threads"] = stacks
            except Exception:  # noqa: BLE001
                pass
        return out

    def _path(self, tag: str) -> str:
        return os.path.join(self.dirpath or ".",
                            f"blackbox-{os.getpid()}-{tag}.json")

    def _write(self, doc: dict, path: str) -> str:
        # atomic: a reader (or the next crash) must never see a torn
        # bundle — tmp + rename on the same filesystem
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        return path

    def dump(self, reason: str = "manual",
             path: Optional[str] = None,
             doc: Optional[dict] = None) -> str:
        """Serialize a bundle to ``path`` (default: a timestamped file in
        the bundle dir). Returns the path. ``doc`` persists an
        already-built bundle (the DUMP opcode writes the same document it
        replies with, instead of a second, later snapshot)."""
        if doc is None:
            doc = self.bundle_dict(reason)
        if path is None:
            if self.dirpath:
                os.makedirs(self.dirpath, exist_ok=True)
            path = self._path(str(int(time.time() * 1e3)))
        out = self._write(doc, path)
        self.dumps += 1
        if _trace._ENABLED:
            _metrics.registry.counter("blackbox.dumps").inc()
            _trace.tracer.event("blackbox.dump", reason=reason, path=out)
        return out

    def trigger(self, reason: str, **attrs) -> Optional[str]:
        """Throttled automatic dump (watchdog / SLO / health hooks): at
        most one per cooldown window; silently a no-op between windows so
        a breach storm cannot become an IO storm."""
        now = time.monotonic()
        if now - self._last_trigger < self.cooldown_s:
            if _trace._ENABLED:
                _metrics.registry.counter("blackbox.throttled").inc()
            return None
        self._last_trigger = now
        try:
            return self.dump(reason)
        except OSError:
            return None

    # -- periodic flush (the SIGKILL answer) -----------------------------
    def start_writer(self) -> None:
        if self.dirpath is None or self.flush_s <= 0:
            return
        if self._writer is not None and self._writer.is_alive():
            return
        os.makedirs(self.dirpath, exist_ok=True)
        self._stop_evt.clear()
        self._writer = threading.Thread(target=self._flush_loop,
                                        daemon=True,
                                        name="mxtpu-blackbox-writer")
        self._writer.start()

    def flush(self) -> Optional[str]:
        """One atomic rewrite of ``blackbox-<pid>-last.json`` (skipped
        when nothing new arrived). Thread stacks are skipped on the
        periodic path — they are crash detail, not steady-state state."""
        if not self._dirty or self.dirpath is None:
            return None
        self._dirty = False
        try:
            path = self._write(self.bundle_dict("flush",
                                                thread_stacks=False),
                               self._path("last"))
        except OSError:
            return None
        self.flushes += 1
        return path

    def _flush_loop(self) -> None:
        while not self._stop_evt.wait(self.flush_s):
            try:
                self.flush()
            except Exception:  # noqa: BLE001 — the recorder must never
                pass           # take down what it records

    def stop(self) -> None:
        self._stop_evt.set()
        if self._writer is not None:
            self._writer.join(timeout=2)
            if self._writer.is_alive():
                # a flush stuck on a dead filesystem: it is a daemon and
                # the stop event is set, so it dies with the process —
                # but count the leak instead of pretending it joined
                _metrics.registry.counter("blackbox.writer_leaked").inc()
            self._writer = None

    def stats(self) -> dict:
        return {"events": len(self._ring), "dumps": self.dumps,
                "flushes": self.flushes, "dir": self.dirpath,
                "flush_s": self.flush_s, "cooldown_s": self.cooldown_s}


# ---------------------------------------------------------------------------
# module singleton + hooks
# ---------------------------------------------------------------------------

recorder: Optional[FlightRecorder] = None
_prev_excepthook = None
_prev_sig: dict = {}


def enabled() -> bool:
    return recorder is not None


def enable(dirpath: Optional[str] = None, *,
           capacity: Optional[int] = None, flush_s: Optional[float] = None,
           cooldown_s: Optional[float] = None, role: Optional[str] = None,
           signals: bool = True) -> FlightRecorder:
    """Arm the flight recorder. With ``dirpath`` (or
    ``MXNET_OBS_BLACKBOX_DIR``): periodic last-bundle flush + faulthandler
    + fatal-signal/excepthook dumps land there; without, the ring still
    records and ``dump(path=...)`` / the DUMP opcode work."""
    global recorder
    if recorder is not None:
        disable()
    dirpath = dirpath or os.environ.get("MXNET_OBS_BLACKBOX_DIR") or None
    recorder = FlightRecorder(capacity=capacity, dirpath=dirpath,
                              flush_s=flush_s, cooldown_s=cooldown_s,
                              role=role)
    _trace._BLACKBOX_SINK = recorder.feed
    recorder.start_writer()
    if dirpath:
        try:  # C-level faults (SEGV/ABRT in native code) bypass python —
            # faulthandler at least leaves the thread stacks on disk
            os.makedirs(dirpath, exist_ok=True)
            f = open(os.path.join(
                dirpath, f"blackbox-{os.getpid()}.stacks"), "w")
            faulthandler.enable(file=f)
        except OSError:
            pass
    if signals:
        _install_hooks()
    return recorder


def disable() -> None:
    global recorder
    _uninstall_hooks()
    if recorder is not None:
        recorder.stop()
    _trace._BLACKBOX_SINK = None
    recorder = None


def bundle(reason: str = "manual") -> dict:
    """The in-memory bundle (the DUMP opcode's payload). Works with the
    recorder disarmed too — the ring is then empty but metrics, profiler
    state, and thread stacks still tell the story."""
    r = recorder if recorder is not None else FlightRecorder(capacity=1)
    return r.bundle_dict(reason)


def dump(reason: str = "manual", path: Optional[str] = None,
         doc: Optional[dict] = None) -> Optional[str]:
    return recorder.dump(reason, path=path, doc=doc) \
        if recorder is not None else None


def trigger(reason: str, **attrs) -> Optional[str]:
    """Throttled hook entry point for the watchdog / SLO / health planes
    (no-op unless the recorder is armed)."""
    return recorder.trigger(reason, **attrs) if recorder is not None \
        else None


# -- fatal-signal / excepthook chains ---------------------------------------

def _dump_from_signal(reason: str, timeout: float = 5.0) -> None:
    """Dump from a signal handler WITHOUT deadlocking the process: the
    handler runs on the main thread, whose interrupted frame may hold any
    of the non-reentrant locks ``bundle_dict`` needs (a histogram's
    ``observe`` lock, the tail buffer's, the profiler's). Serializing on
    a side thread and joining with a bound turns that worst case into a
    lost bundle instead of a SIGTERM that never terminates."""
    done = threading.Event()

    def work():
        try:
            if recorder is not None:
                recorder.dump(reason)
        except Exception:  # noqa: BLE001 — dying anyway
            pass
        finally:
            done.set()

    t = threading.Thread(target=work, daemon=True,
                         name="mxtpu-blackbox-sigdump")
    t.start()
    done.wait(timeout)


def _install_hooks() -> None:
    global _prev_excepthook
    if _prev_excepthook is None:
        _prev_excepthook = sys.excepthook

        def hook(tp, val, tb):
            try:
                if recorder is not None:
                    recorder.trigger(f"uncaught:{tp.__name__}")
            finally:
                _prev_excepthook(tp, val, tb)

        sys.excepthook = hook
    if threading.current_thread() is not threading.main_thread():
        return  # signal.signal only works on the main thread
    for signum in (signal.SIGTERM, signal.SIGABRT):
        if signum in _prev_sig:
            continue
        try:
            prev = signal.getsignal(signum)

            def handler(sig, frame, _prev=prev):
                if recorder is not None:
                    _dump_from_signal(f"signal:{signal.Signals(sig).name}")
                if callable(_prev):
                    _prev(sig, frame)
                elif _prev is not signal.SIG_IGN:
                    # default disposition: restore it and re-raise so the
                    # process still dies with the right status; an
                    # explicit SIG_IGN stays ignored — arming the
                    # recorder must not make an ignored signal fatal
                    signal.signal(sig, signal.SIG_DFL)
                    os.kill(os.getpid(), sig)

            signal.signal(signum, handler)
            _prev_sig[signum] = prev
        except (ValueError, OSError):  # non-main thread / exotic platform
            pass


def _uninstall_hooks() -> None:
    global _prev_excepthook
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    for signum, prev in list(_prev_sig.items()):
        try:
            signal.signal(signum, prev)
        except (ValueError, OSError):
            pass
        _prev_sig.pop(signum, None)


# -- bundle readers (tools/trace_report.py, tools/fleet_report.py) ----------

def is_bundle(doc) -> bool:
    return isinstance(doc, dict) and doc.get("blackbox") == 1


def read_bundle(doc: dict) -> dict:
    """A bundle as a telemetry *part* (the ``obs.telemetry_part`` schema
    plus the profiler lane already folded into ``spans``), so the merge
    tooling treats a corpse's bundle exactly like a live replica's
    telemetry."""
    spans: List[dict] = list(doc.get("events") or ())
    prof = doc.get("profiler") or {}
    spans.extend(prof.get("samples") or ())
    spans.sort(key=lambda e: e.get("ts", 0.0))
    return {"pid": doc.get("pid"),
            "role": doc.get("role") or f"blackbox:{doc.get('reason')}",
            "wall_epoch": doc.get("wall_epoch"),
            "spans": spans,
            "metrics": doc.get("metrics") or {},
            "blackbox_reason": doc.get("reason"),
            "dumped_at": doc.get("dumped_at")}
