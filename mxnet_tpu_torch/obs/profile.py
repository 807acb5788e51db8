"""Continuous stack profiler — always-on, stdlib-only, phase-attributed
(counterpart of ``mxnet_tpu/obs/profile.py``).

Continuous profiling: a sampling thread that costs so little it stays on in production, so "what
was this process doing for the last N seconds" is always answerable —
including by the flight recorder (obs/blackbox.py), which folds the most
recent samples into every crash bundle.

Implementation: a daemon thread wakes at ``MXNET_OBS_PROF_HZ`` (default
67 — deliberately co-prime with common 10/50/100 Hz work periods so the
sampler does not alias onto them), walks ``sys._current_frames()``, and
aggregates each thread's stack as a semicolon-folded string tagged with
that thread's **active span phase** (the tracer's per-thread span stack —
``serve.execute``, ``update.fused``, ``data_wait``, ...). Exports:

- :meth:`SamplingProfiler.folded` — collapsed-stack text
  (``phase;frame;frame count`` — feed to flamegraph.pl / speedscope);
- :meth:`SamplingProfiler.chrome_events` — a per-thread profiler lane for
  the merged chrome trace (consecutive same-leaf samples coalesce into
  one span), rendered by ``tools/trace_report.py``;
- :meth:`SamplingProfiler.recent` — the raw last-N-seconds sample ring
  (the flight recorder's slice).

Overhead is measured, not assumed: ``python -m
mxnet_tpu_torch.tools.serve_bench --prof-overhead`` runs the serve closed
loop with the profiler (and tail buffering) off vs on.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional

from . import metrics as _metrics
from . import trace as _trace
from ._env import env_float as _env_float

__all__ = ["SamplingProfiler", "start", "stop", "profiler", "enabled",
           "folded", "chrome_events", "recent"]


class SamplingProfiler:
    """Sample every thread's python stack at ``hz``, phase-tagged.

    ``depth`` bounds the folded stack (innermost frames win); the sample
    ring holds ``max_samples`` ``(ts, tid, phase, leaf)`` tuples (oldest
    drop). Aggregation is a Counter keyed by ``(phase, folded_stack)`` —
    memory stays bounded by distinct stacks, not run length.
    """

    def __init__(self, hz: Optional[float] = None,
                 depth: Optional[int] = None,
                 max_samples: Optional[int] = None):
        self.hz = float(hz) if hz else _env_float("MXNET_OBS_PROF_HZ", 67.0)
        if self.hz <= 0:
            raise ValueError("profiler hz must be > 0")
        self.depth = int(depth) if depth \
            else int(_env_float("MXNET_OBS_PROF_DEPTH", 48))
        cap = int(max_samples) if max_samples \
            else int(_env_float("MXNET_OBS_PROF_BUFFER", 65536))
        self._samples: deque = deque(maxlen=cap)
        self._folded: "Counter[tuple]" = Counter()
        # code-object-chain -> (folded string, leaf): string work happens
        # once per distinct stack, not once per sample (keys keep their
        # code objects alive — bounded by the program's code, fine)
        self._fold_cache: Dict[tuple, tuple] = {}
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0
        self.ticks = 0
        self.started_at: Optional[float] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "SamplingProfiler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop_evt.clear()
        self.started_at = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxtpu-obs-profiler")
        self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # one tick can outlive the timeout only if something holds
                # the GIL that long; the daemon thread exits on its next
                # wait() check — count the leak, don't hide it
                _metrics.registry.counter("prof.sampler_leaked").inc()
            self._thread = None

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- the sampling loop ----------------------------------------------
    @staticmethod
    def _fold(frame, depth: int) -> str:
        """Innermost-last semicolon fold: ``mod.fn;mod.fn;...``."""
        parts: List[str] = []
        f = frame
        while f is not None and len(parts) < depth:
            code = f.f_code
            mod = code.co_filename.rsplit(os.sep, 1)[-1]
            parts.append(f"{mod}:{code.co_name}")
            f = f.f_back
        parts.reverse()
        return ";".join(parts)

    def sample_once(self) -> int:
        """One sweep over every live thread (callable from tests without
        the thread). Returns the number of thread samples taken."""
        me = threading.get_ident()
        prof_tid = self._thread.ident if self._thread is not None else me
        phases = _trace.tracer.thread_phases()
        now = time.monotonic()
        taken = 0
        depth = self.depth
        cache = self._fold_cache
        frames = sys._current_frames()
        try:
            for tid, frame in frames.items():
                if tid == me or tid == prof_tid:
                    continue  # never profile the profiler
                phase = phases.get(tid, "idle")
                # every tick holds the GIL away from the threads being
                # profiled, so the per-sample work must stay tiny: walk
                # the code-object chain (attribute reads only) and fold
                # to strings once per DISTINCT stack — a serve loop shows
                # a few dozen distinct stacks across millions of ticks
                chain: List = []
                f = frame
                while f is not None and len(chain) < depth:
                    chain.append(f.f_code)
                    f = f.f_back
                key = tuple(chain)
                ent = cache.get(key)
                if ent is None:
                    stack = self._fold(frame, depth)
                    leaf = stack.rsplit(";", 1)[-1] if stack else "?"
                    ent = cache[key] = (stack, leaf)
                stack, leaf = ent
                with self._lock:
                    self._folded[(phase, stack)] += 1
                    self._samples.append((now, tid, phase, leaf))
                taken += 1
        finally:
            del frames  # frame objects pin their locals — drop promptly
        self.samples_taken += taken
        self.ticks += 1
        return taken

    def _loop(self) -> None:
        period = 1.0 / self.hz
        next_t = time.monotonic() + period
        while not self._stop_evt.wait(max(next_t - time.monotonic(), 0.0)):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — a profiler must never crash
                pass           # the process it watches
            next_t += period
            if next_t < time.monotonic() - 1.0:
                next_t = time.monotonic() + period  # fell behind: re-anchor

    # -- exports --------------------------------------------------------
    def folded(self, top: Optional[int] = None) -> str:
        """Collapsed-stack text: ``phase;frame;...;frame count`` per line
        (flamegraph.pl / speedscope input), hottest first."""
        with self._lock:
            items = self._folded.most_common(top)
        return "\n".join(f"{phase};{stack} {n}" if stack else f"{phase} {n}"
                         for (phase, stack), n in items)

    def phase_seconds(self) -> Dict[str, float]:
        """Approximate seconds spent per span phase (samples / hz)."""
        with self._lock:
            agg: Dict[str, float] = {}
            for (phase, _stack), n in self._folded.items():
                agg[phase] = agg.get(phase, 0.0) + n / self.hz
        return dict(sorted(agg.items(), key=lambda kv: -kv[1]))

    def recent(self, seconds: float = 10.0) -> List[dict]:
        """The last ``seconds`` of raw samples (the flight recorder's
        slice), ts rebased to the tracer's epoch so they merge with span
        timestamps."""
        cutoff = time.monotonic() - seconds
        epoch = _trace.tracer._epoch
        with self._lock:
            return [{"ts": ts - epoch, "tid": tid, "phase": phase,
                     "leaf": leaf}
                    for ts, tid, phase, leaf in self._samples
                    if ts >= cutoff]

    def chrome_events(self, seconds: Optional[float] = None) -> List[dict]:
        """The sample stream as a chrome-trace profiler lane: consecutive
        samples on one thread with the same (phase, leaf) coalesce into
        one ``X`` span named ``prof:<phase>`` (args carry the leaf frame).
        Normalized dicts (ts/dur in tracer-epoch seconds) — the schema
        ``trace_report.merge_loaded`` and telemetry parts speak."""
        period = 1.0 / self.hz
        cutoff = None if seconds is None else time.monotonic() - seconds
        epoch = _trace.tracer._epoch
        with self._lock:
            samples = [s for s in self._samples
                       if cutoff is None or s[0] >= cutoff]
        runs: Dict[int, list] = {}
        out: List[dict] = []

        def flush(tid):
            run = runs.pop(tid, None)
            if run is None:
                return
            t0, t_last, phase, leaf, n = run
            out.append({"ph": "X", "name": f"prof:{phase}",
                        "ts": t0 - epoch,
                        "dur": (t_last - t0) + period,
                        "tid": tid,
                        "args": {"leaf": leaf, "samples": n}})

        for ts, tid, phase, leaf, in samples:
            run = runs.get(tid)
            if (run is not None and run[2] == phase and run[3] == leaf
                    and ts - run[1] <= 2.5 * period):
                run[1] = ts
                run[4] += 1
            else:
                flush(tid)
                runs[tid] = [ts, ts, phase, leaf, 1]
        for tid in list(runs):
            flush(tid)
        out.sort(key=lambda e: e["ts"])
        return out

    def stats(self) -> dict:
        with self._lock:
            distinct = len(self._folded)
            buffered = len(self._samples)
        return {"hz": self.hz, "running": self.running(),
                "ticks": self.ticks, "samples": self.samples_taken,
                "distinct_stacks": distinct, "buffered": buffered}

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._folded.clear()
        self.samples_taken = 0
        self.ticks = 0


# ---------------------------------------------------------------------------
# module-level singleton
# ---------------------------------------------------------------------------

profiler: Optional[SamplingProfiler] = None


def enabled() -> bool:
    return profiler is not None and profiler.running()


def start(hz: Optional[float] = None) -> SamplingProfiler:
    """Start (or return) the process profiler at ``hz``
    (``MXNET_OBS_PROF_HZ``, default 67)."""
    global profiler
    if profiler is not None and profiler.running():
        return profiler
    profiler = SamplingProfiler(hz=hz)
    return profiler.start()


def stop() -> None:
    global profiler
    if profiler is not None:
        profiler.stop()


def folded(top: Optional[int] = None) -> str:
    return profiler.folded(top) if profiler is not None else ""


def chrome_events(seconds: Optional[float] = None) -> List[dict]:
    return profiler.chrome_events(seconds) if profiler is not None else []


def recent(seconds: float = 10.0) -> List[dict]:
    return profiler.recent(seconds) if profiler is not None else []
