"""``mx.profiler`` over ``torch.profiler`` (counterpart of
``mxnet_tpu/profiler.py``).

**Traces.** ``set_config(filename=...)``, ``set_state("run"|"stop")``,
``pause``/``resume``, ``dump`` and the ``Profiler`` context manager run
``torch.profiler.profile`` with the CPU and (on a machine with a card)
CUDA activities: the device timeline holds every kernel the card ran, the
port's hand-written ones under their CUDA symbol names
(``flash_fwd_ffma_kernel``, ...). ``dump`` writes one chrome-trace JSON
at ``filename`` (the reference writes an XPlane directory beside it).
Start and stop are idempotent both ways and land as ``obs`` events
(``profiler.start_trace``/``profiler.stop_trace``). ``scope(name)`` is a
``torch.profiler.record_function`` range on the timeline.

**Aggregate statistics.** With ``aggregate_stats=True`` the eager
dispatch point (``ndarray.invoke``) times every op while the profiler
runs, waiting for the card after each (as the reference blocks on each
op), and ``dumps()`` prints the reference's table.

**Dispatch counting.** The reference counts compiled XLA program
executions. The port runs eagerly, so a region counts what a step really
sends to the device:

- ``compiled``: the program-level calls at the sites that stand for the
  reference's programs (the fused update engine, the Executor's forward
  and backward, a hybridized block's ``CachedOp``);
- ``eager_ops``: every operator dispatched while the region is open, as a
  ``TorchDispatchMode`` sees it (installed only while a region is open,
  as ``obs/device.py``'s capture is), the operators of those programs
  included;
- ``d2h``: host reads, counted at the sites that read
  (``NDArray.asnumpy``/``asscalar``, ``obs.health.batched_fetch``);
- ``h2d``: host-to-device copies counted at their sites (none of the
  training sites copies).

``compiled``, ``h2d`` and ``d2h`` live in the obs metrics registry
(``dispatch.*`` counters) as in the reference, so a region is a delta over
them and, with telemetry on, the counters accumulate globally. A thread's
outermost region adds its ``eager_ops`` to ``dispatch.eager_ops`` when it
exits, so the registry holds every counted operator as the reference's
holds every program.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import warnings

from . import obs as _obs

__all__ = ["set_config", "set_state", "dump", "dumps", "pause", "resume",
           "scope", "Profiler", "DispatchCounts", "count_dispatches",
           "count_dispatch", "counting_dispatches"]

_config = {"filename": "profile.json", "profile_all": False,
           "aggregate_stats": False}
# windows: the torch profiles stopped since the last dump, in order
_state = {"running": False, "prof": None, "windows": [], "file": None}

# ---------------------------------------------------------------------------
# Aggregate per-op statistics: a timing wrapper at the eager dispatch choke
# point (ndarray.invoke), active only while the profiler runs with
# aggregate_stats=True, because a per-op time must wait for the card.
# ---------------------------------------------------------------------------

_agg: dict = {}


def aggregate_active() -> bool:
    return _state["running"] and bool(_config.get("aggregate_stats"))


def record_op(name: str, seconds: float) -> None:
    ent = _agg.get(name)
    if ent is None:
        _agg[name] = [1, seconds, seconds, seconds]
    else:
        ent[0] += 1
        ent[1] += seconds
        ent[2] = min(ent[2], seconds)
        ent[3] = max(ent[3], seconds)


def reset_stats() -> None:
    _agg.clear()


def set_config(**kwargs):
    """``profile_{all,symbolic,imperative,memory,api}=...``,
    ``filename=...``, ``aggregate_stats=...``: the reference's keyword
    arguments are accepted; the trace holds every host op and card kernel
    of its window whatever they say."""
    _config.update(kwargs)


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def set_state(state="stop", profile_process="worker"):
    """Start or stop the trace. Idempotent both ways: a second "run" while
    a window is open (or while some other code runs ``torch.profiler``)
    adopts the open window instead of raising into a training loop."""
    import torch

    if state in ("run", 1):
        if _state["running"]:
            return  # double start: the window is already open
        prof = torch.profiler.profile(activities=_activities())
        try:
            prof.start()
        except RuntimeError as e:
            # adopt ONLY the double-start case; any other RuntimeError is
            # a genuine failure the caller must see
            if "already" not in str(e).lower():
                raise
            warnings.warn(f"torch profiler already running ({e}); adopting "
                          "the active window", stacklevel=2)
            prof = None
        _state.update(running=True, prof=prof)
        _obs.event("profiler.start_trace",
                   file=_config.get("filename", "profile.json"))
    elif state in ("stop", 0):
        if not _state["running"]:
            return  # double stop: nothing open
        prof = _state["prof"]
        if prof is not None:
            try:
                prof.stop()
                _state["windows"].append(prof)
            except RuntimeError as e:  # the profile died under us
                warnings.warn(f"torch profiler stop: {e}", stacklevel=2)
        _state.update(running=False, prof=None)
        _obs.event("profiler.stop_trace",
                   file=_config.get("filename", "profile.json"))
    else:
        raise ValueError(f"invalid profiler state {state!r}")


def pause(profile_process="worker"):
    """Close the open window; ``resume`` opens the next. ``dump`` writes
    every window since the last dump into one trace."""
    set_state("stop")


def resume(profile_process="worker"):
    set_state("run")


def _trace_events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def dump(finished=True, profile_process="worker"):
    """Stop tracing and write the windows since the last dump as one
    chrome-trace JSON at the configured ``filename``; returns its path."""
    set_state("stop")
    path = _config.get("filename", "profile.json")
    if not path.endswith(".json"):
        path += ".json"
    events = []
    for prof in _state["windows"]:
        events.extend(_trace_events(prof))
    _state["windows"] = []
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    _state["file"] = path
    return path


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """The aggregate per-op statistics table (the reference's
    ``profiler.dumps()``) after a pointer to the last trace written."""
    lines = [f"profiler trace file: {_state.get('file')}"]
    if _agg:
        key_idx = {"total": 1, "count": 0, "min": 2, "max": 3,
                   "avg": None}.get(sort_by, 1)
        items = list(_agg.items())
        if key_idx is None:
            items.sort(key=lambda kv: kv[1][1] / kv[1][0],
                       reverse=not ascending)
        else:
            items.sort(key=lambda kv: kv[1][key_idx], reverse=not ascending)
        lines.append("")
        lines.append("Profile Statistics (eager op dispatch):")
        lines.append(f"{'Name':<32}{'Count':>8}{'Total(ms)':>12}"
                     f"{'Min(ms)':>10}{'Max(ms)':>10}{'Avg(ms)':>10}")
        for name, (cnt, tot, mn, mx) in items:
            lines.append(f"{name:<32}{cnt:>8}{tot * 1e3:>12.3f}"
                         f"{mn * 1e3:>10.3f}{mx * 1e3:>10.3f}"
                         f"{tot / cnt * 1e3:>10.3f}")
    if reset:
        reset_stats()
    return "\n".join(lines)


@contextlib.contextmanager
def scope(name: str):
    """A named range on the trace's timeline (the reference's profiler
    scopes)."""
    import torch

    with torch.profiler.record_function(name):
        yield


class Profiler:
    """Context manager: profile a region and dump it at exit."""

    def __init__(self, filename="profile", **kwargs):
        set_config(filename=filename, **kwargs)

    def __enter__(self):
        set_state("run")
        return self

    def __exit__(self, *a):
        dump()

_DISPATCH_KINDS = ("compiled", "eager_ops", "h2d", "d2h")


class DispatchCounts:
    """Counters for one measured region."""

    __slots__ = ("compiled", "eager_ops", "h2d", "d2h")

    def __init__(self):
        self.compiled = 0   # program-level calls (engine, executor, CachedOp)
        self.eager_ops = 0  # operators dispatched
        self.h2d = 0        # host-to-device copies
        self.d2h = 0        # device-to-host reads

    @property
    def total_compiled(self):
        return self.compiled + self.eager_ops

    def as_dict(self):
        return {"compiled_calls": self.compiled, "eager_ops": self.eager_ops,
                "total_compiled": self.total_compiled,
                "h2d_transfers": self.h2d, "d2h_transfers": self.d2h}

    def __repr__(self):
        return f"DispatchCounts({self.as_dict()})"


_open_regions = 0  # count_dispatches() nesting depth
_lock = threading.Lock()
_region_depth = threading.local()  # this thread's open regions


def counting_dispatches() -> bool:
    """Call-site guard: True while a count_dispatches() region is open or
    obs telemetry is enabled (the registry then accumulates globally)."""
    return _open_regions > 0 or _obs.enabled()


def count_dispatch(kind: str, n: int = 1) -> None:
    _obs.metrics.registry.counter("dispatch." + kind).inc(n)


def _dispatch_totals() -> dict:
    reg = _obs.metrics.registry
    return {k: reg.counter("dispatch." + k).value for k in _DISPATCH_KINDS
            if k != "eager_ops"}


def _op_counter(counts: DispatchCounts):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts.eager_ops += 1
            return func(*args, **(kwargs or {}))

    return _Counting()


@contextlib.contextmanager
def count_dispatches():
    """Count program calls, operators and transfers in a region::

        with profiler.count_dispatches() as c:
            trainer.step(batch_size)
        assert c.d2h == 0

    The yielded counts are final when the region exits. Operators are
    counted on the thread that opened the region (and the autograd
    engine's, which inherits its mode); the outermost region of a thread
    adds its operators to the registry's ``dispatch.eager_ops`` when it
    exits (a nested region's are already in its parent's count)."""
    global _open_regions
    c = DispatchCounts()
    before = _dispatch_totals()
    depth = getattr(_region_depth, "n", 0)
    _region_depth.n = depth + 1
    with _lock:
        _open_regions += 1
    try:
        with _op_counter(c):
            yield c
    finally:
        with _lock:
            _open_regions -= 1
        _region_depth.n = depth
        after = _dispatch_totals()
        for k, v in after.items():
            setattr(c, k, v - before[k])
        if depth == 0:
            count_dispatch("eager_ops", c.eager_ops)

