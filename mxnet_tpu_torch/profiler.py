"""``mx.profiler``: dispatch counting (counterpart of the dispatch-counting
part of ``mxnet_tpu/profiler.py``).

The reference counts compiled XLA program executions. The port runs
eagerly, so a region counts what a step really sends to the device:

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
them and, with telemetry on, the counters accumulate globally.

The rest of ``mx.profiler`` (``set_config``, ``set_state``, ``dump``, the
aggregate statistics, ``Profiler``) is queue item A15(g) of the port and
raises naming it.
"""
from __future__ import annotations

import contextlib
import threading

from . import obs as _obs
from .base import MXNetError

__all__ = ["DispatchCounts", "count_dispatches", "count_dispatch",
           "counting_dispatches"]

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
    engine's, which inherits its mode)."""
    global _open_regions
    c = DispatchCounts()
    before = _dispatch_totals()
    with _lock:
        _open_regions += 1
    try:
        with _op_counter(c):
            yield c
    finally:
        with _lock:
            _open_regions -= 1
        after = _dispatch_totals()
        for k, v in after.items():
            setattr(c, k, v - before[k])


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise MXNetError(f"mx.profiler.{name}: the profiler beyond dispatch "
                     "counting is queue item A15(g) of the port, not "
                     "ported yet")
