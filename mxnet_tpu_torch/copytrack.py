"""Data-plane copy and sync accounting, ``MXNET_COPYTRACK=1``
(counterpart of ``mxnet_tpu/copytrack.py``): the runtime twin of
``analysis/dataplane.py``.

The static pass proves *where* array bytes can be copied or a host sync
can happen on a hot path; this module measures *how much*, per process,
at the choke points every request transits:

- wire framing (``kvstore/ps_server.py``: ``_array_parts`` counts each
  array packed for the wire, ``_pack_array``'s join, ``_pack_arrays``'
  join, ``_unpack_array``'s copy out of the frame, ``_send_parts`` to a
  socket without ``sendmsg``); ``_recv_exact`` receives into one buffer
  and copies nothing;
- batcher assembly (``serve/batcher.py``, the per-batch concatenation);
- the device boundary: a host sync is a ``host_array``, ``.item()``,
  ``.tolist()`` or ``synchronize`` on a card tensor
  (``serve/engine.py``'s output read, ``serve/decode.py``'s token read).

Counters: ``wire.bytes_copied`` (every byte moved by a host-side buffer
copy), ``wire.serialize_calls`` / ``wire.serialize_bytes`` (array to wire
packs), ``hotpath.host_syncs`` (device-to-host reads, by site). They feed
``copytrack.snapshot()`` while enabled (``serve_bench --wire-hop``
divides its deltas by the requests) and, when telemetry is also on, the
``obs`` metrics registry under the same names.

Zero overhead when off: every site calls ``copytrack.TRACKER.<method>``.
While ``MXNET_COPYTRACK`` is unset, ``TRACKER`` is the no-op singleton
``NULL``: one attribute lookup and an empty call, no locks, no env reads.
"""
from __future__ import annotations

import threading
from typing import Dict

from .base import get_env

__all__ = ["enabled", "enable", "disable", "reset", "snapshot",
           "TRACKER", "NULL"]


class _NullTracker:
    """No-op singleton bound to ``TRACKER`` while tracking is off."""

    __slots__ = ()
    enabled = False

    def copied(self, nbytes):
        pass

    def serialized(self, nbytes, calls=1):
        pass

    def host_sync(self, site=""):
        pass

    def snapshot(self) -> Dict[str, float]:
        return {}


class _Tracker:
    """Live counters; one lock, increments only (hot-path friendly)."""

    __slots__ = ("_mu", "bytes_copied", "serialize_calls",
                 "serialize_bytes", "host_syncs", "sync_sites")
    enabled = True

    def __init__(self):
        self._mu = threading.Lock()
        self.bytes_copied = 0
        self.serialize_calls = 0
        self.serialize_bytes = 0
        self.host_syncs = 0
        self.sync_sites: Dict[str, int] = {}

    def copied(self, nbytes) -> None:
        n = int(nbytes)
        with self._mu:
            self.bytes_copied += n
        _obs_inc("wire.bytes_copied", n)

    def serialized(self, nbytes, calls=1) -> None:
        n = int(nbytes)
        with self._mu:
            self.serialize_calls += calls
            self.serialize_bytes += n
        _obs_inc("wire.serialize_calls", calls)
        _obs_inc("wire.serialize_bytes", n)

    def host_sync(self, site="") -> None:
        with self._mu:
            self.host_syncs += 1
            if site:
                self.sync_sites[site] = self.sync_sites.get(site, 0) + 1
        _obs_inc("hotpath.host_syncs", 1)

    def snapshot(self) -> Dict[str, float]:
        with self._mu:
            return {
                "wire.bytes_copied": self.bytes_copied,
                "wire.serialize_calls": self.serialize_calls,
                "wire.serialize_bytes": self.serialize_bytes,
                "hotpath.host_syncs": self.host_syncs,
                "hotpath.sync_sites": dict(self.sync_sites),
            }


def _obs_inc(name: str, n: int) -> None:
    # forward into the metrics registry so STATS/Prometheus surface the
    # counters when telemetry is on; obs.inc is itself no-op-when-off
    from . import obs

    obs.inc(name, n)


NULL = _NullTracker()
TRACKER = NULL  # rebound by enable()/disable(); call sites read it live


def enabled() -> bool:
    return TRACKER is not NULL


def enable() -> "_Tracker":
    """Swap in a live tracker (idempotent; keeps existing counters)."""
    global TRACKER
    if TRACKER is NULL:
        TRACKER = _Tracker()
    return TRACKER


def disable() -> None:
    global TRACKER
    TRACKER = NULL


def reset() -> None:
    """Zero the counters without changing the enabled state."""
    global TRACKER
    if TRACKER is not NULL:
        TRACKER = _Tracker()


def snapshot() -> Dict[str, float]:
    """Current counters (``{}`` while disabled)."""
    return TRACKER.snapshot()


if get_env("MXNET_COPYTRACK", False, bool):
    enable()
