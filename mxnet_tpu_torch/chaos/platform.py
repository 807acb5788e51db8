"""Platform-outage injection: simulate a hung first touch of the card
(counterpart of ``mxnet_tpu/chaos/platform.py``).

``mxnet_tpu_torch.platform`` runs the first touch of CUDA (``torch.cuda.
init``/``device_count``, the first tensor placed on the card) under a
watchdog; this injector makes a hang there reproducible on demand, so the
degradation path (a raised ``PlatformUnavailable``, or a bounded exit with
one parseable ``platform_unavailable`` artifact line) is a tested
contract.

``MXNET_CHAOS_TUNNEL_HANG`` names the guard points to hang:

- ``1`` / ``all`` / ``*`` — every guarded platform call blocks;
- a comma list (e.g. ``cuda.devices,device_put``) — only those points.

The hook runs *inside* the watchdog's worker thread and blocks it forever
(a daemon thread, so it dies with the process): the caller sees no
exception and no return until the watchdog fires. Like every injector in
this package it is one env lookup when disabled.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Set

__all__ = ["hang_points", "hang_if_injected"]

_ALL = {"1", "all", "*", "true", "yes"}


def hang_points() -> Optional[Set[str]]:
    """Parsed ``MXNET_CHAOS_TUNNEL_HANG``: None when off, ``{"*"}`` for
    every point, else the set of guard-point names to hang. Parsed per
    call — subprocess tests flip the env var at runtime."""
    spec = os.environ.get("MXNET_CHAOS_TUNNEL_HANG", "").strip()
    if not spec:
        return None
    if spec.lower() in _ALL:
        return {"*"}
    return {p.strip() for p in spec.split(",") if p.strip()}


def hang_if_injected(point: str) -> None:
    """Block forever if chaos targets this guard point (called from inside
    the platform watchdog's worker thread)."""
    pts = hang_points()
    if pts is None or ("*" not in pts and point not in pts):
        return
    from .. import obs

    obs.event("chaos.tunnel_hang", point=point)
    while True:  # the real outage never returns either
        time.sleep(3600)
