"""Guarded platform entry points: the first touch of the card under a
watchdog (counterpart of ``mxnet_tpu/platform.py``).

A driver whose first touch of the accelerator blocks forever ships no
artifact and no error. Every first touch of the platform here —
``torch.cuda.init``/``device_count`` and the first tensor placed on the
card — goes through a **watchdog**: the call runs in a daemon worker
thread, the caller waits at most ``timeout`` seconds, and a hang becomes a
raised :class:`PlatformUnavailable` carrying a machine-parseable artifact.
A raise during that first touch (no card, a broken driver) is a
``platform_init_failed`` of its own. Neither is ever turned into a run on
the CPU: ``devices_or_exit()`` prints ONE JSON line (schema
``mxnet_tpu.platform_error/1``, the reference's) and exits non-zero in
bounded time.

Guard points, named after what they guard: ``cuda.devices`` (CUDA's
initialization and enumeration), ``cpu.devices`` (a tool run with
``--device cpu``, which needs no card) and ``device_put`` (the first
tensor placed on a device).

Chaos twin: ``MXNET_CHAOS_TUNNEL_HANG`` (``chaos/platform.py``) blocks the
worker thread at a named guard point, so the bounded exit is asserted by
tests. ``MXNET_PLATFORM_TIMEOUT`` overrides the default budget (seconds);
a call's ``timeout=`` wins over both.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, List, Optional

from .base import MXNetError

__all__ = ["PlatformUnavailable", "call_with_watchdog", "devices",
           "devices_or_exit", "device_put", "emit_artifact",
           "virtual_cpu_env", "ARTIFACT_SCHEMA", "default_timeout"]

ARTIFACT_SCHEMA = "mxnet_tpu.platform_error/1"


def default_timeout() -> float:
    """Watchdog budget in seconds (``MXNET_PLATFORM_TIMEOUT``, default 90,
    under the 120 s within which every driver must exit)."""
    return float(os.environ.get("MXNET_PLATFORM_TIMEOUT", 90))


class PlatformUnavailable(MXNetError):
    """A guarded platform call hung past its watchdog (``kind =
    "platform_unavailable"``) or raised (``kind = "platform_init_failed"``:
    a real driver or configuration failure, not the known hang)."""

    def __init__(self, what: str, detail: str, *, kind: str,
                 timeout_s: float, elapsed_s: float):
        super().__init__(f"{kind}: {what}: {detail}")
        self.what = what
        self.detail = detail
        self.kind = kind
        self.timeout_s = timeout_s
        self.elapsed_s = elapsed_s

    def artifact(self, **extra: Any) -> dict:
        """The machine-parseable error record every driver emits."""
        out = {
            "schema": ARTIFACT_SCHEMA,
            "error": self.kind,
            "what": self.what,
            "detail": self.detail[:300],
            "timeout_s": round(self.timeout_s, 1),
            "elapsed_s": round(self.elapsed_s, 1),
            "pid": os.getpid(),
            "argv0": os.path.basename(sys.argv[0]) if sys.argv else "",
        }
        if self.kind == "platform_unavailable":
            out["hint"] = ("accelerator unresponsive at its first touch: a "
                           "platform outage, not a framework failure")
        out.update(extra)
        return out


def call_with_watchdog(fn: Callable[[], Any], *, what: str,
                       timeout: Optional[float] = None) -> Any:
    """Run ``fn()`` in a daemon worker thread, waiting at most ``timeout``
    seconds. A hang raises :class:`PlatformUnavailable` (the worker is
    abandoned and dies with the process); an exception from ``fn`` is
    raised again as ``platform_init_failed`` with its message."""
    from .chaos.platform import hang_if_injected

    budget = default_timeout() if timeout is None else float(timeout)
    result: List[Any] = []
    error: List[BaseException] = []

    def _run():
        try:
            hang_if_injected(what)  # chaos: the blocking first-touch hook
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 — reported via the artifact
            error.append(e)

    t0 = time.monotonic()
    worker = threading.Thread(target=_run, daemon=True,
                              name=f"mxtpu-platform-watchdog[{what}]")
    worker.start()
    worker.join(timeout=budget)
    elapsed = time.monotonic() - t0
    if worker.is_alive():
        raise PlatformUnavailable(
            what, f"no response within {budget:g}s watchdog",
            kind="platform_unavailable", timeout_s=budget, elapsed_s=elapsed)
    if error:
        e = error[0]
        raise PlatformUnavailable(
            what, f"{type(e).__name__}: {e}", kind="platform_init_failed",
            timeout_s=budget, elapsed_s=elapsed) from e
    return result[0]


def _cuda_devices():
    import torch

    torch.cuda.init()  # raises without a card: never a CPU fallback
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("torch.cuda.device_count() is 0")
    return [torch.device("cuda", i) for i in range(n)]


def devices(timeout: Optional[float] = None, backend: Optional[str] = None):
    """The cards (``torch.device("cuda", i)``), CUDA initialized and
    enumerated under the watchdog (guard point ``cuda.devices``).
    ``backend="cpu"`` returns ``[torch.device("cpu")]`` under guard point
    ``cpu.devices``, for a tool told to run on the CPU."""
    if backend == "cpu":
        import torch

        return call_with_watchdog(lambda: [torch.device("cpu")],
                                  what="cpu.devices", timeout=timeout)
    if backend not in (None, "cuda", "gpu"):
        raise ValueError(f"unknown backend {backend!r}")
    return call_with_watchdog(_cuda_devices, what="cuda.devices",
                              timeout=timeout)


def device_put(x, device=None, timeout: Optional[float] = None):
    """The first tensor placed on ``device`` (default ``cuda:0``) under the
    watchdog (guard point ``device_put``): a card that enumerates but no
    longer moves bytes still fails in bounded time. Later transfers stay
    unguarded (a watchdog thread a copy would distort what is measured)."""
    import torch

    dev = torch.device("cuda", 0) if device is None else torch.device(device)

    def _put():
        t = torch.as_tensor(x).to(dev)
        if t.is_cuda:
            torch.cuda.synchronize(dev)  # the bytes have landed
        return t

    return call_with_watchdog(_put, what="device_put", timeout=timeout)


def emit_artifact(err: PlatformUnavailable, stream=None, **extra) -> dict:
    """Print the one-line JSON platform-error artifact (flushed: the
    process is usually about to exit) and return it."""
    art = err.artifact(**extra)
    print(json.dumps(art), file=stream or sys.stdout, flush=True)
    return art


def devices_or_exit(what: str = "", timeout: Optional[float] = None,
                    exit_code: int = 1, backend: Optional[str] = None,
                    **extra):
    """Driver preamble: return the device list, or emit the platform-error
    artifact and exit — a hung or missing card costs one watchdog budget.
    ``what`` names the driver in the artifact; ``backend="cpu"`` for a
    tool run with ``--device cpu``."""
    try:
        return devices(timeout=timeout, backend=backend)
    except PlatformUnavailable as e:
        if what:
            extra.setdefault("driver", what)
        emit_artifact(e, **extra)
        sys.exit(exit_code)


def virtual_cpu_env(n_devices: int, base: Optional[dict] = None) -> dict:
    """A child process's environment that hides the card
    (``CUDA_VISIBLE_DEVICES`` empty) and strips the hang injector, which
    simulates a fault of the card that a CPU child never touches.

    The reference's sets an XLA host-device count: one process then holds
    ``n_devices`` virtual CPU devices. A port process holds one device; a
    CPU mesh of ``n_devices`` is that many processes
    (``python -m mxnet_tpu_torch.tools.launch -n N``), so ``n_devices`` is
    only checked here."""
    if int(n_devices) < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    env = dict(os.environ if base is None else base)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("MXNET_CHAOS_TUNNEL_HANG", None)
    return env
