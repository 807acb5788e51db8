"""Measurement tools of the port (run on a CUDA card)."""
import time


def join_all(threads, timeout: float, what: str = "bench") -> None:
    """Join every thread of ``threads`` within ``timeout`` seconds in all.
    A thread still alive after it is work the tool lost track of: raise
    rather than report numbers without it."""
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [t for t in threads if t.is_alive()]
    if alive:
        raise RuntimeError(f"{what}: {len(alive)} thread(s) still running "
                           f"after {timeout} s")
