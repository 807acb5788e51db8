"""Process-level fault injection: SIGKILL at named code points or at a
chosen training step (counterpart of ``mxnet_tpu/chaos/proc.py``).

Kill points
-----------
Production code calls ``kill_point("name")`` at interesting instants (the
checkpoint writer brackets its commit with ``ckpt:post_arrays`` /
``ckpt:pre_rename`` / ``ckpt:post_rename``). With
``MXNET_CHAOS_KILL="ckpt:pre_rename@3"`` the process SIGKILLs itself the 3rd
time that point is reached — no cleanup handlers run, exactly like a
preempted VM vanishing. Comma-separate multiple entries; omit ``@n`` to die
on the first hit. When the env var is unset the hook is one dict lookup.

Step-targeted kills
-------------------
:func:`run_until_step` launches a training subprocess that prints
``CHAOS_STEP <n>`` markers (``python -m mxnet_tpu_torch.tools.chaos_kill
--train`` does) and SIGKILLs it the
moment step N is reported — the flagship elastic-training test kills
mid-epoch and asserts a resumed run is bitwise identical to an uninterrupted
one.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import List, Optional, Tuple

__all__ = ["kill_point", "reset_kill_points", "run_until_step",
           "corrupt_file", "STEP_MARKER"]

STEP_MARKER = "CHAOS_STEP"

_counters: dict = {}
_parsed: Optional[dict] = None


def _plan() -> dict:
    global _parsed
    if _parsed is None:
        plan = {}
        for part in filter(None, os.environ.get("MXNET_CHAOS_KILL",
                                                "").split(",")):
            point, _, occ = part.strip().partition("@")
            plan[point] = int(occ) if occ else 1
        _parsed = plan
    return _parsed


def reset_kill_points() -> None:
    global _parsed
    _parsed = None
    _counters.clear()


def kill_point(name: str) -> None:
    """SIGKILL this process if MXNET_CHAOS_KILL targets the Nth hit of
    ``name``. SIGKILL, not sys.exit: atexit/finally must not run — a real
    preemption doesn't unwind the stack either."""
    plan = _plan()
    if not plan or name not in plan:
        return
    _counters[name] = _counters.get(name, 0) + 1
    if _counters[name] == plan[name]:
        # last words to the telemetry stream: the ring buffer dies with the
        # process, but a JSONL stream (MXNET_OBS_JSONL) is flushed per
        # event, so the kill shows up in the post-mortem timeline
        from .. import obs

        obs.event("chaos.kill", point=name, occurrence=_counters[name])
        os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------------------
# subprocess orchestration
# ---------------------------------------------------------------------------

def run_until_step(cmd: List[str], kill_at_step: int, env: Optional[dict] = None,
                   timeout: float = 300.0,
                   marker: str = STEP_MARKER) -> Tuple[int, str]:
    """Run ``cmd``, SIGKILL it when its stdout reports ``<marker> N`` with
    N >= kill_at_step. Returns (returncode, collected stdout). -SIGKILL as
    the returncode confirms the kill landed; any other code means the run
    finished before reaching the step (the caller should assert on this).
    """
    import threading

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines: List[str] = []
    killed = False
    timed_out = threading.Event()

    def _expire():
        # the read loop blocks in readline(); a victim that hangs without
        # output would block the harness forever without this watchdog
        timed_out.set()
        proc.kill()

    watchdog = threading.Timer(timeout, _expire)
    watchdog.start()
    try:
        assert proc.stdout is not None
        for line in proc.stdout:
            lines.append(line)
            if not killed and line.startswith(marker):
                try:
                    step = int(line.split()[1])
                except (IndexError, ValueError):
                    continue
                if step >= kill_at_step:
                    os.kill(proc.pid, signal.SIGKILL)
                    killed = True
        proc.wait(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    if timed_out.is_set():
        raise TimeoutError(
            f"run_until_step timed out:\n{''.join(lines[-50:])}")
    return proc.returncode, "".join(lines)


def run_to_completion(cmd: List[str], env: Optional[dict] = None,
                      timeout: float = 300.0) -> Tuple[int, str]:
    """Run ``cmd`` to completion, returning (returncode, stdout+stderr)."""
    out = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env,
                         timeout=timeout)
    return out.returncode, out.stdout


def corrupt_file(path: str, offset: int = -8, flip: int = 0xFF) -> None:
    """Flip bits of one byte in ``path`` (negative offset = from the end).
    The CRC layers must catch this."""
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        pos = offset if offset >= 0 else size + offset
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ flip]))


def main(argv=None):  # pragma: no cover - thin CLI shim
    from . import __doc__ as chaos_doc

    print(chaos_doc)
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
