"""CheckpointManager — crash-safe, async, self-verifying checkpoints
(counterpart of ``mxnet_tpu/checkpoint/manager.py``; the same on-disk
layout, so either package reads the other's checkpoints).

On-disk layout (one directory per checkpoint, committed by rename):

    <dir>/<prefix>-00000042/
        arrays.bin      all tensors in the reference NDArray container
                        (with the CRC32 footer serialization.save_nd writes)
        manifest.json   written LAST: format version, step, training meta,
                        and a per-array {crc32, shape, dtype} table

Commit protocol: everything is staged in ``.<name>.tmp-<pid>/``, fsynced,
then the directory is renamed into place and the parent fsynced. A crash at
ANY instant (the chaos suite SIGKILLs mid-rename to prove it) therefore
leaves either the previous set of valid checkpoints, or the previous set
plus one fully valid new one — never a half-written one that parses.
The writer brackets its commit with the chaos kill points
``ckpt:post_arrays``, ``ckpt:pre_rename`` and ``ckpt:post_rename``
(``chaos/proc.py``, ``MXNET_CHAOS_KILL``). The writer records the
reference's telemetry: the ``checkpoint.saves``/``.coalesced``/
``.write_errors``/``.writer_thread_leaked`` counters, the ``.queue_depth``
gauge, the ``checkpoint.write`` span and the array-write, fsync, commit
and whole-write histograms.

Validation on load checks the manifest parses, arrays.bin's footer CRC, and
every per-array CRC; ``load_latest`` walks newest→oldest and silently skips
anything invalid (truncated arrays.bin, flipped bytes, missing manifest),
falling back to the newest checkpoint that verifies.

The async writer thread means ``save()`` costs one host snapshot, not one
disk round-trip, so the step loop never blocks on storage.
"""
from __future__ import annotations

import logging
import os
import queue
import re
import shutil
import signal
import threading
import time
from typing import List, Optional

import torch

from .. import obs
from .atomic import atomic_write_json, crc32_bytes, fsync_dir, read_json
from .state import FORMAT_VERSION, TrainingState

__all__ = ["CheckpointManager", "CheckpointError"]

log = logging.getLogger("mxnet_tpu_torch.checkpoint")

_ARRAYS_FILE = "arrays.bin"
_MANIFEST_FILE = "manifest.json"


class CheckpointError(Exception):
    """A checkpoint failed to write, or failed validation on load."""


class CheckpointManager:
    """Manages a directory of atomic, CRC-verified training checkpoints.

    Parameters
    ----------
    directory : str
        Where checkpoints live (created if missing).
    prefix : str
        Checkpoint directory name prefix (``<prefix>-<step:08d>``).
    keep_last : int
        Garbage-collect all but the newest N valid checkpoints (0 = keep all).
    async_write : bool
        Write on a background thread; ``save()`` only snapshots to host
        memory. ``flush()`` / ``close()`` drain the queue.
    """

    def __init__(self, directory: str, prefix: str = "ckpt",
                 keep_last: int = 3, async_write: bool = True):
        self.directory = str(directory)
        self.prefix = prefix
        self.keep_last = int(keep_last)
        self._async = bool(async_write)
        os.makedirs(self.directory, exist_ok=True)
        self._name_re = re.compile(
            r"^" + re.escape(prefix) + r"-(\d{8})$")
        self._queue: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.preempted = threading.Event()
        self.preempt_signum: Optional[int] = None
        self._orig_handlers = None
        self._sweep_stale_tmp()

    # ------------------------------------------------------------------
    # naming / discovery
    # ------------------------------------------------------------------
    def _name(self, step: int) -> str:
        return f"{self.prefix}-{step:08d}"

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, self._name(step))

    def list_steps(self) -> List[int]:
        """All committed (renamed-into-place) checkpoint steps, ascending.
        Commitment is not validity — see :meth:`validate`."""
        steps = []
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return []
        for e in entries:
            m = self._name_re.match(e)
            if m and os.path.isdir(os.path.join(self.directory, e)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def _sweep_stale_tmp(self):
        """Remove staging dirs a crashed writer left behind (safe at init:
        no writer of ours is running yet)."""
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        for e in entries:
            if e.startswith(".") and ".tmp-" in e:
                shutil.rmtree(os.path.join(self.directory, e),
                              ignore_errors=True)

    # ------------------------------------------------------------------
    # writing
    # ------------------------------------------------------------------
    def save(self, state: TrainingState, step: int, block: bool = False):
        """Persist ``state`` as checkpoint ``step``.

        Async by default: enqueue and return (the state's arrays are already
        host-side copies — see ``capture_training_state``). ``block=True``
        writes synchronously in the calling thread (used for the final
        preemption flush).
        """
        self._raise_pending_write_error()
        if self._async and not block:
            self._ensure_writer()
            # coalesce under backpressure: each queued item is a FULL host
            # snapshot, so a writer slower than the save cadence must not
            # grow memory without bound — beyond 2 pending snapshots, drop
            # stale saves, newest wins (crash recovery only ever reads the
            # newest valid one). The bound is 2, not 1, so a burst of saves
            # racing a not-yet-scheduled writer thread doesn't silently
            # thin the committed history
            while self._queue.qsize() > 2:
                try:
                    stale = self._queue.get_nowait()
                except queue.Empty:
                    break
                self._queue.task_done()
                if stale is None:  # close() sentinel: not ours to eat
                    self._queue.put(None)
                    break
                obs.inc("checkpoint.coalesced")
            self._queue.put((int(step), state))
            obs.set_gauge("checkpoint.queue_depth", self._queue.qsize())
        else:
            self._write(int(step), state)
        obs.inc("checkpoint.saves")

    def flush(self):
        """Block until every queued save has hit disk; re-raise write errors."""
        if self._writer is not None:
            self._queue.join()
        self._raise_pending_write_error()

    def close(self):
        self.flush()
        if self._writer is not None:
            self._queue.put(None)
            self._queue.join()
            self._writer.join(timeout=10)
            if self._writer.is_alive():
                obs.inc("checkpoint.writer_thread_leaked")
                obs.event("checkpoint.writer_thread_leaked",
                          join_timeout_s=10)
            self._writer = None
        self.restore_signal_handlers()

    def _raise_pending_write_error(self):
        with self._lock:
            err, self._write_error = self._write_error, None
        if err is not None:
            raise CheckpointError(f"background checkpoint write failed: {err}") \
                from err

    def _ensure_writer(self):
        with self._lock:
            if self._writer is None or not self._writer.is_alive():
                self._writer = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="mxnet-tpu-torch-ckpt-writer")
                self._writer.start()

    def _writer_loop(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, state = item
                try:
                    self._write(step, state)
                except BaseException as e:
                    # a silently lost checkpoint is a resume-time disaster:
                    # log ONCE per failure with the traceback, count it
                    # (even with telemetry off), and keep the error
                    # pending — the next save()/flush()/close() re-raises
                    # it as CheckpointError
                    log.error("background checkpoint %d write failed "
                              "(will re-raise on next save/close): %s",
                              step, e, exc_info=True)
                    obs.metrics.registry.counter(
                        "checkpoint.write_errors").inc()
                    with self._lock:
                        self._write_error = e
            finally:
                self._queue.task_done()
                obs.set_gauge("checkpoint.queue_depth", self._queue.qsize())

    def _write(self, step: int, state: TrainingState):
        from ..chaos.proc import kill_point
        from ..ndarray.serialization import raw_bytes, save_nd

        final = self._path(step)
        # pid AND thread id: the preemption path writes synchronously while
        # the async writer may be writing the SAME step — their staging
        # dirs must not collide
        staging = os.path.join(
            self.directory,
            f".{self._name(step)}.tmp-{os.getpid()}-{threading.get_ident()}")
        if os.path.exists(staging):
            shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging)
        rec = obs.enabled()
        t_start = time.monotonic() if rec else 0.0
        try:
            with obs.trace.span("checkpoint.write", step=step):
                names = sorted(state.arrays)
                arrays = [state.arrays[n] for n in names]
                t0 = time.monotonic() if rec else 0.0
                save_nd(os.path.join(staging, _ARRAYS_FILE), arrays, names)
                if rec:
                    obs.observe("checkpoint.array_write_seconds",
                                time.monotonic() - t0)
                kill_point("ckpt:post_arrays")  # chaos: die, no manifest
                manifest = {
                    "format": FORMAT_VERSION,
                    "step": step,
                    "meta": state.meta,
                    "arrays": {
                        n: {"crc32": crc32_bytes(raw_bytes(a)),
                            "shape": list(a.shape), "dtype": _dtype_str(a)}
                        for n, a in zip(names, arrays)},
                }
                atomic_write_json(os.path.join(staging, _MANIFEST_FILE),
                                  manifest)
                t0 = time.monotonic() if rec else 0.0
                fsync_dir(staging)
                if rec:
                    obs.observe("checkpoint.fsync_seconds",
                                time.monotonic() - t0)
                kill_point("ckpt:pre_rename")  # chaos: die mid-commit
                t0 = time.monotonic() if rec else 0.0
                if os.path.exists(final):
                    # same-step rewrite (epoch-end on top of a batch-period
                    # save): both snapshots resume identically, so keep the
                    # committed one — deleting it first would open a crash
                    # window with NO valid checkpoint at this step
                    shutil.rmtree(staging, ignore_errors=True)
                else:
                    try:
                        os.rename(staging, final)
                    except OSError:
                        if not os.path.exists(final):
                            raise
                        # lost a same-step commit race: keep the winner
                        shutil.rmtree(staging, ignore_errors=True)
                    else:
                        fsync_dir(self.directory)
                if rec:
                    # commit = rename + parent fsync (the atomicity tax)
                    obs.observe("checkpoint.commit_seconds",
                                time.monotonic() - t0)
                kill_point("ckpt:post_rename")
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        if rec:
            obs.observe("checkpoint.write_seconds",
                        time.monotonic() - t_start)
        self._gc()

    def _gc(self):
        if self.keep_last <= 0:
            return
        steps = self.list_steps()
        for old in steps[:-self.keep_last]:
            shutil.rmtree(self._path(old), ignore_errors=True)

    # ------------------------------------------------------------------
    # loading / validation
    # ------------------------------------------------------------------
    def validate(self, step: int) -> TrainingState:
        """Load checkpoint ``step``, raising CheckpointError on any
        corruption: missing/unparseable manifest, truncated or bit-flipped
        arrays (per-array CRC32), or count mismatches."""
        from ..ndarray.serialization import load_nd, raw_bytes

        path = self._path(step)
        manifest_path = os.path.join(path, _MANIFEST_FILE)
        try:
            manifest = read_json(manifest_path)
        except (OSError, ValueError) as e:
            raise CheckpointError(f"{self._name(step)}: bad manifest: {e}") \
                from e
        if manifest.get("format") != FORMAT_VERSION:
            raise CheckpointError(
                f"{self._name(step)}: unsupported format "
                f"{manifest.get('format')!r}")
        try:
            loaded = load_nd(os.path.join(path, _ARRAYS_FILE))
        except (OSError, ValueError) as e:
            raise CheckpointError(f"{self._name(step)}: bad arrays.bin: {e}") \
                from e
        if not isinstance(loaded, dict):
            loaded = {} if not loaded else None
        table = manifest.get("arrays", {})
        if loaded is None or set(loaded) != set(table):
            raise CheckpointError(
                f"{self._name(step)}: manifest/arrays name mismatch")
        for name, info in table.items():
            arr = loaded[name]
            if crc32_bytes(raw_bytes(arr)) != info["crc32"]:
                raise CheckpointError(
                    f"{self._name(step)}: CRC mismatch for array {name!r}")
        return TrainingState(loaded, manifest.get("meta", {}))

    def load(self, step: int) -> TrainingState:
        return self.validate(step)

    def load_latest(self) -> Optional[TrainingState]:
        """Newest checkpoint that passes validation; corrupt/partial ones are
        skipped with a warning. None when nothing valid exists."""
        for step in reversed(self.list_steps()):
            try:
                return self.validate(step)
            except CheckpointError as e:
                log.warning("skipping invalid checkpoint: %s", e)
        return None

    # ------------------------------------------------------------------
    # preemption (SIGTERM/SIGINT)
    # ------------------------------------------------------------------
    def install_signal_handlers(self):
        """SIGTERM/SIGINT set ``self.preempted``; the fit loop polls it after
        each batch, flushes a final checkpoint, and stops cleanly. Only
        possible from the main thread (signal module restriction) — a no-op
        elsewhere."""
        self.preempted.clear()  # a reused manager must not abort a new fit
        self.preempt_signum = None
        if self._orig_handlers is not None:
            return

        def _handler(signum, frame):
            self.preempt_signum = signum
            self.preempted.set()

        try:
            self._orig_handlers = {
                sig: signal.signal(sig, _handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}
        except ValueError:  # not the main thread
            self._orig_handlers = None

    def restore_signal_handlers(self):
        if self._orig_handlers is None:
            return
        try:
            for sig, h in self._orig_handlers.items():
                signal.signal(sig, h)
        except ValueError:
            pass
        self._orig_handlers = None

    # ------------------------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def as_manager(checkpoint) -> Optional[CheckpointManager]:
    """Coerce a fit-API ``checkpoint=`` argument (None | dir path | manager)."""
    if checkpoint is None or isinstance(checkpoint, CheckpointManager):
        return checkpoint
    if isinstance(checkpoint, (str, os.PathLike)):
        return CheckpointManager(checkpoint)
    raise TypeError(
        f"checkpoint must be a directory or CheckpointManager, "
        f"got {type(checkpoint)}")


def _dtype_str(a) -> str:
    """The manifest's dtype name: numpy's, and "bfloat16" for a bf16
    tensor (the reference's ml_dtypes name)."""
    return "bfloat16" if isinstance(a, torch.Tensor) else str(a.dtype)
