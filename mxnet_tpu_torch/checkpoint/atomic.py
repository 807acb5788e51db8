"""Crash-safe filesystem primitives shared by the checkpoint subsystem,
``ndarray/serialization.py`` and ``gluon.Trainer.save_states``
(counterpart of ``mxnet_tpu/checkpoint/atomic.py``, the same functions).

The commit discipline: never expose a
partially written file — write into a temp sibling, flush+fsync, then
``os.replace`` into place and fsync the directory so the rename itself is
durable. CRC32 (the same polynomial ps-lite frames and the reference recordio
magic checks use) detects torn writes that rename atomicity cannot, e.g. a
power cut between the data blocks and the metadata journal commit.

Stdlib-only on purpose: it imports nothing of the framework.
"""
from __future__ import annotations

import json
import os
import tempfile
import zlib

__all__ = ["crc32_bytes", "fsync_dir", "atomic_write_bytes",
           "atomic_write_json", "read_json"]


def crc32_bytes(data, value: int = 0) -> int:
    """CRC32 as an unsigned 32-bit int (zlib.crc32 with masked sign)."""
    return zlib.crc32(data, value) & 0xFFFFFFFF


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-committed rename survives power loss.
    Best-effort: some filesystems (and all of Windows) refuse O_RDONLY dir
    fds — rename atomicity still holds there, only durability timing differs.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, durable: bool = True) -> None:
    """Write ``data`` to ``path`` via temp-file + fsync + rename.

    A reader concurrently opening ``path`` sees either the old content or the
    new content, never a prefix. ``durable=False`` skips the fsyncs (still
    atomic against crashes of *this* process, not against power loss) — used
    by tests and scratch files.
    """
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".tmp-",
                               dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            if durable:
                f.flush()
                os.fsync(f.fileno())
        # mkstemp creates 0600 regardless of umask; a plain open() would
        # not — preserve the destination's mode (or the umask default) so
        # re-saving a file doesn't silently tighten its permissions
        try:
            mode = os.stat(path).st_mode & 0o7777
        except OSError:
            umask = os.umask(0)
            os.umask(umask)
            mode = 0o666 & ~umask
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if durable:
        fsync_dir(d)


def atomic_write_json(path: str, obj, durable: bool = True) -> None:
    atomic_write_bytes(path, json.dumps(obj, sort_keys=True,
                                        indent=1).encode("utf-8"),
                       durable=durable)


def read_json(path: str):
    with open(path, "rb") as f:
        return json.loads(f.read().decode("utf-8"))
