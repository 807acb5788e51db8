"""Build and load the framework-free C++ code of ``native/`` (counterpart
of ``mxnet_tpu/native.py``).

``io_lib()`` compiles ``native/io/recordio_jpeg.cc`` of the checkout, as
it is, with the reference Makefile's flags (``g++ -O2 -std=c++17 -Wall
-pthread -fPIC -shared ... -ljpeg``) into
``build/mxnet_tpu_torch/libmxtpu_io.so`` on first use, and returns a
``ctypes`` handle: the RecordIO + JPEG batch decoder that
``io.ImageRecordIter`` calls once per batch, on the host. Without a
toolchain, ``jpeglib.h`` or ``libjpeg`` it returns None and the iterator
decodes with PIL, the reference's choice; ``io_lib_error()`` says why.
``MXNET_NO_NATIVE_BUILD=1`` skips the build.

``ps_server_binary()`` compiles ``native/ps/ps_server.cc``, as it is,
with the same flags (``g++ -O2 -std=c++17 -Wall -pthread``) into
``build/mxnet_tpu_torch/mxtpu_ps_server`` on first use and returns its
path: the native parameter server that ``tools/launch.py`` starts for
``dist_async``. It returns None without a toolchain;
``ps_server_error()`` says why.

Neither build reads or writes ``native/build/``, the reference's.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

__all__ = ["io_lib", "io_lib_error", "ps_server_binary", "ps_server_error",
           "native_dir", "build_dir"]

_lock = threading.Lock()
_cache: dict = {}
_ROOT = Path(__file__).resolve().parent.parent
_CXXFLAGS = ["-O2", "-std=c++17", "-Wall", "-pthread"]


def native_dir() -> str:
    """``native/`` of the checkout: the C++ sources, shared with the
    reference (never built into by the port)."""
    return str(_ROOT / "native")


def build_dir() -> str:
    return str(_ROOT / "build" / "mxnet_tpu_torch")


def _build(src_rel, out_name, extra_pre, extra_post):
    """Compile ``native/<src_rel>`` into ``build_dir()/<out_name>``:
    (path, None), or (None, reason)."""
    out = os.path.join(build_dir(), out_name)
    if os.path.exists(out):
        return out, None
    if os.environ.get("MXNET_NO_NATIVE_BUILD"):
        return None, "MXNET_NO_NATIVE_BUILD is set"
    src = os.path.join(native_dir(), *src_rel.split("/"))
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *_CXXFLAGS, *extra_pre, src, *extra_post, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return None, f"{' '.join(cmd)}: {e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None, (proc.stderr or proc.stdout).strip()[-2000:]
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out, None


def io_lib():
    """ctypes CDLL of the IO pipeline, or None if it cannot be built."""
    with _lock:
        if "io" not in _cache:
            path, err = _build("io/recordio_jpeg.cc", "libmxtpu_io.so",
                               ["-fPIC", "-shared"], ["-ljpeg"])
            lib = None
            if path:
                try:
                    lib = ctypes.CDLL(path)
                    lib.mxtpu_decode_batch.restype = ctypes.c_int
                    lib.mxtpu_decode_batch.argtypes = [
                        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                        ctypes.POINTER(ctypes.c_float),
                        ctypes.POINTER(ctypes.c_float),
                        ctypes.POINTER(ctypes.c_float),
                        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                        ctypes.c_int]
                    lib.mxtpu_decode_batch_u8.restype = ctypes.c_int
                    lib.mxtpu_decode_batch_u8.argtypes = [
                        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                        ctypes.POINTER(ctypes.c_uint8),
                        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                        ctypes.c_int]
                    lib.mxtpu_scan_offsets.restype = ctypes.c_int64
                    lib.mxtpu_scan_offsets.argtypes = [
                        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int64]
                except (OSError, AttributeError) as e:
                    # OSError: unloadable .so; AttributeError: stale build
                    # missing a newer symbol; the PIL path decodes
                    lib, err = None, str(e)
            _cache["io"] = lib
            _cache["io_error"] = err
        return _cache["io"]


def io_lib_error():
    """Why ``io_lib()`` returned None (None when it loaded)."""
    io_lib()
    return _cache["io_error"]


def ps_server_binary():
    """Path of the native parameter server built from
    ``native/ps/ps_server.cc``, or None if it cannot be built."""
    with _lock:
        if "ps" not in _cache:
            _cache["ps"], _cache["ps_error"] = _build(
                "ps/ps_server.cc", "mxtpu_ps_server", [], [])
        return _cache["ps"]


def ps_server_error():
    """Why ``ps_server_binary()`` returned None (None when it built)."""
    ps_server_binary()
    return _cache["ps_error"]
