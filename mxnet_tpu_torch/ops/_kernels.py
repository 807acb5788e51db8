"""Build and bind the port's hand-written CUDA kernels.

Each source in ``mxnet_tpu_torch/csrc/`` has a plain C entry point. At its
first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library
under ``build/mxnet_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``), named by the hash of its source so that an edited source
is rebuilt, and loaded with ``ctypes``. Nothing is built at import time,
and no CPU tensor reaches a build. A build failure raises; nothing falls
back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from ..base import MXNetError

__all__ = ["KERNELS", "load", "build_all", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)  # a host array of strides

# kernel name -> (source file, C argtypes); every entry returns a
# cudaError_t as int
KERNELS: Dict[str, tuple] = {
    "paged_decode_attention": (
        "paged_decode_attention.cu",
        [_P, _P, _P, _P, _P, _P,            # q k v table lengths out
         _I, _I, _I, _I, _I, _I, _I,        # dtype B H D page max_pages P
         _LL, _LL, _LL, _LL, _LL,           # q_sb q_sh kv_sp kv_ss kv_sh
         _F, _P]),                          # s2_scale stream
    "flash_attention_fwd": (
        "flash_attention_fwd.cu",
        [_P, _P, _P, _P, _P,                # q k v out lse
         _I, _I, _I, _I, _I,                # dtype B H S D
         _LLP, _I, _I, _F, _P]),            # strides causal offset scale stream
    "flash_attention_bwd": (
        "flash_attention_bwd.cu",
        [_P, _P, _P, _P, _P,                # q k v out dout
         _P, _P, _P, _P,                    # lse g_lse dl dq_acc
         _P, _P, _P,                        # dq dk dv
         _I, _I, _I, _I, _I,                # dtype B H S D
         _LLP, _I, _I, _F, _P]),            # strides causal offset scale stream
    "copy_probe": ("copy_probe.cu", [_P, _P, _I, _P]),  # x y n stream
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise MXNetError("nvcc not found (no CUDA toolkit on PATH or in "
                         f"{home}); the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    text = src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers
        text += header.read_bytes()
    digest = hashlib.sha256(text).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for kernel ``name``; returns (process, temp, out)."""
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, build) -> None:
    proc, tmp, out = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"nvcc failed for {name} "
                         f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build of it is safe


def build_all() -> Dict[str, float]:
    """Build every kernel whose library is missing, one ``nvcc`` per source,
    all started together. Returns the wall seconds per kernel (0.0 for one
    already built)."""
    with _lock:
        t0 = time.perf_counter()
        builds = {n: _start_build(n) for n in KERNELS
                  if not _lib_path(n).exists()}
        secs = {n: 0.0 for n in KERNELS}
        for n, build in builds.items():
            _finish_build(n, build)
            secs[n] = time.perf_counter() - t0
        return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                _finish_build(name, _start_build(name))
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, name)
            fn.argtypes = KERNELS[name][1]
            fn.restype = ctypes.c_int
            _loaded[name] = lib
        return lib
