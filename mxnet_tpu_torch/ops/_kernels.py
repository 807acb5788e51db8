"""Build and bind the port's hand-written CUDA kernels.

Each source in ``mxnet_tpu_torch/csrc/`` holds its kernels, a plain C
launcher and a CPython entry point (``csrc/pyentry.cuh``): an extension
module ``_mxt_<name>`` whose one function, ``launch``, takes the
launcher's arguments as Python ints and floats. At its first use a source
is compiled by ``nvcc`` for ``sm_90a`` against the running Python's
headers into ``build/mxnet_tpu_torch/`` at the root of the checkout
(listed in ``.gitignore``), named by the hash of its source, the shared
headers and the flags, so that an edited source is rebuilt, and imported
once.

Every wrapper takes the same two host steps per launch: :func:`entry`
returns the bound ``launch`` function (a dict lookup after the first
call) and :func:`stream` the raw handle of the current CUDA stream of a
tensor's device. Nothing is built at import time, and no CPU tensor
reaches a build. A build failure (no ``nvcc``, no ``Python.h``, a compile
error) raises; nothing falls back.
"""
from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Callable, Dict

import torch

from ..base import MXNetError

__all__ = ["KERNELS", "load", "entry", "stream", "build_all", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"

# kernel name -> source file; module _mxt_<name> in each
KERNELS: Dict[str, str] = {
    "paged_decode_attention": "paged_decode_attention.cu",
    "flash_attention_fwd": "flash_attention_fwd.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "copy_probe": "copy_probe.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, object] = {}
_entries: Dict[str, Callable[..., int]] = {}


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


def _flags() -> list:
    """nvcc flags, with the running Python's headers."""
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise MXNetError(f"Python.h not found in {include}; the kernels' "
                         "Python entry points cannot be built")
    return [*NVCC_FLAGS, "-I" + include]


def _lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name]
    text = src.read_bytes() + " ".join(_flags()).encode()
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers
        text += header.read_bytes()
    digest = hashlib.sha256(text).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for kernel ``name``; returns (process, temp, out)."""
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(), "-o", str(tmp), str(CSRC / KERNELS[name])]
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


def load(name: str):
    """The imported extension module of kernel ``name``, built first if
    needed."""
    mod = _loaded.get(name)
    if mod is not None:
        return mod
    with _lock:
        mod = _loaded.get(name)
        if mod is None:
            path = _lib_path(name)
            if not path.exists():
                _finish_build(name, _start_build(name))
            mod_name = f"_mxt_{name}"
            loader = importlib.machinery.ExtensionFileLoader(mod_name,
                                                             str(path))
            spec = importlib.util.spec_from_file_location(
                mod_name, str(path), loader=loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
            _loaded[name] = mod
        return mod


def entry(name: str) -> Callable[..., int]:
    """The ``launch`` function of kernel ``name``: its launcher's arguments
    in, its cudaError_t out."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries.setdefault(name, load(name).launch)
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream of CUDA tensor
    ``t``'s device, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
