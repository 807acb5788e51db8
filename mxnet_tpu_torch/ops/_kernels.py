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

With a program cache armed (``progcache``: the process-global one, or the
one a cache-hit program hands :func:`preload`), a library missing from
the build directory is first looked up as a kernel entry
(:func:`kernel_key`: the same hash the library is named by): a hit writes
the entry's bytes to the library's path (atomic rename) and imports them,
with no ``nvcc`` run; a reject (an entry that fails its checks or does not
import) is counted and the kernel is built as if there were no entry.
Every library this process builds or finds built goes into that cache.
:func:`build_stats` counts the ``nvcc`` runs of the process and their
seconds, and :func:`recording` collects the kernels a call launches (the
program record's kernel digests). With no cache armed nothing changes.
"""
from __future__ import annotations

import contextlib
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

__all__ = ["KERNELS", "load", "entry", "stream", "build_all", "BUILD_DIR",
           "kernel_key", "preload", "store", "recording", "digests",
           "build_stats"]

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
_tls = threading.local()
# the nvcc runs of this process: count, seconds (each build's own wall)
# and the kernels built, in order
_builds: Dict[str, object] = {"count": 0, "seconds": 0.0, "kernels": []}
_nvcc_version_cache: list = []


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


def _source_digest(name: str) -> str:
    """The hash of kernel ``name``'s source, the shared headers and the
    flags: its library's name and its kernel entry's statics."""
    src = CSRC / KERNELS[name]
    text = src.read_bytes() + " ".join(_flags()).encode()
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers
        text += header.read_bytes()
    return hashlib.sha256(text).hexdigest()


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_digest(name)[:16]}.so"


def kernel_key(name: str):
    """The :class:`~mxnet_tpu_torch.progcache.ProgramKey` of kernel
    ``name``'s entry: site ``kernel``, the library's hash and the flags."""
    from ..progcache import KERNEL_SITE, program_key

    return program_key(KERNEL_SITE, name,
                       {"source": _source_digest(name),
                        "flags": list(NVCC_FLAGS)})


def _start_build(name: str):
    """Start ``nvcc`` for kernel ``name``; returns (process, temp, out,
    start time)."""
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(), "-o", str(tmp), str(CSRC / KERNELS[name])]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, t0


def _finish_build(name: str, build) -> None:
    proc, tmp, out, t0 = build
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise MXNetError(f"nvcc failed for {name} "
                         f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build of it is safe
    _builds["count"] += 1
    _builds["seconds"] += time.perf_counter() - t0
    _builds["kernels"].append(name)
    from .. import obs

    obs.inc("kernels.nvcc_builds")  # a replica's telemetry shows its builds


def build_stats() -> dict:
    """The ``nvcc`` runs of this process: ``count``, ``seconds`` (summed,
    each build's own wall) and ``kernels`` (in order)."""
    with _lock:
        return {"count": _builds["count"], "seconds": _builds["seconds"],
                "kernels": list(_builds["kernels"])}


def _nvcc_version():
    """The last line of ``nvcc --version``, or None without ``nvcc``."""
    if not _nvcc_version_cache:
        try:
            out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
            _nvcc_version_cache.append(out.strip().splitlines()[-1])
        except (MXNetError, OSError, subprocess.SubprocessError,
                IndexError):
            _nvcc_version_cache.append(None)
    return _nvcc_version_cache[0]


def _import(name: str, path: Path):
    mod_name = f"_mxt_{name}"
    loader = importlib.machinery.ExtensionFileLoader(mod_name, str(path))
    spec = importlib.util.spec_from_file_location(mod_name, str(path),
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def _armed(cache):
    if cache is not None:
        return cache
    from .. import progcache

    return progcache.cache()


def _from_cache(name: str, path: Path, pc):
    """Kernel ``name``'s module from its entry in ``pc``: the bytes written
    to ``path`` (atomic rename) and imported. None on a miss or a counted
    reject (the entry's checks, or an import that fails)."""
    def loader(payload: bytes):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_bytes(payload)
        os.replace(tmp, path)
        try:
            return _import(name, path)
        except BaseException:
            path.unlink(missing_ok=True)
            raise

    entry = pc.get(kernel_key(name), device="gpu", loader=loader)
    return None if entry is None else entry.executable


def _store(name: str, pc, replace: bool = False) -> bool:
    """Put kernel ``name``'s built library into ``pc`` unless its entry is
    there already (``replace``: overwrite it, e.g. a rejected one).
    Returns whether the cache holds it."""
    key = kernel_key(name)
    if not replace and pc.has(key):
        return True
    path = _lib_path(name)
    if not path.exists():
        return False
    data = path.read_bytes()
    return pc.put(key, data, device="gpu",
                  meta={"kernel": name, "nvcc": _nvcc_version(),
                        "flags": list(NVCC_FLAGS), "bytes": len(data)})


def store(names, cache) -> int:
    """Put the built libraries of kernels ``names`` into ``cache`` (those
    whose entries it lacks). Returns how many it holds."""
    with _lock:
        return sum(bool(_store(n, cache)) for n in sorted(names)
                   if n in KERNELS)


def build_all(names=None) -> Dict[str, float]:
    """Build every kernel (of ``names``, default all) whose library is
    missing, one ``nvcc`` per source, all started together; with a cache
    armed, those whose entry hits are loaded from it instead, and the
    built ones go into it. Returns the wall seconds per kernel (0.0 for
    one already built or loaded)."""
    names = list(KERNELS if names is None else names)
    with _lock:
        t0 = time.perf_counter()
        pc = _armed(None)
        missing = [n for n in names if not _lib_path(n).exists()]
        if pc is not None:
            for n in list(missing):
                mod = _from_cache(n, _lib_path(n), pc)
                if mod is not None:
                    _loaded[n] = mod
                    missing.remove(n)
        builds = {n: _start_build(n) for n in missing}
        secs = {n: 0.0 for n in names}
        for n, build in builds.items():
            # _lock serialises builds on purpose: a second caller waits for the
            # first's library instead of starting a duplicate nvcc
            _finish_build(n, build)  # lint: disable=blocking-call-under-lock
            secs[n] = time.perf_counter() - t0
        if pc is not None:
            for n in names:  # a built one replaces a rejected entry
                _store(n, pc, replace=n in builds)
        return secs


def load(name: str, cache=None):
    """The imported extension module of kernel ``name``: from the build
    directory, else from its entry in ``cache`` (default: the armed
    process-global cache), else built first."""
    mod = _loaded.get(name)
    if mod is not None:
        return mod
    with _lock:
        mod = _loaded.get(name)
        if mod is None:
            path = _lib_path(name)
            pc = _armed(cache)
            rejected = False
            if pc is not None and not path.exists():
                mod = _from_cache(name, path, pc)
                # an entry that is there but did not load was rejected
                rejected = mod is None and pc.has(kernel_key(name))
            if mod is None:
                if not path.exists():
                    # _lock serialises builds on purpose (see build_all)
                    _finish_build(name, _start_build(name))  # lint: disable=blocking-call-under-lock
                mod = _import(name, path)
            if pc is not None:
                _store(name, pc, replace=rejected)
            _loaded[name] = mod
        return mod


def preload(kernels: Dict[str, str], cache) -> None:
    """Load the kernels of a cache-hit program (name -> entry digest) from
    ``cache`` before its first launch. A digest that is not this build's
    (another host's flags) is left to :func:`load` at launch."""
    for name, digest in sorted(kernels.items()):
        if name in KERNELS and name not in _loaded \
                and kernel_key(name).digest == digest:
            load(name, cache)


@contextlib.contextmanager
def recording():
    """``with recording() as launched:`` — the names of the kernels
    launched on this thread inside the block (nested blocks also report to
    the outer one)."""
    prev = getattr(_tls, "launched", None)
    launched: set = set()
    _tls.launched = launched
    try:
        yield launched
    finally:
        _tls.launched = prev
        if prev is not None:
            prev |= launched


def digests(names) -> Dict[str, str]:
    """Kernel name -> its entry's digest, for the kernels ``names``."""
    return {n: kernel_key(n).digest for n in sorted(names)}


def entry(name: str) -> Callable[..., int]:
    """The ``launch`` function of kernel ``name``: its launcher's arguments
    in, its cudaError_t out."""
    launched = getattr(_tls, "launched", None)
    if launched is not None:  # a program's first run records its kernels
        launched.add(name)
    fn = _entries.get(name)
    if fn is None:
        fn = _entries.setdefault(name, load(name).launch)
    return fn


def stream(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of the current stream of CUDA tensor
    ``t``'s device, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
