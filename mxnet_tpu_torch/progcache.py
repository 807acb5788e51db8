"""Persistent program cache — a warm process compiles nothing
(counterpart of ``mxnet_tpu/progcache.py``).

The reference persists the XLA executables of its serve buckets, decode
programs and fused update step. The port runs eagerly and compiles two
things only, so those are what it persists:

- **Kernel entries** (site ``kernel``, label the kernel's name; statics
  the hash ``ops/_kernels`` names the library by: source, shared headers,
  ``nvcc`` flags): the payload is the ``nvcc``-built extension library
  itself, so a hit loads the same machine code without running ``nvcc``.
  The entry's metadata carries the ``nvcc`` version and the flags.
- **Program entries** (sites ``serve``, ``decode`` and ``update``; statics
  the reference's: graph fingerprint, bucket, input and parameter avals,
  pad value, mesh placement; for ``update`` the optimizer's class and
  step-shaping hyperparameters, multi-precision, clipping and the loss
  scaler): the payload is a :class:`Program` record, the device plane's
  cost record of the program's first run (when the plane was active then)
  and the digests of the kernel entries that run launched. A hit marks the
  ``compile_log`` entry ``cache_hit``, adopts the stored cost instead of a
  capture run (``obs.device.adopt_cached_cost``) and loads the program's
  kernels from their entries. The program still runs eagerly: the cache
  never changes what runs.

The rest is the reference's:

- **One key derivation** (:func:`program_key`, :func:`_canon`): a
  :class:`ProgramKey` carries the (site, label) the device plane files its
  record under and a SHA-256 ``digest`` over the statics, bitwise the
  reference's for the same statics. The digest names the entry's file and
  rides the ``compile_log`` entry and the cost record.
- **Never a wrong program**: every entry embeds an environment fingerprint
  (:func:`env_fingerprint`: platform, card name and compute capability,
  card count, the torch and CUDA versions, the interpreter's extension
  suffix, the numeric switches that change what a kernel or cuBLAS
  computes, and :func:`code_fingerprint` over the package's Python and
  CUDA sources) checked before the payload is used. A missing file is a
  counted miss; a corrupt, truncated, foreign or stale entry, a payload
  that does not parse and a library that does not import are counted
  rejects, and the caller builds or runs as if the entry never existed.
- **Crash-safe writes**: temp + fsync + rename, a CRC32 per entry,
  keep-last-N GC (``MXNET_PROGCACHE_KEEP``).

Activation: ``MXNET_PROGCACHE_DIR=<dir>`` (or ``MXNET_PROGCACHE=1`` with
:func:`default_dir`, ``~/.cache/mxnet_tpu_torch/progcache``) arms the
process-global cache; ``MXNET_PROGCACHE=0`` vetoes it even with a dir set.
``serve.ship_programs`` writes an engine's programs and their kernels into
a ``programs/`` payload beside an artifact, and ``serve.load`` warms from
it.

Differences from the reference: :func:`aot_compile` runs the call once,
recording the kernels it launches, and returns its result beside the
:class:`Program` (there is no ahead-of-time compiler to ask);
:func:`serialize_compiled` writes a :class:`Program`; every payload is
self-contained, so ``put`` never refuses an export, and
:func:`enable_jax_fallback_cache` (jax's compilation cache) raises
:class:`MXNetError`.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import sysconfig
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

from .base import MXNetError
from .checkpoint.atomic import atomic_write_bytes, crc32_bytes

__all__ = ["ProgramKey", "ProgramCache", "CacheEntry", "program_key",
           "env_fingerprint", "code_fingerprint", "active", "cache",
           "configure", "aot_compile", "serialize_compiled",
           "enable_jax_fallback_cache", "default_dir", "reset", "Program"]

# entry format version: the reference's layout and schema
_MAGIC = b"MXPROG1\n"
_SCHEMA = 1

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")

KERNEL_SITE = "kernel"


# ---------------------------------------------------------------------------
# key derivation — THE one place a program's identity is computed
# ---------------------------------------------------------------------------

class ProgramKey(NamedTuple):
    """A program's identity: the (site, label) the device-plane registry
    files cost records under, plus the canonical digest over its statics.
    Built only by :func:`program_key`."""
    site: str
    label: str
    digest: str


def _canon(obj) -> Any:
    """Canonicalize static key parts into a deterministic, JSON-able
    structure (the reference's rules): types become qualified names,
    mappings sort by key, sets sort; anything else falls back to
    ``repr``."""
    if isinstance(obj, type):
        return f"{obj.__module__}.{obj.__qualname__}"
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if isinstance(obj, float):
        return repr(obj)  # repr(f) roundtrips; json would re-round
    if isinstance(obj, bytes):
        return hashlib.sha256(obj).hexdigest()
    if isinstance(obj, dict):
        return {"__map__": sorted((str(k), _canon(v))
                                  for k, v in obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_canon(x) for x in obj]
    if isinstance(obj, (set, frozenset)):
        return {"__set__": sorted(repr(_canon(x)) for x in obj)}
    return repr(obj)


def program_key(site: str, label: str, statics: Any = ()) -> ProgramKey:
    """Derive a program's :class:`ProgramKey` from its statics: everything
    that determines the program short of its tensors' values. Equal
    statics give equal digests in any process, and in either package."""
    blob = json.dumps([_SCHEMA, site, label, _canon(statics)],
                      sort_keys=True, separators=(",", ":"))
    return ProgramKey(site, label,
                      hashlib.sha256(blob.encode("utf-8")).hexdigest())


# ---------------------------------------------------------------------------
# environment fingerprint — when ANY of this drifts, entries are rejected
# ---------------------------------------------------------------------------

_code_fp_cache: list = [None]
# platform ("gpu"/"cpu") -> the fingerprint's fields that cannot change
# while the process runs
_env_fp_cache: Dict[str, dict] = {}
_fp_lock = threading.RLock()
_SOURCES = (".py", ".cu", ".cuh")


def code_fingerprint() -> str:
    """Content hash over every ``mxnet_tpu_torch/**/*.py`` and
    ``csrc/*.cu``/``*.cuh`` file of the package this module was imported
    from. Programs and kernels come from this code, so a source change
    anywhere in it invalidates the cache. Computed once per process."""
    if _code_fp_cache[0] is not None:
        return _code_fp_cache[0]
    with _fp_lock:
        if _code_fp_cache[0] is not None:
            return _code_fp_cache[0]
        root = os.path.dirname(os.path.abspath(__file__))
        h = hashlib.sha256()
        for dirpath, dirnames, filenames in sorted(os.walk(root)):
            dirnames.sort()
            for fn in sorted(filenames):
                if not fn.endswith(_SOURCES):
                    continue
                path = os.path.join(dirpath, fn)
                h.update(os.path.relpath(path, root).encode())
                try:
                    with open(path, "rb") as f:
                        h.update(f.read())
                except OSError:
                    h.update(b"<unreadable>")
        _code_fp_cache[0] = h.hexdigest()
        return _code_fp_cache[0]


def _platform(device) -> str:
    if device is None:
        import torch

        return "gpu" if torch.cuda.is_available() else "cpu"
    if device in ("gpu", "cpu"):
        return device
    return "gpu" if str(device).startswith("cuda") else "cpu"


def env_fingerprint(device=None) -> Dict[str, Any]:
    """The compatibility envelope of an entry for programs on ``device``
    (a torch device or its type, or ``"gpu"``/``"cpu"``; default the card
    when there is one): platform, card name and compute capability, card
    count, torch and CUDA versions, the interpreter's extension suffix
    (the kernels are CPython extensions), the TF32 switches, the float32
    matmul precision, ``cudnn.benchmark``, whether deterministic
    algorithms are on, and the package's source hash. ``nvcc`` is left
    out: a host that serves need not have it. A CPU fingerprint never
    initializes CUDA."""
    import torch

    plat = _platform(device)
    static = _env_fp_cache.get(plat)
    if static is None:
        with _fp_lock:
            static = _env_fp_cache.get(plat)
            if static is None:
                if plat == "gpu":
                    try:
                        idx = torch.cuda.current_device()
                        kind = torch.cuda.get_device_name(idx)
                        cap = ".".join(map(str, torch.cuda
                                           .get_device_capability(idx)))
                        ndev = torch.cuda.device_count()
                    except Exception:  # the fingerprint must never raise
                        kind, cap, ndev = "?", None, 0
                else:
                    kind, cap, ndev = "cpu", None, 1
                static = {
                    "schema": _SCHEMA, "platform": plat,
                    "device_kind": str(kind), "capability": cap,
                    "num_devices": int(ndev), "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "ext_suffix": sysconfig.get_config_var("EXT_SUFFIX"),
                    "code": code_fingerprint()}
                _env_fp_cache[plat] = static
    # the switches can change while the process runs: read them each time
    return dict(
        static,
        tf32_matmul=bool(torch.backends.cuda.matmul.allow_tf32),
        tf32_cudnn=bool(torch.backends.cudnn.allow_tf32),
        matmul_precision=torch.get_float32_matmul_precision(),
        cudnn_benchmark=bool(torch.backends.cudnn.benchmark),
        deterministic=bool(torch.are_deterministic_algorithms_enabled()))


# ---------------------------------------------------------------------------
# the port's program record and its serialization
# ---------------------------------------------------------------------------

class Program(NamedTuple):
    """What the port persists of a program: the device plane's cost record
    of its first run (None when the plane was off then) and the digests of
    the kernel entries that run launched (kernel name -> digest)."""
    cost: Optional[dict]
    kernels: Dict[str, str]


def aot_compile(fn, args: tuple, kwargs: Optional[dict] = None):
    """Run ``fn(*args, **kwargs)`` once, recording the port kernels it
    launches; returns ``(result, Program)`` (cost None). The path a site
    takes with the cache armed and the device plane's capture off."""
    from .ops import _kernels

    with _kernels.recording() as launched:
        out = fn(*args, **(kwargs or {}))
    return out, Program(None, _kernels.digests(launched))


def serialize_compiled(program: Program) -> Optional[bytes]:
    """A :class:`Program` as bytes (canonical JSON), or None when it is
    not one."""
    if not isinstance(program, Program):
        return None
    try:
        return json.dumps({"cost": program.cost,
                           "kernels": dict(program.kernels)},
                          sort_keys=True, separators=(",", ":")
                          ).encode("utf-8")
    except (TypeError, ValueError):
        return None


def _deserialize_compiled(blob: bytes) -> Program:
    rec = json.loads(blob.decode("utf-8"))
    cost, kernels = rec["cost"], rec["kernels"]
    if cost is not None and not isinstance(cost, dict):
        raise ValueError("cost record is not a mapping")
    if not isinstance(kernels, dict) or not all(
            isinstance(k, str) and isinstance(v, str) and len(v) == 64
            for k, v in kernels.items()):
        raise ValueError("kernel digests malformed")
    return Program(cost, dict(kernels))


def load_program(pc: "ProgramCache", key: ProgramKey,
                 device=None) -> Optional[Program]:
    """A program's first run, looked up: on a hit the stored
    :class:`Program`, its kernels loaded from their entries in ``pc`` (no
    ``nvcc``); None on a miss or a reject."""
    from .ops import _kernels

    hit = pc.get(key, device=device)
    if hit is None:
        return None
    _kernels.preload(hit.executable.kernels, pc)
    return hit.executable


def store_program(pc: "ProgramCache", key: ProgramKey, cost: Optional[dict],
                  launched, device=None, meta: Optional[dict] = None
                  ) -> bool:
    """Write a program's record (``cost``, the kernels ``launched``) and
    the entries of those kernels into ``pc``."""
    from .ops import _kernels

    _kernels.store(launched, pc)
    return pc.put(key, Program(cost or None, _kernels.digests(launched)),
                  meta=meta, device=device)


def enable_jax_fallback_cache(directory: str) -> bool:
    """The reference's degraded mode (jax's compilation cache) for
    executables that refuse serialization. The port's entries are
    self-contained, and it has no jax: this raises."""
    raise MXNetError("progcache.enable_jax_fallback_cache: the port has no "
                     "jax compilation cache; its program and kernel "
                     "entries never refuse export")


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

class CacheEntry(NamedTuple):
    """A successful ``get``: the loaded payload (a :class:`Program`, or a
    kernel's library as the caller's ``loader`` returned it) and the
    entry's stored metadata."""
    executable: Any
    meta: Dict[str, Any]


def _obs_count(name: str, **attrs) -> None:
    # metrics/events only when telemetry records; the cache's own stats
    # dict counts unconditionally (serve_bench and the tests read those)
    from . import obs

    if obs.enabled():
        obs.inc(f"progcache.{name}")
        if name in ("reject", "write", "export_refused"):
            obs.event(f"progcache.{name}", **attrs)


class ProgramCache:
    """One cache directory of program and kernel entries.

    Layout: ``<root>/<digest>.mxprog``, each file::

        MXPROG1\\n | u32 header_len | header json | u64 payload_len |
        payload | u32 crc32(all prior)

    The header carries the :class:`ProgramKey`, the writer's
    :func:`env_fingerprint` and caller metadata. Writes are atomic (temp +
    fsync + rename); reads verify magic, CRC, digest and fingerprint before
    the payload is used — a mismatch on any is a counted reject.
    """

    def __init__(self, root: str, keep: Optional[int] = None,
                 durable: bool = True):
        self.root = str(root)
        if keep is None:
            from ._env import env_int

            keep = env_int("MXNET_PROGCACHE_KEEP", 128)
        self.keep = int(keep)
        self.durable = bool(durable)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {"hit": 0, "miss": 0, "reject": 0,
                                      "write": 0, "export_refused": 0}

    def _count(self, name: str, **attrs) -> None:
        with self._lock:
            self.stats[name] = self.stats.get(name, 0) + 1
        _obs_count(name, **attrs)

    def _path(self, digest: str) -> str:
        return os.path.join(self.root, f"{digest}.mxprog")

    def has(self, key: ProgramKey) -> bool:
        """Whether an entry file for ``key`` exists (not verified)."""
        return os.path.exists(self._path(key.digest))

    # -- read ----------------------------------------------------------
    def _read_entry(self, path: str, key: ProgramKey, device):
        """Parse + verify one entry file. Returns (header, payload) or a
        string reject reason."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return "unreadable"
        if len(raw) < len(_MAGIC) + 4 + 8 + 4 \
                or not raw.startswith(_MAGIC):
            return "bad_magic"
        body, crc_bytes = raw[:-4], raw[-4:]
        if crc32_bytes(body) != struct.unpack("<I", crc_bytes)[0]:
            return "crc_mismatch"
        off = len(_MAGIC)
        (hlen,) = struct.unpack_from("<I", body, off)
        off += 4
        try:
            header = json.loads(body[off:off + hlen].decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return "bad_header"
        off += hlen
        if len(body) < off + 8 or not isinstance(header, dict):
            return "truncated"
        (plen,) = struct.unpack_from("<Q", body, off)
        off += 8
        payload = body[off:off + plen]
        if len(payload) != plen:
            return "truncated"
        k = header.get("key")
        if not isinstance(k, dict) or k.get("digest") != key.digest:
            return "digest_mismatch"
        if header.get("env") != env_fingerprint(device):
            return "env_mismatch"
        return header, payload

    def get(self, key: ProgramKey, device=None,
            loader=None) -> Optional[CacheEntry]:
        """Load the entry of ``key`` for programs on ``device`` (see
        :func:`env_fingerprint`). ``loader(payload)`` turns the payload
        into the returned ``executable`` (default: a :class:`Program`);
        whatever it raises is a reject. A missing file is a counted miss, a
        present but unusable one a counted reject: both return None and
        the caller builds or runs as if the entry never existed."""
        path = self._path(key.digest)
        if not os.path.exists(path):
            self._count("miss")
            return None
        res = self._read_entry(path, key, device)
        if isinstance(res, str):
            self._count("reject", reason=res, site=key.site,
                        label=key.label)
            return None
        header, payload = res
        try:
            executable = (loader or _deserialize_compiled)(payload)
        except Exception as e:  # a bad payload degrades to a build or run
            self._count("reject", reason=f"deserialize:{type(e).__name__}",
                        site=key.site, label=key.label)
            return None
        self._count("hit")
        # touch so keep-last-N GC ranks by USE recency, not write time
        try:
            os.utime(path, None)
        except OSError:
            pass
        return CacheEntry(executable, header.get("meta") or {})

    # -- write ---------------------------------------------------------
    def put(self, key: ProgramKey, compiled, meta: Optional[dict] = None,
            device=None) -> bool:
        """Commit one entry: a :class:`Program`, or a kernel library's
        bytes. The payload is round-trip verified before it is published
        (a record that does not read back is counted ``export_refused``
        and not written). Concurrent writers of one key are safe: rename
        is atomic and both wrote the same content."""
        if isinstance(compiled, (bytes, bytearray)):
            blob = bytes(compiled)
        else:
            blob = serialize_compiled(compiled)
            if blob is not None:
                try:
                    if _deserialize_compiled(blob) != compiled:
                        blob = None
                except (ValueError, KeyError, TypeError):
                    blob = None
        if blob is None:
            self._count("export_refused", site=key.site, label=key.label)
            return False
        header = json.dumps(
            {"key": key._asdict(), "env": env_fingerprint(device),
             "meta": meta or {}, "created": time.time()},
            sort_keys=True).encode("utf-8")
        body = b"".join([_MAGIC, struct.pack("<I", len(header)), header,
                         struct.pack("<Q", len(blob)), blob])
        data = body + struct.pack("<I", crc32_bytes(body))
        try:
            atomic_write_bytes(self._path(key.digest), data,
                               durable=self.durable)
        except OSError:
            return False
        self._count("write", site=key.site, label=key.label,
                    bytes=len(data))
        self.gc()
        return True

    # -- GC ------------------------------------------------------------
    def gc(self) -> int:
        """Keep the ``keep`` most recently used entries (by mtime — reads
        touch); drop the rest. Returns how many were removed."""
        if self.keep <= 0:
            return 0
        try:
            entries = [e for e in os.listdir(self.root)
                       if e.endswith(".mxprog")]
        except OSError:
            return 0
        if len(entries) <= self.keep:
            return 0
        stamped = []
        for e in entries:
            try:
                stamped.append((os.path.getmtime(
                    os.path.join(self.root, e)), e))
            except OSError:
                continue  # a concurrent GC got it first
        stamped.sort(reverse=True)
        removed = 0
        for _, e in stamped[self.keep:]:
            try:
                os.unlink(os.path.join(self.root, e))
                removed += 1
            except OSError:
                pass
        return removed

    def entries(self) -> int:
        try:
            return sum(1 for e in os.listdir(self.root)
                       if e.endswith(".mxprog"))
        except OSError:
            return 0


# ---------------------------------------------------------------------------
# process-global activation (env-driven; engines default to this)
# ---------------------------------------------------------------------------

_global: list = [None, False]  # [ProgramCache|None, resolved?]
_global_lock = threading.Lock()


def default_dir() -> str:
    return os.path.join(
        os.environ.get("XDG_CACHE_HOME",
                       os.path.join(os.path.expanduser("~"), ".cache")),
        "mxnet_tpu_torch", "progcache")


def active() -> bool:
    """Is the process-global persistent cache armed?
    ``MXNET_PROGCACHE=0`` vetoes; ``MXNET_PROGCACHE_DIR`` (or
    ``MXNET_PROGCACHE=1`` with the default dir) arms."""
    env = os.environ.get("MXNET_PROGCACHE", "").lower()
    if env in _FALSE:
        return False
    return env in _TRUE or bool(os.environ.get("MXNET_PROGCACHE_DIR"))


def cache() -> Optional[ProgramCache]:
    """The process-global :class:`ProgramCache`, or None when inactive.
    Resolved from the environment on first use; :func:`configure`
    overrides programmatically."""
    if not active():
        return None
    if _global[1]:
        return _global[0]
    with _global_lock:
        if not _global[1]:
            root = os.environ.get("MXNET_PROGCACHE_DIR") or default_dir()
            try:
                _global[0] = ProgramCache(root)
            except OSError:
                _global[0] = None  # unwritable dir: run uncached
            _global[1] = True
    return _global[0]


def configure(directory: Optional[str], keep: Optional[int] = None
              ) -> Optional[ProgramCache]:
    """Arm (or disarm with None) the process-global cache in code — the
    env-free path tools and tests use."""
    with _global_lock:
        if directory is None:
            _global[0], _global[1] = None, True
            os.environ["MXNET_PROGCACHE"] = "0"
            return None
        os.environ.pop("MXNET_PROGCACHE", None)
        os.environ["MXNET_PROGCACHE_DIR"] = str(directory)
        _global[0] = ProgramCache(str(directory), keep=keep)
        _global[1] = True
        return _global[0]


def reset() -> None:
    """Forget the resolved global cache (tests; the next :func:`cache`
    re-reads the environment)."""
    with _global_lock:
        _global[0], _global[1] = None, False

