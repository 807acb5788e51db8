"""The port's persistent program cache (``mxnet_tpu_torch/progcache.py``)
on the CPU: the reference's cases of ``tests/test_progcache.py`` held to
the port's contract, and parity with the JAX package.

- key derivation: one shared ``program_key``, bitwise the reference's for
  the same statics;
- structure: hit / miss / reject (a truncated entry, a flipped byte, a
  foreign or stale fingerprint, a wrong file name, an entry written by the
  other package): every bad entry is a counted reject and the caller runs
  as if there were none, never a crash and never a wrong result;
- kernel entries: a CPython extension built by a stand-in for ``nvcc``
  (``gcc`` on a C source) goes into the cache, loads from it with no build,
  and a rejected entry is rebuilt and replaced; a failing build raises;
- bitwise parity: a cache-hit engine answers what the engine that wrote
  the cache answered, and what an engine with no cache answers, within
  the reference tests' tolerance of the JAX engine (serve buckets, the
  fused update);
- artifact payloads: ``serve.ship_programs`` -> ``serve.load``;
- elastic rejoin: a checkpoint-derived ``prewarm_batch`` hits the program
  a real ``Module.fit`` wrote, and a ``prewarm`` mutates nothing;
- keep-last-N GC;
- a ``ProcReplica`` child killed and started again warms from the cache,
  and ``serve_bench.run_cold_bench``'s warm leg runs no fresh program.
"""
import os
import stat
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import progcache as jprogcache
from mxnet_tpu import serve as jserve
from mxnet_tpu import symbol as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, profiler, progcache, serve
from mxnet_tpu_torch import optimizer as opt_mod
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _kernels

# tiny shapes need no intra-op threads; the suite runs files in parallel
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with mx.cpu():
        yield


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    """Arm the process-global cache at a per-test dir; disarm after."""
    d = str(tmp_path / "progcache")
    monkeypatch.delenv("MXNET_PROGCACHE", raising=False)
    monkeypatch.setenv("MXNET_PROGCACHE_DIR", d)
    progcache.configure(d)
    yield d
    progcache.reset()


def _mlp(S=sym, hidden=8, in_dim=4):
    data = S.Variable("data")
    net = S.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = S.softmax(net, name="prob")
    rng = np.random.RandomState(0)
    arg = {"fc1_weight": rng.randn(hidden, in_dim).astype(np.float32) * 0.3,
           "fc1_bias": rng.randn(hidden).astype(np.float32)}
    return net, arg


def _engine(net, arg, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("lint", "off")
    return serve.InferenceEngine(net, arg, {}, **kw)


def _program(tag="x"):
    return progcache.Program({"flops": 7, "bytes_accessed": 11,
                              "device": "cpu", "tag": tag}, {})


def _put_one(cache, tag="x", shape=(3, 2)):
    key = progcache.program_key("test", tag, (tag, shape))
    assert cache.put(key, _program(tag), meta={"bucket": 1})
    return key


# ---------------------------------------------------------------------------
# key derivation
# ---------------------------------------------------------------------------

def test_program_key_deterministic_and_distinct():
    statics = ((b"graph", ("data",), 0.0),
               {"b": 1, "a": 2}, float("0.1"), type(int))
    k1 = progcache.program_key("serve", "bucket4", statics)
    k2 = progcache.program_key("serve", "bucket4", statics)
    assert k1 == k2 and k1.site == "serve" and k1.label == "bucket4"
    assert len(k1.digest) == 64
    assert progcache.program_key("update", "bucket4", statics) != k1
    assert progcache.program_key("serve", "bucket8", statics) != k1
    assert progcache.program_key(
        "serve", "bucket4", ((b"graph2", ("data",), 0.0),)) != k1
    assert progcache.program_key("s", "l", {"a": 1, "b": 2}) \
        == progcache.program_key("s", "l", {"b": 2, "a": 1})


@pytest.mark.parametrize("statics", [
    (), ((b"graph", ("data",), 0.0), {"b": 1, "a": 2}, float("0.1")),
    (((1, 8), "float32"), frozenset({3, 1}), None, True, [1.5, -2]),
    {"source": "ab" * 32, "flags": ["-O3", "-shared"]}])
def test_program_key_digests_equal_the_reference(statics):
    """The same statics give bitwise the same digest in both packages (a
    type canonicalizes to its qualified name, which names the package)."""
    got = progcache.program_key("serve", "bucket4", statics)
    want = jprogcache.program_key("serve", "bucket4", statics)
    assert tuple(got) == tuple(want)
    assert progcache._canon(statics) == jprogcache._canon(statics)


def test_env_fingerprint_fields():
    fp = progcache.env_fingerprint("cpu")
    for field in ("platform", "device_kind", "num_devices", "torch", "cuda",
                  "ext_suffix", "tf32_matmul", "matmul_precision",
                  "cudnn_benchmark", "deterministic", "code"):
        assert field in fp, fp
    assert fp["platform"] == "cpu" and fp["schema"] == 1
    assert progcache.env_fingerprint(torch.device("cpu")) == fp
    # the copy is defensive: mutating it must not poison the source
    fp["platform"] = "mars"
    assert progcache.env_fingerprint("cpu")["platform"] == "cpu"
    # a switch that changes what cuBLAS computes changes the fingerprint
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        assert progcache.env_fingerprint("cpu") != fp
    finally:
        torch.set_float32_matmul_precision(prev)


def test_code_fingerprint_covers_cuda_sources(tmp_path, monkeypatch):
    """The source hash walks the package's .py files and csrc's .cu/.cuh
    (a kernel edit invalidates every entry) and nothing else."""
    import mxnet_tpu_torch.progcache as pm

    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "a.py").write_text("x = 1\n")
    (pkg / "csrc" / "k.cu").write_text("// kernel\n")
    (pkg / "notes.txt").write_text("ignored\n")
    monkeypatch.setattr(pm, "__file__", str(pkg / "progcache.py"))
    hashes = []
    for edit in (None, ("notes.txt", "still ignored\n"),
                 ("csrc/k.cu", "// kernel, edited\n"),
                 ("a.py", "x = 2\n")):
        if edit:
            (pkg / edit[0]).write_text(edit[1])
        monkeypatch.setattr(pm, "_code_fp_cache", [None])
        hashes.append(pm.code_fingerprint())
    assert hashes[0] == hashes[1]
    assert len(set(hashes[1:])) == 3


# ---------------------------------------------------------------------------
# hit / miss / reject structure
# ---------------------------------------------------------------------------

def test_roundtrip_hit_and_miss(tmp_path):
    cache = progcache.ProgramCache(str(tmp_path))
    key = _put_one(cache)
    assert cache.stats["write"] == 1
    miss = progcache.program_key("test", "other", ("other",))
    assert cache.get(miss) is None
    assert cache.stats["miss"] == 1
    entry = cache.get(key)
    assert entry is not None and entry.meta["bucket"] == 1
    assert cache.stats["hit"] == 1 and cache.stats["reject"] == 0
    assert entry.executable == _program()


def test_aot_compile_records_the_kernels_a_call_launches(fake_kernel):
    """``aot_compile`` runs the call once and returns its result beside
    the :class:`Program` of the kernels it launched (none on the CPU's
    plain versions), which serializes and reads back as itself."""
    out, prog = progcache.aot_compile(lambda x, y=0: x + y, (2,), {"y": 3})
    assert out == 5 and prog == progcache.Program(None, {})
    out, prog = progcache.aot_compile(  # as a wrapper launches
        lambda x: _kernels.entry("fake_probe")(x), (1,))
    assert out == 4
    assert prog.kernels == {"fake_probe":
                            _kernels.kernel_key("fake_probe").digest}
    blob = progcache.serialize_compiled(prog)
    assert progcache._deserialize_compiled(blob) == prog


def test_truncated_entry_rejects(tmp_path):
    cache = progcache.ProgramCache(str(tmp_path))
    key = _put_one(cache)
    path = cache._path(key.digest)
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    assert cache.get(key) is None
    assert cache.stats["reject"] == 1 and cache.stats["hit"] == 0
    assert cache._read_entry(path, key, None) == "crc_mismatch"


def test_corrupt_byte_rejects(tmp_path):
    cache = progcache.ProgramCache(str(tmp_path))
    key = _put_one(cache)
    path = cache._path(key.digest)
    with open(path, "r+b") as f:
        f.seek(len(progcache._MAGIC) + 30)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
    assert cache.get(key) is None
    assert cache.stats["reject"] == 1


@pytest.mark.parametrize("field,value", [("platform", "gpu"),
                                         ("code", "f" * 64),
                                         ("torch", "0.0.1"),
                                         ("deterministic", True)])
def test_foreign_fingerprint_rejects(tmp_path, monkeypatch, field, value):
    """An entry of another platform, stale code, another torch or other
    numeric switches never loads."""
    cache = progcache.ProgramCache(str(tmp_path))
    real = progcache.env_fingerprint("cpu")
    monkeypatch.setattr(progcache, "env_fingerprint",
                        lambda device=None: dict(real, **{field: value}))
    key = _put_one(cache)
    monkeypatch.undo()
    assert cache._read_entry(cache._path(key.digest), key, "cpu") \
        == "env_mismatch"
    assert cache.get(key, device="cpu") is None
    assert cache.stats["reject"] == 1 and cache.stats["hit"] == 0


def test_wrong_digest_filename_rejects(tmp_path):
    cache = progcache.ProgramCache(str(tmp_path))
    key = _put_one(cache)
    other = progcache.program_key("test", "other", ("other",))
    os.rename(cache._path(key.digest), cache._path(other.digest))
    assert cache.get(other) is None  # header digest disagrees with name
    assert cache.stats["reject"] == 1


def test_unparsable_payload_rejects_and_bad_record_is_refused(tmp_path):
    cache = progcache.ProgramCache(str(tmp_path))
    key = progcache.program_key("test", "blob", ())
    assert cache.put(key, b"not a program record")  # raw bytes: a kernel's
    assert cache.get(key) is None  # ... which no Program loader parses
    assert cache.stats["reject"] == 1
    # a record whose cost does not survive the round trip is refused
    bad = progcache.Program({"shape": (1, 2)}, {})
    assert not cache.put(progcache.program_key("test", "bad", ()), bad)
    assert cache.stats["export_refused"] == 1 and cache.entries() == 1
    assert progcache.serialize_compiled("not a program") is None


def test_gc_keep_last_n(tmp_path):
    cache = progcache.ProgramCache(str(tmp_path), keep=2)
    keys = []
    for i in range(4):
        k = _put_one(cache, tag=f"t{i}", shape=(i + 1, 2))
        keys.append(k)
        stamp = time.time() - 100 + i
        os.utime(cache._path(k.digest), (stamp, stamp))
    cache.gc()
    assert cache.entries() <= 2
    assert cache.get(keys[-1]) is not None
    assert cache.get(keys[0]) is None


def test_activation_env_and_veto(tmp_path, monkeypatch):
    d = str(tmp_path / "armed")
    monkeypatch.delenv("MXNET_PROGCACHE", raising=False)
    monkeypatch.delenv("MXNET_PROGCACHE_DIR", raising=False)
    progcache.reset()
    try:
        assert not progcache.active() and progcache.cache() is None
        monkeypatch.setenv("MXNET_PROGCACHE_DIR", d)
        progcache.reset()
        assert progcache.active() and progcache.cache().root == d
        monkeypatch.setenv("MXNET_PROGCACHE", "0")  # the veto wins
        progcache.reset()
        assert not progcache.active() and progcache.cache() is None
        monkeypatch.setenv("MXNET_PROGCACHE", "1")
        monkeypatch.setenv("MXNET_PROGCACHE_KEEP", "3")
        monkeypatch.delenv("MXNET_PROGCACHE_DIR")
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        progcache.reset()
        pc = progcache.cache()
        assert pc.root == progcache.default_dir() == str(
            tmp_path / "xdg" / "mxnet_tpu_torch" / "progcache")
        assert pc.keep == 3
    finally:
        progcache.reset()


def test_reference_names_and_the_jax_fallback():
    missing = [n for n in jprogcache.__all__ if not hasattr(progcache, n)]
    assert not missing, missing
    with pytest.raises(MXNetError, match="enable_jax_fallback_cache"):
        progcache.enable_jax_fallback_cache("/nowhere")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_entry_of_the_other_package_is_an_env_reject(tmp_path, monkeypatch,
                                                     writer):
    """Both packages write the same layout under the same digests: an
    entry one writes is, to the other, a counted ``env_mismatch`` reject,
    never a parse error and never a load."""
    key_args = ("serve", "bucket1", ((b"graph",), (("data",),), 0.0))
    pkey = progcache.program_key(*key_args)
    jkey = jprogcache.program_key(*key_args)
    assert pkey.digest == jkey.digest
    pcache = progcache.ProgramCache(str(tmp_path))
    jcache = jprogcache.ProgramCache(str(tmp_path))
    path = pcache._path(pkey.digest)
    assert path == jcache._path(jkey.digest)
    if writer == "port":
        assert pcache.put(pkey, _program(), meta={"bucket": 1},
                          device="cpu")
        assert jcache._read_entry(path, jkey.digest) == "env_mismatch"
        assert jcache.get(jkey) is None
        assert jcache.stats["reject"] == 1 and jcache.stats["hit"] == 0
    else:
        # the reference's XLA export needs no real executable to be
        # written: stand-ins for its (de)serializers
        monkeypatch.setattr(jprogcache, "serialize_compiled",
                            lambda c: b"xla executable")
        monkeypatch.setattr(jprogcache, "_deserialize_compiled",
                            lambda b: object())
        assert jcache.put(jkey, object(), meta={"bucket": 1})
        assert pcache._read_entry(path, pkey, "cpu") == "env_mismatch"
        assert pcache.get(pkey, device="cpu") is None
        assert pcache.stats["reject"] == 1 and pcache.stats["hit"] == 0


# ---------------------------------------------------------------------------
# kernel entries: a CPython extension built by a stand-in for nvcc
# ---------------------------------------------------------------------------

_FAKE_SRC = r"""
#define PY_SSIZE_T_CLEAN
#include <Python.h>
static PyObject *launch(PyObject *self, PyObject *args) {
    long x;
    if (!PyArg_ParseTuple(args, "l", &x)) return NULL;
    return PyLong_FromLong(x * 3 + 1);
}
static PyMethodDef M[] = {{"launch", launch, METH_VARARGS, ""},
                          {NULL, NULL, 0, NULL}};
static struct PyModuleDef D = {PyModuleDef_HEAD_INIT, "_mxt_fake_probe",
                               NULL, -1, M};
PyMODINIT_FUNC PyInit__mxt_fake_probe(void) { return PyModule_Create(&D); }
"""

_FAKE_NVCC = """#!/bin/sh
[ -n "$FAKE_NVCC_FAIL" ] && { echo "fake nvcc: refused" >&2; exit 3; }
out=""; src=""; inc=""
while [ $# -gt 0 ]; do
  case "$1" in
    -o) out="$2"; shift ;;
    -I*) inc="$inc $1" ;;
    *.cu) src="$1" ;;
  esac
  shift
done
exec gcc -shared -fPIC $inc -x c "$src" -o "$out"
"""


@pytest.fixture()
def fake_kernel(tmp_path, monkeypatch):
    """A kernel ``fake_probe`` whose source is C and whose ``nvcc`` is gcc:
    the loader's build, cache and import path run end to end here."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake_probe.cu").write_text(_FAKE_SRC)
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_kernels, "CSRC", csrc)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build1")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setitem(_kernels.KERNELS, "fake_probe", "fake_probe.cu")
    monkeypatch.setattr(_kernels, "_nvcc_version_cache", ["fake 1.0"])

    def fresh(build_dir):
        """As a new process with an empty build directory would start."""
        _kernels._loaded.pop("fake_probe", None)
        _kernels._entries.pop("fake_probe", None)
        monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / build_dir)

    yield fresh
    fresh("build1")


def test_kernel_entry_loads_without_a_build(fake_kernel, cache_dir):
    pc = progcache.cache()  # armed: what load() consults by default
    builds = _kernels.build_stats()["count"]
    mod = _kernels.load("fake_probe")
    assert mod.launch(41) == 124
    assert _kernels.build_stats()["count"] == builds + 1
    assert _kernels.build_stats()["kernels"][-1] == "fake_probe"
    key = _kernels.kernel_key("fake_probe")
    assert key.site == "kernel" and key.label == "fake_probe"
    assert pc.stats["write"] == 1 and pc.has(key)
    built = _kernels._lib_path("fake_probe").read_bytes()
    entry = pc.get(key, device="gpu", loader=bytes)
    assert entry.executable == built  # the entry is the library's bytes
    assert entry.meta["nvcc"] == "fake 1.0" \
        and entry.meta["flags"] == _kernels.NVCC_FLAGS
    # a new process with an empty build dir: loaded from the entry, no
    # nvcc run, the same bytes at the library's path
    fake_kernel("build2")
    assert not _kernels._lib_path("fake_probe").exists()
    with _kernels.recording() as launched:
        assert _kernels.entry("fake_probe")(41) == 124
    assert launched == {"fake_probe"}
    assert _kernels.build_stats()["count"] == builds + 1
    assert _kernels._lib_path("fake_probe").read_bytes() == built
    assert pc.stats["hit"] == 2 and pc.stats["reject"] == 0
    assert _kernels.digests(launched) == {"fake_probe": key.digest}


def test_kernel_build_all_fills_and_reads_the_cache(fake_kernel, cache_dir):
    """``build_all(names)`` with a cache armed: the missing libraries are
    built in parallel and stored; on an empty build dir they load from
    their entries with no ``nvcc`` run."""
    pc = progcache.cache()
    builds = _kernels.build_stats()["count"]
    secs = _kernels.build_all(["fake_probe"])
    assert set(secs) == {"fake_probe"} and secs["fake_probe"] > 0
    assert _kernels.build_stats()["count"] == builds + 1
    assert pc.has(_kernels.kernel_key("fake_probe"))
    fake_kernel("build2")
    assert _kernels.build_all(["fake_probe"]) == {"fake_probe": 0.0}
    assert _kernels.build_stats()["count"] == builds + 1
    assert _kernels.entry("fake_probe")(5) == 16 and pc.stats["hit"] == 1


def test_kernel_rejected_entry_is_rebuilt_and_replaced(fake_kernel,
                                                       tmp_path):
    pc = progcache.ProgramCache(str(tmp_path / "pc"))
    _kernels.load("fake_probe", cache=pc)
    key = _kernels.kernel_key("fake_probe")
    path = pc._path(key.digest)
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    fake_kernel("build2")
    builds = _kernels.build_stats()["count"]
    # preload hands the cache over, as a cache-hit program does
    _kernels.preload({"fake_probe": key.digest}, pc)
    assert _kernels.entry("fake_probe")(2) == 7
    assert pc.stats["reject"] == 1
    assert _kernels.build_stats()["count"] == builds + 1
    # the rebuilt library replaced the entry
    assert isinstance(pc._read_entry(path, key, "gpu"), tuple)
    fake_kernel("build3")
    _kernels.load("fake_probe", cache=pc)
    assert pc.stats["hit"] == 1 and _kernels.build_stats()["count"] \
        == builds + 1


def test_kernel_entry_that_does_not_import_rejects(fake_kernel, tmp_path):
    """An entry that passes its checks but does not import (bytes of no
    library) is a reject followed by a build."""
    pc = progcache.ProgramCache(str(tmp_path / "pc"))
    key = _kernels.kernel_key("fake_probe")
    assert pc.put(key, b"\x7fELF not really", device="gpu")
    builds = _kernels.build_stats()["count"]
    assert _kernels.load("fake_probe", cache=pc).launch(0) == 1
    assert pc.stats["reject"] == 1 and pc.stats["hit"] == 0
    assert _kernels.build_stats()["count"] == builds + 1


def test_kernel_failed_build_after_reject_raises(fake_kernel, tmp_path,
                                                 monkeypatch):
    """No fallback hides a failure: a rejected entry and an nvcc that
    fails raise."""
    pc = progcache.ProgramCache(str(tmp_path / "pc"))
    key = _kernels.kernel_key("fake_probe")
    assert pc.put(key, b"garbage", device="gpu")
    monkeypatch.setenv("FAKE_NVCC_FAIL", "1")
    with pytest.raises(MXNetError, match="nvcc failed for fake_probe"):
        _kernels.load("fake_probe", cache=pc)
    assert pc.stats["reject"] == 1
    assert "fake_probe" not in _kernels._loaded


def test_kernel_unarmed_load_touches_no_cache(fake_kernel, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("MXNET_PROGCACHE", "0")
    progcache.reset()
    try:
        assert _kernels.load("fake_probe").launch(1) == 4
        assert not (tmp_path / "pc").exists()
    finally:
        progcache.reset()


# ---------------------------------------------------------------------------
# serve engine integration
# ---------------------------------------------------------------------------

def test_engine_cache_hit_bitwise_parity(cache_dir):
    net, arg = _mlp()
    e1 = _engine(net, arg)
    assert e1.warmup((4,)) == len(e1.buckets)
    assert all(e.get("cache_hit") is False for e in e1.compile_log)
    x = np.random.RandomState(3).rand(3, 4).astype(np.float32)
    ref = e1.predict(x)

    e2 = _engine(net, arg)
    assert e2.warmup((4,)) == len(e2.buckets)
    assert [e.get("cache_hit") for e in e2.compile_log] \
        == [True] * len(e2.buckets), "warm engine must hit every bucket"
    assert e2.cache_hits == len(e2.buckets)
    np.testing.assert_array_equal(ref, e2.predict(x))
    assert e2.num_programs <= len(e2.buckets)
    assert all(len(e.get("program_key", "")) == 64
               for e in e1.compile_log + e2.compile_log)
    assert [e["program_key"] for e in e1.compile_log] \
        == [e["program_key"] for e in e2.compile_log]


def test_engine_hit_adopts_the_stored_cost(cache_dir, monkeypatch):
    """With the device plane on, a miss captures and writes its record; a
    hit adopts it (no capture run) and files it under the same key."""
    from mxnet_tpu_torch import obs

    monkeypatch.setenv("MXNET_DEVICE_COST", "1")
    obs.device.reset()
    net, arg = _mlp()
    e1 = _engine(net, arg)
    e1.warmup((4,))
    captured = obs.device.cost_of("serve", "bucket4")
    assert captured["flops"] > 0
    assert captured["program_key"] == e1.compile_log[-1]["program_key"]
    obs.device.reset()
    calls = []
    real = obs.device.capture
    monkeypatch.setattr(obs.device, "capture",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    e2 = _engine(net, arg)
    e2.warmup((4,))
    assert not calls, "a hit must not run a capture"
    assert obs.device.cost_of("serve", "bucket4") == captured
    for a, b in zip(e1.compile_log, e2.compile_log):
        assert {k: a[k] for k in obs.device.COST_FIELDS} \
            == {k: b[k] for k in obs.device.COST_FIELDS}
    obs.device.reset()


def test_mlp_cold_warm_unarmed_bitwise_and_near_the_reference(
        tmp_path, monkeypatch):
    """The reference's MLP: a cold (miss) engine, a warm (hit) one and one
    with no cache answer bitwise the same, and within the reference
    tests' tolerance of the JAX engine."""
    monkeypatch.setenv("MXNET_PROGCACHE", "0")
    progcache.reset()
    try:
        d = str(tmp_path / "pc")
        net, arg = _mlp()
        x = np.random.RandomState(4).rand(7, 4).astype(np.float32)
        cold = _engine(net, arg, progcache_dir=d)
        warm_out = cold.predict(x)
        warm = _engine(net, arg, progcache_dir=d)
        out = warm.predict(x)
        assert [e["cache_hit"] for e in warm.compile_log] == [True]
        unarmed = _engine(net, arg)
        assert unarmed._progcache is None and "progcache" not in \
            unarmed.stats()
        np.testing.assert_array_equal(warm_out, out)
        np.testing.assert_array_equal(unarmed.predict(x), out)
        jnet, jarg = _mlp(jsym)
        jeng = jserve.InferenceEngine(jnet, jarg, {}, max_batch_size=4,
                                      lint="off")
        np.testing.assert_allclose(out, np.asarray(jeng.predict(x)),
                                   rtol=1e-5, atol=1e-6)
    finally:
        progcache.reset()


def test_engine_key_drift_misses_not_collides(cache_dir):
    net, arg = _mlp(hidden=8)
    e1 = _engine(net, arg)
    e1.warmup((4,))
    net2, arg2 = _mlp(hidden=6)
    e2 = _engine(net2, arg2)
    e2.warmup((4,))
    assert all(e.get("cache_hit") is False for e in e2.compile_log)
    e3 = _engine(net, arg, pad_value=1.0)
    e3.warmup((4,))
    assert all(e.get("cache_hit") is False for e in e3.compile_log)


def test_corrupt_cache_degrades_to_compile(cache_dir):
    net, arg = _mlp()
    e1 = _engine(net, arg)
    e1.warmup((4,))
    for f in os.listdir(cache_dir):
        if f.endswith(".mxprog"):
            path = os.path.join(cache_dir, f)
            with open(path, "r+b") as fh:
                fh.seek(20)
                fh.write(b"\xde\xad\xbe\xef")
    e2 = _engine(net, arg)
    assert e2.warmup((4,)) == len(e2.buckets)
    assert all(e.get("cache_hit") is False for e in e2.compile_log)
    assert e2._progcache.stats["reject"] >= len(e2.buckets)
    x = np.random.RandomState(3).rand(2, 4).astype(np.float32)
    np.testing.assert_array_equal(e1.predict(x), e2.predict(x))
    # the misses rewrote the entries: a third engine hits again
    e3 = _engine(net, arg)
    e3.warmup((4,))
    assert all(e["cache_hit"] for e in e3.compile_log)


def test_warmup_concurrent_matches_serial(cache_dir):
    """``concurrency`` is accepted; the port warms serially (a documented
    difference) and a fresh dir still sees each bucket once."""
    net, arg = _mlp()
    e_serial = _engine(net, arg, max_batch_size=8)
    assert e_serial.warmup((4,), concurrency=1) == len(e_serial.buckets)
    e_conc = _engine(net, arg, max_batch_size=8, progcache_dir=None)
    e_conc._progcache = progcache.ProgramCache(cache_dir + "-conc")
    e_conc._key_statics = e_conc._compute_key_statics()
    assert e_conc.warmup((4,), concurrency=4) == len(e_conc.buckets)
    sigs = [e["sig"] for e in e_conc.compile_log]
    assert len(set(map(repr, sigs))) == len(sigs) == len(e_conc.buckets)
    assert not any(e["cache_hit"] for e in e_conc.compile_log)
    x = np.random.RandomState(5).rand(6, 4).astype(np.float32)
    np.testing.assert_array_equal(e_serial.predict(x), e_conc.predict(x))


def test_warmup_idempotent_second_call_zero(cache_dir):
    net, arg = _mlp()
    e = _engine(net, arg)
    assert e.warmup((4,)) == len(e.buckets)
    assert e.warmup((4,)) == 0


def test_ship_programs_and_load(cache_dir, tmp_path):
    progcache.configure(None)
    net, arg = _mlp()
    prefix = str(tmp_path / "model")
    mx.model.save_checkpoint(prefix, 0, net,
                             {k: nd.array(v) for k, v in arg.items()}, {})
    e1 = _engine(net, arg)
    e1.warmup((4,))
    n = serve.ship_programs(e1, prefix)
    assert n == len(e1.buckets)
    assert os.path.isdir(serve.programs_dir_for(prefix))
    eng = serve.load(prefix, epoch=0, max_batch_size=4, lint="off")
    assert eng._progcache is not None \
        and eng._progcache.root == serve.programs_dir_for(prefix)
    assert eng.warmup((4,)) == len(eng.buckets)
    assert all(e.get("cache_hit") for e in eng.compile_log)
    x = np.random.RandomState(7).rand(3, 4).astype(np.float32)
    np.testing.assert_array_equal(e1.predict(x), eng.predict(x))
    # an explicit dir beats the shipped payload
    other = str(tmp_path / "explicit")
    eng2 = serve.load(prefix, epoch=0, max_batch_size=4, lint="off",
                      progcache_dir=other)
    eng2.warmup((4,))
    assert eng2._progcache.root == other
    assert not any(e["cache_hit"] for e in eng2.compile_log)


def test_decode_engine_warm_start_runs_no_fresh_program(tmp_path):
    """A ``DecodeEngine`` on a cache another engine filled: ``warmup()``
    returns 0 fresh signatures, every entry a hit, the greedy tokens the
    same."""
    from mxnet_tpu_torch.models import transformer as tt

    mx.random.seed(7)
    lm = tt.transformer_lm(vocab_size=53, units=16, hidden_size=32,
                           num_layers=2, num_heads=2, max_length=32,
                           dropout=0.0)
    lm.initialize()
    lm(nd.zeros((1, 8)))
    d = str(tmp_path / "pc")
    kw = dict(slots=2, page_size=8, num_pages=9, prompt_buckets=[8, 16],
              device="cpu", progcache_dir=d)
    tokens = []
    for fresh in (3, 0):
        eng = tt_engine = serve.DecodeEngine(lm, **kw)
        assert tt_engine.warmup() == fresh
        assert all(e["cache_hit"] == (fresh == 0)
                   for e in eng.compile_log)
        assert eng.stats()["progcache"]["dir"] == d
        sched = serve.DecodeScheduler(eng, max_new_tokens=5)
        try:
            tokens.append(list(sched.generate(np.arange(1, 6),
                                              max_new_tokens=5)))
        finally:
            sched.close()
    assert tokens[0] == tokens[1] and len(tokens[0]) == 5


# ---------------------------------------------------------------------------
# fused update engine integration
# ---------------------------------------------------------------------------

def _one_step(cache_hit_expected, seed=42):
    rng = np.random.RandomState(seed)
    opt = opt_mod.create("adam", learning_rate=0.05, rescale_grad=0.5)
    up = opt_mod.Updater(opt)
    ws = [nd.array(rng.randn(5, 4).astype(np.float32)),
          nd.array(rng.randn(3).astype(np.float32))]
    gs = [nd.array(rng.randn(5, 4).astype(np.float32)),
          nd.array(rng.randn(3).astype(np.float32))]
    up.update_batch([0, 1], gs, ws)
    eng = up._engine
    assert eng is not None and len(eng.compile_log) == 1
    assert eng.compile_log[0].get("cache_hit") is cache_hit_expected
    assert len(eng.compile_log[0].get("program_key", "")) == 64
    return [w.asnumpy() for w in ws], up


def test_fused_cache_hit_bitwise_and_dispatch_bound(cache_dir):
    w_fresh, _ = _one_step(cache_hit_expected=False)
    w_hit, up = _one_step(cache_hit_expected=True)
    for a, b in zip(w_fresh, w_hit):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(1)
    ws = [nd.array(rng.randn(5, 4).astype(np.float32)),
          nd.array(rng.randn(3).astype(np.float32))]
    gs = [w.zeros_like() for w in ws]
    with profiler.count_dispatches() as c:
        up.update_batch([0, 1], gs, ws)
    # the one-pass-per-step bound holds after a hit
    assert c.as_dict()["compiled_calls"] == 1, c.as_dict()
    assert len(up._engine.compile_log) == 1  # no new signature


def test_updater_prewarm_populates_without_mutating(cache_dir):
    rng = np.random.RandomState(0)
    opt = opt_mod.create("sgd", learning_rate=0.1, momentum=0.9)
    up = opt_mod.Updater(opt)
    ws = [nd.array(rng.randn(4, 3).astype(np.float32))]
    before = ws[0].asnumpy().copy()
    assert up.prewarm_batch([0], ws)
    np.testing.assert_array_equal(before, ws[0].asnumpy())
    assert opt._index_update_count == {}, "prewarm must not advance counts"
    assert opt.num_update == 0 and up.states == {}
    assert up._engine.exec_count == 0
    assert up._engine.compile_log[-1].get("cache_hit") is False
    opt2 = opt_mod.create("sgd", learning_rate=0.1, momentum=0.9)
    up2 = opt_mod.Updater(opt2)
    ws2 = [nd.array(rng.randn(4, 3).astype(np.float32))]
    assert up2.prewarm_batch([0], ws2)
    assert up2._engine.compile_log[-1].get("cache_hit") is True
    # the real first step then finds its signature resolved
    up2.update_batch([0], [ws2[0].zeros_like()], ws2)
    assert len(up2._engine.compile_log) == 1


def test_fused_adam_prewarm_then_steps_bitwise(cache_dir):
    """Adam with multi-precision-free f32 weights: ``prewarm`` touches no
    weight, state or counter, and the steps after it are bitwise those of
    an updater that never prewarmed."""
    def run(prewarm):
        rng = np.random.RandomState(9)
        opt = opt_mod.create("adam", learning_rate=0.01,
                             lr_scheduler=mx.lr_scheduler.FactorScheduler(
                                 step=1, factor=0.5))
        up = opt_mod.Updater(opt)
        ws = [nd.array(rng.randn(6, 2).astype(np.float32)),
              nd.array(rng.randn(2).astype(np.float32))]
        if prewarm:
            snap = [w.asnumpy().copy() for w in ws]
            assert up.prewarm_batch([0, 1], ws)
            assert all(np.array_equal(a, w.asnumpy())
                       for a, w in zip(snap, ws))
            assert opt._index_update_count == {} and up.states == {}
            assert opt.lr_scheduler.base_lr == 0.01
        for _ in range(3):
            gs = [nd.array(rng.randn(*w.shape).astype(np.float32))
                  for w in ws]
            up.update_batch([0, 1], gs, ws)
        return [w.asnumpy() for w in ws]

    for a, b in zip(run(False), run(True)):
        np.testing.assert_array_equal(a, b)


def test_module_fit_then_checkpoint_prewarm_hits(cache_dir, tmp_path):
    from mxnet_tpu_torch.checkpoint import as_manager
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module

    data = sym.var("data")
    net = sym.FullyConnected(data, num_hidden=4, name="fc1")
    net = sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    x = rng.randn(8, 5).astype(np.float32)
    y = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.float32)
    it = NDArrayIter(x, y, batch_size=4)
    ckpt = str(tmp_path / "ckpt")
    mod = Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            checkpoint=ckpt, resume="never")
    pc = progcache.cache()
    writes = pc.stats["write"]
    assert writes >= 1

    mod2 = Module(net, context=mx.cpu())
    mgr = as_manager(ckpt)
    try:
        hits_before = pc.stats["hit"]
        assert mod2._prewarm_update_programs(
            mgr, "sgd", {"learning_rate": 0.1, "momentum": 0.9}, it)
        assert pc.stats["hit"] == hits_before + 1, \
            "checkpoint-derived prewarm must hit the fit's cached program"
        assert pc.stats["write"] == writes
    finally:
        mgr.close()


def test_prewarm_is_a_no_op_without_a_cache(tmp_path, monkeypatch):
    from mxnet_tpu_torch.module import Module

    monkeypatch.setenv("MXNET_PROGCACHE", "0")
    progcache.reset()
    try:
        net = sym.FullyConnected(sym.var("data"), num_hidden=2, name="fc")
        assert Module(net)._prewarm_update_programs(
            object(), "sgd", {}, None) is False
    finally:
        progcache.reset()


# ---------------------------------------------------------------------------
# replicas: a ProcReplica restart and the cold/warm bench
# ---------------------------------------------------------------------------

def _ready_stats(rep, timeout=120.0):
    cli = None
    addr = rep.start()
    try:
        cli = serve.ServeClient(*addr, timeout=5.0)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if cli.ready():
                    return cli.stats()["engine"]
            except Exception:  # noqa: BLE001 — still booting
                pass
            assert rep.alive(), "the replica died before it was ready"
            time.sleep(0.05)
        raise AssertionError("the replica never became ready")
    finally:
        if cli is not None:
            cli.close()


def test_proc_replica_restart_warms_from_cache(tmp_path):
    """A ``ProcReplica`` child on the CPU SIGKILLed and started again
    against the same cache dir becomes ready with every bucket a hit."""
    net, arg = _mlp()
    prefix = str(tmp_path / "model")
    mx.model.save_checkpoint(prefix, 0, net,
                             {k: nd.array(v) for k, v in arg.items()}, {})
    d = str(tmp_path / "pc")
    rep = serve.ProcReplica(
        prefix, progcache_dir=d,
        args=["--epoch", "0", "--warmup-shape", "4", "--max-batch-size",
              "4"],
        env={"MXNET_SERVE_PLATFORM": "cpu", "MXNET_PROGCACHE": "1",
             "OMP_NUM_THREADS": "1"})
    try:
        cold = _ready_stats(rep)
        rep.kill()
        rep.stop()
        warm = _ready_stats(rep)  # the restart: the same replica object
    finally:
        rep.kill()
        rep.stop()
    assert cold["compiles"] == 3 and cold["cache_hits"] == 0
    assert cold["progcache"]["write"] == 3 and cold["progcache"]["dir"] == d
    assert warm["compiles"] == warm["cache_hits"] == 3
    assert warm["progcache"]["hit"] == 3 and warm["progcache"]["miss"] == 0


def test_run_cold_bench_warm_leg_runs_no_fresh_program(tmp_path):
    from mxnet_tpu_torch.tools import serve_bench

    res = serve_bench.run_cold_bench(model="mlp", max_batch_size=4,
                                     timeout=120.0, device="cpu",
                                     keep_artifact=str(tmp_path))
    assert res["ok"], res
    assert res["fresh_compiles_cold"] == 3  # buckets(4) = [1, 2, 4]
    assert res["fresh_compiles_warm"] == 0
    assert res["cache_hits_warm"] == res["compiles_warm"] == 3
    assert res["progcache_cold"]["write"] == 3
    assert os.path.isdir(os.path.join(str(tmp_path), "progcache"))


def test_reference_engine_unchanged_by_port_entries(tmp_path, monkeypatch):
    """The JAX engine pointed at a dir the port filled serves as before:
    none of the port's entries loads into it, its answers unchanged."""
    monkeypatch.setenv("MXNET_PROGCACHE", "0")
    progcache.reset()
    d = str(tmp_path / "shared")
    try:
        net, arg = _mlp()
        _engine(net, arg, progcache_dir=d).warmup((4,))
        jnet, jarg = _mlp(jsym)
        plain = jserve.InferenceEngine(jnet, jarg, {}, max_batch_size=4,
                                       lint="off")
        shared = jserve.InferenceEngine(jnet, jarg, {}, max_batch_size=4,
                                        lint="off", progcache_dir=d)
        x = np.random.RandomState(8).rand(3, 4).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(plain.predict(x)),
                                      np.asarray(shared.predict(x)))
        assert shared._progcache.stats["hit"] == 0
    finally:
        progcache.reset()
