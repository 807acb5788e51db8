"""The port's ``io`` (``CSVIter``, ``MNISTIter``, ``ImageRecordIter``,
``ResizeIter``, ``PrefetchingIter``), ``io.recordio``, ``native``,
``image`` and ``tools.im2rec`` against the JAX package, on the CPU.

The cases of ``tests/test_io.py``, ``tests/test_native.py``'s decode cases
and ``tests/test_im2rec.py`` run through the port, plus the cross-package
contract, all bitwise (tolerance: none): RecordIO files written by either
package are byte-identical and read by the other; ``ImageRecordIter``
batches (C++ decoder and PIL, f32 and uint8, augmented, prefetched) equal
the reference's, both packages building the same ``.cc`` with the same
flags; ``CSVIter``/``MNISTIter``/``ResizeIter``/``image`` outputs equal;
``im2rec`` lists, ``.rec`` and ``.idx`` files equal the repo tool's.
"""
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import native as jnative
from mxnet_tpu.io import recordio as jrec
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image, native, nd
from mxnet_tpu_torch.io import (CSVIter, DataBatch, ImageRecordIter,
                                MNISTIter, NDArrayIter, PrefetchingIter,
                                ResizeIter)
from mxnet_tpu_torch.io import recordio as trec
from mxnet_tpu_torch.io.recordio import (IRHeader, MXIndexedRecordIO,
                                         MXRecordIO, pack, pack_img, unpack,
                                         unpack_img)
from mxnet_tpu_torch.tools import im2rec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.fixture(scope="module", autouse=True)
def _reference_decoder(tmp_path_factory):
    """Both packages decode with the C++ library whenever the port's builds.

    The reference's ``native.io_lib`` runs ``make`` into the shared
    ``native/build/`` and caches a failure for the life of the process:
    when several test processes build it at once, a process that finds the
    library half-written keeps PIL, and its batches then differ from the
    port's C++ ones. Such a process builds the same sources once more into
    a directory of its own."""
    if native.io_lib() is None or jnative.io_lib() is not None:
        yield
        return
    own = tmp_path_factory.mktemp("reference_native") / "native"
    shutil.copytree(jnative.native_dir(), own,
                    ignore=shutil.ignore_patterns("build"))
    shared = jnative.native_dir
    jnative.native_dir = lambda: str(own)
    try:
        jnative._cache.pop("io", None)
        assert jnative.io_lib() is not None, "reference decoder did not build"
    finally:
        jnative.native_dir = shared
    yield


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def iter_all(it):
    it.reset()
    while True:
        try:
            yield it.next()
        except StopIteration:
            return


def _write_rec(prefix, n=8, size=40, fmt=".jpg", quality=95, indexed=True,
               smooth=False):
    if indexed:
        w = MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    else:
        w = MXRecordIO(prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(n):
        if smooth:
            img = np.clip(np.stack([yy * 6, xx * 6, (yy + xx) * 3 + i * 8],
                                   -1), 0, 255).astype(np.uint8)
        else:
            img = rng.randint(0, 255, (size, size, 3)).astype(np.uint8)
        blob = pack_img(IRHeader(0, float(i % 3), i, 0), img,
                        quality=quality, img_fmt=fmt)
        if indexed:
            w.write_idx(i, blob)
        else:
            w.write(blob)
    w.close()
    return prefix + ".rec"


# ---------------------------------------------------------------------------
# tests/test_io.py, through the port
# ---------------------------------------------------------------------------

def test_ndarray_iter_basic():
    x = np.arange(50, dtype=np.float32).reshape(10, 5)
    y = np.arange(10, dtype=np.float32)
    it = NDArrayIter(x, y, batch_size=3, last_batch_handle="pad")
    batches = list(it)
    assert len(batches) == 4
    assert batches[0].data[0].shape == (3, 5)
    assert batches[-1].pad == 2
    np.testing.assert_allclose(batches[-1].data[0].asnumpy()[1:], x[:2])
    it.reset()
    assert len(list(it)) == 4


def test_ndarray_iter_discard_and_shard():
    x = np.arange(10, dtype=np.float32)
    it = NDArrayIter(x, None, batch_size=3, last_batch_handle="discard")
    assert len(list(it)) == 3
    it0 = NDArrayIter(x, None, batch_size=1, part_index=0, num_parts=2)
    it1 = NDArrayIter(x, None, batch_size=1, part_index=1, num_parts=2)
    d0 = np.concatenate([b.data[0].asnumpy() for b in it0])
    d1 = np.concatenate([b.data[0].asnumpy() for b in it1])
    assert sorted(np.concatenate([d0, d1]).tolist()) == list(range(10))


def test_provide_data_descs():
    it = NDArrayIter(np.zeros((8, 3, 4, 4), np.float32),
                     np.zeros(8, np.float32), batch_size=2)
    assert it.provide_data[0].name == "data"
    assert it.provide_data[0].shape == (2, 3, 4, 4)
    assert it.provide_label[0].name == "softmax_label"


def test_csv_iter(tmp_path):
    f = tmp_path / "d.csv"
    np.savetxt(f, np.arange(12).reshape(4, 3), delimiter=",")
    it = CSVIter(str(f), data_shape=(3,), batch_size=2)
    assert next(iter(it)).data[0].shape == (2, 3)


def test_recordio_roundtrip(tmp_path):
    uri = str(tmp_path / "test.rec")
    w = MXRecordIO(uri, "w")
    payloads = [b"hello", b"x" * 1001, b""]
    for p in payloads:
        w.write(p)
    w.close()
    r = MXRecordIO(uri, "r")
    got = []
    while True:
        b = r.read()
        if b is None:
            break
        got.append(b)
    assert got == payloads


def test_indexed_recordio(tmp_path):
    uri, idx = str(tmp_path / "test.rec"), str(tmp_path / "test.idx")
    w = MXIndexedRecordIO(idx, uri, "w")
    for i in range(5):
        w.write_idx(i, f"rec{i}".encode())
    w.close()
    r = MXIndexedRecordIO(idx, uri, "r")
    assert r.keys == list(range(5))
    assert r.read_idx(3) == b"rec3"
    assert r.read_idx(0) == b"rec0"


def test_pack_unpack_header():
    h2, payload = unpack(pack(IRHeader(0, 3.0, 7, 0), b"payload"))
    assert h2.label == 3.0 and h2.id == 7
    assert payload == b"payload"
    h2, payload = unpack(pack(IRHeader(0, [1.0, 2.0, 3.0], 9, 0), b"xy"))
    np.testing.assert_allclose(h2.label, [1, 2, 3])
    assert payload == b"xy"


def test_pack_img_and_image_record_iter(tmp_path):
    uri = _write_rec(str(tmp_path / "img"))
    it = ImageRecordIter(path_imgrec=uri, data_shape=(3, 32, 32), batch_size=4,
                         rand_crop=True, rand_mirror=True, preprocess_threads=2)
    batches = list(iter_all(it))
    assert len(batches) == 2
    assert batches[0].data[0].shape == (4, 3, 32, 32)
    labels = np.concatenate([b.label[0].asnumpy() for b in batches])
    assert set(labels.astype(int)) <= {0, 1, 2}


def test_resize_and_prefetch_iters():
    x = np.arange(20, dtype=np.float32)
    r = ResizeIter(NDArrayIter(x, None, batch_size=4), 10)
    assert len(list(iter_all(r))) == 10
    p = PrefetchingIter(NDArrayIter(x, None, batch_size=4))
    batches = list(iter_all(p))
    assert len(batches) == 5
    got = np.concatenate([b.data[0].asnumpy() for b in batches])
    np.testing.assert_allclose(np.sort(got), x)
    p.close()


def test_image_record_iter_uint8(tmp_path):
    uri = _write_rec(str(tmp_path / "u8"), indexed=False, smooth=True)
    kw = dict(path_imgrec=uri, data_shape=(3, 32, 32), batch_size=8,
              shuffle=False, rand_crop=False, rand_mirror=False,
              mean_r=123.68, mean_g=116.78, mean_b=103.94,
              std_r=58.4, std_g=57.12, std_b=57.38)
    iu = ImageRecordIter(dtype="uint8", **kw)
    bu = iu.next()
    bf = ImageRecordIter(dtype="float32", **kw).next()
    u8 = bu.data[0].asnumpy()
    assert u8.dtype == np.uint8
    assert iu.provide_data[0].dtype == np.uint8
    normalized = (u8.astype(np.float32) - iu.mean) / iu.std
    assert np.abs(normalized - bf.data[0].asnumpy()).max() < 0.15
    np.testing.assert_array_equal(bu.label[0].asnumpy(), bf.label[0].asnumpy())
    with pytest.raises(ValueError):
        ImageRecordIter(dtype="float16", **kw)


def test_prefetching_iter_order_and_full_epoch():
    n, bs = 64, 8
    data = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    base = NDArrayIter({"data": data}, {"softmax_label": np.zeros(n)},
                       batch_size=bs, shuffle=False,
                       last_batch_handle="discard")
    it = PrefetchingIter(base, prefetch=3)
    seen = []
    for epoch in range(2):
        while True:
            try:
                b = next(it)
            except StopIteration:
                it.reset()
                break
            seen.append(b.data[0].asnumpy()[:, 0])
        assert len(seen) == (epoch + 1) * (n // bs)
    expect = np.tile(np.arange(0, n * 2, 2, dtype=np.float32), 2)
    np.testing.assert_array_equal(np.concatenate(seen), expect)
    it.close()


def _prefetched(path, workers, **kw):
    it = ImageRecordIter(path_imgrec=path, data_shape=(3, 32, 32),
                         batch_size=kw.pop("batch_size", 8), shuffle=False,
                         preprocess_threads=1, dtype="uint8", **kw)
    pf = PrefetchingIter(it, prefetch=3, num_threads=workers)
    out = np.concatenate([b.data[0].asnumpy() for b in pf])
    pf.close()
    return it, out


def test_image_record_iter_prefetch_deterministic_seeds(tmp_path):
    path = _write_rec(str(tmp_path / "d"), n=32, quality=90)
    a = _prefetched(path, 1, rand_crop=False, rand_mirror=False, resize=32)[1]
    b = _prefetched(path, 2, rand_crop=False, rand_mirror=False, resize=32)[1]
    np.testing.assert_array_equal(a, b)


def test_pil_fallback_augmentation_deterministic(tmp_path):
    path = _write_rec(str(tmp_path / "png"), n=16, size=48, fmt=".png",
                      quality=0)
    outs = []
    for workers in (1, 2):
        np.random.seed(1234)
        it, out = _prefetched(path, workers, batch_size=4, rand_crop=True,
                              rand_mirror=True, resize=40)
        assert it._native is None  # PNG records force the PIL path
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# tests/test_native.py's decode cases, through the port
# ---------------------------------------------------------------------------

def test_native_builds_into_the_ports_build_dir():
    lib = native.io_lib()
    assert lib is not None, native.io_lib_error()
    assert native.io_lib_error() is None
    assert os.path.exists(os.path.join(REPO, "build", "mxnet_tpu_torch",
                                       "libmxtpu_io.so"))
    assert os.path.realpath(lib._name).startswith(
        os.path.realpath(os.path.join(REPO, "build", "mxnet_tpu_torch")))


def test_native_scan_offsets(tmp_path):
    import ctypes

    uri = _write_rec(str(tmp_path / "img"), n=5)
    lib = native.io_lib()
    assert lib.mxtpu_scan_offsets(uri.encode(), None, 0) == 5
    offs = (ctypes.c_int64 * 5)()
    assert lib.mxtpu_scan_offsets(uri.encode(), offs, 5) == 5
    assert offs[0] == 0 and all(offs[i] < offs[i + 1] for i in range(4))


def test_native_decode_matches_pil(tmp_path):
    uri = _write_rec(str(tmp_path / "img"))
    common = dict(path_imgrec=uri, data_shape=(3, 32, 32), batch_size=4,
                  shuffle=False, rand_crop=False, rand_mirror=False)
    nat = ImageRecordIter(**common)
    assert nat._native is not None
    ref = ImageRecordIter(no_native=True, **common)
    assert ref._native is None
    b_nat, b_ref = nat.next(), ref.next()
    np.testing.assert_array_equal(b_nat.label[0].asnumpy(),
                                  b_ref.label[0].asnumpy())
    d_nat, d_ref = b_nat.data[0].asnumpy(), b_ref.data[0].asnumpy()
    assert d_nat.shape == d_ref.shape == (4, 3, 32, 32)
    assert np.abs(d_nat - d_ref).max() <= 2.0
    assert np.abs(d_nat - d_ref).mean() < 0.5


def test_native_decode_with_augment_and_norm(tmp_path):
    uri = _write_rec(str(tmp_path / "img"), n=4, size=48)
    it = ImageRecordIter(path_imgrec=uri, data_shape=(3, 32, 32), batch_size=4,
                         rand_crop=True, rand_mirror=True, resize=40,
                         mean_r=123.0, mean_g=116.0, mean_b=103.0,
                         std_r=58.0, std_g=57.0, std_b=57.0)
    d = it.next().data[0].asnumpy()
    assert d.shape == (4, 3, 32, 32)
    assert np.isfinite(d).all()
    assert -5 < d.mean() < 5


def test_native_build_can_be_skipped(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_NO_NATIVE_BUILD", "1")
    monkeypatch.setattr(native, "_cache", {})
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path))
    assert native.io_lib() is None
    assert "MXNET_NO_NATIVE_BUILD" in native.io_lib_error()


# ---------------------------------------------------------------------------
# bitwise parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_recordio_files_byte_identical_both_ways(tmp_path, writer):
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (17, 23, 3)).astype(np.uint8)
    records = [pack(IRHeader(0, 2.0, 1, 0), b"abc"),
               pack(IRHeader(0, [1.0, 2.5, -3.0], 2, 7), b"x" * 13),
               pack_img(IRHeader(0, 4.0, 3, 0), img, quality=80),
               pack_img(IRHeader(0, 1.0, 4, 0), img, img_fmt=".png"),
               b""]
    files = {}
    for name, R in (("torch", trec), ("jax", jrec)):
        prefix = str(tmp_path / name)
        w = R.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
        for i, r in enumerate(records):
            w.write_idx(i, r)
        w.close()
        files[name] = prefix
    for ext in (".rec", ".idx"):
        assert open(files["torch"] + ext, "rb").read() == \
            open(files["jax"] + ext, "rb").read()
    # the other package reads what this one wrote
    other = jrec if writer == "torch" else trec
    r = other.MXIndexedRecordIO(files[writer] + ".idx",
                                files[writer] + ".rec", "r")
    assert [r.read_idx(k) for k in r.keys] == records
    h, got = other.unpack_img(r.read_idx(3))
    _same(got, unpack_img(records[3])[1])
    assert h.id == 4


def test_pack_img_bytes_equal_reference():
    img = np.random.RandomState(6).randint(0, 256, (31, 29, 3)) \
        .astype(np.uint8)
    gray = img[:, :, :1]
    for a in (dict(quality=95), dict(quality=50), dict(img_fmt=".png")):
        h = IRHeader(0, 1.5, 9, 2)
        assert pack_img(h, img, **a) == jrec.pack_img(h, img, **a)
        assert pack_img(h, gray, **a) == jrec.pack_img(h, gray, **a)
    blob = pack_img(IRHeader(0, 0.0, 0, 0), img)
    for flag in (0, 1):
        _same(unpack_img(blob, flag)[1], jrec.unpack_img(blob, flag)[1])


_ITER_CASES = {
    "native-f32": dict(),
    "native-u8": dict(dtype="uint8"),
    "native-aug-u8": dict(dtype="uint8", rand_crop=True, rand_mirror=True,
                          resize=36),
    "native-aug-norm": dict(rand_crop=True, rand_mirror=True, resize=40,
                            mean_r=123.0, mean_g=116.0, mean_b=103.0,
                            std_r=58.0, std_g=57.0, std_b=57.0),
    "pil-f32": dict(no_native=True),
    "pil-u8": dict(no_native=True, dtype="uint8"),
    "pil-aug": dict(no_native=True, rand_crop=True, rand_mirror=True,
                    resize=44, preprocess_threads=3),
    "pil-norm": dict(no_native=True, mean_r=10.0, std_b=3.0),
    "shuffle-shard": dict(shuffle=True, part_index=1, num_parts=2),
    "noidx": dict(path_imgidx="/nonexistent.idx"),
}


@pytest.mark.parametrize("case", sorted(_ITER_CASES))
@pytest.mark.parametrize("prefetch", [False, True], ids=["serial",
                                                         "prefetch"])
def test_image_record_iter_matches_reference(tmp_path, case, prefetch):
    uri = _write_rec(str(tmp_path / "r"), n=12, size=40)
    kw = {"path_imgrec": uri, "data_shape": (3, 32, 32), "batch_size": 4,
          "preprocess_threads": 2, **_ITER_CASES[case]}
    out = {}
    for name, Iter, Pf in (("torch", ImageRecordIter, PrefetchingIter),
                           ("jax", jmx.io.ImageRecordIter,
                            jmx.io.PrefetchingIter)):
        np.random.seed(21)
        it = Iter(**kw)
        assert (it._native is None) == ("pil" in case), name
        src = Pf(it, prefetch=3) if prefetch else it
        out[name] = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                     for b in iter_all(src)]
        if prefetch:
            src.close()
    assert len(out["torch"]) == len(out["jax"]) > 0
    for (gd, gl), (wd, wl) in zip(out["torch"], out["jax"]):
        _same(gd, wd)
        _same(gl, wl)


def test_image_record_iter_png_drops_to_pil_like_reference(tmp_path):
    uri = _write_rec(str(tmp_path / "p"), n=8, fmt=".png")
    out = {}
    for name, Iter in (("torch", ImageRecordIter),
                       ("jax", jmx.io.ImageRecordIter)):
        np.random.seed(2)
        it = Iter(path_imgrec=uri, data_shape=(3, 32, 32), batch_size=4,
                  rand_crop=True)
        out[name] = [b.data[0].asnumpy() for b in iter_all(it)]
        assert it._native is None
    for g, w in zip(out["torch"], out["jax"]):
        _same(g, w)


def test_grayscale_record_iter_matches_reference(tmp_path):
    uri = _write_rec(str(tmp_path / "g"), n=4)
    kw = dict(path_imgrec=uri, data_shape=(1, 32, 32), batch_size=2)
    it = ImageRecordIter(**kw)
    assert it._native is None  # the C++ path decodes RGB only
    # the PIL path decodes RGB whatever data_shape[0] says, in both
    _same(it.next().data[0], jmx.io.ImageRecordIter(**kw).next().data[0])


def test_set_partition_matches_reference(tmp_path):
    uri = _write_rec(str(tmp_path / "s"), n=11)
    out = {}
    for name, Iter in (("torch", ImageRecordIter),
                       ("jax", jmx.io.ImageRecordIter)):
        it = Iter(path_imgrec=uri, data_shape=(3, 32, 32), batch_size=2)
        it.set_partition(1, 3)
        out[name] = [b.label[0].asnumpy() for b in iter_all(it)]
    assert len(out["torch"]) == 1
    for g, w in zip(out["torch"], out["jax"]):
        _same(g, w)


def test_csv_iter_matches_reference(tmp_path):
    rng = np.random.RandomState(0)
    f, lf = tmp_path / "d.csv", tmp_path / "l.csv"
    np.savetxt(f, rng.rand(7, 6), delimiter=",")
    np.savetxt(lf, rng.randint(0, 3, (7, 1)), delimiter=",")
    for kw in (dict(), dict(label_csv=str(lf)), dict(round_batch=False),
               dict(part_index=1, num_parts=2)):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in
               CSVIter(str(f), data_shape=(2, 3), batch_size=3, **kw)]
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in
                jmx.io.CSVIter(str(f), data_shape=(2, 3), batch_size=3, **kw)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g[0], w[0])
            _same(g[1], w[1])
            assert g[2] == w[2]


@pytest.mark.parametrize("flat", [False, True], ids=["image", "flat"])
def test_mnist_iter_matches_reference(tmp_path, flat):
    from test_torch_data import _write_idx

    rng = np.random.RandomState(1)
    img, lbl = str(tmp_path / "i"), str(tmp_path / "l")
    _write_idx(img, rng.randint(0, 256, (10, 28, 28)).astype(np.uint8))
    _write_idx(lbl, rng.randint(0, 10, 10).astype(np.uint8))
    out = {}
    for name, Iter in (("torch", MNISTIter), ("jax", jmx.io.MNISTIter)):
        np.random.seed(4)
        it = Iter(image=img, label=lbl, batch_size=3, flat=flat)
        out[name] = [(b.data[0].asnumpy(), b.label[0].asnumpy())
                     for _ in range(2) for b in iter_all(it)]
    assert len(out["torch"]) == 6
    for g, w in zip(out["torch"], out["jax"]):
        _same(g[0], w[0])
        _same(g[1], w[1])


def test_resize_iter_matches_reference():
    x = np.arange(20, dtype=np.float32).reshape(10, 2)
    out = {}
    for name, S in (("torch", mx), ("jax", jmx)):
        r = S.io.ResizeIter(S.io.NDArrayIter(x, None, batch_size=3,
                                             last_batch_handle="discard"), 7)
        out[name] = [b.data[0].asnumpy() for b in iter_all(r)]
        assert r.provide_data[0].shape == (3, 2)
    assert len(out["torch"]) == 7
    for g, w in zip(out["torch"], out["jax"]):
        _same(g, w)


def test_prefetching_iter_raises_a_failed_load(tmp_path):
    """A failed load is not swallowed: it raises from next()."""

    class Broken(NDArrayIter):
        def next(self):
            raise OSError("disk gone")

    it = PrefetchingIter(Broken(np.zeros(4, np.float32), None, batch_size=2))
    with pytest.raises(OSError, match="disk gone"):
        it.next()
    it.close()


def test_prefetching_iter_targets_the_creators_context():
    """Workers make the batches under the context scope that was current
    when the iterator was made (a thread does not inherit another's)."""
    x = np.arange(8, dtype=np.float32)
    with mx.Context("cpu", 3):
        it = PrefetchingIter(NDArrayIter(x, None, batch_size=4))
    b = it.next()
    assert b.data[0].context == mx.Context("cpu", 3)
    it.close()


# ---------------------------------------------------------------------------
# mx.image
# ---------------------------------------------------------------------------

def _img():
    return np.random.RandomState(8).randint(0, 256, (21, 30, 3)) \
        .astype(np.uint8)


_IMAGE_FNS = {
    "imresize": lambda M, a: M.image.imresize(M.nd.array(a), 13, 9),
    "imresize_nearest": lambda M, a: M.image.imresize(M.nd.array(a), 40, 7,
                                                      interp=0),
    "resize_short": lambda M, a: M.image.resize_short(M.nd.array(a), 12),
    "fixed_crop": lambda M, a: M.image.fixed_crop(M.nd.array(a), 2, 3, 10, 8,
                                                  size=(6, 6)),
    "center_crop": lambda M, a: M.image.center_crop(M.nd.array(a), (8, 8))[0],
    "random_crop": lambda M, a: M.image.random_crop(M.nd.array(a),
                                                    (9, 7))[0],
    "color_normalize": lambda M, a: M.image.color_normalize(
        M.nd.array(a.astype(np.float32)), M.nd.array(np.array(
            [1.0, 2.0, 3.0], np.float32)), M.nd.array(np.array(
                [2.0, 4.0, 8.0], np.float32))),
    "augmenters": lambda M, a: _run_augs(M, a),
}


def _run_augs(M, a):
    augs = M.image.CreateAugmenter((3, 10, 10), resize=14, rand_crop=True,
                                   rand_mirror=True, mean=True, std=True)
    out = M.nd.array(a)
    for aug in augs:
        out = aug(out)
    return out


@pytest.mark.parametrize("fn", sorted(_IMAGE_FNS))
def test_image_functions_match_reference(fn):
    got = {}
    for name, M in (("torch", mx), ("jax", jmx)):
        np.random.seed(9)
        got[name] = [_IMAGE_FNS[fn](M, _img()) for _ in range(3)]
    for g, w in zip(got["torch"], got["jax"]):
        _same(g, w)


def test_imread_imdecode_match_reference(tmp_path):
    path = str(tmp_path / "a.png")
    Image.fromarray(_img()).save(path)
    buf = open(path, "rb").read()
    for flag in (0, 1):
        _same(image.imread(path, flag), jimage.imread(path, flag))
        _same(image.imdecode(buf, flag), jimage.imdecode(buf, flag))
    _same(image.imdecode(nd.array(np.frombuffer(buf, np.uint8))),
          jimage.imdecode(buf))


def test_image_iter_matches_reference(tmp_path):
    uri = _write_rec(str(tmp_path / "ii"), n=8)
    out = {}
    for name, M in (("torch", mx), ("jax", jmx)):
        np.random.seed(3)
        it = M.image.ImageIter(batch_size=4, data_shape=(3, 32, 32),
                               path_imgrec=uri, shuffle=True, rand_crop=True)
        assert it.provide_data[0].shape == (4, 3, 32, 32)
        assert (it._inner._native is None) == (native.io_lib() is None)
        out[name] = [b.data[0].asnumpy() for b in it]
        it.reset()
        out[name] += [next(it).data[0].asnumpy()]
    assert len(out["torch"]) == 3
    for g, w in zip(out["torch"], out["jax"]):
        _same(g, w)
    with pytest.raises(ValueError):
        image.ImageIter(batch_size=2, data_shape=(3, 8, 8))


# ---------------------------------------------------------------------------
# tests/test_im2rec.py through the port's tool, and byte parity with the
# repo tool
# ---------------------------------------------------------------------------

def _make_tree(root, classes=3, per_class=8, size=64):
    rng = np.random.RandomState(0)
    for c in range(classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rng.randint(0, 255, (size, size, 3), np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"img{i}.jpg"),
                                      quality=90)


def test_im2rec_end_to_end(tmp_path):
    root = str(tmp_path / "images")
    os.makedirs(root)
    _make_tree(root)
    prefix = str(tmp_path / "data")
    assert im2rec.main([prefix, root, "--list", "--recursive"]) == 0
    lines = open(prefix + ".lst").read().strip().splitlines()
    assert len(lines) == 24
    assert im2rec.main([prefix, root, "--quality", "90"]) == 0
    rec = MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    assert len(rec.keys) == 24
    header, img = unpack_img(rec.read_idx(rec.keys[0]))
    assert img.shape == (64, 64, 3)
    assert float(header.label) in (0.0, 1.0, 2.0)
    it = ImageRecordIter(path_imgrec=prefix + ".rec", data_shape=(3, 32, 32),
                         batch_size=8, resize=48, preprocess_threads=2)
    batch = next(iter(it))
    assert batch.data[0].shape == (8, 3, 32, 32)
    assert batch.label[0].asnumpy().shape == (8,)


def test_im2rec_multilabel_and_passthrough(tmp_path):
    root = str(tmp_path / "images")
    os.makedirs(root)
    _make_tree(root, classes=1, per_class=2)
    prefix = str(tmp_path / "ml")
    with open(prefix + ".lst", "w") as f:
        f.write("0\t1.0\t2.0\t3.0\tclass0/img0.jpg\n")
        f.write("1\t4.0\t5.0\t6.0\tclass0/img1.jpg\n")
    assert im2rec.main([prefix, root, "--pass-through"]) == 0
    rec = MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    header, payload = unpack(rec.read_idx(0))
    np.testing.assert_allclose(np.asarray(header.label), [1.0, 2.0, 3.0])
    assert payload[:2] == b"\xff\xd8"


def test_native_decode_throughput(tmp_path):
    """The training-shape decode rate (224 x 224 from 256 px sources, the
    bench configuration) through the C++ uint8 path, with the reference
    test's floor."""
    root = str(tmp_path / "images")
    os.makedirs(root)
    _make_tree(root, classes=2, per_class=48, size=256)
    prefix = str(tmp_path / "tp")
    assert im2rec.main([prefix, root, "--list", "--recursive"]) == 0
    assert im2rec.main([prefix, root]) == 0
    it = ImageRecordIter(path_imgrec=prefix + ".rec", data_shape=(3, 224, 224),
                         batch_size=32, resize=256, rand_crop=True,
                         rand_mirror=True, preprocess_threads=2, dtype="uint8")
    assert it._native is not None, "native decoder must engage for u8 path"
    next(it)  # warm (the first batch pays file open etc.)
    n = 0
    t0 = time.perf_counter()
    for batch in iter(it.next, None):
        n += batch.data[0].shape[0]
        if n >= 64:
            break
    rate = n / (time.perf_counter() - t0)
    assert n >= 32
    assert rate > 250, f"native u8 decode too slow: {rate:.0f} img/s"


_IM2REC_RUNS = {
    "recursive": (["--list", "--recursive"], []),
    "recursive-noshuffle": (["--list", "--recursive", "--no-shuffle"],
                            ["--quality", "80"]),
    "split": (["--list", "--recursive", "--train-ratio", "0.5"], []),
    "resize-crop": (["--list", "--recursive"],
                    ["--resize", "40", "--center-crop", "--num-thread", "3"]),
    "png": (["--list", "--recursive"], ["--encoding", ".png"]),
    "passthrough": (["--list", "--recursive"], ["--pass-through"]),
}


@pytest.mark.parametrize("case", sorted(_IM2REC_RUNS))
def test_im2rec_bytes_equal_repo_tool(tmp_path, case):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import im2rec as ref_tool
    finally:
        sys.path.pop(0)
    root = str(tmp_path / "images")
    os.makedirs(root)
    _make_tree(root, classes=2, per_class=5, size=48)
    list_args, rec_args = _IM2REC_RUNS[case]
    outs = {}
    for name, tool in (("torch", im2rec), ("jax", ref_tool)):
        prefix = str(tmp_path / name)
        assert tool.main([prefix, root] + list_args) == 0
        lsts = sorted(p for p in os.listdir(tmp_path)
                      if p.startswith(name) and p.endswith(".lst"))
        for lst in lsts:
            assert tool.main([str(tmp_path / lst[:-4]), root] + rec_args) == 0
        outs[name] = {p[len(name):]: open(tmp_path / p, "rb").read()
                      for p in os.listdir(tmp_path) if p.startswith(name)}
    assert sorted(outs["torch"]) == sorted(outs["jax"])
    assert any(k.endswith(".rec") for k in outs["torch"])
    for k, v in outs["jax"].items():
        assert outs["torch"][k] == v, k


def test_batches_land_on_the_current_context(tmp_path):
    uri = _write_rec(str(tmp_path / "c"), n=4)
    with mx.Context("cpu", 5):
        b = ImageRecordIter(path_imgrec=uri, data_shape=(3, 32, 32),
                            batch_size=2).next()
    assert isinstance(b, DataBatch)
    assert b.data[0].context == mx.Context("cpu", 5)
    assert b.label[0].context == mx.Context("cpu", 5)


def test_prefetch_stress_many_workers_bitwise_equal_serial(tmp_path):
    """More prefetch workers than cores, with a short switch interval:
    offsets and seeds reserved under the iterator's lock keep every batch
    equal to a serial read (a lost update would shift or repeat one)."""
    uri = _write_rec(str(tmp_path / "s"), n=48, size=36, fmt=".png")
    kw = dict(path_imgrec=uri, data_shape=(3, 32, 32), batch_size=3,
              rand_crop=True, rand_mirror=True, preprocess_threads=2,
              dtype="uint8")
    np.random.seed(11)
    serial = [b.data[0].asnumpy() for b in iter_all(ImageRecordIter(**kw))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        np.random.seed(11)
        it = PrefetchingIter(ImageRecordIter(**kw), prefetch=24,
                             num_threads=16)
        t0 = time.monotonic()
        got = [b.data[0].asnumpy() for b in it]
        it.close()
    finally:
        sys.setswitchinterval(old)
    assert time.monotonic() - t0 < 120
    assert len(got) == len(serial) == 16
    for g, s in zip(got, serial):
        np.testing.assert_array_equal(g, s)
