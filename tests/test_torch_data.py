"""The port's ``gluon.data`` (samplers, datasets, ``DataLoader``) and
``gluon.data.vision`` (transforms, datasets) against the JAX package, on
the CPU.

The cases of ``tests/test_gluon_data.py`` run through the port, plus the
cross-package contract: under the same ``np.random.seed`` every sampler
order, sample, transform output and ``DataLoader`` batch is bitwise the
reference's (tolerance: none). The port makes samples on the host (CPU
NDArrays, where the reference's sit on the default context) and moves
each batch to the current context in one copy.
"""
import gzip
import pickle
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data import vision as jvision
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import data as gdata
from mxnet_tpu_torch.gluon.data import vision
from mxnet_tpu_torch.gluon.data.vision import SyntheticImageDataset, transforms

torch.set_num_threads(1)

PAIRS = {"jax": (jmx, jdata, jvision), "torch": (mx, gdata, vision)}


@pytest.fixture(autouse=True)
def _on_cpu():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with mx.cpu():
        yield


def _np(x):
    if isinstance(x, (tuple, list)):
        return tuple(_np(v) for v in x)
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return np.asarray(x)


def _assert_same(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _both(make, seed=0):
    """``make(pkg_mx, data_mod, vision_mod)`` run for each package after
    the same ``np.random.seed``: {name: result}."""
    out = {}
    for name, mods in PAIRS.items():
        jblock._SCOPE.counters = {}
        tblock._SCOPE.counters = {}
        np.random.seed(seed)
        out[name] = make(*mods)
    return out


# ---------------------------------------------------------------------------
# tests/test_gluon_data.py, through the port
# ---------------------------------------------------------------------------

def test_array_dataset_and_loader():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10, dtype=np.int32)
    ds = gdata.ArrayDataset(x, y)
    assert len(ds) == 10
    loader = gdata.DataLoader(ds, batch_size=3, last_batch="keep")
    batches = list(loader)
    assert len(batches) == 4
    assert batches[0][0].shape == (3, 4)
    assert batches[-1][0].shape == (1, 4)
    np.testing.assert_allclose(batches[0][0].asnumpy(), x[:3])


def test_loader_discard_rollover():
    ds = gdata.ArrayDataset(np.arange(10, dtype=np.float32))
    assert len(list(gdata.DataLoader(ds, batch_size=3, last_batch="discard"))) == 3
    loader = gdata.DataLoader(ds, batch_size=3, last_batch="rollover")
    assert len(list(loader)) == 3
    assert len(list(loader)) == 3


def test_loader_shuffle_covers_all():
    ds = gdata.ArrayDataset(np.arange(20, dtype=np.float32))
    seen = np.concatenate([b.asnumpy() for b in
                           gdata.DataLoader(ds, batch_size=4, shuffle=True)])
    assert sorted(seen.tolist()) == list(range(20))


def test_loader_threaded_workers():
    ds = SyntheticImageDataset(length=17, shape=(1, 8, 8), num_classes=4)
    loader = gdata.DataLoader(ds, batch_size=4, num_workers=2)
    batches = list(loader)
    assert sum(b[0].shape[0] for b in batches) == 17
    np.testing.assert_array_equal(ds[3][0].asnumpy(), ds[3][0].asnumpy())


def test_dataset_shard_and_take():
    ds = gdata.ArrayDataset(np.arange(10, dtype=np.float32))
    shards = [ds.shard(3, i) for i in range(3)]
    assert [len(s) for s in shards] == [4, 3, 3]
    all_vals = sorted(float(s[i]) for s in shards for i in range(len(s)))
    assert all_vals == list(range(10))
    assert len(ds.take(4)) == 4


def test_transform_first_and_sampler():
    x = np.ones((6, 2, 2, 1), np.uint8) * 255
    y = np.arange(6, dtype=np.int32)
    ds = gdata.ArrayDataset(x, y).transform_first(transforms.ToTensor())
    img, label = ds[2]
    assert img.shape == (1, 2, 2)
    np.testing.assert_allclose(img.asnumpy(), 1.0)
    assert label == 2


def test_transforms_pipeline():
    t = transforms.Compose([
        transforms.Resize(16),
        transforms.CenterCrop(12),
        transforms.RandomFlipLeftRight(),
        transforms.ToTensor(),
        transforms.Normalize(mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25)),
    ])
    img = nd.array(np.random.randint(0, 255, (20, 24, 3)).astype(np.uint8))
    out = t(img)
    assert out.shape == (3, 12, 12)
    assert out.dtype == np.float32


def test_random_resized_crop_and_jitter():
    img = nd.array(np.random.randint(0, 255, (32, 32, 3)).astype(np.uint8))
    assert transforms.RandomResizedCrop(16)(img).shape == (16, 16, 3)
    assert transforms.RandomColorJitter(0.4, 0.4, 0.4)(img).shape == \
        (32, 32, 3)


def test_batch_sampler_api():
    s = gdata.BatchSampler(gdata.SequentialSampler(7), 2, "discard")
    assert len(s) == 3
    assert list(s) == [[0, 1], [2, 3], [4, 5]]


def test_filter_dataset():
    ds = gdata.ArrayDataset(np.arange(10, dtype=np.float32))
    even = ds.filter(lambda x: int(x) % 2 == 0)
    assert len(even) == 5


# ---------------------------------------------------------------------------
# bitwise parity with the reference under the same seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
@pytest.mark.parametrize("shuffle", [False, True], ids=["seq", "shuffled"])
def test_samplers_match_reference(last, shuffle):
    def run(_mx, D, _v):
        base = D.RandomSampler(11) if shuffle else D.SequentialSampler(11, 2)
        bs = D.BatchSampler(base, 3, last)
        return [list(bs), len(bs), list(bs), len(bs)]

    got = _both(run, seed=5)
    assert got["torch"] == got["jax"]


def test_filter_sampler_and_dataset_views_match_reference():
    x = np.arange(12, dtype=np.float32)

    def run(_mx, D, _v):
        ds = D.ArrayDataset(x, x * 2)
        even = ds.filter(lambda a, b: int(a) % 2 == 0)
        shard = ds.shard(5, 3)
        take = ds.take(4)
        lazy = ds.transform(lambda a, b: (a + 1, b))
        eager = ds.transform(lambda a, b: (a - 1, b), lazy=False)
        return ([even[i] for i in range(len(even))],
                [shard[i] for i in range(len(shard))],
                [take[i] for i in range(len(take))],
                [lazy[i] for i in range(len(lazy))],
                [eager[i] for i in range(len(eager))])

    got = _both(run)
    for g, w in zip(got["torch"], got["jax"]):
        assert [tuple(map(float, t)) for t in g] == \
            [tuple(map(float, t)) for t in w]


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_loader_batches_match_reference(workers, last):
    rng = np.random.RandomState(1)
    x = rng.randn(23, 3, 2).astype(np.float32)
    y = rng.randint(0, 5, 23).astype(np.int32)

    def run(_mx, D, _v):
        loader = D.DataLoader(D.ArrayDataset(x, y), batch_size=4,
                              shuffle=True, last_batch=last,
                              num_workers=workers)
        return [b for _ in range(2) for b in loader]

    got = _both(run, seed=7)
    assert len(got["torch"]) == len(got["jax"])
    for g, w in zip(got["torch"], got["jax"]):
        _assert_same(g, w)


@pytest.mark.parametrize("kind", ["pyfloat", "pyint", "f64", "i64", "u8"])
def test_default_batchify_dtypes_match_reference(kind):
    vals = {"pyfloat": [1.5, 2.5], "pyint": [3, 4],
            "f64": list(np.arange(4.0).reshape(2, 2)),
            "i64": list(np.arange(4).reshape(2, 2)),
            "u8": list(np.arange(4, dtype=np.uint8).reshape(2, 2))}[kind]
    want = jdata.dataloader.default_batchify_fn(vals)
    got = gdata.dataloader.default_batchify_fn(vals)
    _assert_same(got, want)
    assert got.context == mx.cpu()


def test_synthetic_normalized_loader_matches_reference():
    """The data_path leg of the smoke at a small size: SyntheticImageDataset
    + transform_first(Normalize) + 2 workers, pin_memory on, discard."""

    def run(_mx, D, V):
        ds = V.SyntheticImageDataset(length=13, shape=(3, 8, 8),
                                     num_classes=10)
        ds = ds.transform_first(V.transforms.Normalize(
            mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)))
        return list(D.DataLoader(ds, batch_size=4, num_workers=2,
                                 pin_memory=True, last_batch="discard"))

    got = _both(run)
    assert len(got["torch"]) == 3
    for g, w in zip(got["torch"], got["jax"]):
        _assert_same(g, w)
        assert g[0].context == mx.cpu()


def test_loader_workers_bitwise_equal_serial():
    ds = SyntheticImageDataset(length=10, shape=(3, 6, 6), num_classes=7)
    serial = list(gdata.DataLoader(ds, batch_size=3, num_workers=0))
    threaded = list(gdata.DataLoader(ds, batch_size=3, num_workers=4,
                                     prefetch=2))
    for a, b in zip(serial, threaded):
        _assert_same(a, b)


def test_samples_are_made_on_the_host():
    """A known difference from the reference: samples and transform
    outputs are CPU NDArrays; the batch lands on the current context."""
    with mx.Context("cpu", 1):
        ds = SyntheticImageDataset(length=4, shape=(3, 4, 4))
        img, _ = ds[0]
        assert img.context == mx.cpu()
        out = transforms.ToTensor()(nd.array(np.zeros((2, 2, 3), np.uint8)))
        assert out.context == mx.cpu()
        batch = next(iter(gdata.DataLoader(ds, batch_size=2)))
        assert batch[0].context == mx.Context("cpu", 1)


def test_custom_batchify_runs_under_consumer_context():
    seen = []

    def batchify(samples):
        seen.append(mx.current_context())
        return nd.array(np.stack(samples))

    ds = gdata.ArrayDataset(np.arange(8, dtype=np.float32))
    with mx.Context("cpu", 2):
        out = list(gdata.DataLoader(ds, batch_size=4, num_workers=2,
                                    batchify_fn=batchify))
    assert seen == [mx.Context("cpu", 2)] * 2
    np.testing.assert_array_equal(out[1].asnumpy(), [4, 5, 6, 7])


def test_loader_argument_errors():
    ds = gdata.ArrayDataset(np.arange(4, dtype=np.float32))
    with pytest.raises(ValueError):
        gdata.DataLoader(ds)
    with pytest.raises(ValueError):
        gdata.DataLoader(ds, batch_size=2, shuffle=True,
                         sampler=gdata.SequentialSampler(4))
    with pytest.raises(ValueError):
        gdata.DataLoader(ds, batch_size=2, batch_sampler=gdata.BatchSampler(
            gdata.SequentialSampler(4), 2))
    bad = gdata.BatchSampler(gdata.SequentialSampler(3), 2, "nope")
    with pytest.raises(ValueError):
        list(bad)


_TRANSFORMS = {
    "to_tensor": lambda T: T.ToTensor(),
    "normalize": lambda T: T.Compose([T.ToTensor(), T.Normalize(
        (0.4, 0.5, 0.6), (0.2, 0.3, 0.25))]),
    "cast": lambda T: T.Cast("float16"),
    "resize": lambda T: T.Resize(13),
    "resize_tuple": lambda T: T.Resize((9, 15), interpolation="bicubic"),
    "resize_keep": lambda T: T.Resize(11, keep_ratio=True),
    "center_crop": lambda T: T.CenterCrop(10),
    "center_crop_up": lambda T: T.CenterCrop((30, 12)),
    "random_crop": lambda T: T.RandomCrop(9),
    "random_crop_pad": lambda T: T.RandomCrop((8, 6), pad=2),
    "random_resized_crop": lambda T: T.RandomResizedCrop(12),
    "flip_lr": lambda T: T.RandomFlipLeftRight(),
    "flip_tb": lambda T: T.RandomFlipTopBottom(),
    "brightness": lambda T: T.RandomBrightness(0.4),
    "contrast": lambda T: T.RandomContrast(0.4),
    "saturation": lambda T: T.RandomSaturation(0.4),
    "lighting": lambda T: T.RandomLighting(0.1),
    "jitter": lambda T: T.RandomColorJitter(0.3, 0.3, 0.3),
    "pipeline": lambda T: T.Compose([T.Resize(16), T.CenterCrop(12),
                                     T.RandomFlipLeftRight(), T.ToTensor(),
                                     T.Normalize((0.5,) * 3, (0.25,) * 3)]),
}


@pytest.mark.parametrize("name", sorted(_TRANSFORMS))
def test_transform_matches_reference(name):
    img = np.random.RandomState(3).randint(0, 256, (20, 24, 3)) \
        .astype(np.uint8)

    def run(M, _D, V):
        t = _TRANSFORMS[name](V.transforms)
        return [t(M.nd.array(img)) for _ in range(4)]

    got = _both(run, seed=11)
    for g, w in zip(got["torch"], got["jax"]):
        _assert_same(g, w)


# ---------------------------------------------------------------------------
# vision datasets from files the test writes
# ---------------------------------------------------------------------------

def _write_idx(path, arr, gz=False):
    code = {np.dtype(np.uint8): 8, np.dtype(np.int32): 12}[arr.dtype]
    head = struct.pack(">HBB", 0, code, arr.ndim) + \
        struct.pack(">" + "I" * arr.ndim, *arr.shape)
    body = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(head + body)


@pytest.mark.parametrize("cls,gz", [("MNIST", False), ("MNIST", True),
                                    ("FashionMNIST", False)])
def test_mnist_datasets_match_reference(tmp_path, cls, gz):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (6, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 6).astype(np.uint8)
    sfx = ".gz" if gz else ""
    for train, stem in ((True, "train"), (False, "t10k")):
        _write_idx(str(tmp_path / f"{stem}-images-idx3-ubyte{sfx}"), imgs, gz)
        _write_idx(str(tmp_path / f"{stem}-labels-idx1-ubyte{sfx}"), labels,
                   gz)

    def run(_M, D, V):
        ds = getattr(V, cls)(root=str(tmp_path), train=False,
                             transform=lambda x, y: (x.astype("float32") / 2,
                                                     y))
        plain = getattr(V, cls)(root=str(tmp_path))
        return [ds[i] for i in range(len(ds))] + [plain[5]]

    got = _both(run)
    assert len(got["torch"]) == 7
    for g, w in zip(got["torch"], got["jax"]):
        _assert_same(g[0], w[0])
        assert g[1] == w[1]
    with pytest.raises(FileNotFoundError, match="no network"):
        vision.MNIST(root=str(tmp_path / "missing"))


@pytest.mark.parametrize("cls", ["CIFAR10", "CIFAR100"])
def test_cifar_datasets_match_reference(tmp_path, cls):
    rng = np.random.RandomState(1)
    names = ([f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
             if cls == "CIFAR10" else ["train", "test"])
    key = "labels" if cls == "CIFAR10" else "fine_labels"
    sub = tmp_path / "cifar-10-batches-py"
    sub.mkdir()
    for n in names:
        batch = {"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8),
                 key: list(rng.randint(0, 10, 3))}
        with open(sub / n, "wb") as f:
            pickle.dump(batch, f)

    def run(_M, D, V):
        ds = getattr(V, cls)(root=str(tmp_path))
        return [ds[i] for i in range(len(ds))]

    got = _both(run)
    assert len(got["torch"]) == (15 if cls == "CIFAR10" else 3)
    for g, w in zip(got["torch"], got["jax"]):
        _assert_same(g[0], w[0])
        assert g[1] == w[1]


def test_image_folder_dataset_matches_reference(tmp_path):
    rng = np.random.RandomState(2)
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for i in range(2):
            Image.fromarray(rng.randint(0, 256, (9, 7, 3)).astype(np.uint8)) \
                .save(tmp_path / c / f"{i}.png")
    (tmp_path / "stray.txt").write_text("not a class")

    def run(_M, _D, V):
        with pytest.warns(UserWarning):
            ds = V.ImageFolderDataset(str(tmp_path))
        gray = V.ImageFolderDataset(str(tmp_path), flag=0,
                                    transform=lambda x, y: (x, y + 10))
        return ds.synsets, [ds[i] for i in range(len(ds))], gray[3]

    got = _both(run)
    assert got["torch"][0] == got["jax"][0] == ["cat", "dog"]
    for g, w in zip(got["torch"][1] + [got["torch"][2]],
                    got["jax"][1] + [got["jax"][2]]):
        _assert_same(g[0], w[0])
        assert g[1] == w[1]


def test_record_datasets_match_reference(tmp_path):
    from mxnet_tpu_torch.io.recordio import (IRHeader, MXIndexedRecordIO,
                                             pack_img)

    prefix = str(tmp_path / "d")
    rec = MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(3)
    for i in range(5):
        img = rng.randint(0, 256, (10, 12, 3)).astype(np.uint8)
        rec.write_idx(i, pack_img(IRHeader(0, float(i % 2), i, 0), img))
    rec.close()

    def run(_M, D, V):
        ds = V.ImageRecordDataset(prefix + ".rec",
                                  transform=lambda x, y: (x, y * 3))
        raw = D.RecordFileDataset(prefix + ".rec")
        return [ds[i] for i in range(len(ds))], [raw[i] for i in
                                                 range(len(raw))]

    got = _both(run)
    for g, w in zip(got["torch"][0], got["jax"][0]):
        _assert_same(g[0], w[0])
        assert g[1] == w[1]
    assert got["torch"][1] == got["jax"][1]


def test_loader_stress_many_workers_bitwise_equal_serial():
    """More workers than cores with a short switch interval: batches come
    back in order and equal to the serial loader's."""
    import sys
    import time

    ds = SyntheticImageDataset(length=61, shape=(3, 5, 5), num_classes=9)
    ds = ds.transform_first(transforms.Normalize(0.5, 0.25))
    serial = list(gdata.DataLoader(ds, batch_size=4))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        threaded = list(gdata.DataLoader(ds, batch_size=4, num_workers=16,
                                         prefetch=32))
    finally:
        sys.setswitchinterval(old)
    assert time.monotonic() - t0 < 120
    assert len(threaded) == len(serial) == 16
    for a, b in zip(serial, threaded):
        _assert_same(a, b)
