"""The port's ``.params`` container (``mxnet_tpu_torch/ndarray/
serialization.py``, ``nd.save``/``nd.load``) and Gluon persistence
against the JAX package, on the CPU.

The cases of ``tests/test_serialization.py`` and
``tests/test_ndarray.py::test_save_load``, each run through the port, plus
the cross-package contract: a file written by either package holds the
same bytes as the other's for the same values (f32, f16, bf16, int,
zero-dim, lists and dicts), loads in the other, and truncated or
bit-flipped files raise ``ValueError``. Gluon's ``save_parameters``/
``load_parameters`` and ``ParameterDict.save``/``load`` are held the same
way, with the reference's own blocks.
"""
import os
import struct
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu.gluon.block as jblock
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray import serialization as jser
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ndarray import serialization as ser

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with tmx.cpu():
        yield


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# tests/test_serialization.py, through the port
# ---------------------------------------------------------------------------

def test_golden_bytes(tmp_path):
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    path = str(tmp_path / "g.params")
    expect = b"".join([
        struct.pack("<QQ", 0x112, 0),          # list magic, reserved
        struct.pack("<Q", 1),                  # n arrays
        struct.pack("<Ii", 0xF993FAC9, 0),     # V2 magic, stype dense
        struct.pack("<I", 2),                  # ndim
        struct.pack("<qq", 2, 3),              # shape (int64)
        struct.pack("<ii", 1, 0),              # dev_type cpu, dev_id
        struct.pack("<i", 0),                  # type flag float32
        arr.tobytes(),
        struct.pack("<Q", 1),                  # n names
        struct.pack("<Q", 1), b"w",
    ])
    ser.save_nd(path, [arr], ["w"], crc=False)
    assert _bytes(path) == expect
    ser.save_nd(path, [arr], ["w"])
    got = _bytes(path)
    assert got[:len(expect)] == expect
    assert got[len(expect):] == struct.pack(
        "<QI", ser._CRC_MAGIC, ser.crc32_bytes(expect))
    # the reference writes the same bytes, and nd.save of an NDArray too
    ref = str(tmp_path / "r.params")
    jser.save_nd(ref, [arr], ["w"])
    assert _bytes(ref) == got
    tnd.save(path, {"w": tnd.array(arr)})
    assert _bytes(path) == got


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16,
                                   np.uint8, np.int32, np.int8, np.int64])
def test_format_roundtrip_dtypes(tmp_path, dtype):
    arr = np.arange(24).astype(dtype).reshape(2, 3, 4)
    path = str(tmp_path / "a.params")
    ser.save_nd(path, [arr], ["x"])
    out = ser.load_nd(path)
    np.testing.assert_array_equal(out["x"], arr)
    assert out["x"].dtype == np.dtype(dtype)
    ref = str(tmp_path / "r.params")
    jser.save_nd(ref, [arr], ["x"])
    assert _bytes(ref) == _bytes(path)


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.uint8,
                                   np.int32, np.int8])
def test_nd_roundtrip_dtypes(tmp_path, dtype):
    arr = np.arange(24).astype(dtype).reshape(2, 3, 4)
    path = str(tmp_path / "a.params")
    tnd.save(path, {"x": tnd.array(arr)})
    out = tnd.load(path)
    np.testing.assert_array_equal(out["x"].asnumpy(), arr)
    assert out["x"].dtype == np.dtype(dtype)
    assert out["x"].context == tmx.cpu()


def test_roundtrip_bfloat16(tmp_path):
    """bf16 round-trips as torch.bfloat16 under the reference's type flag
    12, bit for bit with the reference's ml_dtypes arrays."""
    arr = (np.arange(8) / 3).astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    path, ref = str(tmp_path / "b.params"), str(tmp_path / "r.params")
    ser.save_nd(path, [t], ["x"])
    jser.save_nd(ref, [arr], ["x"])
    assert _bytes(path) == _bytes(ref)
    out = ser.load_nd(ref)
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), t.view(torch.int16))
    loaded = tnd.load(ref)["x"]
    assert loaded.dtype == torch.bfloat16
    np.testing.assert_array_equal(loaded.asnumpy(), arr.astype(np.float32))
    back = jser.load_nd(path)["x"]
    assert back.dtype == np.dtype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.view(np.int16), arr.view(np.int16))


def test_list_and_single_save(tmp_path):
    path = str(tmp_path / "l.params")
    tnd.save(path, [tnd.array(np.ones((2,), np.float32)),
                    tnd.array(np.zeros((3,), np.float32))])
    out = tnd.load(path)
    assert isinstance(out, list) and len(out) == 2
    tnd.save(path, tnd.array(np.full((4,), 7, np.float32)))
    (single,) = tnd.load(path)
    np.testing.assert_array_equal(single.asnumpy(),
                                  np.full((4,), 7, np.float32))


def test_legacy_npz_load(tmp_path):
    path = str(tmp_path / "old.params")
    np.savez(path, **{"arg:w": np.ones((2, 2), np.float32)})
    out = tnd.load(path)
    np.testing.assert_array_equal(out["arg:w"].asnumpy(), np.ones((2, 2)))


def test_truncated_file_rejected(tmp_path):
    arr = np.ones((4, 4), np.float32)
    path = str(tmp_path / "t.params")
    ser.save_nd(path, [arr], ["x"])
    buf = _bytes(path)
    # (cutting exactly the 12-byte footer leaves a valid upstream file)
    for cut in (10, 13, 40, len(buf) - 20):
        with open(path, "wb") as f:
            f.write(buf[:len(buf) - cut])
        with pytest.raises(ValueError):
            ser.load_nd(path)


def test_bit_flip_rejected(tmp_path):
    """A flipped bit anywhere in the data or the names fails the CRC."""
    path = str(tmp_path / "f.params")
    ser.save_nd(path, [np.arange(16, dtype=np.float32)], ["weights"])
    buf = bytearray(_bytes(path))
    for pos in (60, 100, len(buf) - 15):
        bad = bytearray(buf)
        bad[pos] ^= 0x04
        with open(path, "wb") as f:
            f.write(bytes(bad))
        with pytest.raises(ValueError):
            ser.load_nd(path)
            tnd.load(path)


def test_zero_dim_roundtrip(tmp_path):
    path, ref = str(tmp_path / "s.params"), str(tmp_path / "r.params")
    scalar = np.float32(3.25).reshape(())
    tail = np.arange(6, dtype=np.float32).reshape(2, 3)
    with pytest.warns(UserWarning, match="0-d"):
        tnd.save(path, {"loss": tnd.array(scalar), "w": tnd.array(tail)})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jser.save_nd(ref, [np.asarray(scalar), tail], ["loss", "w"])
    assert _bytes(path) == _bytes(ref)
    loaded = tnd.load(path)
    assert loaded["loss"].shape == (1,)
    assert float(loaded["loss"].asnumpy()[0]) == 3.25
    np.testing.assert_array_equal(loaded["w"].asnumpy(), tail)


def test_save_load(tmp_path):
    """tests/test_ndarray.py::test_save_load through the port."""
    p = str(tmp_path / "arrs")
    d = {"w": tnd.array([1.0, 2.0]), "b": tnd.array([3.0])}
    tnd.save(p, d)
    loaded = tnd.load(p)
    assert set(loaded) == {"w", "b"}
    np.testing.assert_array_equal(loaded["w"].asnumpy(), d["w"].asnumpy())


# ---------------------------------------------------------------------------
# across packages: the same bytes both ways
# ---------------------------------------------------------------------------

_VALUES = {
    "f32": np.random.RandomState(0).randn(3, 4).astype(np.float32),
    "f16": np.random.RandomState(1).randn(5).astype(np.float16),
    "i32": np.arange(-3, 9, dtype=np.int32).reshape(3, 4),
    "u8": np.arange(7, dtype=np.uint8),
    "i8": np.arange(-4, 4, dtype=np.int8),
}


@pytest.mark.parametrize("container", ["dict", "list"])
def test_nd_save_bytes_equal_across_packages(tmp_path, container):
    """nd.save of the same values gives the same file in both packages,
    and each package loads the other's file."""
    def pack(nd):
        arrs = {k: nd.array(v, dtype=v.dtype) for k, v in _VALUES.items()}
        return arrs if container == "dict" else list(arrs.values())

    port, ref = str(tmp_path / "p.params"), str(tmp_path / "r.params")
    tnd.save(port, pack(tnd))
    jnd.save(ref, pack(jnd))
    assert _bytes(port) == _bytes(ref)
    mine, theirs = tnd.load(ref), jnd.load(port)
    if container == "list":
        mine = dict(zip(_VALUES, mine))
        theirs = dict(zip(_VALUES, theirs))
    for k, v in _VALUES.items():
        for got in (mine[k], theirs[k]):
            assert got.dtype == v.dtype and got.shape == v.shape
            np.testing.assert_array_equal(got.asnumpy(), v)


# ---------------------------------------------------------------------------
# Gluon: save_parameters / load_parameters, ParameterDict.save / load
# ---------------------------------------------------------------------------

def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(5, in_units=4, activation="relu"))
    net.add(nn.Dense(3, in_units=5))
    return net


def _carry(ref, port):
    for (name, p), q in zip(ref.collect_params().items(),
                            port.collect_params().values()):
        q.set_data(p.data().asnumpy())


def test_save_parameters_bytes_equal_across_packages(tmp_path):
    ref, port = _mlp(jnn), _mlp(tnn)
    ref.initialize()
    port.initialize()
    _carry(ref, port)
    rf, pf = str(tmp_path / "r.params"), str(tmp_path / "p.params")
    ref.save_parameters(rf)
    port.save_parameters(pf)
    assert _bytes(rf) == _bytes(pf)
    # each package loads the other's file into a fresh, uninitialized net
    fresh_port, fresh_ref = _mlp(tnn), _mlp(jnn)
    fresh_port.load_parameters(rf, ctx=tmx.cpu())
    fresh_ref.load_parameters(pf)
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    want = ref(jnd.array(x)).asnumpy()
    np.testing.assert_array_equal(fresh_port(tnd.array(x)).asnumpy(),
                                  port(tnd.array(x)).asnumpy())
    np.testing.assert_allclose(fresh_port(tnd.array(x)).asnumpy(), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fresh_ref(jnd.array(x)).asnumpy(), want,
                               rtol=1e-6)


def test_load_parameters_missing_extra_and_dtype(tmp_path):
    net = _mlp(tnn)
    net.initialize(ctx=tmx.cpu())
    path = str(tmp_path / "p.params")
    net.save_parameters(path)
    small = tnn.HybridSequential()
    small.add(tnn.Dense(5, in_units=4, activation="relu"))
    with pytest.raises(KeyError, match="extra"):
        small.load_parameters(path)
    small.load_parameters(path, ignore_extra=True)
    np.testing.assert_array_equal(small[0].weight.data().asnumpy(),
                                  net[0].weight.data().asnumpy())
    big = _mlp(tnn)
    big.add(tnn.Dense(2, in_units=3))
    with pytest.raises(KeyError, match="missing"):
        big.load_parameters(path)
    big.load_parameters(path, allow_missing=True)
    # cast_dtype: "current" casts to the net's dtype, "saved" takes the
    # file's
    half = _mlp(tnn)
    half.initialize(ctx=tmx.cpu())
    half.cast("float16")
    half.load_parameters(path, cast_dtype=True)
    assert half[0].weight.data().dtype == np.float16
    half.load_parameters(path, cast_dtype=True, dtype_source="saved")
    assert half[0].weight.data().dtype == np.float32
    np.testing.assert_array_equal(half[1].bias.data().asnumpy(),
                                  net[1].bias.data().asnumpy())


def test_save_parameters_deduplicate(tmp_path):
    """A parameter shared by two blocks is written once with
    ``deduplicate`` and loads back into both names."""
    def build(nn):
        net = nn.HybridSequential()
        a = nn.Dense(4, in_units=4)
        net.add(a)
        net.add(nn.Dense(4, in_units=4, prefix=a.prefix,
                         params=a.collect_params()))
        return net

    net = build(tnn)
    net.initialize(ctx=tmx.cpu())
    assert net[0].weight is net[1].weight
    full, dedup = str(tmp_path / "f.params"), str(tmp_path / "d.params")
    net.save_parameters(full)
    net.save_parameters(dedup, deduplicate=True)
    assert set(tnd.load(full)) == {"0.weight", "0.bias", "1.weight",
                                   "1.bias"}
    assert set(tnd.load(dedup)) == {"0.weight", "0.bias"}
    other = build(tnn)
    other.load_parameters(dedup, ctx=tmx.cpu())
    np.testing.assert_array_equal(other[1].weight.data().asnumpy(),
                                  net[0].weight.data().asnumpy())


def test_parameter_dict_save_load_across_packages(tmp_path):
    ref, port = _mlp(jnn), _mlp(tnn)
    ref.initialize()
    port.initialize()
    _carry(ref, port)
    rf, pf = str(tmp_path / "r.params"), str(tmp_path / "p.params")
    ref.collect_params().save(rf)
    port.collect_params().save(pf)
    assert _bytes(rf) == _bytes(pf)
    tblock._SCOPE.counters = {}
    fresh = _mlp(tnn)  # the same names again
    fresh.collect_params().load(rf, ctx=tmx.cpu())
    for p, q in zip(port.collect_params().values(),
                    fresh.collect_params().values()):
        np.testing.assert_array_equal(q.data().asnumpy(),
                                      p.data().asnumpy())
    # strip_prefix / restore_prefix
    ref[0].collect_params().save(rf, strip_prefix="dense0_")
    port[0].collect_params().save(pf, strip_prefix="dense0_")
    assert _bytes(rf) == _bytes(pf)
    assert set(tnd.load(pf)) == {"weight", "bias"}
    one = tnn.Dense(5, in_units=4)  # dense2_
    one.collect_params().load(rf, ctx=tmx.cpu(), restore_prefix="dense2_")
    np.testing.assert_array_equal(one.weight.data().asnumpy(),
                                  port[0].weight.data().asnumpy())
    with pytest.raises(KeyError):
        one.collect_params().load(rf, ctx=tmx.cpu())


def test_trainer_save_states_uses_atomic_commit(tmp_path):
    """Trainer.save_states writes through checkpoint.atomic: the bytes are
    the updater's, and no staging file is left behind."""
    net = tnn.Dense(2, in_units=3)
    net.initialize(ctx=tmx.cpu())
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    with tmx.autograd.record():
        loss = (net(tnd.ones((2, 3))) ** 2).sum()
    loss.backward()
    tr.step(2)
    path = str(tmp_path / "t.states")
    tr.save_states(path)
    assert _bytes(path) == tr._updaters[0].get_states()
    assert os.listdir(tmp_path) == ["t.states"]
