"""NDArray core semantics through both packages: every case of
tests/test_ndarray.py whose ops the port has, run as written there once
through ``mxnet_tpu`` and once through ``mxnet_tpu_torch`` (on the CPU,
inside ``with mx.cpu():``), held to the same numpy expectations with the
reference's tolerances (``mxnet_tpu.test_utils``: f32 rtol 1e-4, atol
1e-5; exact where the reference asks for ``same``). ``test_save_load``
is ``tests/test_torch_serialization.py``'s. Then the port's own traps:
JAX's out-of-range indexing, creation dtypes and the default context."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import nd as tnd

torch.set_num_threads(1)

_DTOL = {np.dtype(np.float16): (1e-2, 1e-2),
         np.dtype(np.float32): (1e-4, 1e-5)}


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def same(a, b):
    return np.array_equal(_np(a), _np(b))


def assert_almost_equal(a, b, rtol=None, atol=None):
    a, b = _np(a), _np(b)
    dt = np.promote_types(a.dtype, b.dtype) if a.dtype.kind == "f" \
        else np.dtype(np.float32)
    drt, dat = _DTOL.get(np.dtype(dt), (1e-4, 1e-5))
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rtol or drt, atol=atol or dat)


@pytest.fixture(params=["mxnet_tpu", "mxnet_tpu_torch"])
def pkg(request):
    """(mx, nd) of one package; the port's arrays on the CPU."""
    if request.param == "mxnet_tpu":
        yield jmx, jnd
    else:
        with tmx.cpu():
            yield tmx, tnd


def test_create_and_asnumpy(pkg):
    mx, nd = pkg
    a = nd.array([[1, 2], [3, 4]])
    assert a.shape == (2, 2)
    assert a.dtype == np.float32
    assert same(a, np.array([[1, 2], [3, 4]], dtype=np.float32))


def test_creation_helpers(pkg):
    mx, nd = pkg
    assert same(nd.zeros((2, 3)), np.zeros((2, 3)))
    assert same(nd.ones((2, 3)), np.ones((2, 3)))
    assert same(nd.full((2,), 7.0), np.full((2,), 7.0, dtype=np.float32))
    assert same(nd.arange(5), np.arange(5, dtype=np.float32))


def test_arithmetic(pkg):
    mx, nd = pkg
    a = nd.array([1.0, 2.0, 3.0])
    b = nd.array([4.0, 5.0, 6.0])
    assert same(a + b, np.array([5, 7, 9], np.float32))
    assert same(a - b, np.array([-3, -3, -3], np.float32))
    assert same(a * b, np.array([4, 10, 18], np.float32))
    assert_almost_equal(a / b, np.array([0.25, 0.4, 0.5], np.float32))
    assert same(a + 1, np.array([2, 3, 4], np.float32))
    assert same(2 * a, np.array([2, 4, 6], np.float32))
    assert same(1 - a, np.array([0, -1, -2], np.float32))
    assert_almost_equal(1 / a, np.array([1, 0.5, 1 / 3], np.float32))
    assert same(a ** 2, np.array([1, 4, 9], np.float32))
    assert same(-a, np.array([-1, -2, -3], np.float32))


def test_inplace_ops(pkg):
    mx, nd = pkg
    a = nd.array([1.0, 2.0])
    a += 1
    assert same(a, np.array([2, 3], np.float32))
    a *= 2
    assert same(a, np.array([4, 6], np.float32))
    a[:] = 0
    assert same(a, np.zeros(2, np.float32))


def test_setitem_getitem(pkg):
    mx, nd = pkg
    a = nd.zeros((3, 4))
    a[1] = 5
    assert same(a[1], np.full(4, 5, np.float32))
    a[0, 2] = 3
    assert a[0, 2].asscalar() == 3
    b = a[0:2]
    assert b.shape == (2, 4)
    a[:, 1] = 9
    assert same(a[:, 1], np.full(3, 9, np.float32))


def test_reshape_magic_codes(pkg):
    mx, nd = pkg
    a = nd.zeros((2, 3, 4))
    assert a.reshape((6, 4)).shape == (6, 4)
    assert a.reshape((-1,)).shape == (24,)
    assert a.reshape((0, -1)).shape == (2, 12)
    assert a.reshape((-2,)).shape == (2, 3, 4)
    assert a.reshape((-3, 4)).shape == (6, 4)
    assert a.reshape((-4, 1, 2, 0, 0)).shape == (1, 2, 3, 4)
    assert a.reshape((2, -4, 3, 1, 4)).shape == (2, 3, 1, 4)


def test_broadcast(pkg):
    mx, nd = pkg
    a = nd.ones((2, 1, 3))
    b = nd.ones((1, 4, 3))
    assert (a + b).shape == (2, 4, 3)
    assert nd.broadcast_to(a, shape=(2, 4, 3)).shape == (2, 4, 3)


def test_reductions(pkg):
    mx, nd = pkg
    x = np.random.RandomState(0).rand(3, 4, 5).astype(np.float32)
    a = nd.array(x)
    assert_almost_equal(a.sum(), x.sum())
    assert_almost_equal(a.sum(axis=1), x.sum(axis=1))
    assert_almost_equal(nd.sum(a, axis=(0, 2)), x.sum(axis=(0, 2)))
    assert_almost_equal(nd.sum(a, axis=1, exclude=True), x.sum(axis=(0, 2)))
    assert_almost_equal(a.mean(axis=0, keepdims=True),
                        x.mean(axis=0, keepdims=True))
    assert_almost_equal(a.max(), x.max())
    assert_almost_equal(nd.norm(a), np.sqrt((x ** 2).sum()), rtol=1e-4)


def test_dot(pkg):
    mx, nd = pkg
    rng = np.random.RandomState(1)
    x = rng.rand(3, 4).astype(np.float32)
    y = rng.rand(4, 5).astype(np.float32)
    assert_almost_equal(nd.dot(nd.array(x), nd.array(y)), x @ y, rtol=1e-4,
                        atol=1e-4)
    assert_almost_equal(nd.dot(nd.array(x), nd.array(y.T), transpose_b=True),
                        x @ y, rtol=1e-4, atol=1e-4)
    bx = rng.rand(2, 3, 4).astype(np.float32)
    by = rng.rand(2, 4, 5).astype(np.float32)
    assert_almost_equal(nd.batch_dot(nd.array(bx), nd.array(by)), bx @ by,
                        rtol=1e-4, atol=1e-4)


def test_slice_family(pkg):
    mx, nd = pkg
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    a = nd.array(x)
    assert same(nd.slice(a, begin=(0, 1), end=(2, 3)), x[0:2, 1:3])
    assert same(nd.slice_axis(a, axis=2, begin=1, end=3), x[:, :, 1:3])
    assert same(nd.slice_like(a, nd.zeros((1, 2, 2))), x[:1, :2, :2])


def test_concat_split_stack(pkg):
    mx, nd = pkg
    rng = np.random.RandomState(2)
    x = rng.rand(2, 3).astype(np.float32)
    y = rng.rand(2, 3).astype(np.float32)
    assert same(nd.concat(nd.array(x), nd.array(y), dim=0),
                np.concatenate([x, y], 0))
    assert same(nd.stack(nd.array(x), nd.array(y), axis=0),
                np.stack([x, y], 0))
    parts = nd.split(nd.array(x), num_outputs=3, axis=1)
    assert len(parts) == 3 and parts[0].shape == (2, 1)
    sq = nd.split(nd.array(x), num_outputs=3, axis=1, squeeze_axis=True)
    assert sq[0].shape == (2,)


def test_take_embedding_onehot_pick(pkg):
    mx, nd = pkg
    rng = np.random.RandomState(3)
    w = rng.rand(10, 4).astype(np.float32)
    idx = np.array([1, 3, 5], np.float32)
    assert same(nd.take(nd.array(w), nd.array(idx)), w[[1, 3, 5]])
    assert same(nd.Embedding(nd.array(idx), nd.array(w), input_dim=10,
                             output_dim=4), w[[1, 3, 5]])
    oh = nd.one_hot(nd.array([0, 2]), 3)
    assert same(oh, np.array([[1, 0, 0], [0, 0, 1]], np.float32))
    data = rng.rand(3, 5).astype(np.float32)
    picked = nd.pick(nd.array(data), nd.array([0, 2, 4], dtype=np.float32))
    assert same(picked, data[np.arange(3), [0, 2, 4]])


def test_elemwise_math(pkg):
    mx, nd = pkg
    x = np.random.RandomState(4).rand(4, 5).astype(np.float32) + 0.5
    a = nd.array(x)
    assert_almost_equal(nd.exp(a), np.exp(x), rtol=1e-4)
    assert_almost_equal(nd.log(a), np.log(x), rtol=1e-4)
    assert_almost_equal(nd.sqrt(a), np.sqrt(x), rtol=1e-4)
    assert_almost_equal(nd.rsqrt(a), 1 / np.sqrt(x), rtol=1e-4)
    assert_almost_equal(nd.sigmoid(a), 1 / (1 + np.exp(-x)), rtol=1e-4)
    assert same(nd.relu(nd.array([-1.0, 1.0])), np.array([0, 1], np.float32))
    assert_almost_equal(nd.clip(a, a_min=0.6, a_max=1.0),
                        np.clip(x, 0.6, 1.0))


def test_transpose_swap_expand(pkg):
    mx, nd = pkg
    x = np.random.RandomState(5).rand(2, 3, 4).astype(np.float32)
    a = nd.array(x)
    assert same(a.T, x.T)
    assert same(nd.transpose(a, axes=(1, 0, 2)), x.transpose(1, 0, 2))
    assert same(nd.swapaxes(a, dim1=0, dim2=2), x.swapaxes(0, 2))
    assert a.expand_dims(1).shape == (2, 1, 3, 4)
    assert nd.squeeze(a.expand_dims(0)).shape == (2, 3, 4)


def test_where_comparisons(pkg):
    mx, nd = pkg
    x = nd.array([1.0, 5.0, 3.0])
    y = nd.array([4.0, 2.0, 3.0])
    assert same(x > y, np.array([0, 1, 0], np.float32))
    assert same(x <= y, np.array([1, 0, 1], np.float32))
    assert same(nd.where(x > y, x, y), np.array([4, 5, 3], np.float32))


def test_astype_cast(pkg):
    mx, nd = pkg
    a = nd.array([1.5, 2.5])
    assert a.astype("int32").dtype == np.int32
    assert nd.cast(a, dtype="float16").dtype == np.float16


def test_context_and_async(pkg):
    mx, nd = pkg
    a = nd.array([1.0], ctx=mx.cpu())
    assert a.context.device_type == "cpu"
    b = a.as_in_context(mx.cpu(0))
    assert same(b, a)
    a.wait_to_read()
    nd.waitall()
    assert float(a.asscalar()) == 1.0


def test_iter_len_bool(pkg):
    mx, nd = pkg
    a = nd.array([[1.0, 2.0], [3.0, 4.0]])
    assert len(a) == 2
    rows = list(a)
    assert same(rows[1], np.array([3, 4], np.float32))
    assert bool(nd.array([1.0]))
    with pytest.raises(ValueError):
        bool(a)


# ---------------------------------------------------------------------------
# The port's traps, against the reference
# ---------------------------------------------------------------------------

def _both(fn):
    """fn(mx, nd) through each package, as numpy."""
    want = _np(fn(jmx, jnd))
    with tmx.cpu():
        got = _np(fn(tmx, tnd))
    return got, want


@pytest.mark.parametrize("key", [
    10, -7, (1, 10), (-5, 0), slice(2, 40), slice(None, None, -2),
    slice(-1, -9, -3), np.array([10, -7, 2, -1]),
    (slice(None), np.array([0, 9])),
    (Ellipsis, -1), (None, 1), "nd-index"])
def test_getitem_clamps_like_jax(key):
    """Out-of-range integer and index-array reads clamp (negatives from
    the end, then into range), where torch would raise."""
    x = np.arange(20, dtype=np.float32).reshape(4, 5)

    def read(mx, nd):
        a = nd.array(x)
        k = nd.array([7.0, -1.0, 2.9]) if isinstance(key, str) else key
        return a[k]

    got, want = _both(read)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_getitem_clamps_on_a_vector():
    got, want = _both(lambda mx, nd: nd.arange(5)[10])
    assert float(got) == float(want) == 4.0
    got, want = _both(lambda mx, nd: nd.arange(5)[nd.array([10, -7])])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [4.0, 0.0])


@pytest.mark.parametrize("key,value", [
    (10, 1.0), (-9, 2.0), ((1, 7), 3.0), (np.array([0, 9, -1, -9]), 4.0),
    ((slice(None), np.array([1, 6])), 5.0), (slice(None, None, -2), 6.0),
    ((2,), "row")])
def test_setitem_drops_out_of_range_writes(key, value):
    """Writes out of range are dropped, in-range ones of the same key land
    (negatives from the end)."""
    x = np.arange(20, dtype=np.float32).reshape(4, 5)

    def write(mx, nd):
        a = nd.array(x)
        v = nd.array(np.arange(5, dtype=np.float32) + 100) \
            if isinstance(value, str) else value
        a[key] = v
        return a

    got, want = _both(write)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source,dtype,want", [
    ([1, 2], None, np.float32), (np.arange(3), None, np.int32),
    (np.arange(3.0), None, np.float32), (np.float16([1]), None, np.float16),
    ([1, 2], "int64", np.int32), ([1.5], "float64", np.float32),
    (np.array([True]), None, np.bool_), ([1], "int8", np.int8)])
def test_creation_dtypes_follow_jax(source, dtype, want):
    """float64 -> float32 and int64 -> int32 (JAX with 64-bit off); lists
    default to float32; numpy arrays keep their (32-bit) type."""
    got, ref = _both(lambda mx, nd: nd.array(source, dtype=dtype))
    assert got.dtype == ref.dtype == np.dtype(want)
    np.testing.assert_array_equal(got, ref)


def test_index_arrays_stay_int32_and_become_int64_in_the_op():
    with tmx.cpu():
        idx = tnd.array(np.array([3, 0], np.int64))
        assert idx.dtype == np.int32
        w = tnd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
        np.testing.assert_array_equal(tnd.take(w, idx).asnumpy(),
                                      np.arange(12).reshape(4, 3)[[3, 0]])
        assert idx.dtype == np.int32


def test_default_context_is_the_card():
    """With no scope and no ctx the port creates arrays on cuda:0; with no
    card it raises instead of quietly using the CPU. The CPU is used when
    named."""
    if torch.cuda.is_available():
        a = tnd.zeros((2,))
        assert a.context == tmx.gpu(0) and a.astorch().device.type == "cuda"
        return
    with pytest.raises(MXNetError, match="no CUDA device"):
        tnd.zeros((2,))
    with pytest.raises(MXNetError, match="no CUDA device"):
        tnd.array([1.0])
    assert tnd.array([1.0], ctx=tmx.cpu()).context == tmx.cpu()
    with tmx.cpu():
        assert tnd.ones((1,)).context.device_type == "cpu"
        assert tmx.current_context() == tmx.cpu()


def test_topk_sort(pkg):
    mx, nd = pkg
    x = np.array([[3.0, 1.0, 2.0], [0.0, 5.0, 4.0]], np.float32)
    a = nd.array(x)
    assert same(nd.topk(a, k=1), np.array([[0], [1]], np.float32))
    v = nd.topk(a, k=2, ret_typ="value")
    assert same(v, np.array([[3, 2], [5, 4]], np.float32))
    assert same(nd.sort(a), np.sort(x, -1))
    assert same(nd.argsort(a), np.argsort(x, -1).astype(np.float32))


def test_sequence_ops(pkg):
    mx, nd = pkg
    x = np.random.rand(4, 2, 3).astype(np.float32)  # (T, B, D)
    ln = nd.array([2.0, 4.0])
    masked = nd.SequenceMask(nd.array(x), ln, use_sequence_length=True,
                             value=-1.0)
    out = masked.asnumpy()
    assert (out[2:, 0] == -1).all() and (out[:, 1] == x[:, 1]).all()
    last = nd.SequenceLast(nd.array(x), ln, use_sequence_length=True)
    assert_almost_equal(last, np.stack([x[1, 0], x[3, 1]]))
    rev = nd.SequenceReverse(nd.array(x), ln, use_sequence_length=True)
    assert_almost_equal(rev.asnumpy()[0, 0], x[1, 0])
    assert_almost_equal(rev.asnumpy()[3, 1], x[0, 1])


def test_unported_op_names_fail_loudly():
    # every op name of the reference is registered now: an unknown name
    with pytest.raises(NotImplementedError, match="'NoSuchOp'"):
        tmx.ops.get_op("NoSuchOp")
    with pytest.raises(AttributeError):
        tnd.NoSuchOp
    with pytest.raises(AttributeError):
        tmx.io.NoSuchIter
    for name in ("FullyConnected", "LayerNorm", "Embedding", "pick",
                 "log_softmax", "sgd_update", "adamw_update", "Dropout"):
        assert tmx.ops.has_op(name), name


def test_mx_sync_waits_after_every_op(monkeypatch):
    """MX_SYNC=1 (read at import) makes invoke wait for each result."""
    from mxnet_tpu_torch.ndarray import ndarray as tndarray

    waited = []
    monkeypatch.setattr(tndarray, "_MX_SYNC", True)
    monkeypatch.setattr(tndarray.NDArray, "wait_to_read",
                        lambda self: waited.append(self) or self)
    with tmx.cpu():
        y = tnd.ones((2,)) + 1
    assert waited and waited[-1] is y
