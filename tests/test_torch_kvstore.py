"""The port's one-process key-value stores (mxnet_tpu_torch.kvstore) and
``gluon.Trainer(kvstore=...)`` against the JAX package's, on the CPU.

The same seeded numpy values go through both packages' stores: every
store name ``create`` takes (and the ones it refuses, with the same
message), merged pushes, two pushes before a pull, ``row_sparse_pull``
and 2-bit compression on the device store (all bitwise), the optimizer on
the store, batched over a multi-key push (rtol 1e-5 / atol 1e-6, the
reference's fused-update tolerance), and ``save_optimizer_states``.
``Trainer(kvstore=s)`` for each one-process name (and for ``dist_sync``
and ``dist_async`` run without a launcher, which reduce nothing) trains
a Dense layer 3 steps to the reference's Trainer at the tolerances of
``test_torch_gluon.py`` (rtol 1e-5, atol 1e-6).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray.sparse import RowSparseNDArray as JRowSparse
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray as TRowSparse

torch.set_num_threads(1)

ALL_NAMES = ["local", "local_update_cpu", "local_allreduce_cpu",
             "local_allreduce_device", "device", "nccl", "ici",
             "dist_sync", "dist_device_sync", "dist_sync_device",
             "dist_async", "dist", "LOCAL", "Device"]
ONE_PROCESS = ["local", "local_update_cpu", "local_allreduce_cpu",
               "local_allreduce_device", "device", "nccl", "ici"]


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    """Port arrays on the CPU; no launcher environment, so the dist names
    make one-process stores in both packages."""
    for var in ("DMLC_NUM_WORKER", "DMLC_WORKER_ID", "MXNET_COORDINATOR",
                "MXNET_PS_ADDR", "DMLC_PS_ROOT_URI", "MXNET_ELASTIC"):
        monkeypatch.delenv(var, raising=False)
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with tmx.cpu():
        yield


def _np(a):
    return a.asnumpy()


@pytest.mark.parametrize("name", ALL_NAMES)
def test_create_takes_every_reference_name(name):
    ref, port = jmx.kv.create(name), tmx.kv.create(name)
    assert port.type == ref.type == name.lower()
    assert (port.rank, port.num_workers) == (ref.rank, ref.num_workers)
    assert type(port).__name__ == type(ref).__name__
    assert tmx.kvstore.create is tmx.kv.create


@pytest.mark.parametrize("name", ["horovod", "bogus", "dist_bogus"])
def test_create_refuses_what_the_reference_refuses(name):
    with pytest.raises(JMXNetError) as je:
        jmx.kv.create(name)
    with pytest.raises(MXNetError) as te:
        tmx.kv.create(name)
    assert str(te.value) == str(je.value)
    with pytest.raises(TypeError):
        tmx.kv.create(3)


def _both(fn):
    """Run ``fn(pkg, nd, RowSparse)`` in both packages; numpy results."""
    return (fn(jmx, jnd, JRowSparse), fn(tmx, tnd, TRowSparse))


def _seeded(n, shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("name", ONE_PROCESS)
def test_merge_and_pull_bitwise(name):
    vals = _seeded(5, (3, 4))

    def run(mx, nd, _rs):
        kv = mx.kv.create(name)
        kv.init("a", nd.array(vals[0]))
        kv.init(["b", 3], [nd.array(vals[1]), nd.array(vals[2])])
        kv.init("a", nd.array(vals[4]))  # a second init is ignored
        out = nd.zeros((3, 4))
        got = {}
        kv.pull("a", out=out)
        got["init"] = _np(out)
        kv.push("a", [nd.array(v) for v in vals[:3]])  # merged by sum
        kv.pull("a", out=out)
        got["merged"] = _np(out)
        kv.push("b", nd.array(vals[3]))
        kv.push("b", nd.array(vals[4]))  # two pushes before a pull merge
        outs = [nd.zeros((3, 4)), nd.zeros((3, 4))]
        kv.pull("b", out=outs)
        got["two_pushes"] = [_np(o) for o in outs]
        kv.pushpull(3, nd.array(vals[0]), out=out)
        got["pushpull"] = _np(out)
        with pytest.raises(Exception, match="not initialized"):
            kv.push("zz", nd.array(vals[0]))
        return got

    ref, port = _both(run)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(port[k]),
                                      np.asarray(ref[k]), err_msg=k)


def test_pulled_value_is_a_copy():
    kv = tmx.kv.create("local")
    w = tnd.array(np.ones(3, np.float32))
    kv.init(0, w)
    kv.set_optimizer(tmx.optimizer.SGD(learning_rate=1.0))
    out = tnd.zeros(3)
    kv.pull(0, out=out)
    kv.push(0, tnd.array(np.ones(3, np.float32)))
    np.testing.assert_array_equal(_np(out), np.ones(3))  # not aliased
    np.testing.assert_array_equal(_np(w), np.ones(3))
    kv.pull(0, out=out)
    np.testing.assert_array_equal(_np(out), np.zeros(3))


def test_row_sparse_pull_bitwise():
    vals = _seeded(2, (6, 3), seed=4)

    def run(mx, nd, rs):
        kv = mx.kv.create("device")
        kv.init("emb", nd.array(vals[0]))
        dense = np.zeros((6, 3), np.float32)
        dense[[1, 4]] = vals[1][[1, 4]]
        kv.push("emb", rs.from_dense(nd.array(dense)))
        out = nd.zeros((3, 3))
        kv.row_sparse_pull("emb", out=out,
                           row_ids=nd.array(np.array([4, 0, 1], np.int32)))
        return _np(out)

    ref, port = _both(run)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.01})])
def test_optimizer_on_store_batched(opt, kw):
    """A multi-key push applies the whole batch through the updater's
    batched (multi-tensor) update; single-key pushes one at a time."""
    ws = _seeded(3, (4,), seed=1)
    grads = [_seeded(3, (4,), seed=10 + s) for s in range(3)]

    def run(mx, nd, _rs):
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create(opt, **kw))
        for i, w in enumerate(ws):
            kv.init(i, nd.array(w))
        outs = [nd.zeros(4) for _ in ws]
        for step in range(3):
            if step < 2:
                kv.push(list(range(3)), [nd.array(g) for g in grads[step]])
            else:
                for i, g in enumerate(grads[step]):
                    kv.push(i, nd.array(g))
        kv.pull(list(range(3)), out=outs)
        return [_np(o) for o in outs]

    ref, port = _both(run)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p, r, rtol=1e-5, atol=1e-6)


def test_optimizer_on_store_batched_uses_update_batch(monkeypatch):
    calls = []
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1))
    orig = kv._updater.update_batch
    monkeypatch.setattr(kv._updater, "update_batch",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    for i in range(3):
        kv.init(i, tnd.array(np.ones(4, np.float32)))
    kv.push([0, 1, 2], [tnd.array(np.ones(4, np.float32))] * 3)
    assert calls == [1]


def test_two_bit_compression_on_device_store_bitwise():
    vals = _seeded(3, (5, 7), seed=7)

    def run(mx, nd, _rs):
        kv = mx.kv.create("device")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("g", nd.zeros((5, 7)))
        out, got = nd.zeros((5, 7)), []
        for v in vals:
            kv.push("g", nd.array(v))
            kv.pull("g", out=out)
            got.append(_np(out))
        return got

    ref, port = _both(run)
    for r, p in zip(ref, port):
        assert p.dtype == np.float32 and p.tobytes() == r.tobytes()


@pytest.mark.parametrize("name", ["local", "local_update_cpu"])
def test_compression_refused_on_local_like_the_reference(name):
    with pytest.raises(JMXNetError) as je:
        jmx.kv.create(name).set_gradient_compression({"type": "2bit"})
    with pytest.raises(MXNetError) as te:
        tmx.kv.create(name).set_gradient_compression({"type": "2bit"})
    assert str(te.value) == str(je.value)


def test_optimizer_states_save_load(tmp_path):
    """save_optimizer_states then load into a fresh store continues as an
    uninterrupted run; the file loads in the reference's store too."""
    ws = _seeded(2, (3,), seed=2)
    gs = _seeded(4, (3,), seed=3)

    def store(mx, nd):
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create("adam", learning_rate=0.1))
        for i, w in enumerate(ws):
            kv.init(i, nd.array(w))
        return kv

    full = store(tmx, tnd)
    for g in gs:
        full.push([0, 1], [tnd.array(g), tnd.array(g)])
    half = store(tmx, tnd)
    for g in gs[:2]:
        half.push([0, 1], [tnd.array(g), tnd.array(g)])
    fname = str(tmp_path / "kv.states")
    half.save_optimizer_states(fname)
    mid = [tnd.zeros(3), tnd.zeros(3)]
    half.pull([0, 1], out=mid)
    resumed = store(tmx, tnd)
    resumed._store = {}
    for i, m in enumerate(mid):
        resumed.init(i, m)
    resumed.load_optimizer_states(fname)
    resumed._optimizer.num_update = half._optimizer.num_update
    resumed._optimizer._index_update_count = dict(
        half._optimizer._index_update_count)
    for g in gs[2:]:
        resumed.push([0, 1], [tnd.array(g), tnd.array(g)])
    a, b = [tnd.zeros(3), tnd.zeros(3)], [tnd.zeros(3), tnd.zeros(3)]
    full.pull([0, 1], out=a)
    resumed.pull([0, 1], out=b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(x), _np(y))
    ref = store(jmx, jnd)
    ref.load_optimizer_states(fname)
    assert sorted(ref._updater.states) == [0, 1]
    with pytest.raises(MXNetError, match="no optimizer"):
        tmx.kv.create("local").save_optimizer_states(fname)


def _trainer_pair(name, update_on_kvstore):
    ref = jnn.Dense(2, in_units=4)
    port = tnn.Dense(2, in_units=4)
    ref.initialize()
    port.initialize()
    for k, p in ref.collect_params().items():
        port.collect_params()[k].set_data(_np(p.data()))
    kw = {"learning_rate": 0.01}
    trs = [pkg.gluon.Trainer(net.collect_params(), "adam", kw, kvstore=name,
                             update_on_kvstore=update_on_kvstore)
           for pkg, net in ((jmx, ref), (tmx, port))]
    return ref, port, trs


def _steps(nd, ag, net, tr, steps=3):
    x = nd.array(np.arange(32, dtype=np.float32).reshape(8, 4) / 32)
    for _ in range(steps):
        with ag.record():
            loss = (net(x) ** 2).sum()
        loss.backward()
        tr.step(8)


@pytest.mark.parametrize("update_on_kvstore", [None, True])
@pytest.mark.parametrize("name", ONE_PROCESS + ["dist_sync", "dist_async"])
def test_trainer_kvstore_matches_reference(name, update_on_kvstore):
    ref, port, (jtr, ttr) = _trainer_pair(name, update_on_kvstore)
    _steps(jnd, jag, ref, jtr)
    _steps(tnd, tag, port, ttr)
    assert (ttr._kvstore is None) == (jtr._kvstore is None)
    for k, p in ref.collect_params().items():
        np.testing.assert_allclose(_np(port.collect_params()[k].data()),
                                   _np(p.data()), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_trainer_takes_a_store_object():
    kv = tmx.kv.create("nccl")
    net = tnn.Dense(2, in_units=4)
    net.initialize()
    plain = tnn.Dense(2, in_units=4)
    plain.initialize()
    plain.weight.set_data(_np(net.weight.data()))
    plain.bias.set_data(_np(net.bias.data()))
    _steps(tnd, tag, net, tmx.gluon.Trainer(net.collect_params(), "sgd",
                                            {"learning_rate": 0.1},
                                            kvstore=kv))
    _steps(tnd, tag, plain, tmx.gluon.Trainer(plain.collect_params(), "sgd",
                                              {"learning_rate": 0.1}))
    np.testing.assert_array_equal(_np(net.weight.data()),
                                  _np(plain.weight.data()))
    assert sorted(kv._store) == ["0", "1"]
