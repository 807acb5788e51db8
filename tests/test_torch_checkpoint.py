"""The port's crash-safe checkpointing (``mxnet_tpu_torch/checkpoint/``)
against the JAX package, on the CPU.

The cases of ``tests/test_checkpoint.py`` run through the port (the
Estimator case runs in ``tests/test_torch_estimator.py``):
the atomic commit and CRC footer, ``CheckpointManager`` (commit, keep-
last-N, the async writer and its surfaced errors, the stale-staging sweep,
fallback past a corrupt, truncated or manifest-less newest checkpoint),
the training-state pieces (optimizer slots and counters, RNG streams, the
iterator cursor, the Trainer's checkpoint state) and bitwise split-vs-
straight ``Module.fit``. Across packages: a checkpoint the reference's
``Module.fit`` writes restores its parameters, optimizer slots and
iterator cursor in the port, and the port's resumed fit ends where the
reference's straight fit does (f32 tolerances); the port's checkpoints
validate in the reference. RNG capture is package-specific: the port keeps
its torch generators' states where the reference keeps its JAX key.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import symbol as jsym
from mxnet_tpu.checkpoint import CheckpointManager as JManager
from mxnet_tpu.io import NDArrayIter as JIter
from mxnet_tpu.module import Module as JModule
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.checkpoint import CheckpointError, CheckpointManager
from mxnet_tpu_torch.checkpoint.atomic import atomic_write_bytes
from mxnet_tpu_torch.checkpoint.state import (TrainingState,
                                              capture_training_state,
                                              restore_iterator,
                                              restore_optimizer, restore_rng)
from mxnet_tpu_torch.io import NDArrayIter
from mxnet_tpu_torch.module import Module
from mxnet_tpu_torch.ndarray import serialization as ser

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _flip(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


# ---------------------------------------------------------------------------
# serialization: atomic save + CRC footer
# ---------------------------------------------------------------------------

def test_save_nd_crc_roundtrip(tmp_path):
    path = str(tmp_path / "a.params")
    arrs = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.ones(3, np.float16)}
    ser.save_nd(path, list(arrs.values()), list(arrs.keys()))
    out = ser.load_nd(path)
    for k, v in arrs.items():
        np.testing.assert_array_equal(out[k], v)


def test_load_nd_rejects_bit_flip(tmp_path):
    path = str(tmp_path / "a.params")
    ser.save_nd(path, [np.arange(8, dtype=np.float32)], ["w"])
    _flip(path, 60)  # inside the record
    with pytest.raises(ValueError, match="CRC mismatch"):
        ser.load_nd(path)


def test_load_nd_rejects_truncation(tmp_path):
    path = str(tmp_path / "a.params")
    ser.save_nd(path, [np.arange(8, dtype=np.float32)], ["w"])
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-5])  # torn write: mid-footer
    with pytest.raises(ValueError):
        ser.load_nd(path)


def test_load_nd_accepts_legacy_no_footer(tmp_path):
    path = str(tmp_path / "a.params")
    arr = np.arange(8, dtype=np.float32)
    ser.save_nd(path, [arr], ["w"], crc=False)
    np.testing.assert_array_equal(ser.load_nd(path)["w"], arr)


def test_atomic_write_replaces_not_appends(tmp_path):
    path = str(tmp_path / "f.bin")
    atomic_write_bytes(path, b"a" * 100)
    atomic_write_bytes(path, b"b" * 3)
    assert open(path, "rb").read() == b"bbb"
    assert [e for e in os.listdir(tmp_path) if ".tmp-" in e] == []


def test_atomic_write_respects_umask(tmp_path):
    path = str(tmp_path / "m.bin")
    old = os.umask(0o022)
    try:
        atomic_write_bytes(path, b"x")
    finally:
        os.umask(old)
    assert (os.stat(path).st_mode & 0o777) == 0o644


# ---------------------------------------------------------------------------
# CheckpointManager: commit, validate, GC, fallback
# ---------------------------------------------------------------------------

def _state(step, seed=0):
    rng = np.random.RandomState(seed + step)
    return TrainingState(
        {"arg:w": rng.randn(4, 3).astype(np.float32),
         "arg:b": rng.randn(3).astype(np.float32)},
        {"format": 1, "global_step": step, "epoch": 0, "nbatch": step})


def test_manager_save_load_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=0, async_write=False)
    st = _state(5)
    mgr.save(st, 5)
    out = mgr.load(5)
    assert out.global_step == 5
    np.testing.assert_array_equal(out.arrays["arg:w"], st.arrays["arg:w"])
    assert out.arg_params().keys() == {"w", "b"}
    # the reference's manager validates the port's checkpoint, and back
    assert JManager(str(tmp_path)).load(5).global_step == 5
    jmgr = JManager(str(tmp_path / "ref"), keep_last=0, async_write=False)
    jmgr.save(_jstate(7), 7)
    np.testing.assert_array_equal(
        CheckpointManager(str(tmp_path / "ref")).load(7).arrays["arg:w"],
        _state(7).arrays["arg:w"])


def _jstate(step):
    from mxnet_tpu.checkpoint.state import TrainingState as JState

    st = _state(step)
    return JState(st.arrays, st.meta)


def test_manager_bf16_arrays(tmp_path):
    """bf16 arrays (CPU torch.bfloat16) go through the manifest's CRCs and
    come back bitwise, under the reference's dtype name."""
    t = torch.arange(6, dtype=torch.float32).div(7).to(torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path), keep_last=0, async_write=False)
    mgr.save(TrainingState({"arg:h": t}, {"format": 1}), 1)
    back = mgr.load(1).arrays["arg:h"]
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    ref = JManager(str(tmp_path)).load(1).arrays["arg:h"]
    np.testing.assert_array_equal(ref.astype(np.float32), t.float().numpy())


def test_manager_keep_last_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(_state(s), s)
    assert mgr.list_steps() == [3, 4]


def test_manager_async_writer_flush(tmp_path):
    with CheckpointManager(str(tmp_path), keep_last=0) as mgr:
        for s in (1, 2, 3):
            mgr.save(_state(s), s)
        mgr.flush()
        assert mgr.list_steps() == [1, 2, 3]
        assert mgr.load_latest().global_step == 3


def test_manager_sweeps_stale_staging(tmp_path):
    stale = tmp_path / ".ckpt-00000009.tmp-12345"
    stale.mkdir()
    (stale / "arrays.bin").write_bytes(b"partial")
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    assert not stale.exists()
    assert mgr.list_steps() == []


def test_manager_corrupt_newest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=0, async_write=False)
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    _flip(str(tmp_path / "ckpt-00000002" / "arrays.bin"), 60)
    with pytest.raises(CheckpointError):
        mgr.validate(2)
    st = mgr.load_latest()
    assert st is not None and st.global_step == 1


def test_manager_truncated_newest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=0, async_write=False)
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    arrays = tmp_path / "ckpt-00000002" / "arrays.bin"
    arrays.write_bytes(arrays.read_bytes()[:37])
    st = mgr.load_latest()
    assert st is not None and st.global_step == 1


def test_manager_missing_manifest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=0, async_write=False)
    mgr.save(_state(1), 1)
    mgr.save(_state(2), 2)
    os.unlink(tmp_path / "ckpt-00000002" / "manifest.json")
    st = mgr.load_latest()
    assert st is not None and st.global_step == 1


def test_manager_all_invalid_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    assert mgr.load_latest() is None
    mgr.save(_state(1), 1)
    os.unlink(tmp_path / "ckpt-00000001" / "manifest.json")
    assert mgr.load_latest() is None


def test_manager_reuse_clears_preempted(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.preempted.set()
    mgr.install_signal_handlers()
    try:
        assert not mgr.preempted.is_set()
    finally:
        mgr.restore_signal_handlers()


def test_manager_background_write_error_surfaces(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=0)
    bad = TrainingState({"arg:w": np.ones(2, np.float32)}, {"format": 1})
    bad.meta["unjsonable"] = object()  # manifest json.dumps fails
    mgr.save(bad, 1)
    with pytest.raises(CheckpointError):
        mgr.flush()
    mgr.close()


def test_manager_refuses_chaos_kill_points(tmp_path, monkeypatch):
    """The chaos kill points are ported: with ``MXNET_CHAOS_KILL`` naming
    a point the writer never reaches, the manager starts and commits as
    usual (the SIGKILL cases are in tests/test_torch_chaos.py)."""
    from mxnet_tpu_torch.chaos import proc

    monkeypatch.setenv("MXNET_CHAOS_KILL", "ckpt:never_reached@1")
    proc.reset_kill_points()
    try:
        mgr = CheckpointManager(str(tmp_path), async_write=False)
        mgr.save(TrainingState({"arg:w": np.ones(2, np.float32)},
                               {"format": 1}), 1)
        mgr.close()
        assert mgr.list_steps() == [1]
    finally:
        monkeypatch.delenv("MXNET_CHAOS_KILL")
        proc.reset_kill_points()


# ---------------------------------------------------------------------------
# training-state capture/restore pieces
# ---------------------------------------------------------------------------

def test_optimizer_state_roundtrip():
    from mxnet_tpu_torch.ndarray import array
    from mxnet_tpu_torch.optimizer import Updater, create as opt_create

    opt = opt_create("adam", learning_rate=0.01)
    upd = Updater(opt)
    w = array(np.ones((3, 2), np.float32))
    for _ in range(3):
        upd(0, array(np.full((3, 2), 0.1, np.float32)), w)
    st = capture_training_state(updater=upd, optimizer=opt)
    opt2 = opt_create("adam", learning_rate=0.01)
    upd2 = Updater(opt2)
    restore_optimizer(upd2, opt2, st)
    assert opt2.num_update == opt.num_update
    assert opt2._index_update_count == opt._index_update_count
    for a, b in zip(upd.states[0], upd2.states[0]):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        assert b.context == mx.cpu()
    w2 = array(w.asnumpy())
    g = array(np.full((3, 2), 0.2, np.float32))
    upd(0, g, w)
    upd2(0, g, w2)
    np.testing.assert_array_equal(w.asnumpy(), w2.asnumpy())


def test_rng_state_roundtrip():
    """numpy's MT stream, the seeded np_rng and the device generators'
    states come back; later draws repeat bit for bit."""
    np.random.seed(11)
    mx.random.seed(11)
    gen = mx.random.generator("cpu")
    torch.rand(2, generator=gen)      # advance the generator
    np.random.rand(3)                 # advance the MT stream
    mx.random.np_rng().random(2)      # advance np_rng
    st = capture_training_state()
    assert "rng:torch:cpu:-1" in st.arrays
    a1 = np.random.rand(4)
    k1 = torch.rand(3, generator=mx.random.generator("cpu"))
    r1 = mx.random.np_rng().random(3)
    np.random.seed(999)  # scramble, then restore
    mx.random.seed(999)
    restore_rng(st)
    np.testing.assert_array_equal(np.random.rand(4), a1)
    assert torch.equal(torch.rand(3, generator=mx.random.generator("cpu")),
                       k1)
    np.testing.assert_array_equal(mx.random.np_rng().random(3), r1)


def test_iterator_state_roundtrip():
    X = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10, dtype=np.float32)
    it = NDArrayIter(X, y, batch_size=2, shuffle=True)
    it.reset()
    next(it)
    next(it)
    st = capture_training_state(train_data=it)
    remaining1 = [b.data[0].asnumpy() for b in it]
    it2 = NDArrayIter(X, y, batch_size=2, shuffle=True)
    assert restore_iterator(it2, st)
    remaining2 = [b.data[0].asnumpy() for b in it2]
    assert len(remaining1) == len(remaining2) == 3
    for a, b in zip(remaining1, remaining2):
        np.testing.assert_array_equal(a, b)


def _leaf(s):
    while isinstance(s, tuple):
        s = s[0]
    return s.asnumpy()


def test_trainer_checkpoint_state_roundtrip():
    from mxnet_tpu_torch import gluon, nd

    net = gluon.nn.Dense(3)
    net.initialize()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    with mx.autograd.record():
        loss = net(nd.ones((2, 4))).sum()
    loss.backward()
    tr.step(2)
    st = tr.get_checkpoint_state()
    net2 = gluon.nn.Dense(3)
    net2.initialize()
    net2(nd.ones((2, 4)))
    tr2 = gluon.Trainer(net2.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9})
    tr2.set_checkpoint_state(st)
    assert tr2._optimizer.num_update == tr._optimizer.num_update
    for k, s in tr._updaters[0].states.items():
        np.testing.assert_array_equal(_leaf(s),
                                      _leaf(tr2._updaters[0].states[k]))


# ---------------------------------------------------------------------------
# Module.fit: split run == straight run, bitwise; across packages
# ---------------------------------------------------------------------------

def _mlp(S=sym):
    data = S.Variable("data")
    net = S.FullyConnected(data, num_hidden=8, name="fc1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.FullyConnected(net, num_hidden=4, name="fc2")
    return S.SoftmaxOutput(net, name="softmax")


_INIT = {k: v for k, v in zip(
    ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"),
    (np.random.RandomState(7).randn(*s).astype(np.float32) * 0.3
     for s in ((8, 6), (8,), (4, 8), (4,))))}


def _fit(num_epoch, ckpt=None, resume="never", seed=33, pkg=None):
    """The MLP fit of tests/test_checkpoint.py, from fixed initial
    parameters (``pkg``: the reference, for the cross-package cases)."""
    ref = pkg is not None
    S, Iter, Mod, m = (jsym, JIter, JModule, jmx) if ref else \
        (sym, NDArrayIter, Module, mx)
    np.random.seed(seed)
    m.random.seed(seed)
    rng = np.random.RandomState(4321)
    X = rng.randn(32, 6).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    it = Iter(X, y, batch_size=8, shuffle=True)
    mod = Mod(_mlp(S), context=m.cpu())
    mod.fit(it, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            arg_params={k: m.nd.array(v) for k, v in _INIT.items()},
            checkpoint=ckpt, resume=resume, checkpoint_batch_period=3)
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_fit_split_training_bitwise(tmp_path):
    straight = _fit(4)
    _fit(2, ckpt=str(tmp_path), resume="auto")
    resumed = _fit(4, ckpt=str(tmp_path), resume="auto")
    assert straight.keys() == resumed.keys()
    for n in straight:
        np.testing.assert_array_equal(straight[n], resumed[n], err_msg=n)


def test_fit_resume_never_ignores_checkpoints(tmp_path):
    _fit(2, ckpt=str(tmp_path), resume="auto")
    p1 = _fit(1, ckpt=None)
    p2 = _fit(1, ckpt=str(tmp_path), resume="never")
    for n in p1:
        np.testing.assert_array_equal(p1[n], p2[n])


def test_fit_resume_pinned_step(tmp_path):
    _fit(2, ckpt=str(tmp_path), resume="auto")
    mgr = CheckpointManager(str(tmp_path))
    steps = mgr.list_steps()
    assert steps, "expected committed checkpoints"
    assert mgr.load(steps[0]).global_step == steps[0]


def test_reference_checkpoint_restores_in_port(tmp_path):
    """A checkpoint the reference's Module.fit wrote restores in the port:
    its parameters, its optimizer slots and its iterator cursor; the
    port's resumed fit then ends where the reference's straight fit
    does."""
    straight = _fit(4, pkg="ref")
    _fit(2, ckpt=str(tmp_path), resume="auto", pkg="ref")
    st = CheckpointManager(str(tmp_path)).load_latest()
    jst = JManager(str(tmp_path)).load_latest()
    assert st.global_step == jst.global_step == 8
    for k, v in jst.arg_params().items():
        np.testing.assert_array_equal(st.arg_params()[k], v)
    from mxnet_tpu_torch.optimizer import Updater, create as opt_create

    opt = opt_create("sgd", learning_rate=0.05, momentum=0.9)
    upd = Updater(opt)
    restore_optimizer(upd, opt, st)
    assert sorted(upd.states) == [0, 1, 2, 3]
    assert opt.num_update == 8
    np.testing.assert_array_equal(upd.states[0].asnumpy(),
                                  jst.arrays["opt:0"])
    it = NDArrayIter(np.zeros((32, 6), np.float32), batch_size=8,
                     shuffle=True)
    assert restore_iterator(it, st)
    np.testing.assert_array_equal(it._order, jst.arrays["iter:order"])
    resumed = _fit(4, ckpt=str(tmp_path), resume="auto")
    for n in straight:
        np.testing.assert_allclose(resumed[n], straight[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_feedforward_fit_checkpoint(tmp_path):
    from mxnet_tpu_torch.model import FeedForward

    np.random.seed(7)
    X = np.random.randn(32, 6).astype(np.float32)
    y = np.random.randint(0, 4, 32).astype(np.float32)
    ff = FeedForward(_mlp(), ctx=mx.cpu(), num_epoch=2)
    ff.fit(X, y, checkpoint=str(tmp_path), resume="never")
    assert CheckpointManager(str(tmp_path)).list_steps()
    assert ff.predict(X).shape == (32, 4)


def test_fit_refuses_planes_not_ported():
    it = NDArrayIter(np.zeros((8, 6), np.float32),
                     np.zeros(8, np.float32), batch_size=4)
    mod = Module(_mlp(), context=mx.cpu())
    # the health plane is ported: fit(health=) samples and turns it off
    from mxnet_tpu_torch.obs import health as health_mod

    mon = health_mod.HealthMonitor(every=1)
    mod.fit(it, num_epoch=1, health=mon)
    assert mon.last_report is not None and mon.last_report["ok"]
    assert not health_mod.enabled()
    # monitor= is accepted and never read, as in the reference's fit
    mod.fit(it, num_epoch=1, monitor=object())
    # a store name is accepted, as in the reference's fit (the distributed
    # stores are ported; a plain name leaves the update local)
    mod.fit(it, num_epoch=1, kvstore="dist_sync")
