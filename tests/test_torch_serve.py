"""The port's batch-serving stack against the reference: ``InferenceEngine``
(bucketing, the program bound, bitwise equality with ``Module.predict`` at
the same bucket, chunking, warmup, hot reload), ``DynamicBatcher`` (linger,
deadlines, priority lanes, shedding, exact splits), ``ServeServer`` /
``ServeClient`` (probes, drain, reload over the wire, streaming), the
artifact loaders, and the wire itself: frames byte-identical with the
reference's for every opcode and array dtype, and reference and port
clients and servers talking to each other in both directions.

The cases of ``tests/test_serve.py`` whose behaviour is ported run here on
the CPU. Left out, as the port's host planes are queue item A15: the
dispatch counter and ``TraceLinter`` proofs of the program bound (the
engine's own accounting is asserted instead), the lint pre-flight's report,
the chaos drop/dup case, and the flagship's chrome trace.

Tolerances: engine outputs are held bitwise to the port's ``Module.predict``
and to exact references (the ``y = scale * x`` model); against the
reference's engine, at rtol 1e-5 / atol 1e-6 (different backends).
"""
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serve as jserve
from mxnet_tpu import symbol as jsym
from mxnet_tpu.kvstore import ps_server as jps

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd, serve
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import NDArrayIter
from mxnet_tpu_torch.kvstore import ps_server as tps
from mxnet_tpu_torch.module import Module
from mxnet_tpu_torch.serve import (DeadlineExceeded, Draining,
                                   DynamicBatcher, InferenceEngine,
                                   RequestRejected, ServeClient, ServeError,
                                   ServeServer, default_buckets)
from mxnet_tpu_torch.serve import server as tsrv

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _linear(S, scale=1.0, dim=4):
    """y = x @ (scale * I): outputs are exactly scale * x."""
    data = S.Variable("data")
    net = S.FullyConnected(data, num_hidden=dim, no_bias=True, name="fc")
    return net, {"fc_weight": np.eye(dim, dtype=np.float32) * scale}


def _linear_engine(scale=1.0, dim=4, max_batch=8, **kw):
    net, arg = _linear(sym, scale, dim)
    return net, arg, InferenceEngine(net, arg, max_batch_size=max_batch,
                                     lint="off", **kw)


def _mlp(S):
    data = S.Variable("data")
    net = S.FullyConnected(data, num_hidden=16, name="fc1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.FullyConnected(net, num_hidden=4, name="fc2")
    net = S.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    arg = {"fc1_weight": rng.randn(16, 6).astype(np.float32) * 0.3,
           "fc1_bias": rng.randn(16).astype(np.float32) * 0.1,
           "fc2_weight": rng.randn(4, 16).astype(np.float32) * 0.3,
           "fc2_bias": np.zeros(4, np.float32)}
    return net, arg


class _FakeEngine:
    """Deterministic, recordable, optionally slow engine for the
    scheduler's tests."""

    def __init__(self, delay=0.0, max_batch_size=8):
        self.delay = delay
        self.max_batch_size = max_batch_size
        self.buckets = default_buckets(max_batch_size)
        self.calls = []  # (rows, t_start)

    def infer(self, inputs, n_valid=None):
        x = inputs[0]
        self.calls.append((int(x.shape[0]), time.monotonic()))
        if self.delay:
            time.sleep(self.delay)
        return [np.asarray(x) * 2.0], 0


# ---------------------------------------------------------------------------
# 1. engine
# ---------------------------------------------------------------------------

def test_default_buckets():
    assert default_buckets(1) == [1]
    assert default_buckets(8) == [1, 2, 4, 8]
    assert default_buckets(24) == [1, 2, 4, 8, 16, 24]
    with pytest.raises(ValueError):
        default_buckets(0)
    for n in (1, 7, 32, 33):
        assert default_buckets(n) == jserve.default_buckets(n)


def test_bucketing_program_count_bound():
    net, arg = _mlp(sym)
    engine = InferenceEngine(net, arg, max_batch_size=8, lint="off")
    rng = np.random.RandomState(1)
    ragged = [3, 1, 5, 2, 8, 7, 4, 6, 3, 1, 5]
    for n in ragged:
        engine.predict(rng.rand(n, 6).astype(np.float32))
    assert engine.num_programs <= len(engine.buckets) == 4
    assert engine.exec_count == len(ragged)
    before = engine.num_programs
    engine.predict(rng.rand(3, 6).astype(np.float32))
    assert engine.num_programs == before
    sigs = [e["sig"] for e in engine.compile_log]
    assert len(sigs) == len(set(sigs)) == engine.num_programs
    assert all(not e["cache_hit"] for e in engine.compile_log)


def test_batched_vs_single_request_bitwise():
    net, arg = _mlp(sym)
    engine = InferenceEngine(net, arg, buckets=(8,), lint="off")
    x = np.random.RandomState(2).rand(6, 6).astype(np.float32)
    batched = engine.predict(x)
    for i in range(6):
        assert np.array_equal(engine.predict(x[i:i + 1])[0], batched[i])
    assert engine.num_programs == 1


def test_engine_oversize_request_chunks():
    net, arg = _mlp(sym)
    engine = InferenceEngine(net, arg, max_batch_size=4, lint="off")
    x = np.random.RandomState(3).rand(11, 6).astype(np.float32)
    out = engine.predict(x)
    assert out.shape == (11, 4)
    assert np.array_equal(out[:4], engine.predict(x[:4]))
    assert engine.num_programs <= len(engine.buckets)


def test_engine_warmup_precompiles_every_bucket():
    net, arg = _mlp(sym)
    engine = InferenceEngine(net, arg, max_batch_size=8, lint="off")
    compiled = engine.warmup((6,))
    assert compiled == len(engine.buckets) == engine.num_programs
    assert engine.warmup((6,)) == 0
    engine.predict(np.zeros((5, 6), np.float32))
    assert engine.num_programs == compiled


def test_engine_lint_preflight_names_a15():
    net, arg = _mlp(sym)
    with pytest.warns(UserWarning, match="A15"):
        engine = InferenceEngine(net, arg, max_batch_size=2, lint="warn")
    assert engine.lint_report is None
    with pytest.raises(MXNetError, match="A15"):
        InferenceEngine(net, arg, lint="error")
    with pytest.raises(ValueError):
        InferenceEngine(net, arg, lint="loud")


@pytest.mark.parametrize("kw,item", [({"mesh": object()}, "A14"),
                                     ({"rules": object()}, "A14"),
                                     ({"data_spec": object()}, "A14"),
                                     ({"progcache_dir": "x"}, "A15")])
def test_engine_later_items_raise(kw, item):
    net, arg = _mlp(sym)
    with pytest.raises(MXNetError, match=item):
        InferenceEngine(net, arg, lint="off", **kw)


def test_programs_shipping_names_a15():
    _net, _arg, engine = _linear_engine()
    for call in (lambda: engine.save_programs("d"),
                 lambda: serve.ship_programs(engine, "p"),
                 lambda: serve.programs_dir_for("p")):
        with pytest.raises(MXNetError, match="A15"):
            call()


def test_engine_rejects_missing_aux():
    data = sym.Variable("data")
    net = sym.BatchNorm(sym.FullyConnected(data, num_hidden=4, name="fc"),
                        name="bn")
    rng = np.random.RandomState(0)
    arg = {"fc_weight": rng.randn(4, 6).astype(np.float32),
           "fc_bias": np.zeros(4, np.float32),
           "bn_gamma": np.ones(4, np.float32),
           "bn_beta": np.zeros(4, np.float32)}
    with pytest.raises(ServeError, match="aux"):
        InferenceEngine(net, arg, lint="off")


def test_engine_rejects_missing_weights():
    net, arg = _mlp(sym)
    bad = dict(arg)
    del bad["fc2_weight"]
    with pytest.raises(ServeError, match="fc2_weight"):
        InferenceEngine(net, bad, lint="off")


@pytest.mark.parametrize("n", [1, 3, 4, 6, 9])
def test_engine_matches_reference_engine(n):
    net, arg = _mlp(sym)
    jnet, jarg = _mlp(jsym)
    engine = InferenceEngine(net, arg, buckets=(2, 4, 8), lint="off")
    jengine = jserve.InferenceEngine(jnet, jarg, buckets=(2, 4, 8),
                                     lint="off")
    x = np.random.RandomState(20 + n).rand(n, 6).astype(np.float32)
    (t,), tv = engine.infer([x])
    (j,), jv = jengine.infer([x])
    assert tv == jv == 0 and t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    assert engine.bucket_for(n) == jengine.bucket_for(n)


def test_engine_pads_with_pad_value_and_keeps_valid_rows():
    net, arg = _mlp(sym)
    e0 = InferenceEngine(net, arg, buckets=(8,), lint="off")
    e1 = InferenceEngine(net, arg, buckets=(8,), lint="off", pad_value=7.5)
    x = np.random.RandomState(5).rand(3, 6).astype(np.float32)
    assert np.array_equal(e0.predict(x), e1.predict(x))


# ---------------------------------------------------------------------------
# 2. batcher
# ---------------------------------------------------------------------------

def test_batcher_linger_coalesces_requests():
    fake = _FakeEngine()
    b = DynamicBatcher(fake, max_linger_ms=120.0, max_queue=64)
    try:
        futs = [b.submit(np.full((1, 3), i, np.float32)) for i in range(4)]
        outs = [f.result(timeout=5)[0][0] for f in futs]
    finally:
        b.close()
    assert [rows for rows, _t in fake.calls] == [4]
    for i, o in enumerate(outs):
        assert np.array_equal(o, np.full((1, 3), 2.0 * i))


def test_deadline_expired_requests_shed_not_executed():
    fake = _FakeEngine(delay=0.3)
    b = DynamicBatcher(fake, max_linger_ms=0.0, max_queue=64)
    try:
        slow = b.submit(np.ones((2, 3), np.float32))
        time.sleep(0.05)
        doomed = b.submit(np.ones((1, 3), np.float32), deadline_ms=100)
        slow.result(timeout=5)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=5)
    finally:
        b.close()
    assert [rows for rows, _t in fake.calls] == [2]
    assert b.stats()["shed_by_reason"]["deadline"] == 1
    with pytest.raises(DeadlineExceeded):
        DynamicBatcher(_FakeEngine(), max_linger_ms=0).submit(
            np.ones((1, 3), np.float32), deadline_ms=-1.0)


def test_tight_deadline_joining_mid_linger_caps_the_linger():
    fake = _FakeEngine(max_batch_size=8)
    b = DynamicBatcher(fake, max_linger_ms=500.0, max_queue=64)
    t0 = time.monotonic()
    try:
        a = b.submit(np.ones((1, 3), np.float32))
        time.sleep(0.05)
        tight = b.submit(np.ones((1, 3), np.float32), deadline_ms=100)
        a.result(timeout=5)
        try:
            tight.result(timeout=5)
            assert time.monotonic() - t0 <= 0.25, \
                "tight request executed long past its deadline"
        except DeadlineExceeded:
            pass  # shed at the dispatch re-check: also within contract
    finally:
        b.close()
    assert fake.calls and fake.calls[0][1] - t0 < 0.35


def test_priority_lane_beats_bulk_backlog():
    fake = _FakeEngine(delay=0.15, max_batch_size=2)
    b = DynamicBatcher(fake, max_batch_size=2, max_linger_ms=0.0,
                       max_queue=64)
    try:
        first = b.submit(np.full((2, 3), -1, np.float32), priority=1)
        time.sleep(0.05)
        bulk = [b.submit(np.full((2, 3), i, np.float32), priority=1)
                for i in range(4)]
        urgent = b.submit(np.full((1, 3), 99, np.float32), priority=0)
        for f in [first, urgent] + bulk:
            f.result(timeout=10)
    finally:
        b.close()
    rows = [r for r, _t in fake.calls]
    assert rows[0] == 2 and rows[1] == 1, rows


def test_queue_watermark_load_shedding():
    fake = _FakeEngine(delay=0.3)
    b = DynamicBatcher(fake, max_linger_ms=0.0, max_queue=3)
    try:
        b.submit(np.ones((1, 3), np.float32))
        time.sleep(0.05)
        kept = [b.submit(np.ones((1, 3), np.float32)) for _ in range(3)]
        with pytest.raises(RequestRejected):
            b.submit(np.ones((1, 3), np.float32))
        st = b.stats()
        assert st["shed"] == 1 and st["shed_by_reason"]["queue_full"] == 1
        for f in kept:
            f.result(timeout=5)
    finally:
        b.close()
    assert b.stopped_clean


def test_batcher_splits_results_exactly():
    net, arg = _mlp(sym)
    engine = InferenceEngine(net, arg, buckets=(8,), lint="off")
    b = DynamicBatcher(engine, max_linger_ms=80.0)
    rng = np.random.RandomState(4)
    xs = [rng.rand(n, 6).astype(np.float32) for n in (1, 3, 2)]
    try:
        outs = [f.result(timeout=10) for f in [b.submit(x) for x in xs]]
    finally:
        b.close()
    for x, (o, _version) in zip(xs, outs):
        assert np.array_equal(o[0], engine.predict(x))


def test_batcher_draining_refuses_and_counts():
    b = DynamicBatcher(_FakeEngine(), max_linger_ms=0.0)
    assert b.drain(timeout=5)
    with pytest.raises(Draining):
        b.submit(np.ones((1, 3), np.float32))
    assert b.stats()["shed_by_reason"]["draining"] == 1
    b.close()
    with pytest.raises(ServeError, match="closed"):
        b.submit(np.ones((1, 3), np.float32))


# ---------------------------------------------------------------------------
# 3. hot reload
# ---------------------------------------------------------------------------

def test_hot_reload_old_or_new_never_mixed():
    _net, _arg, engine = _linear_engine(scale=1.0)
    engine.warmup((4,))
    scales = [1.0, 3.0]
    stop = threading.Event()
    bad = []
    rng = np.random.RandomState(5)
    xs = [rng.rand(n, 4).astype(np.float32) for n in (1, 2, 3, 4)]
    expected = {s: [x * np.float32(s) for x in xs] for s in scales}

    def traffic():
        i = 0
        while not stop.is_set():
            k = i % len(xs)
            out, ver = engine.infer([xs[k]])
            if not any(np.array_equal(out[0], expected[s][k])
                       for s in scales):
                bad.append((k, ver))
                return
            i += 1

    threads = [threading.Thread(target=traffic) for _ in range(4)]
    for t in threads:
        t.start()
    for gen in range(1, 9):
        engine.reload({"fc_weight": np.eye(4, dtype=np.float32)
                       * np.float32(scales[gen % 2])})
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not bad, bad[0]
    assert engine.version == 8
    assert engine.num_programs == len(engine.buckets)


def test_reload_rejects_aval_drift():
    _net, _arg, engine = _linear_engine(scale=1.0)
    with pytest.raises(ServeError, match="aval mismatch"):
        engine.reload({"fc_weight": np.eye(5, dtype=np.float32)})
    with pytest.raises(ServeError, match="missing"):
        engine.reload({})
    assert engine.version == 0


def test_two_phase_reload():
    _net, _arg, engine = _linear_engine(scale=1.0)
    x = np.ones((1, 4), np.float32)
    v = engine.prepare_reload({"fc_weight": np.eye(4, dtype=np.float32)
                               * 2}, version=7)
    assert v == 7 and engine.stats()["staged_version"] == 7
    assert np.array_equal(engine.predict(x), x)  # staged, not serving
    assert engine.commit_reload() == 7
    assert np.array_equal(engine.predict(x), 2 * x)
    with pytest.raises(ServeError, match="no prepared"):
        engine.commit_reload()
    engine.prepare_reload({"fc_weight": np.eye(4, dtype=np.float32)})
    engine.abort_reload()
    engine.abort_reload()
    assert engine.version == 7 and engine.stats()["staged_version"] is None


def test_engine_owns_its_parameters():
    w = nd.array(np.eye(4, dtype=np.float32))
    net, _ = _linear(sym)
    engine = InferenceEngine(net, {"fc_weight": w}, lint="off")
    w[:] = 5.0
    x = np.ones((2, 4), np.float32)
    assert np.array_equal(engine.predict(x), x)


# ---------------------------------------------------------------------------
# 4. endpoint
# ---------------------------------------------------------------------------

def test_server_probes_drain_lifecycle():
    _net, _arg, engine = _linear_engine(scale=2.0)
    srv = ServeServer(engine, port=0, max_linger_ms=0.5)
    srv.start()
    cli = ServeClient("127.0.0.1", srv.port, retries=2)
    try:
        assert cli.health() and cli.ready()
        assert cli.ready_version() == (True, 0)
        x = np.ones((2, 4), np.float32)
        assert np.array_equal(cli.infer(x, deadline_ms=5000), x * 2.0)
        st = cli.stats()
        assert st["engine"]["executions"] >= 1
        assert st["batcher"]["completed"] >= 1
        assert "shed_by_reason" in st["batcher"] and "metrics" not in st
        assert cli.drain()
        assert cli.health() and not cli.ready()
        with pytest.raises(Draining):
            cli.infer(x)
    finally:
        try:
            cli.shutdown()
        except ServeError:
            pass
        cli.close()
        srv.stop()


def test_telemetry_and_dump_name_a15():
    _net, _arg, engine = _linear_engine()
    srv = ServeServer(engine, port=0)
    srv.start()
    cli = ServeClient("127.0.0.1", srv.port)
    try:
        with pytest.raises(ServeError, match="A15"):
            cli.telemetry()
        with pytest.raises(ServeError, match="A15"):
            cli.dump()
        assert cli.health()  # the connection survives the error replies
    finally:
        cli.close()
        srv.stop()


def test_traceparent_key_is_accepted_and_ignored():
    _net, _arg, engine = _linear_engine(scale=2.0)
    srv = ServeServer(engine, port=0)
    srv.start()
    try:
        with socket.create_connection(("127.0.0.1", srv.port)) as s:
            x = np.ones((1, 4), np.float32)
            key = "\x1f00-" + "1" * 32 + "-" + "2" * 16 + "-01"
            tps._send_msg(s, tsrv.OP_INFER, key,
                          tsrv._INFER_HDR.pack(0.0, 1)
                          + tps._pack_arrays([x]))
            op, _k, payload = tps._recv_msg(s)
            assert op == tsrv.OP_INFER and payload[0] == tsrv.STATUS_OK
            outs, _ = tps._unpack_arrays(payload[5:])
            assert np.array_equal(outs[0], 2 * x)
            tps._send_msg(s, 99, "", b"")
            op, _k, payload = tps._recv_msg(s)
            assert payload[0] == tsrv.STATUS_BAD_REQUEST
    finally:
        srv.stop()


def _save_mlp_checkpoints(prefix, S=sym, save=None):
    from mxnet_tpu_torch.model import save_checkpoint

    net, arg = _mlp(S)
    save = save or save_checkpoint
    wrap = nd.array if save is save_checkpoint else jmx.nd.array
    save(prefix, 0, net, {k: wrap(v) for k, v in arg.items()}, {})
    arg2 = {k: v + np.float32(0.25) for k, v in arg.items()}
    save(prefix, 1, net, {k: wrap(v) for k, v in arg2.items()}, {})
    return net, arg, arg2


def test_server_hot_reload_over_the_wire(tmp_path):
    prefix = str(tmp_path / "m")
    _save_mlp_checkpoints(prefix)
    engine = serve.load(prefix, epoch=0, max_batch_size=4, lint="off")
    srv = ServeServer(engine, port=0, max_linger_ms=0.0)
    srv.start()
    cli = ServeClient("127.0.0.1", srv.port)
    x = np.random.RandomState(8).rand(2, 6).astype(np.float32)
    try:
        out0, v0 = cli.infer(x, return_version=True)
        assert v0 == 0
        assert cli.reload(prefix, epoch=1) == 1
        out1, v1 = cli.infer(x, return_version=True)
        assert v1 == 1 and not np.array_equal(out0, out1)
        direct = serve.load(prefix, epoch=1, max_batch_size=4,
                            lint="off").predict(x)
        assert np.array_equal(out1, direct)
        tok = (3, 9)
        assert cli.prepare_reload(prefix, epoch=0, version=5,
                                  token=tok) == 5
        assert cli.commit_reload(tok) == 5
        assert cli.commit_reload(tok) == 5  # retried frame: re-ack
        out2, v2 = cli.infer(x, return_version=True)
        assert v2 == 5 and np.array_equal(out2, out0)
        cli.abort_reload(tok)
        with pytest.raises(ServeError):
            cli.reload(str(tmp_path / "missing"), epoch=0)
    finally:
        cli.close()
        srv.stop()


def test_serve_load_checkpoint_dir_and_symbol_required(tmp_path):
    net, _arg = _mlp(sym)
    ckdir = str(tmp_path / "ck")
    rng = np.random.RandomState(9)
    x = rng.rand(8, 6).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    mod = Module(net, data_names=("data",), label_names=("softmax_label",),
                 context=tmx.cpu())
    mod.fit(NDArrayIter(x, y, batch_size=4), num_epoch=1,
            optimizer_params={"learning_rate": 0.1}, checkpoint=ckdir)
    with pytest.raises(ServeError, match="symbol"):
        serve.load(ckdir)
    engine = serve.load(ckdir, symbol=net, max_batch_size=4, lint="off")
    ref = mod.predict(NDArrayIter(x[:3], None, batch_size=3)).asnumpy()
    assert np.array_equal(engine.predict(x[:3]), ref)
    arg, aux = serve.load_params(ckdir)
    assert set(arg) >= {"fc1_weight", "fc2_bias"} and aux == {}


def test_gluon_export_serves_bitwise(tmp_path):
    from mxnet_tpu_torch import gluon

    tmx.random.seed(10)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(12, activation="relu"), gluon.nn.Dense(3))
    net.initialize(ctx=tmx.cpu())
    x = np.random.RandomState(10).rand(5, 7).astype(np.float32)
    ref = net(nd.array(x)).asnumpy()
    path = str(tmp_path / "dense")
    net.export(path, epoch=0)
    with open(f"{path}-symbol.json") as f:
        meta = json.load(f)
    assert "symbol" in meta and "param_map" in meta
    engine = serve.load(path, epoch=0, max_batch_size=8, lint="off")
    assert np.array_equal(engine.predict(x), ref)


def test_symbol_json_roundtrip_preserves_aux_states(tmp_path):
    data = sym.Variable("data")
    net = sym.BatchNorm(sym.Convolution(data, num_filter=4, kernel=(3, 3),
                                        pad=(1, 1), name="c"), name="bn")
    net = sym.SoftmaxOutput(sym.FullyConnected(sym.Flatten(net),
                                               num_hidden=3, name="fc"),
                            name="softmax")
    loaded = tmx.sym.load_json(net.tojson())
    assert loaded.list_auxiliary_states() == net.list_auxiliary_states()
    assert loaded.list_arguments() == net.list_arguments()
    rng = np.random.RandomState(11)
    x = rng.rand(8, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    mod = Module(net, data_names=("data",), label_names=("softmax_label",),
                 context=tmx.cpu())
    mod.fit(NDArrayIter(x, y, batch_size=4), num_epoch=1,
            optimizer_params={"learning_rate": 0.05})
    prefix = str(tmp_path / "bn")
    mod.save_checkpoint(prefix, 1)
    engine = serve.load(prefix, epoch=1, buckets=(4,), lint="off")
    ref = mod.predict(NDArrayIter(x[:4], None, batch_size=4)).asnumpy()
    assert np.array_equal(engine.predict(x[:4]), ref)


def test_serve_flagship_end_to_end(tmp_path):
    """A model-zoo CNN, 2 training batches, checkpoint, serve.load,
    concurrent mixed-shape clients: outputs bitwise equal to
    Module.predict at the bucket each request ran in, programs <= buckets."""
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    tmx.random.seed(7)
    classes, img = 4, 16
    zoo = get_model("resnet18_v1", classes=classes, thumbnail=True)
    net = sym.SoftmaxOutput(zoo(sym.Variable("data")), name="softmax")
    rng = np.random.RandomState(7)
    x = rng.rand(8, 3, img, img).astype(np.float32)
    y = rng.randint(0, classes, 8).astype(np.float32)
    mod = Module(net, data_names=("data",), label_names=("softmax_label",),
                 context=tmx.cpu())
    mod.fit(NDArrayIter(x, y, batch_size=4), num_epoch=1,
            optimizer_params={"learning_rate": 0.05})
    prefix = str(tmp_path / "cnn")
    mod.save_checkpoint(prefix, 1)
    engine = serve.load(prefix, epoch=1, buckets=(2, 4), lint="off")
    srv = ServeServer(engine, port=0, max_linger_ms=1.0)
    srv.start()
    qx = rng.rand(14, 3, img, img).astype(np.float32)
    ref = {b: mod.predict(NDArrayIter(qx, None, batch_size=b)).asnumpy()
           for b in (2, 4)}
    sizes = [1, 2, 3, 4, 1, 3]
    offsets = np.cumsum([0] + sizes)
    results, errors = {}, []

    def client_thread(i):
        try:
            cli = ServeClient("127.0.0.1", srv.port)
            lo = offsets[i]
            results[i] = cli.infer(qx[lo:lo + sizes[i]], deadline_ms=60000,
                                   priority=i % 2, return_version=True)
            cli.close()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client_thread, args=(i,))
               for i in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    srv.stop()
    assert not errors, errors
    for i, size in enumerate(sizes):
        out, ver = results[i]
        lo = offsets[i]
        assert ver == 0
        assert any(np.array_equal(out, ref[b][lo:lo + size])
                   for b in (2, 4)), i
    assert engine.num_programs <= len(engine.buckets) == 2


# ---------------------------------------------------------------------------
# 5. the wire: frames, dtypes, and cross-package interoperation
# ---------------------------------------------------------------------------

def _bf16_ref(bits):
    import ml_dtypes

    return bits.view(ml_dtypes.bfloat16)


_WIRE_DTYPES = ["float32", "float64", "float16", "uint8", "int32", "int8",
                "int64", "bool", "int16", "uint16", "uint32", "uint64",
                "bfloat16"]


@pytest.mark.parametrize("dt", _WIRE_DTYPES)
def test_array_frames_are_byte_identical_per_dtype(dt):
    rng = np.random.RandomState(_WIRE_DTYPES.index(dt))
    if dt == "bfloat16":
        bits = rng.randint(0, 1 << 15, (2, 3)).astype(np.uint16)
        ref_arr = _bf16_ref(bits)
        port_arr = torch.from_numpy(bits.astype(np.int16)).view(
            torch.bfloat16)
    else:
        ref_arr = (rng.rand(2, 3) * 100).astype(dt)
        port_arr = ref_arr
    ref = jps._pack_arrays([ref_arr, ref_arr[:1]])
    got = tps._pack_arrays([port_arr, port_arr[:1]])
    assert got == ref
    back, n = tps._unpack_arrays(memoryview(ref))
    assert n == len(ref)
    if dt == "bfloat16":
        assert back[0].dtype == torch.bfloat16
        assert np.array_equal(back[0].view(torch.int16).numpy(),
                              bits.astype(np.int16))
    else:
        assert back[0].dtype == np.dtype(dt)
        assert np.array_equal(back[0], ref_arr)
    rback, _ = jps._unpack_arrays(memoryview(got))
    assert np.array_equal(np.asarray(rback[0]).view(np.uint8),
                          np.asarray(ref_arr).view(np.uint8))


def test_zero_dim_and_empty_arrays_pack_identically():
    for a in (np.float32(3.5).reshape(()), np.zeros((0, 4), np.int32)):
        assert tps._pack_arrays([a]) == jps._pack_arrays([a])


def _capture_request(mod, call, reply_frames):
    """The frame ``call(client)`` puts on the wire, captured from a
    socketpair whose far end answers with ``reply_frames``."""
    a, b = socket.socketpair()
    cli = mod.ServeClient("127.0.0.1", 1, retries=1)
    cli._sock = a
    got = {}

    def far():
        (ln,) = struct.unpack("<I", jps._recv_exact(b, 4))
        got["frame"] = struct.pack("<I", ln) + jps._recv_exact(b, ln)
        for f in reply_frames:
            b.sendall(f)

    t = threading.Thread(target=far)
    t.start()
    try:
        res = call(cli)
        if hasattr(res, "__next__"):
            res = list(res)
    finally:
        t.join(timeout=10)
        a.close()
        b.close()
    return got["frame"], res


def _frame(opcode, payload=b""):
    return struct.pack("<IBH", 3 + len(payload), opcode, 0) + payload


_X = np.arange(8, dtype=np.float32).reshape(2, 4)
_OK = struct.pack("<B", 0)
_REQUESTS = {
    "infer": (lambda c: c.infer(_X, deadline_ms=250.0, priority=0),
              [_frame(32, struct.pack("<BI", 0, 3)
                      + jps._pack_arrays([_X]))]),
    "health": (lambda c: c.health(), [_frame(33, _OK)]),
    "ready": (lambda c: c.ready_version(),
              [_frame(34, struct.pack("<BI", 0, 4))]),
    "reload": (lambda c: c.reload("/ckpt/m", epoch=2, prefix="m"),
               [_frame(35, struct.pack("<BI", 0, 1))]),
    "stats": (lambda c: c.stats(), [_frame(36, _OK + b'{"a": 1}')]),
    "stats_no_metrics": (lambda c: c.stats(include_metrics=False),
                         [_frame(36, _OK + b"{}")]),
    "drain": (lambda c: c.drain(stop=True), [_frame(37, _OK)]),
    "shutdown": (lambda c: c.shutdown(), [_frame(38, _OK)]),
    "prepare_reload": (lambda c: c.prepare_reload(
        "/ckpt/m", epoch=1, version=6, token=(7, 8)),
        [_frame(39, struct.pack("<BI", 0, 6))]),
    "commit_reload": (lambda c: c.commit_reload((7, 8)),
                      [_frame(40, struct.pack("<BI", 0, 6))]),
    "abort_reload": (lambda c: c.abort_reload((7, 8)), [_frame(41, _OK)]),
    "dump": (lambda c: c.dump(reason="probe"), [_frame(43, _OK + b"{}")]),
    "infer_stream": (lambda c: c.generate([5, 6, 7], max_new_tokens=2,
                                          deadline_ms=900.0, priority=0),
                     [_frame(45, struct.pack("<II", 11, 1)),
                      _frame(45, struct.pack("<II", 12, 2)),
                      _frame(46, struct.pack("<BI", 0, 2))]),
}


@pytest.mark.parametrize("op", sorted(_REQUESTS))
def test_client_request_frames_are_byte_identical(op):
    call, replies = _REQUESTS[op]
    ref_frame, ref_res = _capture_request(jserve, call, replies)
    port_frame, port_res = _capture_request(serve, call, replies)
    assert port_frame == ref_frame
    if isinstance(ref_res, np.ndarray):
        assert np.array_equal(ref_res, port_res)
    else:
        assert ref_res == port_res


def test_telemetry_request_frame_matches_but_the_token():
    call = lambda c: c.telemetry()  # noqa: E731
    replies = [_frame(42, _OK + b'{"parts": []}')]
    ref_frame, ref_res = _capture_request(jserve, call, replies)
    port_frame, port_res = _capture_request(serve, call, replies)
    assert ref_res == port_res == {"parts": []}
    ref_spec, port_spec = (json.loads(f[7:]) for f in (ref_frame,
                                                        port_frame))
    assert ref_spec.pop("token") != port_spec.pop("token")
    assert ref_spec == port_spec
    assert ref_frame[:7] == port_frame[:7]


def _raw_exchange(port, frames):
    out = []
    with socket.create_connection(("127.0.0.1", port)) as s:
        for f in frames:
            s.sendall(f)
            (ln,) = struct.unpack("<I", jps._recv_exact(s, 4))
            out.append(struct.pack("<I", ln) + jps._recv_exact(s, ln))
    return out


def test_server_reply_frames_are_byte_identical():
    jnet, jarg = _linear(jsym, scale=2.0)
    tnet, targ = _linear(sym, scale=2.0)
    jeng = jserve.InferenceEngine(jnet, jarg, max_batch_size=4, lint="off")
    teng = InferenceEngine(tnet, targ, max_batch_size=4, lint="off")
    x = np.random.RandomState(14).rand(3, 4).astype(np.float32)
    frames = [
        _frame(32, tsrv._INFER_HDR.pack(0.0, 1) + jps._pack_arrays([x])),
        _frame(33), _frame(34),
        _frame(40, struct.pack("<QQ", 1, 2)),
        _frame(41, struct.pack("<QQ", 1, 2)),
        _frame(37, struct.pack("<B", 0)), _frame(34),
        _frame(32, tsrv._INFER_HDR.pack(0.0, 1) + jps._pack_arrays([x])),
    ]
    replies = []
    for mod, eng in ((jserve, jeng), (serve, teng)):
        srv = mod.ServeServer(eng, port=0, max_linger_ms=0.0)
        srv.start()
        try:
            replies.append(_raw_exchange(srv.port, frames))
        finally:
            srv.stop()
    ref, got = replies
    for i in (0, 1, 2, 4, 5, 6, 7):
        assert got[i] == ref[i], i
    # a commit with nothing staged is an error status on both
    assert got[3][7] == ref[3][7] == tsrv.STATUS_INTERNAL


@pytest.fixture(scope="module")
def tiny_lm():
    from mxnet_tpu.models import transformer as jt

    jmx.random.seed(20261017)
    lm = jt.transformer_lm(vocab_size=97, units=32, hidden_size=64,
                           num_layers=2, num_heads=4, max_length=64,
                           dropout=0.0)
    lm.initialize()
    lm(jmx.nd.zeros((1, 8)))
    return lm, jt.decode_config(lm), jt.decode_params(lm)


_DECODE = dict(slots=4, page_size=8, num_pages=16, prompt_buckets=[8, 16])


def _port_decode(tiny_lm):
    _lm, cfg, params = tiny_lm
    eng = serve.DecodeEngine(cfg, params, device="cpu", **_DECODE)
    eng.warmup()
    return eng, serve.DecodeScheduler(eng, max_new_tokens=5)


def _ref_decode(tiny_lm):
    lm, _cfg, _params = tiny_lm
    eng = jserve.DecodeEngine(lm, **_DECODE)
    eng.warmup()
    return eng, jserve.DecodeScheduler(eng, max_new_tokens=5)


def _exercise(cli_mod, port, prompt, prefix, x, expect):
    """Infer, ready, stats, reload, a greedy stream and drain through a
    ``cli_mod`` client; returns the streamed tokens."""
    cli = cli_mod.ServeClient("127.0.0.1", port)
    try:
        assert cli.health() and cli.ready()
        out, ver = cli.infer(x, return_version=True)
        assert ver == 0
        np.testing.assert_allclose(out, expect(0), rtol=1e-5, atol=1e-6)
        st = cli.stats()
        assert st["batcher"]["completed"] >= 1 and "decode" in st
        assert cli.reload(prefix, epoch=1) == 1
        out, ver = cli.infer(x, return_version=True)
        assert ver == 1
        np.testing.assert_allclose(out, expect(1), rtol=1e-5, atol=1e-6)
        toks = list(cli.generate(prompt, max_new_tokens=5))
        assert cli.drain() and not cli.ready()
        return toks
    finally:
        cli.close()


def test_reference_client_against_port_server(tmp_path, tiny_lm):
    prefix = str(tmp_path / "m")
    _net, arg, arg2 = _save_mlp_checkpoints(prefix)
    jnet, _ = _mlp(jsym)
    jeng = jserve.InferenceEngine(jnet, arg, max_batch_size=4, lint="off")
    x = np.random.RandomState(15).rand(3, 6).astype(np.float32)
    ref_out = {0: jeng.predict(x)}
    jeng.reload(arg2)
    ref_out[1] = jeng.predict(x)
    engine = serve.load(prefix, epoch=0, max_batch_size=4, lint="off")
    _deng, sched = _port_decode(tiny_lm)
    prompt = np.arange(1, 10, dtype=np.int32)
    want = list(sched.generate(prompt, max_new_tokens=5))
    srv = ServeServer(engine, port=0, decode=sched, max_linger_ms=0.0)
    srv.start()
    try:
        toks = _exercise(jserve, srv.port, prompt, prefix, x,
                         ref_out.__getitem__)
    finally:
        srv.stop()
    assert toks == want and len(toks) == 5


def test_port_client_against_reference_server(tmp_path, tiny_lm):
    from mxnet_tpu.model import save_checkpoint as jsave

    prefix = str(tmp_path / "m")
    jnet, arg, arg2 = _save_mlp_checkpoints(prefix, S=jsym, save=jsave)
    tnet, _ = _mlp(sym)
    teng = InferenceEngine(tnet, arg, max_batch_size=4, lint="off")
    x = np.random.RandomState(16).rand(3, 6).astype(np.float32)
    port_out = {0: teng.predict(x)}
    teng.reload(arg2)
    port_out[1] = teng.predict(x)
    jeng = jserve.load(prefix, epoch=0, max_batch_size=4, lint="off")
    _deng, jsched = _ref_decode(tiny_lm)
    _pdeng, psched = _port_decode(tiny_lm)
    prompt = np.arange(3, 12, dtype=np.int32)
    want = list(psched.generate(prompt, max_new_tokens=5))
    psched.close()
    srv = jserve.ServeServer(jeng, port=0, decode=jsched, max_linger_ms=0.0)
    srv.start()
    try:
        toks = _exercise(serve, srv.port, prompt, prefix, x,
                         port_out.__getitem__)
    finally:
        srv.stop()
    assert toks == want and len(toks) == 5


def test_streaming_lane_over_the_wire_reclaims_pages(tiny_lm):
    deng, sched = _port_decode(tiny_lm)
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (3, 9, 13)]
    want = [list(sched.generate(p, max_new_tokens=4)) for p in prompts]
    srv = ServeServer(decode=sched, port=0)
    srv.start()
    got = [None] * len(prompts)

    def stream(i):
        cli = ServeClient("127.0.0.1", srv.port)
        got[i] = list(cli.generate(prompts[i], max_new_tokens=4))
        cli.close()

    threads = [threading.Thread(target=stream, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    cli = ServeClient("127.0.0.1", srv.port)
    try:
        assert cli.ready()
        gen = cli.generate(prompts[0], max_new_tokens=4)
        next(gen)
        gen.close()  # hang up mid-stream: the server cancels it
        with pytest.raises(ServeError):
            cli.infer(np.ones((1, 4), np.float32))  # no batch engine
    finally:
        cli.close()
        srv.stop()
    assert got == want
    deng.pool.assert_baseline()
