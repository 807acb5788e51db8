"""The port's data-plane copy tracker (``mxnet_tpu_torch/copytrack.py``)
against the reference's: the NULL contract (zero overhead when off), the
wire framing's counts equal to the reference's for the same numpy arrays,
the batcher's assembly copy, the engine's and the decode step's host
syncs (a read of a card tensor only, so none on the CPU), and
``serve_bench --wire-hop``'s per-request counts."""
import os
import socket
import sys
import threading

import numpy as np
import pytest

from mxnet_tpu import copytrack as jct
from mxnet_tpu.kvstore import ps_server as jps
from mxnet_tpu_torch import copytrack as ct
from mxnet_tpu_torch.kvstore import ps_server as tps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _tracker_off():
    ct.disable()
    jct.disable()
    yield
    ct.disable()
    jct.disable()


def _counts(mod):
    snap = mod.snapshot()
    return {k: v for k, v in snap.items() if k != "hotpath.sync_sites"}


_ARRAYS = [np.arange(12, dtype=np.float32).reshape(3, 4),
           np.arange(5, dtype=np.int32), np.float64(2.5) * np.ones(()),
           np.ones((2, 3, 4), np.float16), np.zeros((0, 3), np.float32)]


class _NoSendmsg:
    """A socket double without ``sendmsg`` (the joined-send path)."""

    def __init__(self):
        self.data = bytearray()

    def sendall(self, b):
        self.data += b


def _framing(ps, arrays):
    """Every framing site once over ``arrays``: packs, unpacks, the sparse
    payload, a send through a socket without ``sendmsg``."""
    for a in arrays:
        ps._unpack_array(memoryview(ps._pack_array(np.ascontiguousarray(a))))
    buf = ps._pack_arrays(arrays)
    outs, _ = ps._unpack_arrays(memoryview(buf))
    for got, want in zip(outs, arrays):
        np.testing.assert_array_equal(got, want)
    ps._unpack_sparse(memoryview(ps._pack_sparse(
        np.array([1, 3], np.int64), np.ones((2, 4), np.float32))))
    ps._send_msg(_NoSendmsg(), 1, "k", [b"ab", memoryview(b"cdef")])


def test_null_contract_when_off():
    assert ct.TRACKER is ct.NULL and not ct.enabled()
    assert ct.snapshot() == {}
    _framing(tps, _ARRAYS)
    assert ct.TRACKER is ct.NULL
    live = ct.enable()
    assert ct.enable() is live  # idempotent, keeps its counters
    ct.disable()
    assert ct.TRACKER is ct.NULL


def test_framing_counts_equal_the_reference():
    ct.enable()
    jct.enable()
    _framing(tps, _ARRAYS)
    _framing(jps, _ARRAYS)
    mine, ref = _counts(ct), _counts(jct)
    assert mine == ref
    assert mine["wire.serialize_calls"] == 2 * len(_ARRAYS) + 2
    assert mine["wire.bytes_copied"] > 0 and mine["hotpath.host_syncs"] == 0
    ct.reset()
    assert _counts(ct)["wire.bytes_copied"] == 0 and ct.enabled()


def test_large_frame_is_received_without_a_reassembly_copy():
    """A frame larger than one ``recv`` goes into one buffer: the port
    counts no reassembly copy where the reference copies the joined
    chunks."""
    a, b = socket.socketpair()
    payload = np.ones(3 << 20, np.uint8)  # 3 MiB, several recv calls
    ct.enable()
    jct.enable()
    for mod, tracker in ((tps, ct), (jps, jct)):
        t = threading.Thread(target=mod._send_msg,
                             args=(a, 1, "k", [payload.data]))
        t.start()
        _op, _key, got = mod._recv_msg(b)
        t.join(timeout=30)
        assert len(got) == payload.nbytes
    assert ct.snapshot()["wire.bytes_copied"] == 0
    assert jct.snapshot()["wire.bytes_copied"] >= payload.nbytes
    a.close()
    b.close()


class _RecordingEngine:
    max_batch_size = 8

    def __init__(self, gate):
        self.gate = gate
        self.rows = []

    def infer(self, inputs, n_valid=None):
        self.gate.wait(10)
        self.rows.append(int(inputs[0].shape[0]))
        return [np.asarray(inputs[0]) * 2], 1


def test_batcher_counts_its_assembly_copy():
    """Requests batched together are concatenated once: the tracker counts
    the batch's bytes, a batch of one request copies nothing."""
    from mxnet_tpu_torch.serve.batcher import DynamicBatcher

    gate = threading.Event()
    eng = _RecordingEngine(gate)
    b = DynamicBatcher(eng, max_linger_ms=0.0)
    ct.enable()
    row = np.ones((1, 6), np.float32)
    try:
        futs = [b.submit([row])]
        # the worker blocks in the first batch while the rest queue up
        futs += [b.submit([row]) for _ in range(5)]
        gate.set()
        for f in futs:
            f.result(timeout=10)
    finally:
        b.close()
    assert sum(eng.rows) == 6
    want = sum(n * row.nbytes for n in eng.rows if n > 1)
    assert want > 0
    assert ct.snapshot()["wire.bytes_copied"] == want


def test_engine_and_decode_count_no_sync_on_the_cpu():
    """A host sync is a read of a card tensor: an engine batch and decode
    steps on the CPU count none (the card test counts one per batch)."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import serve, symbol as sym

    ct.enable()
    with tmx.cpu():
        net = sym.FullyConnected(sym.Variable("data"), num_hidden=4,
                                 no_bias=True, name="fc")
        eng = serve.InferenceEngine(
            net, {"fc_weight": np.eye(4, dtype=np.float32)},
            max_batch_size=4, lint="off", ctx=tmx.cpu())
        outs, _ = eng.infer([np.ones((2, 4), np.float32)])
    np.testing.assert_array_equal(outs[0], np.ones((2, 4), np.float32))
    snap = ct.snapshot()
    assert snap["hotpath.host_syncs"] == 0 and snap["hotpath.sync_sites"] == {}


def test_serve_path_keeps_null_with_tracker_off():
    """The whole wire path (client, server, batcher, engine) with the
    tracker off leaves ``TRACKER is NULL``."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import serve, symbol as sym
    from mxnet_tpu_torch.serve import ServeClient, ServeServer

    with tmx.cpu():
        net = sym.FullyConnected(sym.Variable("data"), num_hidden=4,
                                 no_bias=True, name="fc")
        eng = serve.InferenceEngine(
            net, {"fc_weight": np.eye(4, dtype=np.float32)},
            max_batch_size=4, lint="off", ctx=tmx.cpu())
    srv = ServeServer(eng, port=0, max_linger_ms=0.0)
    srv.start()
    try:
        cli = ServeClient("127.0.0.1", srv.port, timeout=10)
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        np.testing.assert_array_equal(cli.infer(x), x)
        cli.close()
    finally:
        srv.stop()
    assert ct.TRACKER is ct.NULL


def test_serve_bench_wire_hop_reports_counts(capsys):
    """``--wire-hop``: every copy-tracker key is a number, and the tracker
    is off again afterwards."""
    import json

    from mxnet_tpu_torch.tools import serve_bench as tsb

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import serve_bench as jsb

    assert tsb.main(["--wire-hop", "--device", "cpu", "--duration", "0.6",
                     "--clients", "2"]) == 0
    res = json.loads(capsys.readouterr().out)
    want = jsb.run_wire_hop(duration=0.3, clients=2)
    assert set(res) == set(want)
    for k in ("bytes_copied_per_request", "serialize_calls_per_request",
              "host_syncs_per_request", "sync_sites", "bytes_copied_total"):
        assert res[k] is not None, k
    assert res["bytes_copied_per_request"] > 0
    # one request of the mlp's input and one reply, each packed once
    assert res["serialize_calls_per_request"] >= 2
    assert ct.TRACKER is ct.NULL
