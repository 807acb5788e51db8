"""The port's parameter server and client (mxnet_tpu_torch.kvstore.
ps_server / ps_client / elastic.PushWAL) against the JAX package's, on the
CPU, over loopback sockets.

- One scripted session of raw frames (init, seq and plain pushes, a
  code-16 push, pulls, sparse push and pull, rejected frames, the
  idempotent barrier, the clocks, a staleness-gated pull, the text
  SET_OPT and an SGD push) gets byte-identical replies from the
  reference's server and the port's; the port's client drives the
  reference's server and the reference's client the port's, with the same
  results (bitwise: every value is exact in f32).
- The native server, built from ``native/ps/ps_server.cc`` into
  ``build/mxnet_tpu_torch/``, gives the same replies for the frames it
  speaks.
- A WAL (and a snapshot) the reference's server wrote replays in the
  port's server to the same weights; a torn WAL tail is truncated.
- The port refuses the legacy pickle SET_OPT blob with an error reply;
  OP_TELEMETRY answers with the server's part, and STATS carries the
  fleet and hot-key sections.
"""
import os
import pickle
import socket
import struct
import subprocess
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.kvstore import ps_client as jpc
from mxnet_tpu.kvstore import ps_server as jps
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, native
from mxnet_tpu_torch.kvstore import elastic as tel
from mxnet_tpu_torch.kvstore import ps_client as tpc
from mxnet_tpu_torch.kvstore import ps_server as tps
from mxnet_tpu_torch.kvstore.compression import GradientCompression

_CID = 0x1234_5678_9ABC_DEF0


def _f32(*shape, val=None, seed=0):
    if val is not None:
        return np.full(shape, val, np.float32)
    # small integers: every sum and SGD step below is exact in f32
    return np.random.RandomState(seed).randint(-4, 5, shape).astype(
        np.float32)


def _script():
    """(opcode, key, payload) frames of one session; ``tps`` packs them
    (the framing is byte-identical with the reference's)."""
    P = tps._pack_array
    seq = lambda s, body: struct.pack("<QQ", _CID, s) + body  # noqa: E731
    idx = np.array([3, 0], np.int32)
    rows = _f32(2, 4, seed=2)
    frames = [
        (tps.OP_INIT, "w", P(_f32(3, 4, seed=1))),
        (tps.OP_INIT, "w", P(_f32(3, 4, val=9.0))),     # first init wins
        (tps.OP_INIT, "emb", P(_f32(5, 4, seed=3))),
        (tps.OP_INIT, "i", P(np.arange(6, dtype=np.int32))),
        (tps.OP_PULL, "w", b""),
        (tps.OP_PULL, "i", b""),
        (tps.OP_PUSH_SEQ, "w", seq(1, P(_f32(3, 4, seed=4)))),
        (tps.OP_PUSH_SEQ, "w", seq(1, P(_f32(3, 4, seed=5)))),  # a retry
        (tps.OP_PUSH_SEQ, "w", seq(2, GradientCompression(0.5).pack_wire(
            "w", _f32(3, 4, seed=6)))),                  # code 16
        (tps.OP_PUSH, "w", P(_f32(3, 4, val=1.0))),
        (tps.OP_PULL, "w", b""),
        (tps.OP_PUSH_SEQ, "nokey", seq(3, P(_f32(2, val=1.0)))),
        (tps.OP_PUSH_SPARSE_SEQ, "emb", seq(4, tps._pack_sparse(idx, rows))),
        (tps.OP_PUSH_SPARSE_SEQ, "emb", seq(4, tps._pack_sparse(idx, rows))),
        (tps.OP_PUSH_SPARSE, "emb", tps._pack_sparse(
            np.array([9], np.int32), _f32(1, 4))),       # out of range
        (tps.OP_PUSH_SPARSE, "emb", tps._pack_sparse(
            np.array([1, 1], np.int32), _f32(2, 4, seed=7))),
        (tps.OP_PULL_SPARSE, "emb", P(np.array([4, 1, 3], np.int32))),
        (tps.OP_PULL_SPARSE, "emb", P(np.array([7], np.int32))),
        (tps.OP_PULL, "emb", b""),
        (tps.OP_BARRIER, "", struct.pack("<QQ", _CID, 0)),
        (tps.OP_BARRIER, "", struct.pack("<QQ", _CID, 0)),  # re-ack
        (tel.OP_CLOCK, "", struct.pack("<QQQ", _CID, 0, 3)),
        (tel.OP_CLOCK, "", struct.pack("<QQQ", _CID, 0, 2)),  # max-merged
        (tel.OP_CLOCK, "", struct.pack("<QQQ", _CID + 1, 1, 5)),
        (tel.OP_CLOCK_PULL, "", b""),
        (tel.OP_PULL_STALE, "w", struct.pack("<QQQQd", _CID, 0, 4, 2, 5.0)),
        (tel.OP_REDUCE, "g", struct.pack("<QQd", _CID, 0, 1.0)
         + P(_f32(2))),                                  # no membership
        (tps.OP_SET_OPT, "", b"sgd learning_rate=0.5 wd=0.0 "
                             b"rescale_grad=1.0"),
        (tps.OP_PUSH_SEQ, "w", seq(5, P(_f32(3, 4, val=2.0)))),
        (tps.OP_PULL, "w", b""),
        (tps.OP_PUSH_SPARSE_SEQ, "emb", seq(6, tps._pack_sparse(
            np.array([2], np.int32), _f32(1, 4, val=4.0)))),
        (tps.OP_PULL, "emb", b""),
    ]
    return frames


_NATIVE_OPS = {tps.OP_INIT, tps.OP_PUSH, tps.OP_PULL, tps.OP_SET_OPT,
               tps.OP_BARRIER, tps.OP_PUSH_SPARSE, tps.OP_PULL_SPARSE,
               tps.OP_PUSH_SEQ, tps.OP_PUSH_SPARSE_SEQ}


def _replies(port, frames):
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        out = []
        for op, key, payload in frames:
            tps._send_msg(s, op, key, payload)
            rop, rkey, rpayload = tps._recv_msg(s)
            out.append((rop, rkey, bytes(rpayload)))
        return out


@pytest.fixture
def servers():
    made = []

    def make(pkg, **kw):
        srv = pkg.PSServer(host="127.0.0.1", port=0, **kw)
        srv.start()
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.stop()


def test_replies_byte_identical_reference_and_port(servers):
    frames = _script()
    ref = _replies(servers(jps).port, frames)
    port = _replies(servers(tps).port, frames)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, (i, frames[i][:2], r[2][:64], p[2][:64])


def test_port_client_on_reference_server_and_back(servers):
    """Each package's client against the other's server: the same
    results through the client API (dense, code 16, sparse, barrier,
    clocks, SET_OPT + push)."""
    def session(client_mod, srv, sgd, gc):
        cli = client_mod.PSClient("127.0.0.1", srv.port, timeout=10,
                                  retries=2, retry_interval=0.05)
        out = {}
        cli.init("w", _f32(2, 3, seed=1))
        cli.init("emb", _f32(4, 3, seed=2))
        cli.push("w", _f32(2, 3, seed=3))
        cli.push("w", _f32(2, 3, seed=4), compressor=gc)
        out["w"] = cli.pull("w")
        cli.push_row_sparse("emb", np.array([0, 3], np.int32),
                            _f32(2, 3, seed=5))
        out["rows"] = cli.pull_row_sparse("emb", np.array([3, 1], np.int32))
        cli.barrier(timeout=10)
        out["clock"] = cli.push_clock(0, 4)
        out["table"] = cli.pull_clock()
        out["stale"] = cli.pull_stale("w", 0, 4, 0, timeout=5)[0]
        cli.set_optimizer(sgd)
        cli.push("w", _f32(2, 3, val=2.0))
        out["after_sgd"] = cli.pull("w")
        with pytest.raises(jmx.base.MXNetError if client_mod is jpc
                           else MXNetError):
            cli.pull_row_sparse("emb", np.array([9], np.int32))
        cli.close()
        return out

    from mxnet_tpu.kvstore.compression import GradientCompression as JGC

    jsgd = jmx.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0)
    tsgd = tmx.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0)
    want = session(jpc, servers(jps), jsgd, JGC(0.5))
    got_port_on_ref = session(tpc, servers(jps), tsgd,
                              GradientCompression(0.5))
    got_ref_on_port = session(jpc, servers(tps), jsgd, JGC(0.5))
    for got in (got_port_on_ref, got_ref_on_port):
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k


def _native_server():
    path = native.ps_server_binary()
    if path is None:
        pytest.skip(f"no C++ toolchain: {native.ps_server_error()}")
    assert os.path.dirname(path) == native.build_dir()
    assert "native" + os.sep + "build" not in path
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([path, "--port", str(port), "--num-workers",
                             "1"], stdout=subprocess.PIPE, text=True)
    assert "listening" in proc.stdout.readline()
    return proc, port


def test_native_server_replies_match_port(servers):
    """The native server built from native/ps/ps_server.cc unchanged gives
    the port's replies for every frame it speaks."""
    # the native server holds f32 only (no int32 key "i")
    frames = [f for f in _script() if f[0] in _NATIVE_OPS and f[1] != "i"
              and not (f[0] == tps.OP_PUSH_SEQ and struct.unpack_from(
                  "<B", f[2], 16 + 1 + 4 * f[2][16])[0] == 16)]
    proc, port = _native_server()
    try:
        got = _replies(port, frames)
    finally:
        proc.kill()
        proc.wait()
    want = _replies(servers(tps).port, frames)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, (i, frames[i][:2])


def test_port_client_on_native_server():
    proc, port = _native_server()
    try:
        cli = tpc.PSClient("127.0.0.1", port, timeout=10, retries=2)
        cli.init("w", _f32(4, val=1.0))
        cli.push("w", _f32(4, val=2.0), compressor=GradientCompression(0.5))
        np.testing.assert_array_equal(cli.pull("w"), _f32(4, val=1.5))
        cli.set_optimizer(tmx.optimizer.SGD(learning_rate=0.25,
                                            rescale_grad=1.0))
        cli.push("w", _f32(4, val=2.0))
        np.testing.assert_array_equal(cli.pull("w"), _f32(4, val=1.0))
        cli.close()
    finally:
        proc.kill()
        proc.wait()


def _reference_session(tmp_path, snapshot_after=None):
    srv = jps.PSServer(host="127.0.0.1", port=0, snapshot_dir=str(tmp_path),
                       snapshot_period=0)
    srv.start()
    cli = jpc.PSClient("127.0.0.1", srv.port, timeout=10, retries=3,
                       retry_interval=0.05)
    cli.init("w", _f32(3, 2, seed=1))
    cli.init("emb", _f32(4, 2, seed=2))
    cli.set_optimizer(jmx.optimizer.SGD(learning_rate=0.5, momentum=0.5,
                                        rescale_grad=1.0))
    for i in range(4):
        cli.push("w", _f32(3, 2, seed=10 + i))
        cli.push_row_sparse("emb", np.array([i % 4], np.int32),
                            _f32(1, 2, seed=20 + i))
        cli.push_clock(0, i + 1)
        if snapshot_after == i:
            srv.snapshot_now()
    want = {"w": cli.pull("w"), "emb": cli.pull("emb")}
    cli.close()
    srv.stop()
    return want


@pytest.mark.parametrize("snapshot_after", [None, 1])
def test_reference_wal_replays_in_the_port(tmp_path, snapshot_after):
    """Weights, momentum slots and clocks the reference's server logged
    (and snapshotted) come back in the port's server; the next push
    continues the same SGD-with-momentum trajectory as the reference."""
    import shutil

    state = tmp_path / "state"
    want = _reference_session(state, snapshot_after)
    assert any(n.startswith("wal-") for n in os.listdir(state))
    shutil.copytree(state, tmp_path / "copy")
    after = {}
    for pkg, cli_mod, d in ((jps, jpc, tmp_path / "copy"),
                            (tps, tpc, state)):
        srv = pkg.PSServer(host="127.0.0.1", port=0, snapshot_dir=str(d),
                           snapshot_period=0)
        srv.start()
        try:
            cli = cli_mod.PSClient("127.0.0.1", srv.port, timeout=10,
                                   retries=2)
            if pkg is tps:
                for k, v in want.items():
                    np.testing.assert_array_equal(cli.pull(k), v, err_msg=k)
                assert cli.pull_clock() == (4, {0: 4})
            cli.push("w", _f32(3, 2, seed=30))
            after[pkg] = cli.pull("w")
            cli.close()
        finally:
            srv.stop()
    # the momentum slots came back: the next step is the reference's
    np.testing.assert_allclose(after[tps], after[jps], rtol=1e-6, atol=1e-6)


def test_port_wal_replays_in_the_reference(tmp_path):
    srv = tps.PSServer(host="127.0.0.1", port=0, snapshot_dir=str(tmp_path),
                       snapshot_period=0)
    srv.start()
    cli = tpc.PSClient("127.0.0.1", srv.port, timeout=10, retries=2)
    cli.init("w", _f32(5, seed=1))
    for i in range(3):
        cli.push("w", _f32(5, seed=2 + i))
    want = cli.pull("w")
    cli.close()
    srv.stop()
    ref = jps.PSServer(host="127.0.0.1", port=0, snapshot_dir=str(tmp_path),
                       snapshot_period=0)
    try:
        np.testing.assert_array_equal(ref._weights["w"], want)
    finally:
        ref.stop()


def test_wal_torn_tail_is_truncated(tmp_path):
    wal = tel.PushWAL(str(tmp_path))
    wal.rotate(0)
    wal.append(0, 7, 1, "w", b"payload-1")
    wal.append(0, 7, 2, "w", b"payload-2")
    wal.close()
    path = os.path.join(str(tmp_path), "wal-00000000.bin")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 3)
    seen = []
    assert tel.PushWAL(str(tmp_path)).replay(
        lambda kind, cid, seq, key, payload: seen.append(seq)) == 1
    assert seen == [1]
    wal2 = tel.PushWAL(str(tmp_path))
    wal2.rotate(0)
    wal2.append(0, 7, 3, "w", b"payload-3")
    wal2.close()
    # the reference's replay reads the port's repaired log the same way
    from mxnet_tpu.kvstore.elastic import PushWAL as JWAL

    seen_ref = []
    JWAL(str(tmp_path)).replay(
        lambda kind, cid, seq, key, payload: seen_ref.append((seq, bytes(
            payload))))
    assert seen_ref == [(1, b"payload-1"), (3, b"payload-3")]


def test_wal_records_byte_identical(tmp_path):
    from mxnet_tpu.kvstore.elastic import PushWAL as JWAL

    for pkg_wal, sub in ((JWAL, "ref"), (tel.PushWAL, "port")):
        d = tmp_path / sub
        d.mkdir()
        w = pkg_wal(str(d))
        w.rotate(0)
        w.append(0, _CID, 5, "w", b"\x01\x02")
        w.append(4, _CID, 9, "3", b"")
        w.close()
    assert (tmp_path / "ref" / "wal-00000000.bin").read_bytes() == \
        (tmp_path / "port" / "wal-00000000.bin").read_bytes()


def test_port_refuses_pickle_set_opt_and_telemetry(servers):
    srv = servers(tps)
    blob = pickle.dumps({"name": "sgd", "kwargs": {"learning_rate": 0.1}})
    (op, _k, reply), = _replies(srv.port, [(tps.OP_SET_OPT, "", blob)])
    assert reply[:1] == b"\x01" and b"pickle" in reply
    assert srv._updater is None
    cli = tpc.PSClient("127.0.0.1", srv.port, timeout=5, retries=1)
    # the training-fleet plane is ported: OP_TELEMETRY answers
    (part,) = cli.telemetry()["parts"]
    assert part["role"] == "ps_server" and part["stats"]["keys"] == 0
    stats = cli.stats(include_metrics=False)
    assert stats["keys"] == 0 and stats["fleet"]["stragglers"] == []
    assert stats["hot_keys"] == []
    cli.close()


def test_client_retries_across_a_restarted_server():
    """A server restarted on the same port: the next RPC reconnects with
    backoff instead of failing (the idle ping detects the dead socket)."""
    srv = tps.PSServer(host="127.0.0.1", port=0)
    srv.start()
    port = srv.port
    cli = tpc.PSClient("127.0.0.1", port, timeout=5, retries=4,
                       retry_interval=0.1, idle_ping=0.05)
    cli.init("w", np.zeros(2, np.float32))
    srv.stop()
    deadline = time.monotonic() + 10
    srv2 = None
    while srv2 is None:
        try:
            srv2 = tps.PSServer(host="127.0.0.1", port=port)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
    srv2.start()
    time.sleep(0.1)
    cli.init("w", np.zeros(2, np.float32))
    np.testing.assert_array_equal(cli.pull("w"), np.zeros(2, np.float32))
    assert cli._sock.getsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE) == 1
    cli.close()
    srv2.stop()
