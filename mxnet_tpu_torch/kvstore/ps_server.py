"""The parameter server of the distributed stores and its wire framing
(counterpart of ``mxnet_tpu/kvstore/ps_server.py``).

Frames are length-prefixed and byte-identical with the reference's
(little-endian)::

    frame  := u32 len | u8 opcode | u16 key_len | key bytes | payload
    array  := u8 ndim | u32 * ndim shape | u8 dtype_code | raw bytes
    arrays := u8 count | array * count

``dtype_code`` is the mshadow type flag (``base.DTYPE_TO_CODE``); code 16
is a 2-bit compressed gradient (``f32 threshold | packed bytes``,
``kvstore/compression.py``), which unpacks to its dequantized f32 values.
numpy has no bfloat16, so a bf16 array is a CPU ``torch.bfloat16`` tensor
on both sides: it packs as its raw bits under code 12 and unpacks to one,
never through float32. The serve plane (``serve/server.py``,
``serve/client.py``) rides the same frames on its own opcode range
(``wire.py``).

:class:`PSServer` is the ``dist_async`` transport and the elastic plane's
server: workers push gradients, the server applies the optimizer on
arrival (no barrier) and workers pull fresh weights. Its arrays are numpy
on the host, as in the reference; the optimizer runs through the port's
``optimizer.Updater`` on CPU tensors. One thread serves each connection,
with a lock per key. Beside INIT/PUSH/PULL/SET_OPT/BARRIER/SHUTDOWN it
serves the sparse and seq-dedup pushes (exactly-once across retries), an
idempotent barrier, the elastic membership opcodes (``elastic.py``) and
the bounded-staleness clocks. With ``snapshot_dir`` set it snapshots
weights, optimizer state, the seq-dedup table and the membership through
``checkpoint.CheckpointManager`` and logs every acked push in a
write-ahead log (``elastic.PushWAL``, the reference's record framing), so
a warm restart loses no acked push and applies none twice.

The training-fleet plane (``obs/fleetstats.py``) lives here too: worker
parts piggybacked on heartbeats feed ``self.fleet`` (a
``FleetAggregator`` judging over the live ranks), ``OP_TELEMETRY`` answers
with the server's own part (its ``kvstore.server.rpc`` lanes and STATS)
and every cached worker part, exactly once under retries, and
``OP_STATS`` carries the ``fleet``, ``hot_keys`` and clock ``widen``
sections. In async mode a straggler verdict actuates: compute blame widens
the blamed rank's staleness bound by ``MXNET_ASYNC_WIDEN`` (capped at
``MXNET_ASYNC_MAX_STALENESS``), data-wait blame requests a shard recut,
a recovery narrows it back. A key's trace-context suffix
(``obs/context.py``) is stripped before any lookup, and the RPC runs
under a ``kvstore.server.rpc`` span in that context.

Refused with an error reply: a ``SET_OPT`` payload that is not the text
spec (the reference's legacy pickle blob, whose unpickling would import
the reference package).

Run one with ``python -m mxnet_tpu_torch.kvstore.ps_server --port P
--num-workers N``.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import struct
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from .. import obs
from ..obs import context as obs_context
from ..base import CODE_TO_DTYPE, DTYPE_TO_CODE, MXNetError, get_env
from ..ndarray.serialization import host_array, raw_bytes
from ..wire import PS_WIRE
from . import elastic as elastic_mod
from .compression import TWO_BIT_DTYPE_CODE, dequantize_2bit
from .elastic import (OP_CLOCK, OP_CLOCK_PULL, OP_EPOCH, OP_HB, OP_JOIN,
                      OP_LEAVE, OP_PULL_STALE, OP_REDUCE, OP_REDUCE_SCOPED,
                      ST_ERROR, ST_OK, ST_QUARANTINED, ST_STALE)

__all__ = ["PSServer", "main", "OP_NAMES", "_pack_array", "_unpack_array",
           "_pack_arrays", "_unpack_arrays", "_pack_sparse",
           "_unpack_sparse", "_send_msg", "_recv_exact", "_recv_msg"]

(OP_INIT, OP_PUSH, OP_PULL, OP_SET_OPT, OP_BARRIER, OP_SHUTDOWN,
 OP_PUSH_SPARSE, OP_PULL_SPARSE, OP_PUSH_SEQ, OP_PUSH_SPARSE_SEQ,
 OP_TELEMETRY, OP_STATS) = \
    PS_WIRE.codes("init", "push", "pull", "set_opt", "barrier", "shutdown",
                  "push_sparse", "pull_sparse", "push_seq",
                  "push_sparse_seq", "telemetry", "stats")

OP_NAMES = dict(PS_WIRE.names())

_BF16 = DTYPE_TO_CODE["bfloat16"]


def _array_parts(arr) -> list:
    """One packed array as ``[header, elements]`` buffer parts for
    ``_send_msg``: a numpy array's elements go as a view, not a copy."""
    arr = host_array(arr)  # numpy, or a CPU bfloat16 tensor
    code = _BF16 if isinstance(arr, torch.Tensor) \
        else DTYPE_TO_CODE[arr.dtype.name]
    shape = tuple(arr.shape)
    head = (struct.pack("<B", len(shape))
            + struct.pack(f"<{len(shape)}I", *shape) + struct.pack("<B", code))
    if isinstance(arr, torch.Tensor):
        return [head, raw_bytes(arr)]
    return [head, memoryview(np.ascontiguousarray(arr).reshape(-1)
                             .view(np.uint8))]


def _pack_array(arr) -> bytes:
    return b"".join(_array_parts(arr))


def _array_nbytes(buf: memoryview) -> int:
    """Byte length of one packed array at the head of ``buf``."""
    ndim = struct.unpack_from("<B", buf, 0)[0]
    shape = struct.unpack_from(f"<{ndim}I", buf, 1)
    code = struct.unpack_from("<B", buf, 1 + 4 * ndim)[0]
    size = 1
    for s in shape:
        size *= s
    if code == TWO_BIT_DTYPE_CODE:
        return 2 + 4 * ndim + 4 + (size + 3) // 4
    return 2 + 4 * ndim + size * _itemsize(code)


def _itemsize(code: int) -> int:
    if code == _BF16:
        return 2
    if code not in CODE_TO_DTYPE:
        raise MXNetError(f"wire dtype code {code} is not supported")
    return np.dtype(CODE_TO_DTYPE[code]).itemsize


def _unpack_array(buf: memoryview, copy: bool = True):
    """One packed array. ``copy=False`` keeps a writable buffer's bytes as
    the array's storage (a frame from ``_recv_exact`` is one buffer of its
    own); a read-only buffer is copied either way."""
    ndim = struct.unpack_from("<B", buf, 0)[0]
    shape = struct.unpack_from(f"<{ndim}I", buf, 1)
    code = struct.unpack_from("<B", buf, 1 + 4 * ndim)[0]
    off = 2 + 4 * ndim
    if code == TWO_BIT_DTYPE_CODE:
        size = int(np.prod(shape)) if ndim else 1
        if len(buf) < off + 4 or len(buf) - off - 4 < (size + 3) // 4:
            raise ConnectionError("truncated 2-bit payload")  # drops the conn
        (threshold,) = struct.unpack_from("<f", buf, off)
        packed = np.frombuffer(buf, dtype=np.uint8, offset=off + 4)
        return dequantize_2bit(packed, threshold, size).reshape(shape)
    _itemsize(code)
    if code == _BF16:
        bits = np.frombuffer(buf, dtype=np.int16, offset=off)
        return torch.from_numpy(bits.reshape(shape).copy()).view(
            torch.bfloat16)
    data = np.frombuffer(buf, dtype=np.dtype(CODE_TO_DTYPE[code]),
                         offset=off).reshape(shape)
    return data if data.flags.writeable and not copy else data.copy()


def _pack_sparse(indices: np.ndarray, rows: np.ndarray) -> bytes:
    """The row-sparse payload: int32 indices, then the rows."""
    return (_pack_array(np.ascontiguousarray(indices, np.int32))
            + _pack_array(np.ascontiguousarray(rows)))


def _unpack_sparse(buf: memoryview):
    n = _array_nbytes(buf)
    return _unpack_array(buf[:n]), _unpack_array(buf[n:])


def _pack_arrays(arrays) -> bytes:
    """N arrays on one payload: u8 count, then each array."""
    if len(arrays) > 255:
        raise ValueError(f"too many arrays for one frame ({len(arrays)})")
    # as the reference: numpy inputs made contiguous, so 0-d packs as (1,)
    return struct.pack("<B", len(arrays)) + b"".join(
        _pack_array(a if isinstance(a, torch.Tensor)
                    else np.ascontiguousarray(a)) for a in arrays)


def _unpack_arrays(buf: memoryview):
    """The arrays of a :func:`_pack_arrays` payload, and the bytes read."""
    (count,) = struct.unpack_from("<B", buf, 0)
    out, off = [], 1
    for _ in range(count):
        n = _array_nbytes(buf[off:])
        out.append(_unpack_array(buf[off:off + n]))
        off += n
    return out, off


def _send_msg(sock: socket.socket, opcode: int, key: str = "", payload=b""):
    """Frame and send one message. ``payload`` is ``bytes``/``memoryview``
    or a list of buffer parts, sent scatter-gather without being joined."""
    kb = key.encode()
    parts = list(payload) if isinstance(payload, (list, tuple)) \
        else [payload]
    plen = sum(len(p) for p in parts)
    head = struct.pack("<IBH", 3 + len(kb) + plen, opcode, len(kb)) + kb
    _send_parts(sock, [head] + parts)


def _send_parts(sock, parts) -> None:
    """``sendall`` of a list of buffers through ``sendmsg``, resuming after
    a partial send."""
    views = [memoryview(p) for p in parts if len(p)]
    if not hasattr(sock, "sendmsg"):
        sock.sendall(b"".join(views))
        return
    while views:
        sent = sock.sendmsg(views)
        while sent:
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """``n`` bytes, received straight into one new buffer (no joined
    chunks: a frame of gradients is copied once, by the socket)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return buf


def _recv_msg(sock: socket.socket):
    """One frame: ``(opcode, key, payload memoryview)``."""
    (ln,) = struct.unpack("<I", _recv_exact(sock, 4))
    body = memoryview(_recv_exact(sock, ln))
    opcode, klen = struct.unpack_from("<BH", body, 0)
    key = bytes(body[3:3 + klen]).decode()
    payload = body[3 + klen:]
    return opcode, key, payload


class PSServer:
    """The server process: aggregates pushes and runs the optimizer per
    key. ``dist_async``: every push applies ``updater(key, grad, weight)``
    under the key's lock at once, with no worker barrier."""

    def __init__(self, host="0.0.0.0", port=9091, num_workers=1,
                 barrier_timeout=60.0, snapshot_dir=None,
                 snapshot_period=None, hb_interval=None, miss_k=None,
                 async_staleness=None):
        self._weights: Dict[str, np.ndarray] = {}
        self._locks: Dict[str, threading.Lock] = {}
        self._updater = None
        self._optimizer = None
        self._opt_spec: Optional[str] = None
        self._global_lock = threading.Lock()
        self._num_workers = num_workers
        # the elastic membership plane is made at the first OP_JOIN, so a
        # classic fleet pays nothing for it (not even its liveness thread)
        self._elastic: Optional[elastic_mod.ElasticState] = None
        self._elastic_cfg = (hb_interval, miss_k)
        self._elastic_lock = threading.Lock()
        # durable state: periodic snapshots, warm restart from the newest
        self._snapshot_dir = snapshot_dir or get_env(
            "MXNET_PS_SNAPSHOT_DIR", None)
        self._snapshot_period = float(
            snapshot_period if snapshot_period is not None
            else get_env("MXNET_PS_SNAPSHOT_PERIOD_S", 5.0, float))
        self._snap_mgr = None
        self._snap_step = 0
        self._snap_thread: Optional[threading.Thread] = None
        self._snap_lock = threading.Lock()
        self._wal: Optional[elastic_mod.PushWAL] = None
        # (client_id, key) -> last applied seq, LRU-bounded against client
        # churn; its own lock, since handlers of different keys share it
        self._applied_seq: "OrderedDict" = OrderedDict()
        # key-indexed mirror of _applied_seq (same lock): a snapshot copies
        # one key's entries under that key's lock
        self._seq_by_key: Dict[str, Dict[int, int]] = {}
        self._seq_lock = threading.Lock()
        self._barrier_timeout = barrier_timeout
        self._barrier_count = 0
        self._barrier_gen = 0
        # idempotent barrier: a (client_id, barrier_epoch) token counts a
        # retransmit once while the round gathers, and the released LRU
        # re-acks one that arrives after the round completed
        self._barrier_arrived: Dict = {}
        self._barrier_released: "OrderedDict" = OrderedDict()
        self._barrier_stamps: Dict = {}  # token -> arrival (monotonic)
        self._barrier_cv = threading.Condition()
        # the training-fleet plane: worker parts cached off heartbeats and
        # the straggler detector over them; OP_TELEMETRY drains exactly
        # once through the collection-token LRU
        from ..obs import fleetstats as _fleetstats

        self.fleet = _fleetstats.FleetAggregator(
            member_ranks=self._live_ranks)
        self._hot_keys = _fleetstats.HotKeyTable()
        self._telemetry_tokens: "OrderedDict" = OrderedDict()
        self._telemetry_lock = threading.Lock()
        # bounded-staleness async clocks: rank -> last COMPLETED step, the
        # cid -> rank table and the staleness widening the straggler
        # policy grants a rank. Made before _init_durability, which
        # max-merges a snapshot's clocks into them. Lock order: _clock_cv
        # may take the elastic cv, never the reverse.
        self._clock: Dict[int, int] = {}
        self._clock_rank: Dict[int, int] = {}
        self._staleness_widen: Dict[int, int] = {}
        self._clock_cv = threading.Condition()
        if async_staleness is None:
            env = get_env("MXNET_ASYNC_STALENESS", None)
            async_staleness = int(env) if env is not None else None
        self._async_staleness = async_staleness
        self._async_widen_step = get_env("MXNET_ASYNC_WIDEN", 2, int)
        self._async_max_staleness = get_env(
            "MXNET_ASYNC_MAX_STALENESS", 16, int)
        if self._async_staleness is not None:
            # verdicts actuate in async mode only: sync fleets just report
            self.fleet.on_straggler(self._policy_on_straggler)
        self._started = time.monotonic()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads = []
        self._conns = []
        if self._snapshot_dir:
            self._init_durability()

    def serve_forever(self):
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.5)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            self._conns.append(conn)
            t = threading.Thread(target=self._handle_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads = [th for th in self._threads if th.is_alive()]
            self._threads.append(t)

    def start(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    # ------------------------------------------------------------------
    # elastic membership + durable state
    # ------------------------------------------------------------------
    def _elastic_state(self) -> elastic_mod.ElasticState:
        """The membership plane, made at the first OP_JOIN. Its change
        callback wakes the barrier, so a declared death releases a waiting
        (now survivor-complete) barrier at once."""
        with self._elastic_lock:
            if self._elastic is None:
                hb, miss = self._elastic_cfg
                self._elastic = elastic_mod.ElasticState(
                    hb_interval=hb, miss_k=miss,
                    on_change=[self._on_membership_change],
                    on_prune=[self.fleet.forget])
            return self._elastic

    def _on_membership_change(self):
        with self._barrier_cv:
            self._release_barrier_locked()
            self._barrier_cv.notify_all()
        # a declared death moves the committed-clock floor
        with self._clock_cv:
            self._clock_cv.notify_all()

    def _live_ranks(self):
        """The active members' ranks (None without a membership plane):
        the fleet aggregator judges a window once each has reported."""
        el = self._elastic
        if el is None:
            return None
        with el.cv:
            return [m.rank for m in el.active_members()]

    def _required_workers(self) -> int:
        """Barrier quorum: the LIVE membership once anyone heartbeats, the
        launch-time worker count otherwise."""
        el = self._elastic
        if el is not None:
            with el.cv:
                if el.has_members():
                    return max(1, el.active_count())
        return self._num_workers

    # -- bounded-staleness clocks --------------------------------------
    def _clock_floor_locked(self) -> int:
        """Caller holds ``_clock_cv``. The least committed step over LIVE
        ranks (a live rank that has not committed floors at 0); without a
        membership plane, over every rank that ever committed."""
        live = self._live_ranks()
        if live:
            return min(self._clock.get(r, 0) for r in live)
        if not self._clock:
            return 0
        return min(self._clock.values())

    def _clock_bounds_locked(self):
        """Caller holds ``_clock_cv``: (floor, max clock, the straggler
        policy's widening)."""
        floor = self._clock_floor_locked()
        maxc = max(self._clock.values()) if self._clock else 0
        widen = max(self._staleness_widen.values(), default=0)
        return floor, maxc, widen

    def _advance_clock(self, cid: int, rank: int, step: int) -> bool:
        """Commit "rank FINISHED step": max-merged (a retried or reordered
        frame never rolls a clock back), logged (WAL kind 4) before the
        ack, and every staleness-gated pull is woken."""
        with self._clock_cv:
            advanced = step > self._clock.get(rank, -1)
            if advanced:
                self._clock[rank] = step
                self._clock_cv.notify_all()
            self._clock_rank[cid] = rank
        if advanced and self._wal is not None:
            self._wal.append(4, cid, step, str(rank), b"")
        return advanced

    def _policy_on_straggler(self, verdict: dict):
        """The async straggler policy (an ``on_straggler`` hook): compute
        blame widens the staleness bound for the blamed rank (fast ranks
        run further ahead instead of stalling at the gate), data-wait
        blame requests a shard recut at the next epoch boundary, and a
        recovery withdraws the widening. Runs on a heartbeat handler
        thread and returns at once; ``FleetAggregator`` counts its
        errors."""
        kind = verdict.get("kind")
        rank = verdict.get("rank")
        if rank is None:
            return
        if kind == "recovered":
            with self._clock_cv:
                narrowed = self._staleness_widen.pop(rank, None)
                if narrowed is not None:
                    self._clock_cv.notify_all()
            if narrowed is not None:
                obs.event("train.async.staleness_narrowed", rank=rank,
                          was=narrowed)
            return
        if kind != "straggler":
            return
        blame = verdict.get("blame")
        if blame == "data_wait" and self._elastic is not None:
            self._elastic.request_recut()
            obs.event("train.async.shard_recut", rank=rank, blame=blame)
            return
        base = self._async_staleness or 0
        with self._clock_cv:
            cur = self._staleness_widen.get(rank, 0)
            new = min(cur + self._async_widen_step,
                      max(0, self._async_max_staleness - base))
            if new != cur:
                self._staleness_widen[rank] = new
                self._clock_cv.notify_all()
        if new != cur:
            obs.inc("train.async.staleness_widened")
            obs.event("train.async.staleness_widened", rank=rank,
                      widen=new, blame=blame or "compute")

    def _init_durability(self):
        from ..checkpoint.manager import CheckpointManager

        self._snap_mgr = CheckpointManager(self._snapshot_dir, prefix="ps",
                                           keep_last=3, async_write=False)
        state = self._snap_mgr.load_latest()
        if state is not None and state.meta.get("kind") == "ps_server":
            if state.meta.get("generation") is not None:
                self._elastic_state()  # generation stays monotonic
            elastic_mod.install_server_state(self, state)
            self._snap_step = (self._snap_mgr.latest_step() or 0) + 1
        # replay the acked pushes the snapshot does not cover through the
        # seq-dedup path, then open a fresh log. Key births (kind 2) go
        # first: a birth and a first push are logged under different
        # locks, so an acked push can precede its key's birth in the log
        self._wal = elastic_mod.PushWAL(self._snapshot_dir)
        pushes = []

        def _births_first(kind, cid, seq, key, payload):
            if kind == 2:
                self._replay_push(kind, cid, seq, key, payload)
            else:
                pushes.append((kind, cid, seq, key, payload))

        self._wal.replay(_births_first)
        for rec in pushes:
            self._replay_push(*rec)
        self._wal.rotate(self._snap_step)
        if self._snapshot_period > 0:
            self._snap_thread = threading.Thread(
                target=self._snapshot_loop, daemon=True,
                name="mxt-ps-snapshot")
            self._snap_thread.start()

    def _replay_push(self, kind: int, cid: int, seq: int, key: str,
                     payload: bytes):
        """WAL replay: the seq-push apply path without the wire. Kinds:
        0 dense push, 1 sparse push, 2 key birth (first wins), 3 optimizer
        spec, 4 committed-clock advance (max-merged)."""
        if kind == 2:
            with self._global_lock:
                if key not in self._weights:
                    self._weights[key] = _unpack_array(memoryview(payload))
                    self._locks[key] = threading.Lock()
            return
        if kind == 3:
            spec = bytes(payload).decode("ascii", errors="replace")
            if spec != (self._opt_spec or "") or self._updater is None:
                # an unchanged spec must not rebuild the Updater: that
                # would wipe the slots the snapshot restored
                self._set_optimizer_bytes(bytes(payload))
            return
        if kind == 4:
            try:
                rank = int(key)
            except ValueError:
                return
            with self._clock_cv:
                if seq > self._clock.get(rank, -1):
                    self._clock[rank] = seq
                self._clock_rank[cid] = rank
            return
        if key not in self._weights:
            return
        buf = memoryview(payload)
        with self._locks[key]:
            with self._seq_lock:
                fresh = self._applied_seq.get((cid, key), -1) < seq
            if not fresh:
                return
            if kind == 0:
                self._apply_dense(key, _unpack_array(buf))
            elif not self._apply_sparse(key, buf, locked=True):
                return
            with self._seq_lock:
                self._record_seq(cid, key, seq)

    def _snapshot_loop(self):
        while not self._stop.wait(self._snapshot_period):
            try:
                self.snapshot_now()
            except Exception:  # noqa: BLE001 — a failed snapshot must not
                obs.inc("elastic.ps_snapshot_errors")  # kill the server

    def snapshot_now(self):
        """Write one durable snapshot (atomic commit, CRC manifest); safe
        beside request handling: each key is captured under the lock its
        pushes apply under."""
        if self._snap_mgr is None:
            return
        with self._snap_lock:
            state = elastic_mod.capture_server_state(self)
            step, self._snap_step = self._snap_step, self._snap_step + 1
            self._snap_mgr.save(state, step, block=True)
            if self._wal is not None:
                # pushes after this snapshot land in the fresh log; older
                # logs are covered by it and collected
                self._wal.rotate(step + 1)
            obs.inc("elastic.ps_snapshots")

    def stop(self):
        self._stop.set()
        if self._elastic is not None:
            self._elastic.close()
        if self._wal is not None:
            self._wal.close()
        try:
            self._sock.close()
        except OSError:
            pass
        for c in list(self._conns):  # a stopped server must look dead
            try:
                c.close()
            except OSError:
                pass
        me = threading.current_thread()  # OP_SHUTDOWN stops from a handler
        reap = [t for t in self._threads if t is not me]
        if self._snap_thread is not None and self._snap_thread is not me:
            reap.append(self._snap_thread)
        deadline = time.monotonic() + 1.0  # one budget for the whole reap
        leaked = 0
        for t in reap:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            leaked += t.is_alive()
        if leaked:
            obs.inc("kvstore.server.threads_leaked", leaked)

    # ------------------------------------------------------------------
    def _handle_loop(self, conn: socket.socket):
        try:
            while True:
                opcode, key, payload = _recv_msg(conn)
                # strip the wire's trace context before any key lookup: a
                # context-bearing key must hit the same weight/lock/seq
                # tables as its plain form
                key, wctx = obs_context.extract_key(key)
                rec = obs.enabled()
                t0 = time.monotonic() if rec else 0.0
                if rec:
                    obs.inc("kvstore.server.bytes_received", len(payload))
                try:
                    # the server's span joins the worker's trace: both
                    # halves of an RPC on the merged timeline
                    with obs_context.use(wctx), obs.trace.span(
                            "kvstore.server.rpc",
                            op=OP_NAMES.get(opcode, str(opcode)), key=key):
                        alive = self._handle_one(conn, opcode, key, payload)
                finally:
                    if rec:
                        obs.observe(
                            "kvstore.server.rpc."
                            f"{OP_NAMES.get(opcode, str(opcode))}_seconds",
                            time.monotonic() - t0)
                if not alive:
                    return
        except (ConnectionError, OSError):
            return
        finally:  # prune: reconnecting clients make churn routine
            try:
                conn.close()
            except OSError:
                pass
            try:
                self._conns.remove(conn)
            except ValueError:
                pass

    def _reduce(self, conn, opcode, key, payload) -> None:
        """Answer one OP_REDUCE / OP_REDUCE_SCOPED frame (the scoped form
        carries the contributor count after the 24-byte header)."""
        head = 28 if opcode == OP_REDUCE_SCOPED else 24
        if self._elastic is None or len(payload) < head:
            _send_msg(conn, opcode, key, struct.pack("<BQI", ST_ERROR, 0, 0))
            return
        cid, round_id, wait = struct.unpack_from("<QQd", payload, 0)
        expected = (struct.unpack_from("<I", payload, 24)[0]
                    if opcode == OP_REDUCE_SCOPED else 0)
        # summed, never written: the frame's buffer is its storage
        arr = _unpack_array(payload[head:], copy=False)
        st, gen, n, result = self._elastic.reduce(
            cid, key, round_id, arr,
            timeout=max(1.0, min(float(wait), 3600.0)),
            expected=int(expected))
        # the released sum goes out as a view: one array, read by every
        # contributor's handler, copied by none
        _send_msg(conn, opcode, key,
                  [struct.pack("<BQI", st, gen, n)]
                  + (_array_parts(result) if st == ST_OK else []))

    def _handle_one(self, conn: socket.socket, opcode: int, key: str,
                    payload) -> bool:
        """Serve one framed request; False only after OP_SHUTDOWN."""
        if opcode == OP_INIT:
            arr = _unpack_array(payload)
            with self._global_lock:
                created = key not in self._weights
                if created:
                    self._weights[key] = arr
                    self._locks[key] = threading.Lock()
            if created and self._wal is not None:
                self._wal.append(2, 0, 0, key, bytes(payload))
            _send_msg(conn, OP_INIT, key, b"\x00")
        elif opcode == OP_PUSH:
            grad = _unpack_array(payload)
            with self._locks[key]:
                self._apply_dense(key, grad)
            _send_msg(conn, OP_PUSH, key, b"\x00")
        elif opcode == OP_PUSH_SEQ:
            # exactly-once push: (client_id, seq) prefix; a retried frame
            # whose seq was applied is acked without applying again
            if key not in self._weights or len(payload) < 16:
                _send_msg(conn, OP_PUSH_SEQ, key, b"\x01")
                return True
            cid, seq = struct.unpack_from("<QQ", payload, 0)
            grad = _unpack_array(payload[16:])
            rec = obs.enabled()
            t_apply = t_wal = 0.0
            with self._locks[key]:
                with self._seq_lock:
                    fresh = self._applied_seq.get((cid, key), -1) < seq
                if fresh:
                    t0 = time.monotonic() if rec else 0.0
                    self._apply_dense(key, grad)
                    if rec:
                        t_apply = time.monotonic() - t0
                    # recorded only after the apply succeeded
                    with self._seq_lock:
                        self._record_seq(cid, key, seq)
                    if self._wal is not None:
                        # durable before the ack: an acked push is never
                        # resent, so it must survive a SIGKILL here
                        t0 = time.monotonic() if rec else 0.0
                        self._wal.append(0, cid, seq, key,
                                         bytes(payload[16:]))
                        if rec:
                            t_wal = time.monotonic() - t0
            if rec and fresh:
                # the reduce plane's split: the optimizer's apply against
                # the WAL append, and the bounded hot-key table
                obs.observe("kvstore.server.push.apply_seconds", t_apply)
                if self._wal is not None:
                    obs.observe("kvstore.server.push.wal_seconds", t_wal)
                self._hot_keys.record(key, len(payload) - 16, t_apply)
            _send_msg(conn, OP_PUSH_SEQ, key, b"\x00")
        elif opcode == OP_PULL:
            rec = obs.enabled()
            t0 = time.monotonic() if rec else 0.0
            with self._locks.get(key, self._global_lock):
                arr = self._weights[key]
            _send_msg(conn, OP_PULL, key, _pack_array(arr))
            if rec:
                # the serialize half of the per-RPC split
                obs.observe("kvstore.server.pull.serialize_seconds",
                            time.monotonic() - t0)
        elif opcode == OP_PUSH_SPARSE:
            # only the touched rows cross the wire; a bad key or an
            # out-of-range index replies \x01 and corrupts nothing
            ok = self._apply_sparse(key, payload)
            _send_msg(conn, OP_PUSH_SPARSE, key, b"\x00" if ok else b"\x01")
        elif opcode == OP_PUSH_SPARSE_SEQ:
            if key not in self._weights or len(payload) < 16:
                _send_msg(conn, OP_PUSH_SPARSE_SEQ, key, b"\x01")
                return True
            cid, seq = struct.unpack_from("<QQ", payload, 0)
            ok = True
            with self._locks[key]:
                with self._seq_lock:
                    fresh = self._applied_seq.get((cid, key), -1) < seq
                if fresh:
                    ok = self._apply_sparse(key, payload[16:], locked=True)
                    if ok:  # a rejected frame must not burn the seq
                        with self._seq_lock:
                            self._record_seq(cid, key, seq)
                        if self._wal is not None:
                            self._wal.append(1, cid, seq, key,
                                             bytes(payload[16:]))
            _send_msg(conn, OP_PUSH_SPARSE_SEQ, key,
                      b"\x00" if ok else b"\x01")
        elif opcode == OP_PULL_SPARSE:
            reply = b""  # empty = failure, as the C++ server answers
            if key in self._weights:
                idx = _unpack_array(payload).astype(np.int64)
                w = self._weights[key]
                if (idx.ndim == 1 and idx.size > 0 and 0 <= idx.min()
                        and idx.max() < w.shape[0]):
                    with self._locks.get(key, self._global_lock):
                        reply = _pack_array(np.ascontiguousarray(w[idx]))
            _send_msg(conn, OP_PULL_SPARSE, key, reply)
        elif opcode == OP_SET_OPT:
            try:
                self._set_optimizer_bytes(bytes(payload))
            except MXNetError as e:
                _send_msg(conn, OP_SET_OPT, key,
                          b"\x01" + str(e).encode("utf-8", "replace"))
                return True
            if self._wal is not None and self._opt_spec:
                self._wal.append(3, 0, 0, "", self._opt_spec.encode("ascii"))
            _send_msg(conn, OP_SET_OPT, key, b"\x00")
        elif opcode == OP_BARRIER:
            ok, detail = self._barrier(payload)
            _send_msg(conn, OP_BARRIER, key,
                      b"\x00" if ok else b"\x01" + detail)
        elif opcode == OP_HB:
            # an empty payload is a connection-liveness ping: it replies
            # without touching membership. Bytes past the 16-byte identity
            # are the worker's training-fleet part
            part_blob = cid = None
            if len(payload) >= 16:
                cid, _rank = struct.unpack_from("<QQ", payload, 0)
                if len(payload) > 16:
                    part_blob = payload[16:]
                st, gen, count = self._elastic_state().heartbeat(cid)
            elif self._elastic is not None:
                with self._elastic.cv:
                    st, gen, count = (ST_OK, self._elastic.generation,
                                      self._elastic.active_count())
            else:
                st, gen, count = ST_OK, 0, 0
            _send_msg(conn, OP_HB, key, struct.pack("<BQI", st, gen, count))
            if part_blob is not None:
                # ingested after the beat refreshed liveness and was acked:
                # judging and the policy hooks can never turn a received
                # heartbeat into a missed one
                self.fleet.add_part(cid, part_blob)
        elif opcode == OP_JOIN:
            cid, rank = struct.unpack_from("<QQ", payload, 0)
            state, gen, epoch, part, nparts, count = \
                self._elastic_state().join(cid, rank)
            st = {"active": ST_OK, "quarantined": ST_QUARANTINED}.get(
                state, ST_STALE)
            _send_msg(conn, OP_JOIN, key,
                      struct.pack("<BQQIII", st, gen, epoch, part, nparts,
                                  count))
        elif opcode == OP_REDUCE:
            # the elastic sum-allreduce over the live membership
            self._reduce(conn, opcode, key, payload)
        elif opcode == OP_REDUCE_SCOPED:
            # completes at an explicit contributor count (the
            # hierarchical reduction's group-local and cross-group stages)
            self._reduce(conn, opcode, key, payload)
        elif opcode == OP_EPOCH:
            if self._elastic is None or len(payload) < 24:
                _send_msg(conn, OP_EPOCH, key,
                          struct.pack("<BQQIII", ST_ERROR, 0, 0, 0, 1, 0))
                return True
            cid, epoch, wait = struct.unpack_from("<QQd", payload, 0)
            st, gen, nxt, part, nparts, count = self._elastic.epoch_end(
                cid, epoch, timeout=max(1.0, min(float(wait), 3600.0)))
            _send_msg(conn, OP_EPOCH, key,
                      struct.pack("<BQQIII", st, gen, nxt, part, nparts,
                                  count))
        elif opcode == OP_LEAVE:
            if self._elastic is not None and len(payload) >= 8:
                (cid,) = struct.unpack_from("<Q", payload, 0)
                self._elastic.leave(cid)
            _send_msg(conn, OP_LEAVE, key, b"\x00")
        elif opcode == OP_CLOCK:
            # "rank r finished step t"; the reply carries the fleet clock
            # bounds, so each commit refreshes the worker's view
            if len(payload) < 24:
                _send_msg(conn, OP_CLOCK, key,
                          struct.pack("<BQQI", ST_ERROR, 0, 0, 0))
                return True
            cid, rank, step = struct.unpack_from("<QQQ", payload, 0)
            self._advance_clock(cid, int(rank), int(step))
            with self._clock_cv:
                floor, maxc, widen = self._clock_bounds_locked()
            _send_msg(conn, OP_CLOCK, key,
                      struct.pack("<BQQI", ST_OK, floor, maxc, widen))
        elif opcode == OP_CLOCK_PULL:
            with self._clock_cv:
                floor = self._clock_floor_locked()
                table = sorted(self._clock.items())
            _send_msg(conn, OP_CLOCK_PULL, key,
                      struct.pack("<BQI", ST_OK, floor, len(table))
                      + b"".join(struct.pack("<QQ", r, c) for r, c in table))
        elif opcode == OP_PULL_STALE:
            # staleness-gated pull: blocks while the puller would run more
            # than `stale` steps ahead of the committed-clock floor; the
            # wait bound rides in the request, so the server answers
            # ST_ERROR before the client's socket gives up
            if len(payload) < 40 or key not in self._weights:
                _send_msg(conn, OP_PULL_STALE, key,
                          struct.pack("<BQQ", ST_ERROR, 0, 0))
                return True
            cid, rank, step, stale, wait = struct.unpack_from(
                "<QQQQd", payload, 0)
            deadline = time.monotonic() + max(0.0, min(float(wait), 3600.0))
            st = ST_OK
            with self._clock_cv:
                while True:
                    floor, maxc, widen = self._clock_bounds_locked()
                    if step <= floor + stale + widen:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        st = ST_ERROR
                        obs.inc("kvstore.async.gate_timeouts")
                        break
                    self._clock_cv.wait(timeout=remaining)
            if st != ST_OK:
                _send_msg(conn, OP_PULL_STALE, key,
                          struct.pack("<BQQ", st, floor, maxc))
                return True
            with self._locks.get(key, self._global_lock):
                arr = self._weights[key]
            _send_msg(conn, OP_PULL_STALE, key,
                      [struct.pack("<BQQ", ST_OK, floor, maxc),
                       _pack_array(arr)])
        elif opcode == OP_TELEMETRY:
            # this server's part and every cached worker part. Draining is
            # destructive and clients retry lost replies, so a collection
            # token re-serves the cached reply instead of draining twice
            try:
                spec = json.loads(bytes(payload).decode("utf-8")) \
                    if len(payload) else {}
                token = spec.get("token")
                drain = bool(spec.get("drain", True))
                if token is None:
                    blob = json.dumps(self.telemetry(drain=drain),
                                      default=float).encode("utf-8")
                else:
                    # lookup and drain under one lock hold: a retried
                    # token racing its original's drain must not miss the
                    # cache and drain a second batch
                    with self._telemetry_lock:
                        blob = self._telemetry_tokens.get(token)
                        if blob is None:
                            blob = json.dumps(
                                self.telemetry(drain=drain),
                                default=float).encode("utf-8")
                            self._telemetry_tokens[token] = blob
                            while len(self._telemetry_tokens) > 16:
                                self._telemetry_tokens.popitem(last=False)
                _send_msg(conn, OP_TELEMETRY, key, b"\x00" + blob)
            except Exception as e:  # noqa: BLE001 — reported on the wire
                obs.inc("kvstore.telemetry_errors")
                _send_msg(conn, OP_TELEMETRY, key,
                          b"\x01" + f"{type(e).__name__}: {e}".encode(
                              "utf-8", "replace"))
        elif opcode == OP_STATS:
            try:
                include = True
                if len(payload):
                    try:
                        spec = json.loads(bytes(payload).decode("utf-8"))
                        include = bool(spec.get("metrics", True))
                    except ValueError:
                        pass
                blob = json.dumps(self.stats(include_metrics=include),
                                  default=str).encode("utf-8")
                _send_msg(conn, OP_STATS, key, b"\x00" + blob)
            except Exception as e:  # noqa: BLE001 — reported on the wire
                obs.inc("kvstore.stats_errors")
                _send_msg(conn, OP_STATS, key,
                          b"\x01" + f"{type(e).__name__}: {e}".encode(
                              "utf-8", "replace"))
        elif opcode == OP_SHUTDOWN:
            if self._snap_mgr is not None:
                try:
                    self.snapshot_now()  # parting durable state
                except Exception:  # noqa: BLE001 — shutdown goes on
                    obs.inc("elastic.ps_snapshot_errors")
            _send_msg(conn, OP_SHUTDOWN, key, b"\x00")
            self.stop()
            return False
        return True

    # ------------------------------------------------------------------
    def stats(self, include_metrics: bool = True) -> dict:
        """Key count, membership liveness, the training-fleet section
        (per-rank window summaries, straggler verdicts), the bounded
        hot-key table, the async clocks with the policy's widening and,
        with ``include_metrics``, the metrics registry's snapshot."""
        out = {"pid": os.getpid(),
               "uptime_seconds": round(time.monotonic() - self._started, 3),
               "keys": len(self._weights),
               "num_workers": self._num_workers}
        el = self._elastic
        if el is not None:
            with el.cv:
                out["generation"] = el.generation
                out["epoch"] = el.epoch
                out["active_workers"] = el.active_count()
            out["membership"] = [
                {"rank": rank, "client_id": str(cid), "state": state,
                 "last_hb_age_s": age}
                for rank, cid, state, age in el.liveness_table()]
        out["fleet"] = self.fleet.stats()
        out["hot_keys"] = self._hot_keys.snapshot()
        with self._clock_cv:
            if self._clock or self._async_staleness is not None:
                floor, maxc, widen = self._clock_bounds_locked()
                out["async"] = {
                    "staleness": self._async_staleness,
                    "clock_floor": floor, "clock_max": maxc,
                    "widen": widen,
                    "clocks": {str(r): c
                               for r, c in sorted(self._clock.items())},
                    "staleness_widen": {
                        str(r): w for r, w
                        in sorted(self._staleness_widen.items())}}
        if include_metrics:
            out["metrics"] = obs.metrics.snapshot()
        return out

    def telemetry(self, drain: bool = True) -> dict:
        """The ``OP_TELEMETRY`` document, ``{"parts": [...]}``: this
        process's part first (role ``ps_server``, its STATS attached),
        then every cached worker part (role ``rank<r>``) with its
        windows, spans and clock anchor."""
        st = self.stats(include_metrics=False)
        part = obs.telemetry_part(drain=drain, role="ps_server")
        part["stats"] = st
        return {"parts": [part] + self.fleet.parts(drain=drain)}

    def _record_seq(self, cid, key, seq):
        """Caller holds ``self._seq_lock``. LRU-bounded (client churn)."""
        self._applied_seq[(cid, key)] = seq
        self._applied_seq.move_to_end((cid, key))
        self._seq_by_key.setdefault(key, {})[cid] = seq
        while len(self._applied_seq) > 65536:
            (ocid, okey), _oseq = self._applied_seq.popitem(last=False)
            per_key = self._seq_by_key.get(okey)
            if per_key is not None:
                per_key.pop(ocid, None)
                if not per_key:
                    del self._seq_by_key[okey]

    def _apply_dense(self, key, grad):
        """Caller holds the key's lock: the optimizer's update, or a plain
        accumulation without one."""
        if self._updater is not None:
            self._apply(key, grad, self._weights[key])
        else:
            self._weights[key] = self._weights[key] + grad

    def _apply_sparse(self, key, payload, locked=False) -> bool:
        """Validate and apply a row-sparse push. False (nothing changed) on
        a bad key, a shape mismatch or an out-of-range index."""
        if key not in self._weights:
            return False
        idx, rows = _unpack_sparse(payload)
        idx = idx.astype(np.int64)
        w = self._weights[key]
        if not (idx.ndim == 1 and rows.shape[:1] == idx.shape
                and rows.shape[1:] == w.shape[1:] and idx.size > 0
                and 0 <= idx.min() and idx.max() < w.shape[0]):
            return False
        lock = self._locks[key] if not locked else contextlib.nullcontext()
        with lock:
            if self._updater is not None:
                grad = np.zeros_like(w)
                np.add.at(grad, idx, rows.astype(w.dtype))
                self._apply(key, grad, w)
            else:
                np.add.at(w, idx, rows.astype(w.dtype))
        return True

    def _release_barrier_locked(self) -> bool:
        """Caller holds ``_barrier_cv``. Releases the round once the quorum
        arrived: the LIVE membership's cid set (an arrived member that
        then died never stands in for a live one that did not arrive), or
        the static worker count without a membership plane."""
        el = self._elastic
        required_cids = None
        if el is not None:
            with el.cv:
                if el.has_members():
                    required_cids = {m.cid for m in el.active_members()}
        if required_cids is None:
            if self._barrier_count < self._num_workers:
                return False
        else:
            arrived = {tok[0] for tok, g in self._barrier_arrived.items()
                       if g == self._barrier_gen}
            if not arrived or not required_cids.issubset(arrived):
                return False
        if obs.enabled() and el is not None and self._barrier_stamps:
            # the barrier wait by rank: the rank with ~zero wait is the
            # one everyone else waited on
            now = time.monotonic()
            with el.cv:
                rank_of = {m.cid: m.rank for m in el.members.values()}
            for tok, t0 in self._barrier_stamps.items():
                r = rank_of.get(tok[0])
                if r is not None:
                    obs.observe(f"kvstore.barrier_wait.rank{r}_seconds",
                                now - t0)
        self._barrier_count = 0
        self._barrier_gen += 1
        for tok in self._barrier_arrived:
            self._barrier_released[tok] = True
        self._barrier_arrived.clear()
        self._barrier_stamps.clear()
        while len(self._barrier_released) > 65536:
            self._barrier_released.popitem(last=False)
        self._barrier_cv.notify_all()
        return True

    def _barrier_timeout_detail(self) -> bytes:
        """The straggler report after the \\x01 status: which ranks are
        missing and how old their heartbeats are (only the counts without
        a membership plane)."""
        detail = {"expected": self._required_workers(),
                  "arrived": self._barrier_count}
        if self._elastic is not None:
            arrived_cids = {tok[0] for tok, g in self._barrier_arrived.items()
                            if g == self._barrier_gen}
            missing = [
                {"rank": rank, "client_id": cid, "state": state,
                 "last_heartbeat_age_s": age}
                for rank, cid, state, age in self._elastic.liveness_table()
                if state == "active" and cid not in arrived_cids]
            detail["missing"] = sorted(missing, key=lambda m: m["rank"])
        obs.inc("kvstore.barrier_timeouts")
        return json.dumps(detail).encode()

    def _barrier(self, payload):
        """Membership-scoped rendezvous; returns ``(ok, detail_bytes)``. A
        16-byte (client_id, barrier_epoch) token makes it idempotent; a
        timeout rolls its own arrival back; a declared-dead member's
        arrival is rejected, not counted."""
        token = (struct.unpack_from("<QQ", payload, 0)
                 if len(payload) >= 16 else None)
        if token is not None and self._elastic is not None:
            with self._elastic.cv:
                if self._elastic.has_members():
                    m = self._elastic.members.get(token[0])
                    if m is None or m.state != "active":
                        obs.inc("elastic.stale_rejected")
                        return False, json.dumps(
                            {"stale_member": True,
                             "client_id": token[0]}).encode()
        ok, detail = True, b""
        with self._barrier_cv:
            counted = True
            if token is not None:
                if token in self._barrier_released:
                    return True, b""  # the round completed: re-ack
                if token in self._barrier_arrived:
                    # a retransmit while the round gathers waits for the
                    # release its original arrival counts toward
                    gen = self._barrier_arrived[token]
                    counted = False
                else:
                    gen = self._barrier_gen
                    self._barrier_arrived[token] = gen
                    self._barrier_stamps[token] = time.monotonic()
                    self._barrier_count += 1
            else:
                gen = self._barrier_gen
                self._barrier_count += 1
            if not (counted and self._release_barrier_locked()):
                deadline = time.monotonic() + self._barrier_timeout
                while self._barrier_gen == gen:
                    # a membership change may have shrunk the quorum
                    if self._release_barrier_locked():
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        detail = self._barrier_timeout_detail()
                        if counted:
                            self._barrier_count = max(
                                0, self._barrier_count - 1)
                            if token is not None:
                                self._barrier_arrived.pop(token, None)
                                self._barrier_stamps.pop(token, None)
                        ok = False
                        break
                    self._barrier_cv.wait(timeout=remaining)
        return ok, detail

    def _set_optimizer_bytes(self, blob: bytes):
        """The SET_OPT payload is text, ``name key=val key=val ...``, the
        format the C++ server parses too. The reference also takes a
        legacy pickle blob; unpickling one would import the reference
        package, so it raises here."""
        from ..optimizer import Updater, create as opt_create

        try:
            parts = blob.decode("ascii").split()
            name, kwargs = parts[0], {}
            for kv in parts[1:]:
                k, _, v = kv.partition("=")
                kwargs[k] = float(v)
        except (UnicodeDecodeError, ValueError, IndexError) as e:
            raise MXNetError(
                "SET_OPT: only the text spec 'name key=val ...' is taken; "
                "the legacy pickle blob is refused (unpickling it would "
                "import the reference package)") from e
        opt = opt_create(name, **kwargs)
        self._opt_spec = blob.decode("ascii")
        self._optimizer = opt
        self._updater = Updater(opt)

    def _apply(self, key, grad, weight_np):
        """The optimizer's update on host tensors; the weights stay numpy
        on the host, as in the reference."""
        from ..context import cpu
        from ..ndarray import NDArray

        w = NDArray(np.array(weight_np), ctx=cpu())
        self._updater(key, NDArray(np.asarray(grad), ctx=cpu()), w)
        # the PS keeps its weights on the host: asnumpy of this CPU NDArray
        # copies no device memory
        self._weights[key] = w.asnumpy()  # lint: disable=host-sync-on-hot-path


def main():
    import argparse

    ap = argparse.ArgumentParser(
        description="mxnet_tpu_torch parameter server (host-side)")
    ap.add_argument("--port", type=int, default=9091)
    ap.add_argument("--num-workers", type=int, default=1)
    ap.add_argument("--snapshot-dir", default=None,
                    help="durable-state directory (atomic CRC snapshots; a "
                    "warm restart picks up the newest valid one); default "
                    "MXNET_PS_SNAPSHOT_DIR")
    ap.add_argument("--snapshot-period", type=float, default=None,
                    help="seconds between snapshots "
                    "(MXNET_PS_SNAPSHOT_PERIOD_S, default 5)")
    args = ap.parse_args()
    srv = PSServer(port=args.port, num_workers=args.num_workers,
                   snapshot_dir=args.snapshot_dir,
                   snapshot_period=args.snapshot_period)
    print(f"PSServer listening on :{srv.port}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
