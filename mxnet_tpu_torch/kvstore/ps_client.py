"""Worker-side client of the parameter server (counterpart of
``mxnet_tpu/kvstore/ps_client.py``).

Every RPC has a socket timeout and reconnects and retries with capped
exponential backoff and jitter, so a killed and restarted server looks
like a slow RPC, not a worker crash. Dense and sparse pushes carry a
``(client_id, seq)`` token the server dedups on and ``barrier()`` a
barrier-epoch token, so the retry path is exactly-once end to end.

Each attempt runs under a ``kvstore.rpc`` span; inside a traced flow the
key carries that span's context after ``\x1f`` (``obs/context.py``), which
the python server strips before any lookup, so both halves of an RPC share
one trace id. Outside a trace keys go on the wire as given. Retries count
``kvstore.rpc.retries`` and their backoff. The reference's chaos hooks
(frame drops and duplicates, queue item A15(f)) are left out.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time

import numpy as np

from .. import obs
from ..obs import context as obs_context
from ..base import (MXNetError, capped_backoff, configure_socket_keepalive,
                    get_env)
from .elastic import (OP_CLOCK, OP_CLOCK_PULL, OP_HB, OP_PULL_STALE, ST_OK,
                      StaleMemberError)
from .ps_server import (OP_BARRIER, OP_INIT, OP_NAMES, OP_PULL,
                        OP_PULL_SPARSE, OP_PUSH_SEQ, OP_PUSH_SPARSE_SEQ,
                        OP_SET_OPT, OP_SHUTDOWN, OP_STATS, OP_TELEMETRY,
                        _pack_array, _pack_sparse, _recv_msg, _send_msg,
                        _unpack_array)

__all__ = ["PSClient"]


class PSClient:
    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 retries: int = 5, retry_interval: float = 0.5,
                 retry_max_interval: float = 5.0, idle_ping: float = None):
        self._addr = (host, port)
        self._timeout = timeout
        self._retries = max(1, int(retries))
        self._retry_interval = retry_interval
        self._retry_max_interval = retry_max_interval
        self._lock = threading.Lock()
        self._sock = None
        # a connection idle past this many seconds is pinged (OP_HB)
        # before reuse, so a dead server shows at the next RPC; None keeps
        # TCP keepalive alone (the native server has no ping opcode)
        self._idle_ping_s = (idle_ping if idle_ping is not None
                             else get_env("MXNET_PS_IDLE_PING_S", None,
                                          float))
        self._last_io = time.monotonic()
        self._client_id = int.from_bytes(os.urandom(8), "little")
        self._push_seq = 0  # guarded by _lock, allocated with the send
        self._barrier_epoch = 0
        self._connect()

    def _connect(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)
        configure_socket_keepalive(self._sock)
        self._last_io = time.monotonic()

    def _ping_stale_connection(self):
        """An OP_HB round trip before reusing a long-idle connection; any
        failure drops the socket for the caller's reconnect path."""
        if (self._sock is None or not self._idle_ping_s
                or time.monotonic() - self._last_io < self._idle_ping_s):
            return
        try:
            self._sock.settimeout(min(self._timeout, 3.0))
            _send_msg(self._sock, OP_HB, "", b"")
            _recv_msg(self._sock)
            self._sock.settimeout(self._timeout)
            self._last_io = time.monotonic()
        except (ConnectionError, OSError):
            obs.inc("kvstore.rpc.stale_connections")
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _rpc(self, opcode, key="", payload=b"", timeout=None, retries=None):
        # the lock spans send and receive: the wire is serial per socket,
        # and push() pairs its seq allocation with the send
        with self._lock:
            return self._rpc_locked(opcode, key, payload, timeout, retries)  # lint: disable=blocking-call-under-lock

    def _rpc_locked(self, opcode, key="", payload=b"", timeout=None,
                    retries=None):
        """Caller holds ``self._lock``."""
        retries = self._retries if retries is None else retries
        last_err = None
        opname = OP_NAMES.get(opcode, str(opcode))
        for attempt in range(retries):
            try:
                self._ping_stale_connection()
                if self._sock is None:
                    self._connect()
                if timeout is not None:
                    self._sock.settimeout(timeout)
                rec = obs.enabled()
                t0 = time.monotonic() if rec else 0.0
                with obs.trace.span("kvstore.rpc", op=opname, key=key,
                                    attempt=attempt):
                    # inside a traced flow the key carries this span's
                    # context; the python server strips it before lookup
                    wire_key = obs_context.inject_key(
                        key, obs_context.current())
                    _send_msg(self._sock, opcode, wire_key, payload)
                    reply = _recv_msg(self._sock)
                if rec:
                    obs.observe(f"kvstore.rpc.{opname}_seconds",
                                time.monotonic() - t0)
                    if opname in ("push", "push_seq", "push_sparse",
                                  "push_sparse_seq", "init"):
                        obs.inc("kvstore.bytes_pushed", len(payload))
                    elif opname in ("pull", "pull_sparse"):
                        obs.inc("kvstore.bytes_pulled", len(reply[2]))
                if timeout is not None:
                    self._sock.settimeout(self._timeout)
                self._last_io = time.monotonic()
                return reply
            except (ConnectionError, OSError) as e:  # timeouts included
                last_err = e
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                delay = capped_backoff(attempt, self._retry_interval,
                                       self._retry_max_interval)
                if obs.enabled():
                    obs.inc("kvstore.rpc.retries")
                    obs.observe("kvstore.rpc.backoff_seconds", delay)
                    obs.trace.event("kvstore.rpc.retry", op=opname, key=key,
                                    attempt=attempt, error=str(e))
                time.sleep(delay)
        obs.inc("kvstore.rpc.failures")
        raise MXNetError(
            f"PS rpc op={opcode} key={key!r} failed after "
            f"{retries} attempts: {last_err}")

    def init(self, key: str, value: np.ndarray):
        self._rpc(OP_INIT, key, _pack_array(np.ascontiguousarray(value)))

    def push(self, key: str, grad: np.ndarray, compressor=None):
        if compressor is not None:
            payload = compressor.pack_wire(key, np.ascontiguousarray(grad))
        else:
            payload = _pack_array(np.ascontiguousarray(grad))
        # seq allocation and send are one critical section: out-of-order
        # sends of one key would make the server drop the lower seq
        with self._lock:
            self._push_seq += 1
            # the seq allocation and its send: one step under the lock
            _, _, reply = self._rpc_locked(  # lint: disable=blocking-call-under-lock
                OP_PUSH_SEQ, key,
                struct.pack("<QQ", self._client_id, self._push_seq)
                + payload)
        if bytes(reply[:1]) != b"\x00":
            raise MXNetError(
                f"push rejected for key {key!r} (uninitialized key or "
                "malformed frame)")

    def pull(self, key: str) -> np.ndarray:
        _, _, payload = self._rpc(OP_PULL, key)
        return _unpack_array(payload)

    def push_row_sparse(self, key: str, indices: np.ndarray,
                        rows: np.ndarray):
        """Push only the touched rows, seq-tagged like the dense push."""
        with self._lock:
            self._push_seq += 1
            # the seq allocation and its send: one step under the lock
            _, _, payload = self._rpc_locked(  # lint: disable=blocking-call-under-lock
                OP_PUSH_SPARSE_SEQ, key,
                struct.pack("<QQ", self._client_id, self._push_seq)
                + _pack_sparse(indices, rows))
        if bytes(payload[:1]) != b"\x00":
            raise MXNetError(
                f"sparse push rejected for key {key!r} (bad dtype, "
                "uninitialized key, or out-of-range row index)")

    def pull_row_sparse(self, key: str, indices: np.ndarray) -> np.ndarray:
        _, _, payload = self._rpc(
            OP_PULL_SPARSE, key,
            _pack_array(np.ascontiguousarray(indices, np.int32)))
        if len(payload) == 0:  # the server's failure reply
            raise MXNetError(
                f"sparse pull rejected for key {key!r} (uninitialized key "
                "or out-of-range row index)")
        return _unpack_array(payload)

    def push_clock(self, rank: int, step: int):
        """Commit "this rank FINISHED ``step``" (``OP_CLOCK``); returns the
        fleet's ``(floor, max_clock, widen)``."""
        _, _, reply = self._rpc(
            OP_CLOCK, "",
            struct.pack("<QQQ", self._client_id, int(rank), int(step)))
        st, floor, maxc, widen = struct.unpack_from("<BQQI", reply, 0)
        if st != ST_OK:
            raise MXNetError(f"clock push rejected for rank {rank}")
        return floor, maxc, widen

    def pull_clock(self):
        """The committed-clock table: ``(floor, {rank: clock})``."""
        _, _, reply = self._rpc(OP_CLOCK_PULL, "")
        st, floor, n = struct.unpack_from("<BQI", reply, 0)
        if st != ST_OK:
            raise MXNetError("clock pull failed")
        table = {}
        for i in range(n):
            r, c = struct.unpack_from("<QQ", reply, 13 + 16 * i)
            table[int(r)] = int(c)
        return floor, table

    def pull_stale(self, key: str, rank: int, step: int, staleness: int,
                   timeout: float = 90.0):
        """Staleness-gated pull (``OP_PULL_STALE``): blocks server-side
        while this worker's ``step`` runs more than ``staleness`` steps
        ahead of the fleet's committed-clock floor. Returns ``(weights,
        floor, max_clock)``."""
        payload = struct.pack("<QQQQd", self._client_id, int(rank),
                              int(step), int(staleness), float(timeout))
        _, _, reply = self._rpc(OP_PULL_STALE, key, payload,
                                timeout=timeout + 10.0)
        st, floor, maxc = struct.unpack_from("<BQQ", reply, 0)
        if st != ST_OK:
            raise TimeoutError(
                f"staleness-gated pull for key {key!r} timed out: this "
                f"rank's clock {step} is more than {staleness} steps "
                f"ahead of the fleet floor {floor}")
        return _unpack_array(reply[17:]), floor, maxc

    def set_optimizer(self, optimizer):
        """Send the optimizer as the text spec both servers parse."""
        name = type(optimizer).__name__.lower()
        kwargs = {"learning_rate": optimizer.lr, "wd": optimizer.wd,
                  "rescale_grad": optimizer.rescale_grad}
        mom = getattr(optimizer, "momentum", None)
        if mom:
            kwargs["momentum"] = mom
        for k in ("beta1", "beta2", "epsilon"):
            v = getattr(optimizer, k, None)
            if v is not None:
                kwargs[k] = v
        spec = name + " " + " ".join(f"{k}={v}" for k, v in kwargs.items())
        _, _, reply = self._rpc(OP_SET_OPT, "", spec.encode("ascii"))
        if bytes(reply[:1]) not in (b"", b"\x00"):
            raise MXNetError("set_optimizer rejected: "
                             + bytes(reply[1:]).decode("utf-8", "replace"))

    def barrier(self, timeout: float = 90.0):
        """Idempotent rendezvous: the ``(client_id, barrier_epoch)`` token
        lets the server count a retried arrival once. A timeout raises
        with the server's report of the missing ranks."""
        with self._lock:
            # the epoch advances even on failure: reusing a token at the
            # next rendezvous could match this round's release
            epoch = self._barrier_epoch
            self._barrier_epoch += 1
            payload = struct.pack("<QQ", self._client_id, epoch)
            # the epoch and its barrier frame: one step under the lock
            _, _, reply = self._rpc_locked(OP_BARRIER, payload=payload,  # lint: disable=blocking-call-under-lock
                                           timeout=timeout)
        if bytes(reply[:1]) != b"\x01":
            return
        detail = ""
        try:
            d = json.loads(bytes(reply[1:]).decode()) if len(reply) > 1 \
                else {}
        except (ValueError, UnicodeDecodeError):
            d = {}
        if d.get("stale_member"):
            raise StaleMemberError(
                "barrier rejected: this worker is not a live fleet member "
                "(declared dead after missed heartbeats); restart to "
                "rejoin")
        if d:
            missing = ", ".join(
                f"rank {m['rank']} ({m['state']}, last heartbeat "
                f"{m['last_heartbeat_age_s']}s ago)"
                for m in d.get("missing", []))
            detail = (f": {d.get('arrived')}/{d.get('expected')} arrived"
                      + (f"; missing {missing}" if missing else ""))
        raise TimeoutError(
            "kvstore barrier timed out waiting for stragglers" + detail)

    def telemetry(self, drain: bool = True) -> dict:
        """The training-fleet telemetry document (``OP_TELEMETRY``):
        ``{"parts": [...]}``, the server's own part (its RPC lanes and
        STATS, with the straggler verdicts and hot keys) and every cached
        worker part. Draining is destructive and ``_rpc`` retries lost
        replies, so the request carries a fresh collection token: a
        retried frame gets the server's cached reply instead of draining
        a second batch."""
        spec = {"drain": bool(drain), "token": os.urandom(8).hex()}
        _, _, reply = self._rpc(OP_TELEMETRY, "",
                                json.dumps(spec).encode("utf-8"))
        if bytes(reply[:1]) != b"\x00":
            raise MXNetError("PS telemetry failed: "
                             + bytes(reply[1:]).decode("utf-8", "replace"))
        return json.loads(bytes(reply[1:]).decode("utf-8"))

    def stats(self, include_metrics: bool = True) -> dict:
        """The server's STATS (``OP_STATS``): membership liveness, the
        training-fleet section, hot keys, the async clocks and, by
        default, the metrics snapshot under ``"metrics"``."""
        payload = b"" if include_metrics \
            else json.dumps({"metrics": False}).encode("utf-8")
        _, _, reply = self._rpc(OP_STATS, "", payload)
        if bytes(reply[:1]) != b"\x00":
            raise MXNetError("PS stats failed: "
                             + bytes(reply[1:]).decode("utf-8", "replace"))
        return json.loads(bytes(reply[1:]).decode("utf-8"))

    def shutdown(self):
        self._rpc(OP_SHUTDOWN)

    def close(self):
        """End this client session (the server keeps running). Safe to
        call twice."""
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
