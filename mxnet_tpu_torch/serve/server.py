"""Threaded socket front end of ``mxnet_tpu_torch.serve`` (counterpart of
``mxnet_tpu/serve/server.py``).

The serve plane rides the parameter-server framing
(``kvstore/ps_server.py``) on its own opcode range (``wire.py``), byte for
byte as the reference's, so a reference client talks to this server and
the other way round.

Wire protocol (little-endian):

  INFER  request : f64 deadline_ms (0 = none) | u8 priority | packed arrays
  INFER  reply   : u8 status | (ok: u32 param_version | packed arrays)
                               (err: utf-8 message)
  HEALTH reply   : u8 0 — process liveness only
  READY  reply   : u8 status | u32 param_version
  RELOAD request : utf-8 json {"path": ..., "epoch": ..., "prefix": ...}
  RELOAD reply   : u8 status | (ok: u32 new_version; err: message)
  STATS  reply   : u8 0 | utf-8 json (engine + batcher + server stats)
  DRAIN  request : u8 stop_after (0/1); reply u8 0 once drained
  PREPARE_RELOAD : utf-8 json {"path", "epoch", "prefix", "version",
                   "token": [cid, epoch]} — load, validate and stage
  COMMIT_RELOAD  : u64 cid | u64 epoch — flip the staged set; a retried
                   commit re-acks from the committed-token LRU
  ABORT_RELOAD   : u64 cid | u64 epoch — discard the staged set
  INFER_STREAM   : f64 deadline_ms | u8 priority | u32 max_new_tokens |
                   f32 temperature | packed arrays (one int32 prompt);
                   replied by STREAM_TOKEN (u32 token | u32 index) frames
                   closed by STREAM_END (u8 status | u32 n_tokens) or
                   STREAM_ERROR (u8 status | message)
  TELEMETRY request : utf-8 json {"drain": bool (default true),
                   "format": "json"|"prometheus", "openmetrics": bool,
                   "token": collection token, "retained": [trace ids]}
                   (empty = defaults)
  TELEMETRY reply: u8 status | utf-8 json {"parts": [telemetry part,
                   ...]} (``obs.telemetry_part``: pid, role, clock
                   anchor, drained span ring, metrics snapshot; a
                   FleetServer adds one part per live replica) or the
                   Prometheus text exposition (``obs/export.py``)
  DUMP   request : utf-8 json {"reason": str, "write": bool} (or empty)
  DUMP   reply   : u8 status | utf-8 json flight-recorder bundle
                   (``obs/blackbox.py``)

A request key may carry a ``\\x1f``-suffixed W3C traceparent
(``obs/context.py``): the handler strips it before anything reads the key
and runs the request under it; an INFER or INFER_STREAM without one is a
new root here when telemetry records (``serve.rpc`` span, tail verdict at
its close). The reference's ``chaos`` kill points are queue item A15 (its
item 4) of the port.

Graceful degradation: a deadline-expired or shed request gets an explicit
status, never a hang; ``drain()`` flips readiness, finishes in-flight
work, then (optionally) stops the listener; a hot reload swaps parameters
atomically and every reply carries the version it was computed with.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from .. import obs
from ..kvstore.ps_server import (_pack_arrays, _recv_msg, _send_msg,
                                 _unpack_arrays)
from ..obs import context as obs_context
from ..wire import SERVE_WIRE
from .batcher import DynamicBatcher
from .engine import (DeadlineExceeded, Draining, InferenceEngine,
                     RequestRejected, ServeError)

__all__ = ["ServeServer", "OP_INFER", "OP_HEALTH", "OP_READY", "OP_RELOAD",
           "OP_STATS", "OP_DRAIN", "OP_SHUTDOWN", "OP_PREPARE_RELOAD",
           "OP_COMMIT_RELOAD", "OP_ABORT_RELOAD", "OP_TELEMETRY", "OP_DUMP",
           "OP_INFER_STREAM", "OP_STREAM_TOKEN", "OP_STREAM_END",
           "OP_STREAM_ERROR", "SERVE_OP_NAMES", "STATUS_OK",
           "STATUS_REJECTED", "STATUS_DEADLINE", "STATUS_BAD_REQUEST",
           "STATUS_DRAINING", "STATUS_INTERNAL", "STATUS_NOT_READY"]

(OP_INFER, OP_HEALTH, OP_READY, OP_RELOAD, OP_STATS, OP_DRAIN,
 OP_SHUTDOWN, OP_PREPARE_RELOAD, OP_COMMIT_RELOAD,
 OP_ABORT_RELOAD, OP_TELEMETRY, OP_DUMP, OP_INFER_STREAM,
 OP_STREAM_TOKEN, OP_STREAM_END, OP_STREAM_ERROR) = SERVE_WIRE.codes(
    "infer", "health", "ready", "reload", "stats", "drain",
    "serve_shutdown", "prepare_reload", "commit_reload", "abort_reload",
    "telemetry", "dump", "infer_stream", "stream_token", "stream_end",
    "stream_error")

SERVE_OP_NAMES = dict(SERVE_WIRE.names())

(STATUS_OK, STATUS_REJECTED, STATUS_DEADLINE, STATUS_BAD_REQUEST,
 STATUS_DRAINING, STATUS_INTERNAL, STATUS_NOT_READY) = range(7)

_INFER_HDR = struct.Struct("<dB")  # deadline_ms (0 = none), priority
# deadline_ms, priority, max_new_tokens (0 = server default), temperature
_STREAM_HDR = struct.Struct("<dBIf")
_TOKEN_FRAME = struct.Struct("<II")


def _err_payload(status: int, msg: str) -> bytes:
    return struct.pack("<B", status) + msg.encode("utf-8", "replace")


class ServeServer:
    """A concurrent inference endpoint over an :class:`InferenceEngine`.

    One accept loop and one thread per connection; every connection's
    INFERs go into the shared :class:`DynamicBatcher`, whose worker is the
    one thread that runs the engine. ``decode`` (a
    ``serve.DecodeScheduler``) serves ``OP_INFER_STREAM``.
    """

    def __init__(self, engine: Optional[InferenceEngine] = None,
                 host: str = "127.0.0.1", port: int = 0, *,
                 batcher: Optional[DynamicBatcher] = None,
                 decode=None,
                 max_linger_ms: float = 2.0, max_queue: int = 256,
                 lanes: int = 2, default_timeout: float = 30.0):
        self._engine = engine
        if batcher is not None:
            self._batcher = batcher
        elif engine is not None:
            self._batcher = DynamicBatcher(
                engine, max_linger_ms=max_linger_ms, max_queue=max_queue,
                lanes=lanes)
        else:
            self._batcher = None
        self._decode = decode
        self._default_timeout = float(default_timeout)
        self._draining = False
        self._started = time.monotonic()
        self._shed_draining = 0  # server-level sheds (pre-batcher)
        # two-phase reload: the staged token and the committed-token LRU
        # (a retried COMMIT re-acks, never re-flips); one lock serializes
        # prepare/commit/abort and the single-replica reload
        self._reload_lock = threading.Lock()
        self._staged_token = None
        self._committed_tokens: "OrderedDict" = OrderedDict()
        # exactly-once telemetry drains: a retried collection token
        # re-serves the cached reply instead of draining again
        self._telemetry_tokens: "OrderedDict" = OrderedDict()
        self._telemetry_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads = []
        self._conns = []

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
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
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads = [th for th in self._threads if th.is_alive()]
            self._threads.append(t)

    def start(self):
        t = threading.Thread(target=self.serve_forever, daemon=True,
                             name="mxnet-torch-serve-accept")
        t.start()
        return t

    def stop(self):
        self._stop.set()
        self._close_listener()
        self._sever_connections()
        # reap handler threads; OP_SHUTDOWN stops from inside a handler,
        # which must not join itself
        me = threading.current_thread()
        deadline = time.monotonic() + 1.0  # one budget for the whole reap
        leaked = 0
        for t in [t for t in self._threads if t is not me]:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                leaked += 1
        if leaked:
            obs.inc("serve.handler_threads_leaked", leaked)
            obs.event("serve.handler_threads_leaked", count=leaked)
        if self._batcher is not None:
            self._batcher.close(timeout=5)
        if self._decode is not None:
            self._decode.close(timeout=5)

    def abort(self):
        """Crash-style stop: sever the listener and every connection
        without draining queued or in-flight work."""
        self._stop.set()
        self._close_listener()
        self._sever_connections()

    def _sever_connections(self):
        # shutdown() wakes a handler blocked in recv (close() alone does
        # not), so the handler threads end and release the server and its
        # engine; a snapshot: handler threads remove themselves from _conns
        for c in list(self._conns):
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def _close_listener(self):
        # shutdown() first: close() alone does not wake the accept loop
        # blocked in its poll, and the kernel keeps the listener alive
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def drain(self, stop: bool = False, timeout: float = 30.0) -> bool:
        """Flip readiness off, let queued and in-flight requests finish,
        refuse new ones; ``stop=True`` closes the listener afterwards."""
        self._draining = True
        obs.event("serve.drain", stop=stop)
        ok = True
        if self._batcher is not None:
            ok = self._batcher.drain(timeout=timeout)
        if self._decode is not None:
            ok = self._decode.drain(timeout=timeout) and ok
        if stop:
            self.stop()
        return ok

    def reload(self, path: str, epoch: Optional[int] = None,
               prefix: str = "ckpt") -> int:
        """Hot-swap parameters from a newer artifact of the same graph.
        In-flight requests keep the generation they started with."""
        if self._engine is None:
            raise ServeError("no engine loaded")
        from . import load_params

        arg, aux = load_params(path, epoch=epoch, prefix=prefix)
        with self._reload_lock:
            return self._engine.reload(arg, aux)

    def prepare_reload(self, path: str, epoch: Optional[int] = None,
                       prefix: str = "ckpt", *,
                       version: Optional[int] = None, token=None) -> int:
        """Phase one of the two-phase reload: load, validate and stage the
        new generation without flipping."""
        if self._engine is None:
            raise ServeError("no engine loaded")
        from . import load_params

        arg, aux = load_params(path, epoch=epoch, prefix=prefix)
        with self._reload_lock:
            staged = self._engine.prepare_reload(arg, aux, version=version)
            self._staged_token = tuple(token) if token is not None else None
        return staged

    def commit_reload(self, token=None) -> int:
        """Phase two: flip the staged generation. A token already in the
        committed LRU re-acks with the version it flipped to."""
        if self._engine is None:
            raise ServeError("no engine loaded")
        tok = tuple(token) if token is not None else None
        with self._reload_lock:
            if tok is not None and tok in self._committed_tokens:
                return self._committed_tokens[tok]  # retried frame: re-ack
            if tok is not None and self._staged_token not in (None, tok):
                raise ServeError(
                    f"commit token {tok} does not match staged "
                    f"{self._staged_token}")
            version = self._engine.commit_reload()
            self._staged_token = None
            if tok is not None:
                self._committed_tokens[tok] = version
                while len(self._committed_tokens) > 4096:
                    self._committed_tokens.popitem(last=False)
        return version

    def abort_reload(self, token=None) -> None:
        """Discard a staged generation (idempotent rollback)."""
        if self._engine is None:
            return
        tok = tuple(token) if token is not None else None
        with self._reload_lock:
            if tok is None or self._staged_token in (None, tok):
                self._engine.abort_reload()
                self._staged_token = None

    def stats(self, include_metrics: bool = True) -> dict:
        """Server, engine, batcher and decode stats; ``include_metrics``
        adds the metrics registry's snapshot under ``"metrics"`` (the
        telemetry path leaves it out: its part carries one)."""
        out = {"uptime_seconds": round(time.monotonic() - self._started, 3),
               "draining": self._draining,
               "connections": len(self._conns),
               "sheds": {"draining": self._shed_draining},
               "pid": os.getpid()}
        if include_metrics:
            out["metrics"] = obs.metrics.snapshot()
        if self._engine is not None:
            out["engine"] = self._engine.stats()
        if self._batcher is not None:
            out["batcher"] = self._batcher.stats()
        if self._decode is not None:
            out["decode"] = self._decode.stats()
        return out

    def telemetry(self, drain: bool = True,
                  retained: Optional[list] = None) -> dict:
        """This process's telemetry contribution (``OP_TELEMETRY``): span
        ring (drained by default), metrics snapshot, clock anchor. A
        FleetServer overrides this to append every live replica's parts.
        ``retained`` is the tail plane's verdict list riding the request:
        pending traces named in it promote into the ring before the
        drain."""
        if retained:
            obs.tail.resolve(retained)
        # stats first: anything stats() mirrors into gauges must land in
        # the snapshot telemetry_part() takes
        st = self.stats(include_metrics=False)
        part = obs.telemetry_part(drain=drain, role="server")
        part["stats"] = st
        return {"parts": [part]}

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------
    def _handle(self, conn: socket.socket):
        try:
            self._handle_loop(conn)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            try:
                self._conns.remove(conn)
            except ValueError:
                pass

    def _handle_loop(self, conn: socket.socket):
        try:
            while True:
                opcode, key, payload = _recv_msg(conn)
                # strip the wire's trace context before anything reads
                # the key; a context-less INFER is a new root here
                key, wctx = obs_context.extract_key(key)
                rec = obs.enabled()
                root_here = False
                if wctx is None and rec and opcode in (OP_INFER,
                                                       OP_INFER_STREAM):
                    wctx = obs_context.new_root()
                    root_here = True
                t0 = time.monotonic() if rec else 0.0
                opname = SERVE_OP_NAMES.get(opcode, str(opcode))
                try:
                    with obs_context.use(wctx), \
                            obs.trace.span("serve.rpc", op=opname):
                        alive = self._handle_one(conn, opcode, key, payload)
                finally:
                    if rec:
                        obs.observe(f"serve.rpc.{opname}_seconds",
                                    time.monotonic() - t0)
                    # tail retention: a root born here takes its verdict
                    # now (latency + the outcome noted while handling);
                    # a remote root's hop applies only its local flags.
                    # Both clear this thread's notes
                    if root_here:
                        obs.tail.finish_root(wctx, time.monotonic() - t0)
                    else:
                        obs.tail.finish_remote(wctx,
                                               time.monotonic() - t0)
                if not alive:
                    return
        except (ConnectionError, OSError):
            return

    def _reply(self, conn, opcode: int, payload):
        _send_msg(conn, opcode, "", payload)

    def _handle_one(self, conn, opcode: int, key: str, payload) -> bool:
        if opcode == OP_INFER:
            self._reply(conn, OP_INFER, self._do_infer(payload))
        elif opcode == OP_INFER_STREAM:
            return self._do_infer_stream(conn, payload)
        elif opcode == OP_HEALTH:
            self._reply(conn, OP_HEALTH, struct.pack("<B", STATUS_OK))
        elif opcode == OP_READY:
            # a decode-only replica is ready while its scheduler accepts
            # work; the serving version rides along
            src = self._batcher if self._batcher is not None \
                else self._decode
            if src is None or (self._engine is None
                               and not hasattr(src, "ready")):
                status = STATUS_NOT_READY
            elif self._draining:
                status = STATUS_DRAINING
            elif self._engine is None and not src.ready():
                status = STATUS_NOT_READY
            else:
                status = STATUS_OK
            if self._engine is not None:
                version = self._engine.version
            else:
                version = int(getattr(src, "version", 0) or 0)
            self._reply(conn, OP_READY,
                        struct.pack("<BI", status, version))
        elif opcode == OP_RELOAD:
            try:
                spec = json.loads(bytes(payload).decode("utf-8"))
                version = self.reload(spec["path"],
                                      epoch=spec.get("epoch"),
                                      prefix=spec.get("prefix", "ckpt"))
                self._reply(conn, OP_RELOAD,
                            struct.pack("<BI", STATUS_OK, version))
            except Exception as e:  # noqa: BLE001 — wire-reported
                obs.inc("serve.reload_errors")
                self._reply(conn, OP_RELOAD, _err_payload(
                    STATUS_INTERNAL, f"{type(e).__name__}: {e}"))
        elif opcode == OP_PREPARE_RELOAD:
            try:
                spec = json.loads(bytes(payload).decode("utf-8"))
                staged = self.prepare_reload(
                    spec["path"], epoch=spec.get("epoch"),
                    prefix=spec.get("prefix", "ckpt"),
                    version=spec.get("version"), token=spec.get("token"))
                self._reply(conn, OP_PREPARE_RELOAD,
                            struct.pack("<BI", STATUS_OK, staged))
            except Exception as e:  # noqa: BLE001 — wire-reported
                obs.inc("serve.reload_errors")
                self._reply(conn, OP_PREPARE_RELOAD, _err_payload(
                    STATUS_INTERNAL, f"{type(e).__name__}: {e}"))
        elif opcode == OP_COMMIT_RELOAD:
            try:
                token = struct.unpack_from("<QQ", payload, 0) \
                    if len(payload) >= 16 else None
                version = self.commit_reload(token)
                self._reply(conn, OP_COMMIT_RELOAD,
                            struct.pack("<BI", STATUS_OK, version))
            except Exception as e:  # noqa: BLE001 — wire-reported
                obs.inc("serve.reload_errors")
                self._reply(conn, OP_COMMIT_RELOAD, _err_payload(
                    STATUS_INTERNAL, f"{type(e).__name__}: {e}"))
        elif opcode == OP_ABORT_RELOAD:
            token = struct.unpack_from("<QQ", payload, 0) \
                if len(payload) >= 16 else None
            self.abort_reload(token)
            self._reply(conn, OP_ABORT_RELOAD, struct.pack("<B", STATUS_OK))
        elif opcode == OP_STATS:
            # optional json payload {"metrics": false} skips the registry
            # snapshot (the fleet supervisor's cheap per-probe poll)
            include = True
            if len(payload):
                try:
                    spec = json.loads(bytes(payload).decode("utf-8"))
                    include = bool(spec.get("metrics", True))
                except ValueError:
                    pass
            blob = json.dumps(self.stats(include_metrics=include),
                              default=str).encode("utf-8")
            self._reply(conn, OP_STATS, struct.pack("<B", STATUS_OK) + blob)
        elif opcode == OP_TELEMETRY:
            try:
                spec = json.loads(bytes(payload).decode("utf-8")) \
                    if len(payload) else {}
                token = spec.get("token")
                blob = None
                if token is not None:
                    with self._telemetry_lock:
                        blob = self._telemetry_tokens.get(token)
                if blob is None:
                    tel = self.telemetry(drain=bool(spec.get("drain", True)),
                                         retained=spec.get("retained"))
                    if spec.get("format") == "prometheus":
                        blob = obs.export_mod.parts_to_prometheus(
                            tel["parts"],
                            openmetrics=bool(spec.get("openmetrics", True)),
                        ).encode("utf-8")
                    else:
                        blob = json.dumps(tel, default=float).encode("utf-8")
                    if token is not None:
                        with self._telemetry_lock:
                            self._telemetry_tokens[token] = blob
                            while len(self._telemetry_tokens) > 4:
                                self._telemetry_tokens.popitem(last=False)
                self._reply(conn, OP_TELEMETRY,
                            struct.pack("<B", STATUS_OK) + blob)
            except Exception as e:  # noqa: BLE001 — wire-reported
                obs.inc("serve.telemetry_errors")
                self._reply(conn, OP_TELEMETRY, _err_payload(
                    STATUS_INTERNAL, f"{type(e).__name__}: {e}"))
        elif opcode == OP_DUMP:
            # the flight recorder's bundle, built from the always-on ring:
            # nothing drains, so retries are harmless
            try:
                spec = json.loads(bytes(payload).decode("utf-8")) \
                    if len(payload) else {}
                reason = str(spec.get("reason", "wire"))
                doc = obs.blackbox.bundle(reason=reason)
                if spec.get("write") and obs.blackbox.enabled():
                    # persist the same document the reply carries
                    doc["path"] = obs.blackbox.dump(reason=reason, doc=doc)
                blob = json.dumps(doc, default=str).encode("utf-8")
                self._reply(conn, OP_DUMP,
                            struct.pack("<B", STATUS_OK) + blob)
            except Exception as e:  # noqa: BLE001 — wire-reported
                obs.inc("serve.dump_errors")
                self._reply(conn, OP_DUMP, _err_payload(
                    STATUS_INTERNAL, f"{type(e).__name__}: {e}"))
        elif opcode == OP_DRAIN:
            stop = bool(payload and payload[0])
            drained = self.drain(stop=False)
            self._reply(conn, OP_DRAIN, struct.pack(
                "<B", STATUS_OK if drained else STATUS_INTERNAL))
            if stop:
                self.stop()
                return False
        elif opcode == OP_SHUTDOWN:
            self._reply(conn, OP_SHUTDOWN, struct.pack("<B", STATUS_OK))
            self.stop()
            return False
        else:
            self._reply(conn, opcode,
                        _err_payload(STATUS_BAD_REQUEST,
                                     f"unknown opcode {opcode}"))
        return True

    def _do_infer_stream(self, conn, payload) -> bool:
        """Relay one generation as a chunked reply sequence: from the decode
        scheduler on a replica, from ``Router.generate`` on a fleet front
        (both yield ints and raise the typed serve errors). Returns False
        (drop the connection) only when the client died mid-stream;
        closing the generator cancels the generation so that its KV pages
        are reclaimed at the next step boundary."""
        src = self._decode if self._decode is not None else self._batcher
        gen_fn = getattr(src, "generate", None)
        if gen_fn is None:
            self._reply(conn, OP_STREAM_ERROR, _err_payload(
                STATUS_NOT_READY, "no decode path loaded"))
            return True
        if self._draining:
            self._shed_draining += 1
            obs.inc("serve.shed_draining")
            obs.tail.note("shed")
            self._reply(conn, OP_STREAM_ERROR, _err_payload(
                STATUS_DRAINING, "endpoint draining"))
            return True
        try:
            deadline_ms, priority, max_new, temp = \
                _STREAM_HDR.unpack_from(payload, 0)
            arrays, _ = _unpack_arrays(payload[_STREAM_HDR.size:])
            tokens = np.asarray(arrays[0]).reshape(-1)
        except (struct.error, IndexError, KeyError, ValueError) as e:
            self._reply(conn, OP_STREAM_ERROR, _err_payload(
                STATUS_BAD_REQUEST, f"malformed INFER_STREAM frame: {e}"))
            return True
        gen = gen_fn(tokens,
                     max_new_tokens=int(max_new) or None,
                     deadline_ms=deadline_ms or None,
                     priority=int(priority),
                     temperature=float(temp))
        n = 0
        try:
            try:
                for tok in gen:
                    n += 1
                    _send_msg(conn, OP_STREAM_TOKEN, "",
                              _TOKEN_FRAME.pack(int(tok) & 0xFFFFFFFF, n))
                _send_msg(conn, OP_STREAM_END, "",
                          struct.pack("<BI", STATUS_OK, n))
            except RequestRejected as e:
                obs.tail.note("shed")
                _send_msg(conn, OP_STREAM_ERROR, "",
                          _err_payload(STATUS_REJECTED, str(e)))
            except DeadlineExceeded as e:
                obs.tail.note("deadline")
                _send_msg(conn, OP_STREAM_ERROR, "",
                          _err_payload(STATUS_DEADLINE, str(e)))
            except Draining as e:
                obs.tail.note("shed")
                _send_msg(conn, OP_STREAM_ERROR, "",
                          _err_payload(STATUS_DRAINING, str(e)))
            except ServeError as e:
                obs.tail.note("error")
                _send_msg(conn, OP_STREAM_ERROR, "",
                          _err_payload(STATUS_INTERNAL, str(e)))
        except (ConnectionError, OSError):
            obs.inc("serve.stream_client_lost")
            return False  # the client vanished mid-stream
        finally:
            gen.close()
            if n:
                obs.inc("serve.stream_tokens", n)
        return True

    def _do_infer(self, payload):
        if self._batcher is None:
            return _err_payload(STATUS_NOT_READY, "no model loaded")
        if self._draining:
            self._shed_draining += 1
            obs.inc("serve.shed_draining")
            return _err_payload(STATUS_DRAINING, "endpoint draining")
        try:
            deadline_ms, priority = _INFER_HDR.unpack_from(payload, 0)
            arrays, _ = _unpack_arrays(payload[_INFER_HDR.size:])
        except (struct.error, IndexError, KeyError, ValueError) as e:
            return _err_payload(STATUS_BAD_REQUEST,
                                f"malformed INFER frame: {e}")
        try:
            fut = self._batcher.submit(arrays,
                                       deadline_ms=deadline_ms or None,
                                       priority=int(priority))
            wait = (deadline_ms / 1e3) if deadline_ms \
                else self._default_timeout
            outs, version = fut.result(timeout=wait + 1.0)
        except RequestRejected as e:
            obs.tail.note("shed")
            return _err_payload(STATUS_REJECTED, str(e))
        except DeadlineExceeded as e:
            obs.tail.note("deadline")
            # a deadline-less request timing out the server-side wait is
            # an internal condition, not an SLO miss the client asked for
            if not deadline_ms:
                return _err_payload(
                    STATUS_INTERNAL,
                    f"server wait exceeded {self._default_timeout}s: {e}")
            return _err_payload(STATUS_DEADLINE, str(e))
        except Draining as e:
            obs.tail.note("shed")
            return _err_payload(STATUS_DRAINING, str(e))
        except ServeError as e:
            obs.tail.note("error")
            return _err_payload(STATUS_INTERNAL, str(e))
        with obs.trace.span("serve.serialize", outputs=len(outs)):
            # status header and arrays travel as separate parts
            return [struct.pack("<BI", STATUS_OK, version),
                    _pack_arrays(outs)]


def _serve_context():
    """The engine's placement: ``MXNET_SERVE_PLATFORM`` (the reference's
    pin, ``cpu`` or ``gpu``) when set, else the default context (the card;
    without one, raises)."""
    from ..context import cpu, current_context, gpu

    plat = os.environ.get("MXNET_SERVE_PLATFORM", "").strip().lower()
    if not plat:
        return current_context()
    if plat == "cpu":
        return cpu()
    if plat in ("gpu", "cuda"):
        return gpu(0)
    raise ValueError(f"MXNET_SERVE_PLATFORM={plat!r}: want cpu or gpu")


def main(argv=None):  # pragma: no cover - CLI shim
    import argparse

    ap = argparse.ArgumentParser(description="mxnet_tpu_torch serving "
                                             "endpoint")
    ap.add_argument("model", help="artifact path (Module checkpoint prefix, "
                    "Gluon export path, or checkpoint directory)")
    ap.add_argument("--epoch", type=int, default=None)
    ap.add_argument("--port", type=int, default=9191)
    ap.add_argument("--max-batch-size", type=int, default=32)
    ap.add_argument("--max-linger-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--warmup-shape", type=str, default=None,
                    help="comma-separated per-row feature shape to run "
                         "every bucket for, e.g. 3,224,224")
    ap.add_argument("--progcache-dir", type=str, default=None,
                    help="persistent program-cache directory (progcache); "
                         "overrides MXNET_PROGCACHE_DIR: warmup loads the "
                         "bucket programs and their kernels from it "
                         "instead of building and counting them")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel engine over N ranks (mesh axis "
                         "'tp', parameters replicated on the CLI path): "
                         "inside a job of N ranks (tools/launch.py) each "
                         "rank is one, outside one this process starts "
                         "the other N-1; rank 0 serves")
    args = ap.parse_args(argv)
    if args.progcache_dir:
        from .. import progcache

        progcache.configure(args.progcache_dir)

    from . import load

    ctx = _serve_context()
    engine_kw = {"ctx": ctx}
    if args.tp:
        engine_kw["mesh"] = _tp_mesh(args.tp, ctx, argv)
    # a peer rank of --tp does not return from here (serve/group.py)
    engine = load(args.model, epoch=args.epoch,
                  max_batch_size=args.max_batch_size, **engine_kw)
    if args.warmup_shape:
        feat = tuple(int(d) for d in args.warmup_shape.split(",") if d)
        engine.warmup(feat)
    srv = ServeServer(engine, port=args.port,
                      max_linger_ms=args.max_linger_ms,
                      max_queue=args.max_queue)
    print(f"ServeServer listening on :{srv.port}", flush=True)
    srv.serve_forever()
    engine.close()


def _tp_mesh(tp: int, ctx, argv):
    """The ``{"tp": tp}`` mesh of ``--tp``, over the job's ranks: those of
    the launcher's job, or, outside one, this process and ``tp - 1``
    peers it starts with the same arguments (``group.spawn_peers``)."""
    import sys

    from ..kvstore.dist import join_process_group, launcher_rank
    from ..parallel import make_mesh
    from . import group

    rank, n = launcher_rank()
    if n == 1 and tp > 1:
        group.spawn_peers(tp, [sys.executable, "-m",
                               "mxnet_tpu_torch.serve.server",
                               *(sys.argv[1:] if argv is None else argv)])
        rank, n = 0, tp
    if n != tp:
        raise ServeError(f"--tp {tp} in a job of {n} ranks")
    if rank:
        group.watch_parent()
    if tp > 1:
        join_process_group(rank, tp, who="server --tp",
                           timeout=group.SERVE_GROUP_TIMEOUT)
    with ctx:
        return make_mesh({"tp": tp})


if __name__ == "__main__":  # pragma: no cover
    main()
