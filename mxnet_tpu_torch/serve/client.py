"""Client of the ``mxnet_tpu_torch.serve`` socket endpoint (counterpart of
``mxnet_tpu/serve/client.py``; it talks to the reference's server as well).

Every RPC has a socket timeout and a reconnect-retry loop with capped
exponential backoff and jitter (``base.capped_backoff``). The connection
is lazy: the first RPC dials inside the retry loop, so clients reconnecting
after a replica restart do not dial in lockstep. Inference is stateless,
so retrying an INFER whose reply was lost is safe; a request whose
deadline has passed is not re-sent (:class:`DeadlineExceeded`).

Tracing (``obs``): each RPC runs in a ``serve.client.rpc`` span whose
context rides the frame's key field (``obs/context.py``); ``infer`` and
``generate`` are trace roots when the caller carries no context, and take
the tail verdict at their close from the reply's status. The reference's
chaos injection points are queue item A15 (its item 4) of the port.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..base import capped_backoff, configure_socket_keepalive
from ..obs import context as obs_context
from ..kvstore.ps_server import (_pack_arrays, _recv_msg, _send_msg,
                                 _unpack_arrays)
from .engine import (DeadlineExceeded, Draining, RequestRejected, ServeError)
from .server import (OP_ABORT_RELOAD, OP_COMMIT_RELOAD, OP_DRAIN, OP_DUMP,
                     OP_HEALTH, OP_INFER, OP_INFER_STREAM,
                     OP_PREPARE_RELOAD, OP_READY, OP_RELOAD, OP_SHUTDOWN,
                     OP_STATS, OP_STREAM_END, OP_STREAM_ERROR,
                     OP_STREAM_TOKEN, OP_TELEMETRY, SERVE_OP_NAMES,
                     STATUS_BAD_REQUEST, STATUS_DEADLINE, STATUS_DRAINING,
                     STATUS_INTERNAL, STATUS_NOT_READY, STATUS_OK,
                     STATUS_REJECTED, _INFER_HDR, _STREAM_HDR,
                     _TOKEN_FRAME)

__all__ = ["ServeClient"]

_STATUS_ERRORS = {
    STATUS_REJECTED: RequestRejected,
    STATUS_DEADLINE: DeadlineExceeded,
    STATUS_DRAINING: Draining,
    STATUS_BAD_REQUEST: ServeError,
    STATUS_INTERNAL: ServeError,
    STATUS_NOT_READY: ServeError,
}


def _outcome(e: BaseException) -> str:
    """A root's tail outcome from the typed error its reply raised."""
    if isinstance(e, DeadlineExceeded):
        return "deadline"
    if isinstance(e, (RequestRejected, Draining)):
        return "shed"
    if isinstance(e, GeneratorExit):
        return "cancelled"
    return "error"


class ServeClient:
    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 retries: int = 3, retry_interval: float = 0.2,
                 retry_max_interval: float = 2.0):
        self._addr = (host, port)
        self._timeout = float(timeout)
        self._retries = max(1, int(retries))
        self._retry_interval = retry_interval
        self._retry_max_interval = retry_max_interval
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None  # the first RPC dials

    # ------------------------------------------------------------------
    def _connect(self):
        self._drop_sock()
        self._sock = socket.create_connection(self._addr,
                                              timeout=self._timeout)
        configure_socket_keepalive(self._sock)

    def _backoff(self, attempt: int) -> float:
        return capped_backoff(attempt, self._retry_interval,
                              self._retry_max_interval)

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _rpc(self, opcode: int, payload: bytes = b"",
             deadline: Optional[float] = None,
             retries: Optional[int] = None,
             timeout: Optional[float] = None):
        """Send one frame, return the reply payload. Reconnect-retries on
        connection errors; gives up once ``deadline`` (monotonic seconds)
        has passed. ``timeout`` overrides the socket timeout for this one
        RPC."""
        retries = self._retries if retries is None else max(1, int(retries))
        last_err = None
        opname = SERVE_OP_NAMES.get(opcode, str(opcode))
        # the wire is serial per socket: the lock spans the round trip
        with self._lock:
            for attempt in range(retries):
                if deadline is not None and time.monotonic() >= deadline:
                    raise DeadlineExceeded(
                        f"deadline expired during {opname} retries "
                        f"(last error: {last_err})")
                try:
                    if self._sock is None:
                        self._connect()
                    if timeout is not None:
                        self._sock.settimeout(timeout)
                    rec = obs.enabled()
                    t0 = time.monotonic() if rec else 0.0
                    with obs.trace.span("serve.client.rpc", op=opname,
                                        attempt=attempt):
                        # the span is the current context now: the key
                        # carries its span id, the server's spans hang
                        # off it. No context (or obs off): key "", the
                        # old wire format byte for byte
                        key = obs_context.inject_key(
                            "", obs_context.current())
                        _send_msg(self._sock, opcode, key, payload)  # lint: disable=blocking-call-under-lock
                        reply = _recv_msg(self._sock)  # lint: disable=blocking-call-under-lock
                    if rec:
                        obs.observe(f"serve.client.{opname}_seconds",
                                    time.monotonic() - t0)
                    if timeout is not None:
                        self._sock.settimeout(self._timeout)
                    return reply[2]
                except (ConnectionError, OSError) as e:
                    last_err = e
                    self._drop_sock()
                    if attempt + 1 >= retries:
                        break  # no retry left: surface the error now
                    delay = self._backoff(attempt)
                    if obs.enabled():
                        obs.inc("serve.client.retries")
                        obs.observe("serve.client.backoff_seconds", delay)
                        obs.trace.event("serve.client.retry", op=opname,
                                        attempt=attempt, error=str(e))
                    # the backoff keeps the lock: the socket is this client's
                    # one wire
                    time.sleep(delay)  # lint: disable=blocking-call-under-lock
        obs.inc("serve.client.failures")
        raise ServeError(
            f"serve rpc {opname} failed after {retries} attempts: "
            f"{last_err}")

    @staticmethod
    def _check(payload, what: str) -> memoryview:
        status = payload[0]
        if status == STATUS_OK:
            return payload[1:]
        msg = bytes(payload[1:]).decode("utf-8", "replace") or what
        raise _STATUS_ERRORS.get(status, ServeError)(msg)

    # ------------------------------------------------------------------
    # API
    # ------------------------------------------------------------------
    def infer(self, *inputs, deadline_ms: Optional[float] = None,
              priority: int = 1, return_version: bool = False,
              rpc_timeout: Optional[float] = None
              ) -> Union[np.ndarray, List[np.ndarray], tuple]:
        """Run inference on one request batch (one array per model input).
        ``deadline_ms`` propagates to the server's scheduler: an expired
        request is shed there, never executed late. ``priority`` 0 is the
        tight-SLO lane. Returns the output array (or list), plus the
        serving parameter version when ``return_version``."""
        arrays = [x if isinstance(x, torch.Tensor)  # bfloat16 included
                  else np.ascontiguousarray(np.asarray(x)) for x in inputs]
        payload = (_INFER_HDR.pack(float(deadline_ms or 0.0),
                                   min(max(int(priority), 0), 255))
                   + _pack_arrays(arrays))
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms else None)
        # the trace is born here unless the caller carries one: the
        # sampling decision (or the tail bit) rides the wire onwards
        ctx = None
        root_here = False
        if obs.enabled():
            ctx = obs_context.current()
            if ctx is None:
                ctx = obs_context.new_root()
                root_here = True
        t0 = time.monotonic()
        try:
            with obs_context.use(ctx):
                reply = self._check(self._rpc(OP_INFER, payload,
                                              deadline=deadline,
                                              timeout=rpc_timeout),
                                    "inference failed")
        except BaseException as e:
            # the server's verdict rode the reply's status byte
            if root_here:
                obs.tail.finish_root(ctx, time.monotonic() - t0,
                                     outcome=_outcome(e))
            raise
        if root_here:
            obs.tail.finish_root(ctx, time.monotonic() - t0)
        (version,) = struct.unpack_from("<I", reply, 0)
        outs, _ = _unpack_arrays(reply[4:])
        result = outs[0] if len(outs) == 1 else outs
        return (result, version) if return_version else result

    def generate(self, tokens, *, max_new_tokens: Optional[int] = None,
                 deadline_ms: Optional[float] = None, priority: int = 1,
                 temperature: float = 0.0,
                 rpc_timeout: Optional[float] = None):
        """Stream one autoregressive generation, yielding int token ids as
        the server emits them (``OP_INFER_STREAM``). The typed serve errors
        can raise mid-iteration. Closing the generator early hangs up the
        connection, which cancels the generation server-side.

        The request is retried only while no reply chunk has arrived; a
        wire broken mid-stream raises ``ServeError("stream broken after N
        tokens")``. The connection lock is held for the whole stream."""
        prompt = np.ascontiguousarray(
            np.asarray(tokens, dtype=np.int32).reshape(-1))
        payload = (_STREAM_HDR.pack(float(deadline_ms or 0.0),
                                    min(max(int(priority), 0), 255),
                                    int(max_new_tokens or 0),
                                    float(temperature))
                   + _pack_arrays([prompt]))
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms else None)
        # the root born here rides the wire to the replica: its decode
        # spans join this trace
        ctx = None
        root_here = False
        if obs.enabled():
            ctx = obs_context.current()
            if ctx is None:
                ctx = obs_context.new_root()
                root_here = True
        t0 = time.monotonic()
        try:
            yield from self._generate_stream(payload, ctx, deadline,
                                             rpc_timeout)
        except BaseException as e:
            if root_here:
                obs.tail.finish_root(ctx, time.monotonic() - t0,
                                     outcome=_outcome(e))
            raise
        if root_here:
            obs.tail.finish_root(ctx, time.monotonic() - t0)
        if obs.enabled():
            obs.observe("serve.client.infer_stream_seconds",
                        time.monotonic() - t0)

    def _generate_stream(self, payload: bytes, ctx, deadline, timeout):
        opname = SERVE_OP_NAMES.get(OP_INFER_STREAM, "infer_stream")
        with self._lock:
            last_err = None
            for attempt in range(self._retries):
                if deadline is not None and time.monotonic() >= deadline:
                    raise DeadlineExceeded(
                        f"deadline expired during {opname} retries "
                        f"(last error: {last_err})")
                try:
                    if self._sock is None:
                        self._connect()
                    if timeout is not None:
                        self._sock.settimeout(timeout)
                    # the lock spans the stream's send and its receive loop:
                    # the wire is serial per socket
                    _send_msg(self._sock, OP_INFER_STREAM,  # lint: disable=blocking-call-under-lock
                              obs_context.inject_key("", ctx), payload)
                    break
                except (ConnectionError, OSError) as e:
                    last_err = e
                    self._drop_sock()
                    if attempt + 1 >= self._retries:
                        obs.inc("serve.client.failures")
                        raise ServeError(
                            f"serve rpc {opname} failed after "
                            f"{self._retries} attempts: {last_err}")
                    delay = self._backoff(attempt)
                    if obs.enabled():
                        obs.inc("serve.client.retries")
                        obs.observe("serve.client.backoff_seconds", delay)
                        obs.trace.event("serve.client.retry", op=opname,
                                        attempt=attempt, error=str(e))
                    # the backoff keeps the lock: the socket is this client's
                    # one wire
                    time.sleep(delay)  # lint: disable=blocking-call-under-lock
            n = 0
            err = None
            try:
                while True:
                    opcode, _key, chunk = _recv_msg(self._sock)  # lint: disable=blocking-call-under-lock
                    if opcode == OP_STREAM_TOKEN:
                        n += 1
                        tok, _idx = _TOKEN_FRAME.unpack_from(chunk, 0)
                        yield int(tok)
                    elif opcode == OP_STREAM_END:
                        break
                    elif opcode == OP_STREAM_ERROR:
                        status = chunk[0] if len(chunk) else \
                            STATUS_INTERNAL
                        msg = bytes(chunk[1:]).decode("utf-8", "replace") \
                            or "generation failed"
                        err = _STATUS_ERRORS.get(status, ServeError)(msg)
                        break
                    else:
                        self._drop_sock()
                        raise ServeError(
                            f"unexpected opcode {opcode} in stream reply")
                if timeout is not None:
                    self._sock.settimeout(self._timeout)
            except GeneratorExit:
                # hanging up is the cancel signal; the socket has chunks in
                # flight and cannot be reused
                self._drop_sock()
                obs.inc("serve.client.stream_cancelled")
                raise
            except (ConnectionError, OSError, struct.error) as e:
                self._drop_sock()
                obs.inc("serve.client.stream_broken")
                raise ServeError(f"stream broken after {n} tokens: {e}")
            finally:
                if obs.enabled() and n:
                    obs.inc("serve.client.stream_tokens", n)
            if err is not None:
                raise err

    def health(self) -> bool:
        """Liveness probe (True = the process answers)."""
        try:
            return self._rpc(OP_HEALTH)[0] == STATUS_OK
        except ServeError:
            return False

    def ready(self) -> bool:
        """Readiness probe (True = model loaded and accepting traffic;
        False while draining)."""
        try:
            return self._rpc(OP_READY)[0] == STATUS_OK
        except ServeError:
            return False

    def ready_version(self) -> Tuple[bool, int]:
        """Readiness plus the serving parameter version in one probe."""
        try:
            reply = self._rpc(OP_READY)
            if len(reply) >= 5:
                status, version = struct.unpack_from("<BI", reply, 0)
                return status == STATUS_OK, int(version)
            return reply[0] == STATUS_OK, 0
        except ServeError:
            return False, -1

    def stats(self, include_metrics: bool = True) -> dict:
        """Server stats json. ``include_metrics=False`` asks a server that
        keeps a metrics registry to leave its snapshot out."""
        payload = b"" if include_metrics \
            else json.dumps({"metrics": False}).encode("utf-8")
        reply = self._check(self._rpc(OP_STATS, payload), "stats failed")
        return json.loads(bytes(reply).decode("utf-8"))

    def dump(self, reason: str = "wire", write: bool = False) -> dict:
        """The server's flight-recorder bundle (``OP_DUMP``,
        ``obs/blackbox.py``): the ring of recent spans, a metrics snapshot,
        profiler samples and every thread's stack. ``write=True`` also
        persists it server-side (when the recorder has a directory) and
        returns its path in ``"path"``. Read-only: retries are
        harmless."""
        payload = json.dumps({"reason": reason,
                              "write": bool(write)}).encode("utf-8")
        reply = self._check(self._rpc(OP_DUMP, payload), "dump failed")
        return json.loads(bytes(reply).decode("utf-8"))

    def telemetry(self, drain: bool = True, fmt: str = "json",
                  retained: Optional[list] = None,
                  openmetrics: bool = True):
        """The server's telemetry (``OP_TELEMETRY``): ``fmt="json"``
        returns ``{"parts": [...]}``, one part per process behind the
        endpoint (a FleetServer adds every live replica's), each with its
        drained span ring, metrics snapshot and clock anchor;
        ``fmt="prometheus"`` the text exposition (``openmetrics=False``:
        strict 0.0.4, no exemplars). ``drain=False`` peeks. A fresh
        collection token makes a retried frame re-serve the server's
        cached reply instead of draining twice. The request carries this
        process's retained-trace verdicts (``obs/tail.py``) plus
        ``retained``, so held spans downstream promote with it."""
        spec = {"drain": bool(drain), "format": fmt,
                "token": os.urandom(8).hex()}
        if fmt == "prometheus" and not openmetrics:
            spec["openmetrics"] = False
        ids = list(retained or ())
        if obs.tail.enabled():
            ids.extend(obs.tail.retained_ids())
        if ids:
            spec["retained"] = sorted(set(ids))
        reply = self._check(
            self._rpc(OP_TELEMETRY, json.dumps(spec).encode("utf-8")),
            "telemetry failed")
        if fmt == "prometheus":
            return bytes(reply).decode("utf-8")
        return json.loads(bytes(reply).decode("utf-8"))

    def reload(self, path: str, epoch: Optional[int] = None,
               prefix: str = "ckpt") -> int:
        """Hot-swap the server onto a newer checkpoint of the same model.
        Returns the new parameter version."""
        spec = {"path": path, "epoch": epoch, "prefix": prefix}
        reply = self._check(
            self._rpc(OP_RELOAD, json.dumps(spec).encode("utf-8")),
            "reload failed")
        (version,) = struct.unpack_from("<I", reply, 0)
        return version

    def prepare_reload(self, path: str, epoch: Optional[int] = None,
                       prefix: str = "ckpt", *,
                       version: Optional[int] = None,
                       token: Optional[Tuple[int, int]] = None,
                       retries: Optional[int] = None) -> int:
        """Phase one of the two-phase reload: the server loads, validates
        and stages the new generation. Returns the staged version."""
        spec = {"path": path, "epoch": epoch, "prefix": prefix,
                "version": version,
                "token": list(token) if token is not None else None}
        reply = self._check(
            self._rpc(OP_PREPARE_RELOAD, json.dumps(spec).encode("utf-8"),
                      retries=retries),
            "prepare_reload failed")
        (staged,) = struct.unpack_from("<I", reply, 0)
        return staged

    def commit_reload(self, token: Tuple[int, int],
                      retries: Optional[int] = None) -> int:
        """Phase two: flip the staged generation; safe to retry."""
        reply = self._check(
            self._rpc(OP_COMMIT_RELOAD, struct.pack("<QQ", *token),
                      retries=retries),
            "commit_reload failed")
        (ver,) = struct.unpack_from("<I", reply, 0)
        return ver

    def abort_reload(self, token: Tuple[int, int]) -> None:
        """Discard a staged generation (idempotent rollback)."""
        self._check(self._rpc(OP_ABORT_RELOAD, struct.pack("<QQ", *token)),
                    "abort_reload failed")

    def drain(self, stop: bool = False) -> bool:
        """Ask the server to finish in-flight work and refuse new requests
        (``stop=True`` also closes the listener afterwards)."""
        payload = struct.pack("<B", 1 if stop else 0)
        return self._rpc(OP_DRAIN, payload)[0] == STATUS_OK

    def shutdown(self) -> None:
        self._rpc(OP_SHUTDOWN)

    def close(self) -> None:
        with self._lock:
            self._drop_sock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
