"""Fault-tolerant serving fleet — supervised replicas behind a failover
router (counterpart of ``mxnet_tpu/serve/fleet.py``).

One serve process degrades gracefully (``server.py``); this layer makes the
*service* survive the process, and adds a **fleet-atomic** model flip.

Layers (bottom up):

- **Replica handles** — :class:`LocalReplica` (an in-process
  :class:`~mxnet_tpu_torch.serve.server.ServeServer`, "killed" by severing
  its sockets — crash-equivalent to a client), :class:`ProcReplica` (a
  real subprocess, ``python -m mxnet_tpu_torch.serve.server``, killed with
  SIGKILL) and :class:`GroupReplica` (a replica group: the ranks of a
  sharded engine on one slice of a mesh, a job of their own
  (``serve/group.py``), killed as a unit). One supervision/routing code
  path covers all three.
- :class:`ReplicaPool` — supervision: liveness via the health/readiness
  probes, restart-with-capped-backoff+jitter on death
  (``base.capped_backoff``), and **target tracking**: a replica restarted
  after a fleet reload is resynced to the committed ``(artifact,
  version)`` *before* it is marked ready, so a rejoin can never
  reintroduce a stale generation. The pool is elastic
  (:meth:`ReplicaPool.add_replica` / :meth:`ReplicaPool.remove_replica`).
- :class:`Router` — spreads traffic over ready replicas (round-robin),
  with per-replica **circuit breakers**, client-side **failover** (INFER
  is read-only, so a retry on another replica is idempotent),
  optional **tail-latency hedging** (``hedge_ms``), streaming relay
  (``generate``, failover only before the first token) and the
  **fleet-atomic two-phase reload**.
- :class:`FleetServer` — a :class:`ServeServer` whose "batcher" is the
  Router: the same wire protocol, so ``ServeClient`` and ``serve_bench``
  drive a fleet exactly like a single replica.

Fleet-atomic reload (the two-phase flip)
----------------------------------------
The prepare wave is a *barrier* — no commit is sent until every ready
replica has staged the new generation — and the commit carries a
``(controller_id, epoch)`` token the replica dedups in an LRU, so a
retried commit whose ack was lost applies exactly once. Phase one does ALL
fallible work (disk load, device placement, shape validation); phase two
is a pointer swap that only process death can stop. The router pauses
intake, drains in-flight work, commits everywhere, and stamps the fleet
version — so a replica that dies during phase two serves nothing and
restarts onto the committed target, every reply carries its parameter
version, and the router rejects a stale one (failing over instead).

Telemetry: ``fleet.ready_replicas`` and ``fleet.replica<i>.*`` gauges,
``fleet.failovers`` / ``fleet.hedges`` / ``fleet.hedge_wins`` /
``fleet.breaker_trips`` / ``fleet.replica_deaths`` /
``fleet.replica_restarts`` counters, and ``fleet.rpc.replica<i>_seconds``
and ``fleet.request_latency_seconds`` histograms go into ``obs.metrics``
(recorded while ``obs`` is enabled); the autoscaler reads its burn from
them. The router roots a trace per request when the caller carries none,
routes each attempt in a ``fleet.route`` span (``fleet.route_stream``
events for streams), notes hedges and breaker trips for the tail plane,
and emits the membership events (``fleet.replica_*``, ``fleet.reload``,
...). ``Router.collect_telemetry`` pulls every ready replica's parts over
``OP_TELEMETRY`` and ``FleetServer.telemetry`` adds the front's own. A
``ProcReplica`` inherits the parent's telemetry switches; with
``obs_dir=`` (or ``MXNET_OBS_DIR``) its child streams
``<obs_dir>/replica-<pid>.jsonl`` and keeps its flight recorder's
bundles there. ``ProcReplica(progcache_dir=)`` pins the child's program
cache (``MXNET_PROGCACHE_DIR``; otherwise the parent's ``MXNET_PROGCACHE*``
rides the inherited environment), so a restart or an autoscaler's
scale-out warms its programs and kernels from disk. The reference's
``MXNET_CHAOS_KILL_REPLICA<i>`` kill points are queue item A15 of the
port (its item 4) and raise naming it.
``ReplicaPool.sharded``
takes a picklable ``make_server`` (a module-level function or a
``functools.partial`` of one): it runs in every rank of each group.
"""
from __future__ import annotations

import contextlib
import os
import queue
import select
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..base import MXNetError, capped_backoff
from .batcher import Future
from .client import ServeClient
from .engine import (DeadlineExceeded, Draining, RequestRejected, ServeError)
from .server import ServeServer

__all__ = ["CircuitBreaker", "LocalReplica", "ProcReplica", "GroupReplica",
           "ReplicaPool", "Router", "FleetServer"]


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Per-replica circuit breaker: ``threshold`` consecutive hard failures
    trip it OPEN (requests skip the replica instead of queueing behind a
    corpse); after ``cooldown`` seconds it goes HALF-OPEN and admits one
    probe request — success closes it, failure re-opens it for another
    cooldown. Thread-safe; shed replies (429/draining) are *answers*, not
    failures, and reset the streak."""

    def __init__(self, threshold: int = 3, cooldown: float = 1.0):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self.trips = 0
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_out = False
        # cumulative seconds spent NOT closed (open + half-open probing) —
        # the SLO monitor's "breaker open-time" signal: how long traffic
        # was being turned away from this replica
        self.open_seconds = 0.0
        self._not_closed_since: Optional[float] = None
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a request go to this replica now? HALF-OPEN admits exactly
        one in-flight probe per cooldown window."""
        with self._lock:
            if self._state == "closed":
                return True
            if (self._state == "open"
                    and time.monotonic() - self._opened_at >= self.cooldown):
                self._state = "half_open"
                self._probe_out = False
            if self._state == "half_open" and not self._probe_out:
                self._probe_out = True
                return True
            return False

    def success(self) -> None:
        with self._lock:
            if self._not_closed_since is not None:
                self.open_seconds += time.monotonic() - self._not_closed_since
                self._not_closed_since = None
            self._state = "closed"
            self._consecutive = 0
            self._probe_out = False

    def release(self) -> None:
        """An admitted request ended with NO verdict on the replica's
        health (deadline expired client-side, dispatch never happened).
        Free the half-open probe slot so the next request can probe —
        without this, a deadline during half-open would blackhole the
        replica forever."""
        with self._lock:
            self._probe_out = False

    def failure(self) -> bool:
        """Record a hard failure; True when this call tripped the breaker
        open (the caller counts trips once, not per rejected request)."""
        with self._lock:
            self._consecutive += 1
            if self._state == "half_open" or (
                    self._state == "closed"
                    and self._consecutive >= self.threshold):
                was_closed = self._state == "closed"
                self._state = "open"
                self._opened_at = time.monotonic()
                if was_closed:  # open→half_open→open keeps the first stamp
                    self._not_closed_since = self._opened_at
                self._probe_out = False
                self.trips += 1
                return True
            return False

    def snapshot(self) -> dict:
        with self._lock:
            open_s = self.open_seconds
            if self._not_closed_since is not None:
                open_s += time.monotonic() - self._not_closed_since
            return {"state": self._state, "consecutive": self._consecutive,
                    "trips": self.trips, "threshold": self.threshold,
                    "cooldown_s": self.cooldown,
                    "open_seconds": round(open_s, 4)}


# ---------------------------------------------------------------------------
# replica handles
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class LocalReplica:
    """In-process replica: ``factory()`` must return a *started*
    :class:`ServeServer`. ``kill()`` severs its listener and every live
    connection without draining — to clients this is indistinguishable
    from SIGKILL, which makes the failover paths testable at tier-1
    speed."""

    def __init__(self, factory: Callable[[], ServeServer]):
        self._factory = factory
        self.server: Optional[ServeServer] = None
        self.idx = -1  # assigned by the pool

    def start(self) -> Tuple[str, int]:
        self.server = self._factory()
        return ("127.0.0.1", self.server.port)

    def alive(self) -> bool:
        return self.server is not None and not self.server._stop.is_set()

    def kill(self) -> None:
        if self.server is not None:
            self.server.abort()

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
            self.server = None


class ProcReplica:
    """Subprocess replica: ``python -m mxnet_tpu_torch.serve.server
    <model>`` on a pre-picked port, started with ``subprocess.Popen`` (a
    fresh interpreter, never a fork of a parent that may hold a CUDA
    context), in a session of its own. ``kill()`` is a real SIGKILL of the
    session's process group, so it reaches the ranks a ``--tp`` child
    starts. The child serves on the card unless its environment pins
    ``MXNET_SERVE_PLATFORM=cpu``.

    Telemetry inheritance: when the parent has obs on the child gets
    ``MXNET_OBS=1``, the parent's sample rate and its tail and profiler
    switches; with an ``obs_dir`` (param or ``MXNET_OBS_DIR``) the child
    also streams flush-per-event JSONL to ``<obs_dir>/replica-<pid>.jsonl``
    and arms its flight recorder there, so a SIGKILLed replica leaves its
    half of the timeline and its last bundle on disk
    (``tools/trace_report.py`` merges them back in by pid lane).

    Program cache: ``progcache_dir`` pins the child's
    ``MXNET_PROGCACHE_DIR`` (an inherited ``MXNET_PROGCACHE=0`` veto is
    left standing); without it the parent's ``MXNET_PROGCACHE*`` rides the
    inherited environment. Every start of the replica (a restart after a
    kill included) warms from that cache.

    The reference's per-replica chaos (``MXNET_CHAOS_KILL_REPLICA<i>``)
    is queue item A15 of the port (its item 4) and raises when given."""

    def __init__(self, model: str, *, args: Sequence[str] = (),
                 env: Optional[dict] = None, log_path: Optional[str] = None,
                 obs_dir: Optional[str] = None,
                 progcache_dir: Optional[str] = None):
        chaos = [k for k in list(env or {}) + list(os.environ)
                 if k.startswith("MXNET_CHAOS_KILL_REPLICA")]
        if chaos:
            raise MXNetError(f"{chaos[0]}: the chaos kill points are queue "
                             "item A15 of the port")
        self.model = model
        self._args = list(args)
        self._env = dict(env or {})
        self._log_path = log_path
        self._obs_dir = obs_dir or os.environ.get("MXNET_OBS_DIR")
        self._progcache_dir = progcache_dir
        self.proc: Optional[subprocess.Popen] = None
        self.idx = -1  # assigned by the pool

    def start(self) -> Tuple[str, int]:
        port = _free_port()
        env = _job_env()
        env.update(self._env)
        if self._progcache_dir:
            env["MXNET_PROGCACHE_DIR"] = str(self._progcache_dir)
        if obs.enabled() and self._obs_dir:
            # the flight recorder's bundles land beside the JSONL stream
            env.setdefault("MXNET_OBS_BLACKBOX_DIR", self._obs_dir)
        if self._obs_dir and env.get("MXNET_OBS") \
                and "MXNET_OBS_JSONL" not in self._env:
            os.makedirs(self._obs_dir, exist_ok=True)
            # %p expands to the CHILD's pid at its obs import: one file
            # per replica, surviving SIGKILL (it overrides an inherited
            # MXNET_OBS_JSONL, whose one file would mix clock anchors)
            env["MXNET_OBS_JSONL"] = os.path.join(self._obs_dir,
                                                  "replica-%p.jsonl")
        out = open(self._log_path, "ab") if self._log_path \
            else subprocess.DEVNULL
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.serve.server",
                 self.model, "--port", str(port)] + self._args,
                env=env, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True)
        finally:
            if out is not subprocess.DEVNULL:
                out.close()
        return ("127.0.0.1", port)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self) -> None:
        if self.proc is not None:
            _signal_group(self.proc, signal.SIGKILL)

    def stop(self) -> None:
        if self.proc is not None:
            _stop_group(self.proc)


def _signal_group(proc, sig) -> None:
    """``sig`` to the process group of ``proc``, a session leader."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        pass


def _stop_group(proc, pids: Sequence[int] = (), timeout: float = 5.0):
    """SIGTERM the session of ``proc``, SIGKILL it after ``timeout``, reap
    ``proc`` and wait until none of ``pids`` runs."""
    from .group import pid_alive

    if proc.poll() is None:
        _signal_group(proc, signal.SIGTERM)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
    _signal_group(proc, signal.SIGKILL)
    proc.wait()
    deadline = time.monotonic() + timeout
    while any(pid_alive(p) for p in pids):
        if time.monotonic() > deadline:
            raise ServeError(f"ranks {[p for p in pids if pid_alive(p)]} "
                             "outlived their group's kill")
        time.sleep(0.02)


def _job_env() -> dict:
    """A child replica's environment: this process's, without the
    launcher's job variables (a ``--tp`` child or a replica group forms a
    job of its own), with the repo root on ``PYTHONPATH`` (the child
    imports the port whatever its cwd) and, when ``obs`` is on,
    ``MXNET_OBS``, the sample rate and the tail and profiler switches
    (the whole fleet observes or none of it does)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DMLC_NUM_WORKER", "DMLC_WORKER_ID",
                        "MXNET_COORDINATOR", "DMLC_PS_ROOT_URI",
                        "DMLC_PS_ROOT_PORT", "MXNET_WORKER_ID",
                        "MXNET_NUM_WORKER")}
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    if obs.enabled():
        env.setdefault("MXNET_OBS", "1")
        env.setdefault("MXNET_OBS_SAMPLE", repr(obs.context.sample_rate()))
        if obs.tail.enabled():
            env.setdefault("MXNET_OBS_TAIL", "1")
        if obs.profile.enabled():
            env.setdefault("MXNET_OBS_PROF", "1")
    return env


class GroupReplica:
    """A replica group: ``make_server(submesh)`` in every rank of a job of
    ``mesh.size`` processes (``python -m mxnet_tpu_torch.serve.group``),
    the leader's server the replica's address. ``start()`` starts the
    leader in a new session (it starts its peers) and returns once the
    leader's factory returned and its server listens, or raises with the
    tail of the group's output; ``kill()`` SIGKILLs the session's process
    group; ``stop()`` ends it and waits until no rank of it runs.
    ``mesh`` is the slice (its ranks renumbered from 0 in the group's
    job); ``env`` is added to the ranks' environment; ``pids`` holds the
    ranks' pids once started."""

    def __init__(self, make_server: Callable, mesh, *,
                 env: Optional[dict] = None, start_timeout: float = 600.0):
        from .group import group_payload

        self._payload = group_payload(make_server, mesh)
        self.mesh = mesh
        self._env = dict(env or {})
        self.start_timeout = float(start_timeout)
        self.proc: Optional[subprocess.Popen] = None
        self.pids: List[int] = []
        self._log = None
        self._stops = 0  # a stop during a start ends what it started
        self.idx = -1  # assigned by the pool

    def start(self) -> Tuple[str, int]:
        stops = self._stops
        env = _job_env()
        env.update(self._env)
        self._log = tempfile.TemporaryFile()
        r, w = os.pipe()
        try:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.serve.group",
                 "--ranks", str(self.mesh.size), "--report-fd", str(w)],
                env=env, stdin=subprocess.PIPE, stdout=self._log,
                stderr=subprocess.STDOUT, pass_fds=(w,),
                start_new_session=True)
        finally:
            os.close(w)
        try:
            self.proc.stdin.write(self._payload)
            self.proc.stdin.close()
            line = self._read_report(r)
        finally:
            os.close(r)
        if line:
            port, *self.pids = (int(v) for v in line.split())
        if not line or self._stops != stops:
            tail = self._log_tail()
            self.stop()
            raise ServeError(f"replica group on {self.mesh!r} stopped or "
                             f"ended before serving:\n{tail}")
        return ("127.0.0.1", port)

    def _read_report(self, fd: int) -> str:
        buf = b""
        deadline = time.monotonic() + self.start_timeout
        while not buf.endswith(b"\n"):
            left = deadline - time.monotonic()
            if left <= 0:
                return ""
            ready, _, _ = select.select([fd], [], [], min(left, 1.0))
            if ready:
                chunk = os.read(fd, 4096)
                if not chunk:
                    return ""  # the leader died
                buf += chunk
        return buf.decode().strip()

    def _log_tail(self, n: int = 4000) -> str:
        """The end of the group's output (all ranks')."""
        if self._log is None:
            return ""
        self._log.seek(0, os.SEEK_END)
        size = self._log.tell()
        self._log.seek(max(0, size - n))
        return self._log.read().decode("utf-8", "replace")

    def alive(self) -> bool:
        from .group import pid_alive

        return (self.proc is not None and self.proc.poll() is None
                and all(pid_alive(p) for p in self.pids))

    def kill(self) -> None:
        if self.proc is not None:
            _signal_group(self.proc, signal.SIGKILL)

    def stop(self) -> None:
        self._stops += 1
        if self.proc is not None:
            try:
                _stop_group(self.proc, self.pids)
            finally:
                self.proc = None
                if self._log is not None:
                    self._log.close()
                    self._log = None


# ---------------------------------------------------------------------------
# replica pool (supervision)
# ---------------------------------------------------------------------------

class _Member:
    __slots__ = ("idx", "handle", "state", "addr", "incarnation", "restarts",
                 "restart_at", "restarting", "version", "rpcs", "errors",
                 "sheds", "last_error", "queue_depth", "occupancy")

    def __init__(self, idx: int, handle):
        self.idx = idx
        self.handle = handle
        # new|starting|quarantined|ready|resync|dead|leaving|removed|stopped
        self.state = "new"
        self.addr: Optional[Tuple[str, int]] = None
        self.incarnation = 0
        self.restarts = 0
        self.restart_at = 0.0
        self.restarting = False
        self.version = 0
        self.rpcs = 0
        self.errors = 0
        self.sheds = 0
        self.last_error = ""
        # pulled from the replica's STATS by the supervisor each cycle and
        # mirrored into fleet.replica<i>.* gauges — the autoscaler and the
        # Prometheus exposition read the SAME numbers
        self.queue_depth = 0
        self.occupancy = 0.0


class ReplicaPool:
    """Supervise N serve replicas: bring-up, liveness probes, restart with
    capped backoff + jitter, and reload-target tracking so restarts rejoin
    at the committed fleet version (never a stale one).

    The pool is **elastic** (the elastic training plane's membership
    protocol on the serve plane): :meth:`add_replica` brings a newcomer up
    **quarantined** — started, probed ready, warmed, resynced to the
    committed ``(artifact, version)`` target — and only then **activates**
    it at a **generation boundary** (one atomic flip under the pool lock;
    the Router's candidate set changes between requests, never mid-request).
    :meth:`remove_replica` is the leave half: deactivate at a boundary
    (routing stops instantly), drain the replica's queued + in-flight work,
    then stop it — scale-in sheds nothing. ``generation`` increments on
    every membership change, so observers can count scale events exactly.
    """

    def __init__(self, replicas: Sequence, *, probe_interval: float = 0.5,
                 backoff_base: float = 0.2, backoff_cap: float = 5.0,
                 ready_timeout: float = 120.0, probe_timeout: float = 3.0):
        if not replicas:
            raise ValueError("need at least one replica")
        self._members = [_Member(i, h) for i, h in enumerate(replicas)]
        for m in self._members:
            m.handle.idx = m.idx
        self.probe_interval = float(probe_interval)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self.ready_timeout = float(ready_timeout)
        self.probe_timeout = float(probe_timeout)
        self._target: Optional[Tuple[str, Optional[int], str, int]] = None
        self._lock = threading.RLock()
        self._pool_id = int.from_bytes(os.urandom(8), "little")
        self._resync_seq = 0
        self._stop_evt = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        # membership generation: bumped on every activate/leave —
        # autoscale events are generation deltas
        self.generation = 0
        # mesh-slice allocator (ReplicaPool.sharded): slices freed by
        # scale-in are reused by the next scale-out
        self._make_server: Optional[Callable] = None
        self._spare_slices: List = []
        self._group_kw: dict = {}

    @classmethod
    def local(cls, factory: Callable[[], ServeServer], n: int,
              **kw) -> "ReplicaPool":
        return cls([LocalReplica(factory) for _ in range(n)], **kw)

    @classmethod
    def spawn(cls, model: str, n: int, *, args: Sequence[str] = (),
              env: Optional[dict] = None, obs_dir: Optional[str] = None,
              **kw) -> "ReplicaPool":
        return cls([ProcReplica(model, args=args, env=env, obs_dir=obs_dir)
                    for _ in range(n)], **kw)

    @classmethod
    def sharded(cls, make_server: Callable, groups: Optional[int] = None, *,
                mesh=None, start: Optional[int] = None,
                env: Optional[dict] = None, **kw) -> "ReplicaPool":
        """Data-parallel replica groups on mesh slices: split ``mesh`` along
        its ``dp`` axis (``parallel.mesh_slices``) and supervise one
        :class:`GroupReplica` per slice, a job of the slice's ranks, each
        of which calls ``make_server(submesh)``: it must return a
        *started* :class:`ServeServer` whose engine was built with
        ``mesh=submesh`` (on the other ranks that constructor does not
        return). ``make_server`` must be picklable (a module-level
        function or a ``functools.partial`` of one); a closure raises
        ``MXNetError``.

        ``start`` (default: all ``groups``) brings up only the first
        ``start`` slices; the rest stay spare for elastic scale-out
        (:meth:`new_sharded_handle` / ``serve/autoscale.py``). Default
        mesh: ``make_mesh({"dp": groups, "tp": -1})`` over this host's
        devices (its cards, or the CPU inside ``with mx.cpu():``). A mesh
        may list one device several times: its ranks share it. ``env``
        is added to each rank's environment."""
        import torch

        from ..context import current_context
        from ..parallel import make_mesh, mesh_slices
        from .group import check_factory

        check_factory(make_server)
        if mesh is None:
            if not groups:
                raise ValueError("pass groups= or mesh=")
            if current_context().device_type == "gpu":
                devices = [torch.device("cuda", i)
                           for i in range(torch.cuda.device_count())]
            else:
                devices = [torch.device("cpu")]
            mesh = make_mesh({"dp": int(groups), "tp": -1}, devices=devices)
        slices = mesh_slices(mesh, "dp")
        if start is None:
            start = len(slices)
        start = max(1, min(int(start), len(slices)))
        group_kw = {"env": env,
                    "start_timeout": kw.get("ready_timeout", 120.0)}
        pool = cls([GroupReplica(make_server, sub, **group_kw)
                    for sub in slices[:start]], **kw)
        pool._make_server = make_server
        pool._group_kw = group_kw
        pool._spare_slices = list(slices[start:])
        return pool

    def new_sharded_handle(self) -> GroupReplica:
        """Allocate a spare mesh slice and return a replica handle bound to
        it — the autoscaler's scale-out factory for sharded pools. Raises
        :class:`ServeError` when every slice is in use."""
        if self._make_server is None:
            raise ServeError("not a sharded pool (use ReplicaPool.sharded)")
        with self._lock:
            if not self._spare_slices:
                raise ServeError("no spare mesh slices (fleet at capacity)")
            sub = self._spare_slices.pop(0)
        return GroupReplica(self._make_server, sub, **self._group_kw)

    @property
    def spare_slices(self) -> int:
        with self._lock:
            return len(self._spare_slices)

    # -- lifecycle ------------------------------------------------------
    def start(self, wait_ready: bool = True) -> "ReplicaPool":
        threads = [threading.Thread(target=self._bring_up, args=(m,),
                                    daemon=True) for m in self._members]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.ready_timeout)
        if any(t.is_alive() for t in threads):
            # a wedged bring-up is not fatal (the member stays un-ready and
            # the supervisor owns it) but must not pass silently
            obs.inc("fleet.bringup_threads_stuck")
            obs.event("fleet.bringup_stuck",
                      stuck=sum(t.is_alive() for t in threads))
        self._stop_evt.clear()
        self._supervisor = threading.Thread(target=self._supervise,
                                            daemon=True,
                                            name="mxtpu-fleet-supervisor")
        self._supervisor.start()
        if wait_ready and not self.ready_members():
            self.stop()
            errs = {m.idx: m.last_error for m in self._members}
            raise ServeError(f"no replica became ready: {errs}")
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
            if self._supervisor.is_alive():
                obs.inc("fleet.supervisor_thread_leaked")
                obs.event("fleet.supervisor_thread_leaked", join_timeout_s=5)
        for m in self._members:
            try:
                m.handle.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
            m.state = "stopped"
        self._gauge()

    # -- views ----------------------------------------------------------
    def members(self) -> List[_Member]:
        return list(self._members)

    def ready_members(self) -> List[_Member]:
        return [m for m in self._members if m.state == "ready"]

    @property
    def target(self):
        with self._lock:
            return self._target

    def set_target(self, path: str, epoch: Optional[int], prefix: str,
                   version: int) -> None:
        """Record the committed reload target. Called by the router BEFORE
        phase-two commits begin, so a replica killed mid-flip restarts onto
        the new generation — the invariant that keeps a mixed-version fleet
        unreachable."""
        with self._lock:
            self._target = (path, epoch, prefix, int(version))

    def request_resync(self, idx: int) -> None:
        """Ask the supervisor to re-drive a live replica onto the committed
        target (a commit that errored on an alive replica)."""
        m = self._members[idx]
        if m.state == "ready":
            m.state = "resync"

    def kill(self, idx: int) -> None:
        """Chaos helper: hard-kill one replica (SIGKILL / socket sever).
        The supervisor detects and restarts it."""
        obs.event("fleet.chaos_kill", replica=idx)
        self._members[idx].handle.kill()

    # -- elastic membership (join/leave) --------------------------------
    def add_replica(self, handle, *, wait_ready: bool = True) -> int:
        """Elastic scale-out: register ``handle`` as a new member and drive
        it through quarantine → resync-to-committed-target → activation at
        a generation boundary. ``wait_ready=False`` joins in the background
        (the autoscaler's mode — bring-up includes the engine's warmup and
        must not block the control loop). Returns the member index."""
        with self._lock:
            idx = len(self._members)
            m = _Member(idx, handle)
            handle.idx = idx
            self._members.append(m)
        obs.inc("fleet.scale_out")
        obs.event("fleet.replica_join", replica=idx)
        if wait_ready:
            self._bring_up(m)
            if m.state != "ready":
                raise ServeError(
                    f"replica {idx} failed to join: {m.last_error}")
        else:
            # supervised fire-and-forget: the member's state machine (the
            # pool lock + leaving/removed terminal states) owns this
            # bring-up; remove_replica reaps a member whose thread wedged
            threading.Thread(target=self._bring_up, args=(m,),
                             daemon=True).start()  # lint: disable=thread-fire-and-forget
        return idx

    def remove_replica(self, idx: int, *, drain_timeout: float = 30.0
                       ) -> bool:
        """Elastic scale-in (the leave protocol): deactivate at a
        generation boundary — ``ready_members()`` stops listing the member
        the instant the state flips, so the Router routes nothing new to
        it — then DRAIN its queued + in-flight work and stop the handle.
        Zero requests are lost: anything racing the flip fails over through
        the Router. Returns True when the drain finished in time."""
        m = self._members[idx]
        with self._lock:
            if m.state in ("leaving", "removed", "stopped"):
                return True
            prev, m.state = m.state, "leaving"
            self.generation += 1
            gen = self.generation
        obs.inc("fleet.scale_in")
        obs.event("fleet.replica_leave", replica=idx, generation=gen)
        self._gauge()
        drained = True
        if prev == "ready" and m.handle.alive() and m.addr:
            try:
                cli = self._client(m, timeout=max(drain_timeout,
                                                  self.probe_timeout))
                try:
                    drained = cli.drain(stop=False)
                finally:
                    cli.close()
            except Exception as e:  # noqa: BLE001 — leave is best-effort
                m.last_error = f"drain: {type(e).__name__}: {e}"
                drained = False
        try:
            m.handle.stop()
        except Exception:  # noqa: BLE001 — it may already be dead
            pass
        m.state = "removed"
        # a removed member's gauges must not linger in the registry as
        # frozen last values
        for g in ("queue_depth", "occupancy", "breaker_state"):
            obs.metrics.remove(f"fleet.replica{idx}.{g}")
        # return the mesh slice (sharded pools) for the next scale-out
        sub = getattr(m.handle, "mesh", None)
        if sub is not None and self._make_server is not None:
            with self._lock:
                self._spare_slices.append(sub)
        self._gauge()
        return drained

    def _activate(self, m: _Member) -> bool:
        """Activate at a generation boundary: ONE atomic flip under the
        pool lock. Routing (ready_members) sees the member before or after
        the boundary, never a half-joined state."""
        with self._lock:
            if m.state in ("leaving", "removed", "stopped"):
                return False  # removed while joining: stay out
            m.state = "ready"
            self.generation += 1
            gen = self.generation
        obs.set_gauge("fleet.generation", gen)
        obs.event("fleet.replica_activated", replica=m.idx,
                  generation=gen, version=m.version)
        return True

    def stats(self) -> dict:
        members = {}
        for m in self._members:
            members[str(m.idx)] = {
                "state": m.state, "version": m.version,
                "restarts": m.restarts,
                "queue_depth": m.queue_depth,
                "occupancy": round(m.occupancy, 4)}
        return {"replicas": len(self._members),
                "ready": len(self.ready_members()),
                "generation": self.generation,
                "spare_slices": self.spare_slices,
                "target_version": self._target[3] if self._target else None,
                "restarts": sum(m.restarts for m in self._members),
                "members": members}

    # -- internals ------------------------------------------------------
    def _gauge(self) -> None:
        obs.set_gauge("fleet.ready_replicas", len(self.ready_members()))

    def _client(self, m: _Member, timeout: Optional[float] = None
                ) -> ServeClient:
        return ServeClient(m.addr[0], m.addr[1],
                           timeout=timeout or self.probe_timeout, retries=1)

    def _transition(self, m: _Member, state: str) -> bool:
        """Flip a member's state under the pool lock unless it has left
        (leaving/removed/stopped are terminal for joiners): an unlocked
        write here could overwrite a concurrent remove_replica's verdict
        and activate — and route — a replica whose mesh slice was already
        returned to the spare list."""
        with self._lock:
            if m.state in ("leaving", "removed", "stopped"):
                return False
            m.state = state
            return True

    def _bring_up(self, m: _Member) -> None:
        if not self._transition(m, "starting"):
            return  # scaled in while waiting for this bring-up
        try:
            m.addr = m.handle.start()
            m.incarnation += 1
            deadline = time.monotonic() + self.ready_timeout
            ready = False
            while time.monotonic() < deadline and not self._stop_evt.is_set():
                if not m.handle.alive():
                    raise ServeError("replica process died during bring-up")
                cli = self._client(m)
                try:
                    ready, m.version = cli.ready_version()
                finally:
                    cli.close()
                if ready:
                    break
                time.sleep(min(0.05 * (1 + m.restarts), 0.5))
            if not ready:
                raise ServeError(
                    f"replica {m.idx} not ready within {self.ready_timeout}s")
            # QUARANTINE: fully up but not routed — the committed-target
            # resync happens here, so activation can never introduce a
            # stale generation (the elastic-plane rejoin invariant)
            if not self._transition(m, "quarantined"):
                return  # removed mid-bring-up; the leaver stopped the handle
            self._resync_member(m)
            if not self._activate(m):
                return  # removed while quarantined
            obs.event("fleet.replica_ready", replica=m.idx,
                      incarnation=m.incarnation, version=m.version)
        except Exception as e:  # noqa: BLE001 — supervised: schedule retry
            m.last_error = f"{type(e).__name__}: {e}"
            self._schedule_restart(m)
        self._gauge()

    def _resync_member(self, m: _Member) -> None:
        tgt = self.target
        if tgt is None or m.version == tgt[3]:
            return
        path, epoch, prefix, version = tgt
        with self._lock:
            self._resync_seq += 1
            token = (self._pool_id, self._resync_seq)
        cli = self._client(m, timeout=max(self.probe_timeout, 10.0))
        try:
            cli.prepare_reload(path, epoch=epoch, prefix=prefix,
                               version=version, token=token, retries=3)
            cli.commit_reload(token, retries=3)
        finally:
            cli.close()
        m.version = version
        obs.event("fleet.replica_resynced", replica=m.idx, version=version)

    def _probe_ok(self, m: _Member) -> bool:
        cli = self._client(m)
        try:
            return cli.health()
        finally:
            cli.close()

    def _mark_dead(self, m: _Member) -> None:
        if not self._transition(m, "dead"):
            return  # already leaving/removed: no death accounting
        obs.inc("fleet.replica_deaths")
        obs.event("fleet.replica_dead", replica=m.idx,
                  incarnation=m.incarnation)
        self._schedule_restart(m)
        self._gauge()

    def _schedule_restart(self, m: _Member) -> None:
        if not self._transition(m, "dead"):
            return  # a leaver's death needs no resurrection
        delay = capped_backoff(m.restarts, self.backoff_base,
                               self.backoff_cap)
        m.restart_at = time.monotonic() + delay

    def _restart(self, m: _Member) -> None:
        try:
            m.restarts += 1
            obs.inc("fleet.replica_restarts")
            try:
                m.handle.stop()  # reap the corpse / release the old socket
            except Exception:  # noqa: BLE001 — it is already dead
                pass
            self._bring_up(m)
        finally:
            m.restarting = False

    def _probe_ready_members(self) -> None:
        """Probe every ready member CONCURRENTLY: a wedged replica blocks
        its own probe for probe_timeout, not the detection and restart of
        its dead peers (serial probing would head-of-line-block the whole
        supervision cycle behind one corpse)."""
        ready = [m for m in self._members if m.state == "ready"]
        if not ready:
            return
        verdicts = {}

        def probe(m):
            try:
                verdicts[m.idx] = m.handle.alive() and self._probe_ok(m)
            except Exception:  # noqa: BLE001 — a broken probe is a death
                verdicts[m.idx] = False

        threads = [threading.Thread(target=probe, args=(m,), daemon=True)
                   for m in ready]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.probe_timeout + 1.0)
        if any(t.is_alive() for t in threads):
            # a probe thread still stuck past its socket timeout means a
            # wedged replica: its member gets no verdict below and is
            # marked dead
            obs.inc("fleet.probe_threads_stuck")
        for m in ready:
            # no verdict (probe thread still stuck) = not answering = dead
            if m.state == "ready" and not verdicts.get(m.idx, False):
                self._mark_dead(m)

    def _collect_member_stats(self) -> None:
        """Pull each ready replica's batcher queue-depth/occupancy (one
        metrics-free STATS RPC) into the member record AND the registry, so
        the autoscaler and an operator's dashboard read the same numbers."""
        for m in [m for m in self._members if m.state == "ready"]:
            try:
                cli = self._client(m)
                try:
                    st = cli.stats(include_metrics=False)
                finally:
                    cli.close()
            except Exception:  # noqa: BLE001 — the probe's job, not ours
                continue
            b = st.get("batcher") or {}
            m.queue_depth = int(b.get("queue_depth", 0) or 0)
            m.occupancy = float(b.get("occupancy", 0.0) or 0.0)
            # re-check state + set gauges under the pool lock: a
            # remove_replica that ran during the stats RPC has already
            # deleted this member's gauges, and an unguarded set here
            # would resurrect them as permanent frozen values (removal
            # flips the state under the same lock first)
            with self._lock:
                if m.state != "ready":
                    continue
                obs.set_gauge(f"fleet.replica{m.idx}.queue_depth",
                              m.queue_depth)
                obs.set_gauge(f"fleet.replica{m.idx}.occupancy",
                              m.occupancy)
        obs.set_gauge("fleet.replicas_total", sum(
            1 for m in self._members
            if m.state not in ("removed", "stopped")))
        obs.set_gauge("fleet.generation", self.generation)

    def _supervise(self) -> None:
        while not self._stop_evt.wait(self.probe_interval):
            self._probe_ready_members()
            self._collect_member_stats()
            for m in self._members:
                if self._stop_evt.is_set():
                    return
                if m.state == "resync":
                    try:
                        self._resync_member(m)
                        m.state = "ready"
                    except Exception as e:  # noqa: BLE001 — degrade to dead
                        m.last_error = f"{type(e).__name__}: {e}"
                        self._mark_dead(m)
                elif (m.state == "dead" and not m.restarting
                        and time.monotonic() >= m.restart_at):
                    m.restarting = True
                    # supervised: m.restarting gates re-spawn and _restart
                    # clears it in a finally — the supervisor loop is the
                    # join point for this state machine
                    threading.Thread(target=self._restart, args=(m,),
                                     daemon=True).start()  # lint: disable=thread-fire-and-forget
            self._gauge()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

class _ConnPool:
    """Free-list of ServeClients for one replica incarnation (one socket
    per concurrent request, not one serialized socket per replica)."""

    def __init__(self, addr: Tuple[str, int], timeout: float):
        self._addr = addr
        self._timeout = timeout
        self._free: List[ServeClient] = []
        self._lock = threading.Lock()

    def acquire(self) -> ServeClient:
        with self._lock:
            if self._free:
                return self._free.pop()
        return ServeClient(self._addr[0], self._addr[1],
                           timeout=self._timeout, retries=1)

    def release(self, cli: ServeClient) -> None:
        with self._lock:
            self._free.append(cli)

    def close(self) -> None:
        with self._lock:
            for cli in self._free:
                cli.close()
            self._free.clear()


class Router:
    """Spread INFER traffic across a :class:`ReplicaPool` with breakers,
    failover, hedging, and the fleet-atomic two-phase reload. Duck-types
    the :class:`DynamicBatcher` surface (``submit``/``stats``/``drain``/
    ``close`` + ``ready``/``version``), so a :class:`ServeServer` front
    can mount it directly as its batcher (:class:`FleetServer`)."""

    def __init__(self, pool: ReplicaPool, *, hedge_ms: Optional[float] = None,
                 breaker_threshold: int = 3, breaker_cooldown: float = 1.0,
                 client_timeout: float = 30.0, gate_timeout: float = 10.0,
                 flip_timeout: float = 30.0):
        self._pool = pool
        self.hedge_ms = hedge_ms
        self._client_timeout = float(client_timeout)
        self._gate_timeout = float(gate_timeout)
        self._flip_timeout = float(flip_timeout)
        self._breakers = {m.idx: CircuitBreaker(breaker_threshold,
                                                breaker_cooldown)
                          for m in pool.members()}
        self._pools: dict = {}
        self._lock = threading.Lock()
        self._rr = 0
        # intake gate: cleared only for the phase-two flip window
        self._gate = threading.Event()
        self._gate.set()
        self._cv = threading.Condition()
        self._inflight = 0
        tgt = pool.target
        self._fleet_version = tgt[3] if tgt else 0
        self._reload_lock = threading.Lock()
        self._controller_id = int.from_bytes(os.urandom(8), "little")
        self._reload_epoch = 0
        self._commit_hook: Optional[Callable] = None  # test injection point
        # unconditional counters (the STATS endpoint works with obs off)
        self.failovers = 0
        self.hedges = 0
        self.hedge_wins = 0
        self.stale_rejected = 0

    # -- plumbing -------------------------------------------------------
    def _breaker(self, m: _Member) -> CircuitBreaker:
        br = self._breakers.get(m.idx)
        if br is None:
            br = self._breakers.setdefault(m.idx, CircuitBreaker())
        return br

    @contextlib.contextmanager
    def _conn(self, m: _Member):
        key = (m.idx, m.incarnation)
        pool = self._pools.get(key)
        if pool is None:
            with self._lock:
                pool = self._pools.get(key)
                if pool is None:
                    pool = _ConnPool(m.addr, self._client_timeout)
                    self._pools[key] = pool
                    for k in [k for k in self._pools
                              if k[0] == m.idx and k != key]:
                        self._pools.pop(k).close()  # stale incarnation
        cli = pool.acquire()
        try:
            yield cli
        except BaseException:
            cli.close()  # unknown wire state: never back into the pool
            raise
        else:
            pool.release(cli)

    def _candidates(self) -> List[_Member]:
        members = self._pool.ready_members()
        if not members:
            return []
        with self._lock:
            start = self._rr % len(members)
            self._rr += 1
        return members[start:] + members[:start]

    # -- the per-replica attempt ---------------------------------------
    def _attempt(self, m: _Member, arrays, deadline: Optional[float],
                 priority: int):
        """One replica, one try. Returns ``(True, (outs, version))`` or
        ``(False, exception)``. Hard failures feed the breaker; shed
        replies are answers (the replica is alive) and reset it."""
        rem = None if deadline is None else deadline - time.monotonic()
        if rem is not None and rem <= 0:
            return False, DeadlineExceeded("deadline expired before dispatch")
        br = self._breaker(m)
        if not br.allow():
            return False, RequestRejected(
                f"replica {m.idx} circuit breaker open")
        rpc_timeout = self._client_timeout if rem is None \
            else min(self._client_timeout, rem + 0.5)
        t0 = time.monotonic()
        try:
            with obs.trace.span("fleet.route", replica=m.idx,
                                priority=priority):
                with self._conn(m) as cli:
                    result, version = cli.infer(
                        *arrays,
                        deadline_ms=rem * 1e3 if rem is not None else None,
                        priority=priority, return_version=True,
                        rpc_timeout=rpc_timeout)
        except (RequestRejected, Draining) as e:
            br.success()  # an answering replica is a healthy replica
            m.sheds += 1
            return False, e
        except DeadlineExceeded as e:
            # no health verdict (the budget ran out, the replica may be
            # fine) — but the half-open probe slot must not leak
            br.release()
            return False, e
        except (ServeError, ConnectionError, OSError) as e:
            if br.failure():
                obs.inc("fleet.breaker_trips")
                obs.event("fleet.breaker_trip", replica=m.idx)
                # a request that crossed a TRIPPING breaker is interesting
                # to the tail plane even if a failover later succeeds
                obs.tail.note(breaker=True)
            m.errors += 1
            m.last_error = f"{type(e).__name__}: {e}"
            return False, e
        br.success()
        m.rpcs += 1
        obs.observe(f"fleet.rpc.replica{m.idx}_seconds",
                    time.monotonic() - t0)
        outs = result if isinstance(result, list) else [result]
        return True, (outs, int(version))

    def _attempt_hedged(self, primary: _Member, secondary: _Member, arrays,
                        deadline: Optional[float], priority: int):
        """Race a slow primary against a hedge on a second replica: wait
        ``hedge_ms`` for the primary, then duplicate the request (INFER is
        read-only — the loser's work is wasted capacity, not corruption)
        and take the first success."""
        q: "queue.Queue" = queue.Queue()
        # the trace context is thread-local and the racers run on fresh
        # threads: carry it over, or a hedged request would re-root
        ctx = obs.context.current()

        def run(member):
            with obs.context.use(ctx):
                res = self._attempt(member, arrays, deadline, priority)
                # tail notes are thread-local too: ship this racer's back
                # with its result, for the request thread to re-apply
                q.put((member, res, obs.tail.take_notes()))

        def renote(notes):
            outcome, flags = notes
            if outcome:
                obs.tail.note(outcome=outcome)
            for f in flags:
                obs.tail.note(**{f: True})

        # deliberately unjoined racer: the reply comes back over q and
        # INFER is read-only — the losing attempt is wasted capacity, not
        # an orphaned mutation; a wedged racer dies with its socket timeout
        threading.Thread(target=run, args=(primary,), daemon=True).start()  # lint: disable=thread-fire-and-forget
        try:
            member, (ok, val), notes = q.get(timeout=self.hedge_ms / 1e3)
            renote(notes)
            if ok:
                return True, val
            # primary failed FAST (conn refused, shed): that is plain
            # failover to the secondary, not a hedge
            self.failovers += 1
            obs.inc("fleet.failovers")
            return self._attempt(secondary, arrays, deadline, priority)
        except queue.Empty:
            pass
        self.hedges += 1
        obs.inc("fleet.hedges")
        obs.event("fleet.hedge", primary=primary.idx,
                  secondary=secondary.idx)
        # the primary was slow enough to duplicate: a tail signal
        obs.tail.note(hedged=True)
        # the hedge racer: unjoined for the primary's reason above
        threading.Thread(target=run, args=(secondary,), daemon=True).start()  # lint: disable=thread-fire-and-forget
        budget = self._client_timeout if deadline is None \
            else max(deadline - time.monotonic(), 0.0)
        end = time.monotonic() + budget + 0.5
        last = None
        for _ in range(2):
            try:
                member, (ok, val), notes = q.get(
                    timeout=max(end - time.monotonic(), 0.01))
            except queue.Empty:
                break
            renote(notes)
            if ok:
                if member is secondary:
                    self.hedge_wins += 1
                    obs.inc("fleet.hedge_wins")
                return True, val
            last = val
        return False, (last if last is not None
                       else DeadlineExceeded("hedged attempts timed out"))

    # -- public API -----------------------------------------------------
    def infer(self, inputs, deadline_ms: Optional[float] = None,
              priority: int = 1) -> Tuple[List[np.ndarray], int]:
        """Route one request; failover across replicas within the deadline.
        Returns ``(outputs, param_version)`` like ``InferenceEngine.infer``.
        Raises the last shed error only when every replica shed; a hard
        failure on every replica raises :class:`ServeError`."""
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        arrays = [np.ascontiguousarray(np.asarray(x)) for x in inputs]
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms else None)
        # a Router driven directly (no FleetServer front) roots the trace
        # here; behind a front the serve.rpc handler activated the wire's
        rctx = None
        if obs.enabled() and obs.context.current() is None:
            rctx = obs.context.new_root()
        # gate-check and inflight-increment must be one atomic step from
        # the flip's point of view: check the gate again under _cv after
        # counting ourselves, so either the reload's drain sees us (and
        # waits) or we see the cleared gate (and back off) — a request can
        # never slip between the gate clearing and the commit wave
        gate_deadline = time.monotonic() + self._gate_timeout
        while True:
            budget = gate_deadline - time.monotonic()
            if deadline is not None:
                budget = min(budget, deadline - time.monotonic())
            if budget <= 0 or not self._gate.wait(timeout=budget):
                raise RequestRejected("fleet reload flip in progress; retry")
            with self._cv:
                if self._gate.is_set():
                    self._inflight += 1
                    break
        t0 = time.monotonic()
        outcome = "ok"
        try:
            with obs.context.use(rctx):
                result = self._infer_routed(arrays, deadline, priority)
            # ONE observation per REQUEST, front-side — the replica-side
            # serve.latency_seconds counts executions, which hedging
            # duplicates; SLO math prefers this histogram when present so
            # phantom hedge completions can't dilute attainment
            obs.observe("fleet.request_latency_seconds",
                        time.monotonic() - t0)
            return result
        except DeadlineExceeded:
            obs.inc("fleet.request_deadline_exceeded")
            outcome = "deadline"
            raise
        except (RequestRejected, Draining):
            outcome = "shed"
            raise
        except BaseException:
            outcome = "error"
            raise
        finally:
            # a directly driven Router owns the root: its verdict here.
            # Behind a front the wire handler owns it (and this thread's
            # notes): rctx is None then
            if rctx is not None:
                obs.tail.finish_root(rctx, time.monotonic() - t0,
                                     outcome=outcome)
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()

    def _infer_routed(self, arrays, deadline, priority):
        cands = self._candidates()
        if not cands:
            raise RequestRejected("no ready replicas")
        shed_err = None
        hard_err = None
        i = 0
        while i < len(cands):
            if deadline is not None and time.monotonic() >= deadline:
                raise DeadlineExceeded(
                    "deadline expired during fleet failover")
            hedge_ok = (self.hedge_ms is not None and i + 1 < len(cands)
                        and (deadline is None
                             or (deadline - time.monotonic()) * 1e3
                             > 2 * self.hedge_ms))
            if hedge_ok:
                ok, val = self._attempt_hedged(cands[i], cands[i + 1],
                                               arrays, deadline, priority)
                i += 2
            else:
                ok, val = self._attempt(cands[i], arrays, deadline, priority)
                i += 1
            if ok:
                outs, version = val
                if version != self._fleet_version:
                    # a reply from a generation the fleet no longer serves
                    # must never escape — reject and fail over (the pool
                    # resyncs the straggler)
                    self.stale_rejected += 1
                    obs.inc("fleet.stale_version_rejected")
                    hard_err = ServeError(
                        f"stale param version {version} "
                        f"(fleet at {self._fleet_version})")
                    continue
                return outs, version
            if isinstance(val, DeadlineExceeded):
                raise val
            if isinstance(val, (RequestRejected, Draining)):
                shed_err = val
            else:
                hard_err = val
            if i < len(cands):
                self.failovers += 1
                obs.inc("fleet.failovers")
        if hard_err is not None:
            raise ServeError(
                f"all {len(cands)} replicas failed; last: {hard_err}")
        raise shed_err if shed_err is not None \
            else RequestRejected("no replica accepted the request")

    # -- DynamicBatcher duck-type (FleetServer mounts this) -------------
    def submit(self, inputs, deadline_ms: Optional[float] = None,
               priority: int = 1) -> Future:
        """Route inline and return a resolved Future (concurrency comes
        from the front's thread-per-connection handlers); shed/deadline
        errors raise here, matching ``DynamicBatcher.submit`` fail-fast."""
        fut = Future()
        fut._set_result(self.infer(inputs, deadline_ms=deadline_ms,
                                   priority=priority))
        return fut

    def generate(self, tokens, *, max_new_tokens: Optional[int] = None,
                 deadline_ms: Optional[float] = None, priority: int = 1,
                 temperature: float = 0.0):
        """Route one streaming generation to a replica and relay its
        tokens (the ``DecodeScheduler.generate`` duck-type — a
        FleetServer front mounts this as its INFER_STREAM source).

        Failover is only legal BEFORE the first token: a shed or hard
        failure with nothing streamed moves to the next candidate like
        ``infer``, but once a replica has emitted a chunk the generation
        is COMMITTED there — a retry elsewhere would splice a different
        token sequence into the same stream — so a mid-stream failure
        propagates to the caller as the typed error. Streams do not hold
        the reload-flip gate (a generation can outlive a flip); a flip
        that restarts the serving replica surfaces as a mid-stream
        ``ServeError``, which the caller handles exactly like any other
        broken stream."""
        prompt = np.ascontiguousarray(np.asarray(tokens, dtype=np.int32))
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms else None)
        cands = self._candidates()
        if not cands:
            raise RequestRejected("no ready replicas")
        shed_err = None
        hard_err = None
        for i, m in enumerate(cands):
            if i:
                self.failovers += 1
                obs.inc("fleet.failovers")
            rem = None if deadline is None else deadline - time.monotonic()
            if rem is not None and rem <= 0:
                raise DeadlineExceeded(
                    "deadline expired during fleet failover")
            br = self._breaker(m)
            if not br.allow():
                shed_err = shed_err or RequestRejected(
                    f"replica {m.idx} circuit breaker open")
                continue
            rpc_timeout = self._client_timeout if rem is None \
                else min(self._client_timeout, rem + 0.5)
            committed = False
            try:
                # a caller that closes this generator (GeneratorExit at a
                # yield) closes the replica connection on its way out of
                # _conn: the replica cancels the generation and its pages
                # come back
                with self._conn(m) as cli:
                    it = cli.generate(
                        prompt, max_new_tokens=max_new_tokens,
                        deadline_ms=rem * 1e3 if rem is not None else None,
                        priority=priority, temperature=temperature,
                        rpc_timeout=rpc_timeout)
                    try:
                        first = next(it)
                    except StopIteration:
                        br.success()  # empty stream is still an answer
                        m.rpcs += 1
                        return
                    br.success()
                    m.rpcs += 1
                    committed = True
                    # an event, not a span: a span must not stay open
                    # while the generator is suspended
                    obs.trace.event("fleet.route_stream", replica=m.idx,
                                    priority=priority)
                    yield first
                    yield from it
                    return
            except (RequestRejected, Draining) as e:
                br.success()  # an answering replica is a healthy replica
                m.sheds += 1
                shed_err = e
            except DeadlineExceeded:
                # pre-commit: no health verdict, free the probe slot
                # (post-commit success() already closed it — harmless);
                # either way the budget is gone, so no failover
                br.release()
                raise
            except (ServeError, ConnectionError, OSError) as e:
                if committed:
                    # the stream is committed to this replica: surface
                    # the break instead of splicing another generation
                    raise
                if br.failure():
                    obs.inc("fleet.breaker_trips")
                    obs.event("fleet.breaker_trip", replica=m.idx)
                    obs.tail.note(breaker=True)
                m.errors += 1
                m.last_error = f"{type(e).__name__}: {e}"
                hard_err = e
        if hard_err is not None:
            raise ServeError(
                f"all {len(cands)} replicas failed; last: {hard_err}")
        raise shed_err if shed_err is not None \
            else RequestRejected("no replica accepted the stream")

    def ready(self) -> bool:
        return self._gate.is_set() and bool(self._pool.ready_members())

    @property
    def version(self) -> int:
        return self._fleet_version

    def queue_depth(self) -> int:
        return 0  # routing is synchronous; queues live in the replicas

    def stats(self) -> dict:
        _BR_STATE = {"closed": 0, "half_open": 1, "open": 2}
        replicas = {}
        for m in self._pool.members():
            br = self._breaker(m).snapshot()
            replicas[str(m.idx)] = {
                "state": m.state,
                "addr": f"{m.addr[0]}:{m.addr[1]}" if m.addr else None,
                "incarnation": m.incarnation, "restarts": m.restarts,
                "version": m.version, "rpcs": m.rpcs, "errors": m.errors,
                "sheds": m.sheds, "last_error": m.last_error,
                "queue_depth": m.queue_depth,
                "occupancy": round(m.occupancy, 4),
                "breaker": br,
            }
            # numeric breaker state per replica in the registry
            # (0 closed / 1 half-open / 2 open) — operators and the
            # autoscaler read the router's own verdicts, not a copy.
            # Checked + set under the POOL lock: remove_replica flips the
            # state under that lock before deleting the member's gauges,
            # so this can never resurrect a removed replica's gauge
            with self._pool._lock:
                if m.state not in ("leaving", "removed", "stopped"):
                    obs.set_gauge(f"fleet.replica{m.idx}.breaker_state",
                                  _BR_STATE.get(br["state"], 2))
        open_s = sum(r["breaker"]["open_seconds"]
                     for r in replicas.values())
        # mirrored into the registry so fleet-level SLO math works off the
        # merged metrics snapshot alone (no stats dict in hand)
        obs.set_gauge("fleet.breaker_open_seconds", open_s)
        return {"fleet_version": self._fleet_version,
                "ready_replicas": len(self._pool.ready_members()),
                "failovers": self.failovers, "hedges": self.hedges,
                "hedge_wins": self.hedge_wins,
                "stale_rejected": self.stale_rejected,
                "breaker_trips": sum(b.trips
                                     for b in self._breakers.values()),
                "breaker_open_seconds": round(open_s, 4),
                "inflight": self._inflight,
                "intake_paused": not self._gate.is_set(),
                "hedge_ms": self.hedge_ms,
                "replicas": replicas}

    def collect_telemetry(self, drain: bool = True,
                          retain: Optional[list] = None) -> list:
        """Pull every ready replica's telemetry parts over
        ``OP_TELEMETRY`` (drained rings: repeated collections are
        increments). A replica that fails mid-pull is skipped and counted:
        the dead leave their JSONL evidence instead. ``retain`` fans the
        tail plane's verdict list out, so a replica's held spans of a
        retained trace promote into the part this collection returns. A
        ``GroupReplica`` answers from its leader: the part holds the
        leader's spans, not its peers'."""
        parts = []
        for m in self._pool.ready_members():
            try:
                with self._conn(m) as cli:
                    tel = cli.telemetry(drain=drain, retained=retain)
                for p in tel.get("parts", []):
                    p["role"] = f"replica{m.idx}"
                    parts.append(p)
            except (ServeError, ConnectionError, OSError) as e:
                obs.inc("fleet.telemetry_errors")
                obs.event("fleet.telemetry_error", replica=m.idx,
                          error=str(e)[:160])
        return parts

    def drain(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
        return True

    def close(self, timeout: float = 30.0) -> None:
        self.drain(timeout)
        with self._lock:
            for pool in self._pools.values():
                pool.close()
            self._pools.clear()

    def _wait_inflight_zero(self, timeout: float) -> bool:
        return self.drain(timeout)

    # -- fleet-atomic reload -------------------------------------------
    def reload(self, path: str, epoch: Optional[int] = None,
               prefix: str = "ckpt") -> int:
        """Two-phase fleet flip: every replica serves the new generation or
        none does (see the module docstring for the atomicity argument).
        Returns the new fleet version."""
        with self._reload_lock:
            members = self._pool.ready_members()
            if not members:
                raise ServeError("no ready replicas to reload")
            new_version = self._fleet_version + 1
            self._reload_epoch += 1
            token = (self._controller_id, self._reload_epoch)
            with obs.trace.span("fleet.reload", version=new_version,
                                replicas=len(members)):
                self._prepare_all(members, token, path, epoch, prefix,
                                  new_version)
                # holding _reload_lock across the flip drain is the POINT
                # (reloads are serialized fleet-wide) and the drain is
                # bounded by flip_timeout
                self._commit_all(members, token, path, epoch, prefix,
                                 new_version)  # lint: disable=blocking-call-under-lock
            obs.inc("fleet.reloads")
            obs.event("fleet.reload", version=new_version)
            return new_version

    def _prepare_all(self, members, token, path, epoch, prefix, version):
        """Phase one — a barrier: every ready replica stages the new
        generation (all fallible work happens here) or the whole reload
        aborts and nothing changed anywhere."""
        prepared = []
        try:
            for m in members:
                with self._conn(m) as cli:
                    cli.prepare_reload(path, epoch=epoch, prefix=prefix,
                                       version=version, token=token,
                                       retries=3)
                prepared.append(m)
        except Exception as e:
            for p in prepared:
                try:
                    with self._conn(p) as cli:
                        cli.abort_reload(token)
                except Exception:  # noqa: BLE001 — rollback is best-effort
                    pass
            raise ServeError(f"fleet reload prepare failed "
                             f"(rolled back on {len(prepared)} replicas): "
                             f"{type(e).__name__}: {e}")

    def _commit_all(self, members, token, path, epoch, prefix, version):
        """Phase two — pause intake, drain in-flight, flip every live
        replica (a pure pointer swap), stamp the fleet version. A replica
        that dies mid-phase serves nothing and restarts onto the committed
        target; one that errors while alive is resynced and version-gated
        until it is."""
        self._gate.clear()
        try:
            if not self._wait_inflight_zero(self._flip_timeout):
                for m in members:
                    try:
                        with self._conn(m) as cli:
                            cli.abort_reload(token)
                    except Exception:  # noqa: BLE001 — best-effort rollback
                        pass
                raise ServeError(
                    f"fleet reload: in-flight requests did not drain within "
                    f"{self._flip_timeout}s flip window; aborted (still "
                    f"serving v{self._fleet_version} everywhere)")
            # commit point: from here the reload WILL happen. Restarts must
            # land on the new generation even if every commit RPC dies.
            self._pool.set_target(path, epoch, prefix, version)
            for m in members:
                if self._commit_hook is not None:
                    self._commit_hook(m)  # chaos injection for tests
                try:
                    with self._conn(m) as cli:
                        cli.commit_reload(token, retries=3)
                    m.version = version
                except (ServeError, ConnectionError, OSError) as e:
                    # dead mid-flip → serves nothing; alive-but-errored →
                    # resynced by the pool and version-gated meanwhile
                    obs.inc("fleet.commit_failures")
                    obs.event("fleet.commit_failure", replica=m.idx,
                              error=str(e)[:160])
                    m.last_error = f"commit: {type(e).__name__}: {e}"
                    self._pool.request_resync(m.idx)
            self._fleet_version = version
        finally:
            self._gate.set()


# ---------------------------------------------------------------------------
# socket front
# ---------------------------------------------------------------------------

class FleetServer(ServeServer):
    """One socket endpoint for the whole fleet: the Router is mounted as
    the server's batcher, so INFER routes with failover/hedging, READY
    reflects live replicas + the fleet version, RELOAD is the fleet-atomic
    two-phase flip, and STATS returns per-replica breaker/failover state —
    all on the unchanged serve wire protocol (``ServeClient`` and
    ``serve_bench`` work as-is)."""

    def __init__(self, router: Router, host: str = "127.0.0.1",
                 port: int = 0, *, default_timeout: float = 30.0):
        super().__init__(engine=None, batcher=router, host=host, port=port,
                         default_timeout=default_timeout)
        self._router = router

    def reload(self, path: str, epoch: Optional[int] = None,
               prefix: str = "ckpt") -> int:
        return self._router.reload(path, epoch=epoch, prefix=prefix)

    def telemetry(self, drain: bool = True,
                  retained: Optional[list] = None) -> dict:
        """The fleet collection plane: one ``OP_TELEMETRY`` against the
        front returns the front's own part (its rpc and ``fleet.route``
        spans, the router's metrics) plus one part per live replica —
        what ``obs.export_mod.merge_chrome_parts`` merges into one
        timeline and ``parts_to_prometheus`` labels by pid and role.

        Tail retention: the caller's verdicts resolve this process's
        pending buffer, then they and the front's own recent verdicts fan
        out with the replica pulls. Parts are deduped by pid: an
        in-process ``LocalReplica`` fleet shares one tracer ring and
        registry with the front."""
        if retained:
            obs.tail.resolve(retained)
        fan_out = sorted(set(list(retained or ())
                             + obs.tail.retained_ids()))
        # stats first: Router.stats() refreshes the breaker-open-time
        # gauge, which must land in the snapshot the part takes
        st = self.stats(include_metrics=False)
        front = obs.telemetry_part(drain=drain, role="fleet")
        front["stats"] = st
        parts, seen = [front], {front["pid"]}
        for p in self._router.collect_telemetry(drain=drain,
                                                retain=fan_out or None):
            if p.get("pid") in seen:
                continue
            seen.add(p.get("pid"))
            parts.append(p)
        return {"parts": parts}
