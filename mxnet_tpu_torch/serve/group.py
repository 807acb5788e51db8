"""Replica groups of sharded serving: a tensor-parallel engine's ranks as
one ``torch.distributed`` job (the port's counterpart of the reference's
one process on a slice of devices; ``parallel/mesh.py`` makes each mesh
device a rank of a job).

A sharded :class:`~mxnet_tpu_torch.serve.engine.InferenceEngine` runs on
every rank of its mesh. Rank 0 of the mesh, the **leader**, is the
engine its caller uses (and the one a ``ServeServer`` wraps); every other
rank, a **peer**, builds the same engine and never returns from the
constructor: it follows the leader (:meth:`Channel.follow`). Each
operation that touches the mesh is first announced by the leader with a
broadcast on the job's group: a bucket's forward, a reload's prepare,
commit or abort, and stop. The announcement is a fixed-size int64 header
(the operation, its integers, the dtype and shape of each array), then
the arrays (a padded batch, a new parameter set). The leader holds one
lock from the announcement to the end of the operation, so every rank
issues the same collectives in the same order, whichever thread (the
batcher, a reload handler) leads it. A group whose collective failed on
the leader is broken: later operations raise ``ServeError``, and a rank
started by :func:`main` ends its group (below).

A replica group of a serving pool (``ReplicaPool.sharded``) is a job of
its own, started by :func:`main` (``python -m
mxnet_tpu_torch.serve.group``), with its own rendezvous port:

- the pool's handle starts the leader in a new session and writes it the
  pickled ``(make_server, the slice's devices, axis names, shape)``; the
  leader starts its peers (fresh interpreters, never a fork of a parent
  holding a CUDA context) with the same bytes, and every rank forms the
  job's group (``kvstore.dist.join_process_group``: gloo as ``gloo_host``
  when ranks share a card, NCCL when each has its own) and calls
  ``make_server(submesh)`` under its device's context;
- the leader reports ``"<port> <pid> ..."`` (its server's port, then the
  pid of every rank) on the file descriptor it was given, and serves;
- a peer never opens a socket; it exits when its parent, the leader,
  dies (or when a collective with it fails), and the leader kills its
  peers and exits when one of them dies (or when the pool's process
  does), so the pool's supervisor sees the whole group dead and restarts
  it as a unit; the handle's ``kill`` kills the session's process group.

``server --tp N`` starts its own N ranks the same way
(:func:`spawn_peers`).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import tsan
from ..base import MXNetError

__all__ = ["Channel", "PeerExit", "spawn_peers", "watch_parent",
           "check_factory", "group_payload", "pid_alive", "main"]

(OP_FORWARD, OP_PREPARE, OP_COMMIT, OP_ABORT, OP_RELOAD,
 OP_STOP) = range(1, 7)

_HDR = 64                 # int64 slots of an announcement
_MAX_DIMS = 8
_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int32, torch.int64, torch.uint8, torch.int8, torch.bool)
# the group's collectives wait as long as a server idles between requests;
# a dead rank ends them sooner (its connections close)
SERVE_GROUP_TIMEOUT = datetime.timedelta(days=3650)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# set in a rank that main() started: a broken group ends the process
_end_group = None
_stopping = False


class PeerExit(SystemExit):
    """Raised by a peer rank's engine constructor once its leader stopped
    the group: the rank has nothing left to do (exit code 0). ``engine``
    is the peer's engine, for a caller that reports on it."""

    def __init__(self, engine):
        super().__init__(0)
        self.engine = engine


class Channel:
    """The leader-to-peers announcements of one sharded engine, over the
    default group of its job (the engine's mesh must span the job)."""

    def __init__(self, mesh, device):
        import torch.distributed as dist

        mesh.device_mesh  # forms the job's group
        n = dist.get_world_size()
        if mesh.size != n or sorted(mesh.ranks.ravel().tolist()) != \
                list(range(n)):
            raise MXNetError(
                f"a sharded engine's mesh must span its job: {mesh!r} in a "
                f"job of {n} ranks (a replica group is a job of its own: "
                "ReplicaPool.sharded)")
        self.leader = int(mesh.ranks.flat[0])
        self.is_leader = dist.get_rank() == self.leader
        self.device = device
        self._lock = tsan.lock("serve.group.channel")
        self.broken: Optional[str] = None

    # -- collectives ------------------------------------------------------
    def _bcast(self, t):
        import torch.distributed as dist

        dist.broadcast(t, src=self.leader)

    def share(self, tensors: Sequence[torch.Tensor]) -> None:
        """The leader's values of ``tensors`` on every rank, in place
        (every rank calls it with tensors of the same shapes)."""
        for t in tensors:
            self._bcast(t)

    # -- the leader -------------------------------------------------------
    @contextlib.contextmanager
    def lead(self, op: int, ints: Sequence[int] = (),
             arrays: Sequence[torch.Tensor] = ()):
        """Announce ``op`` with ``ints`` and ``arrays`` (tensors on the
        engine's device) and hold the group until the block ends."""
        from .engine import ServeError

        hdr = [op, len(ints), *ints, len(arrays)]
        for a in arrays:
            if a.ndim > _MAX_DIMS or a.dtype not in _DTYPES:
                raise ServeError(f"an array of {a.ndim} dims of {a.dtype} "
                                 "cannot be announced")
            hdr += [_DTYPES.index(a.dtype), a.ndim, *a.shape]
        if len(hdr) > _HDR:
            raise ServeError("announcement too long for its header")
        with self._lock:
            if self.broken:
                raise ServeError(f"the engine's rank group is broken: "
                                 f"{self.broken}")
            try:
                t = torch.zeros(_HDR, dtype=torch.int64, device=self.device)
                t[:len(hdr)] = torch.tensor(hdr, dtype=torch.int64)
                self._bcast(t)
                self.share(arrays)
                yield
            except BaseException as e:
                self.broken = f"{type(e).__name__}: {e}"
                if _end_group is not None:
                    _end_group(f"leader: {self.broken}")
                raise

    # -- a peer -----------------------------------------------------------
    def receive(self):
        """The next announcement: ``(op, ints, arrays)``."""
        t = torch.empty(_HDR, dtype=torch.int64, device=self.device)
        self._bcast(t)
        hdr = t.tolist()
        op, n_ints = hdr[0], hdr[1]
        ints = hdr[2:2 + n_ints]
        i = 2 + n_ints
        arrays = []
        for _ in range(hdr[i]):
            dtype, ndim = _DTYPES[hdr[i + 1]], hdr[i + 2]
            shape = hdr[i + 3:i + 3 + ndim]
            i += 2 + ndim
            arrays.append(torch.empty(shape, dtype=dtype,
                                      device=self.device))
        self.share(arrays)
        return op, ints, arrays

    def follow(self, engine) -> None:
        """A peer's loop: run each announced operation until the leader
        stops the group."""
        while True:
            op, ints, arrays = self.receive()
            if op == OP_STOP:
                return
            engine._follow_op(op, ints, arrays)


# ---------------------------------------------------------------------------
# the processes of a group
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pid_alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] not in ("Z", "X")
    except FileNotFoundError:
        return False
    except OSError:
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False


def _kill_all(procs):
    for p in procs:
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass


def spawn_peers(n: int, argv: Sequence[str], payload: Optional[bytes] = None
                ) -> List[subprocess.Popen]:
    """Start ranks 1..n-1 of a job of ``n`` whose rank 0 is this process:
    each runs ``argv`` in a fresh interpreter, in this process's session,
    with the launcher's environment (``DMLC_WORKER_ID``,
    ``DMLC_NUM_WORKER``, ``MXNET_COORDINATOR`` at a port picked here),
    which is set for this process too; ``payload`` goes to each one's
    standard input. If a peer exits before this process stops its group,
    the others are killed and this process exits."""
    os.environ.update({"MXNET_COORDINATOR": f"127.0.0.1:{_free_port()}",
                       "DMLC_NUM_WORKER": str(n), "DMLC_WORKER_ID": "0"})
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for r in range(1, n):
        p = subprocess.Popen(list(argv), env=dict(env, DMLC_WORKER_ID=str(r)),
                             stdin=subprocess.PIPE if payload is not None
                             else subprocess.DEVNULL)
        if payload is not None:
            p.stdin.write(payload)
            p.stdin.close()
        procs.append(p)

    def watch(p):
        rc = p.wait()
        if not _stopping:
            print(f"serve group: rank pid {p.pid} exited {rc}; ending the "
                  "group", file=sys.stderr, flush=True)
            _kill_all(procs)
            os._exit(1)

    for p in procs:
        # daemon watchers, one per rank: each ends the whole group (os._exit)
        # when its rank dies, so the process's lifetime supervises them
        threading.Thread(target=watch, args=(p,), daemon=True).start()  # lint: disable=thread-fire-and-forget
    return procs


def watch_parent() -> None:
    """End this process when its parent dies (a peer whose leader died)."""
    ppid = os.getppid()

    def loop():
        while os.getppid() == ppid:
            time.sleep(0.5)
        os._exit(1)

    # a daemon that ends this process when its parent dies: the process's
    # lifetime is its join point
    threading.Thread(target=loop, daemon=True,  # lint: disable=thread-fire-and-forget
                     name="mxnet-serve-parent-watch").start()


def stopping() -> None:
    """Mark this process's group as stopping: peers that exit now are not
    a failure."""
    global _stopping
    _stopping = True


def check_factory(make_server) -> None:
    """``make_server`` runs in every rank of a replica group, a process
    of its own, so it must pickle by reference: a module-level function or
    a ``functools.partial`` of one. Anything else raises ``MXNetError``."""
    fn = make_server
    while hasattr(fn, "func"):  # functools.partial
        fn = fn.func
    qual = getattr(fn, "__qualname__", "")
    why = None
    if "<locals>" in qual or "<lambda>" in qual:
        why = "it is a closure or a lambda"
    elif getattr(fn, "__module__", None) == "__main__":
        why = "it is defined in __main__, which the ranks do not import"
    else:
        try:
            pickle.dumps(make_server)
        except Exception as e:  # noqa: BLE001 — reported below
            why = f"it does not pickle ({type(e).__name__}: {e})"
    if why is not None:
        raise MXNetError(
            f"ReplicaPool.sharded: make_server {make_server!r} must be "
            f"picklable, but {why}: each replica group's ranks are "
            "processes of their own, and each calls make_server(submesh); "
            "pass a module-level function or a functools.partial of one")


def group_payload(make_server, mesh) -> bytes:
    """The bytes a replica group's ranks start from: ``make_server``
    (:func:`check_factory`) and the slice's devices, axis names and
    shape."""
    check_factory(make_server)
    return pickle.dumps((make_server, [str(d) for d in mesh.devices.flat],
                         tuple(mesh.axis_names),
                         tuple(mesh.devices.shape)))


def main(argv=None) -> int:
    """A rank of a replica group (see the module's docstring)."""
    import argparse

    ap = argparse.ArgumentParser(description="a rank of a replica group")
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--report-fd", type=int, default=None,
                    help="the leader's: where it reports its port and pids")
    args = ap.parse_args(argv)
    payload = sys.stdin.buffer.read()
    make_server, devices, axis_names, shape = pickle.loads(payload)
    watch_parent()  # the pool's process, or a peer's leader
    peers = []
    if args.report_fd is not None and args.ranks > 1:
        peers = spawn_peers(args.ranks, [
            sys.executable, "-m", "mxnet_tpu_torch.serve.group",
            "--ranks", str(args.ranks)], payload)

    global _end_group

    def end_group(why):
        print(f"serve group: {why}; ending the group", file=sys.stderr,
              flush=True)
        _kill_all(peers)
        os._exit(1)

    _end_group = end_group
    from .. import context
    from ..kvstore.dist import join_process_group, launcher_rank
    from ..parallel.mesh import Mesh

    rank = launcher_rank()[0] if args.ranks > 1 else 0
    if args.ranks > 1:
        join_process_group(rank, args.ranks, who="serve group",
                           timeout=SERVE_GROUP_TIMEOUT)
    devs = np.empty(len(devices), dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    mesh = Mesh(devs.reshape(shape), axis_names)
    with context.Context(devs[rank]):
        srv = make_server(mesh)  # a peer raises PeerExit here
    with os.fdopen(args.report_fd, "w") as f:
        f.write(" ".join(str(v) for v in [srv.port, os.getpid()]
                         + [p.pid for p in peers]) + "\n")
    srv._stop.wait()
    srv._engine.close()  # stops the peers
    for p in peers:
        p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
