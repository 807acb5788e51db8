"""Distributed job launcher on one host (counterpart of
``tools/launch.py``).

    python -m mxnet_tpu_torch.tools.launch -n 2 python train.py
    python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 python train.py
    python -m mxnet_tpu_torch.tools.launch -n 3 -e python train.py

Each worker gets the reference's environment contract:
``DMLC_ROLE=worker``, ``DMLC_NUM_WORKER=<n>``, ``DMLC_WORKER_ID=<rank>``,
``DMLC_NUM_SERVER``, and either ``MXNET_COORDINATOR=<host:port>`` (the
``dist_sync`` rendezvous: the address of rank 0's ``torch.distributed``
store) or, with ``-s`` > 0, ``-e`` or ``--async-staleness``,
``MXNET_PS_ADDR`` / ``MXNET_PS_PORT`` of one parameter-server process.

The server is the native one (``native/ps/ps_server.cc``, built by
``native.ps_server_binary()``) where the reference would start its own
native build, and the port's Python server
(``python -m mxnet_tpu_torch.kvstore.ps_server``) where the reference
would start its Python twin: in elastic mode (``-e``: the membership
opcodes) and bounded-staleness mode (``--async-staleness``: the clock
opcodes), which the native server does not speak, or when the native one
does not build. ``--ps-server python|native`` forces the choice.

The workers' ``dist_sync`` backend follows from how many ranks share a
card (``kvstore.dist.choose_backend``): gloo when ranks share one or there
is none, NCCL when each has its own. Multi-host launchers (ssh, mpi, ...)
raise: start the same command on every host with the environment above.
Returns the first non-zero worker exit code.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

__all__ = ["launch_local", "start_ps_server", "main"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ps_server(port: int, num_workers: int, elastic: bool = False,
                    async_staleness=None, kind: str = "auto", env=None):
    """Start one parameter-server process on ``port`` and wait for its
    banner; returns the ``Popen``. ``kind``: "native", "python" or "auto"
    (native unless elastic, bounded-staleness, or not buildable); ``env``:
    variables set for the server on top of this process's."""
    from .. import native

    env = dict(os.environ, **(env or {}))
    if async_staleness is not None:
        env["MXNET_ASYNC_STALENESS"] = str(async_staleness)
    binary = None
    if kind == "native" or (kind == "auto" and not elastic
                            and async_staleness is None):
        binary = native.ps_server_binary()
        if binary is None and kind == "native":
            raise RuntimeError("the native parameter server did not build: "
                               f"{native.ps_server_error()}")
    if binary is not None:
        cmd = [binary, "--port", str(port), "--num-workers",
               str(num_workers)]
    else:
        cmd = [sys.executable, "-m", "mxnet_tpu_torch.kvstore.ps_server",
               "--port", str(port), "--num-workers", str(num_workers)]
        # the child imports the port whatever the caller's cwd
        env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 60
    lines = []
    while time.time() < deadline:  # skip chatter before the banner
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if "listening" in line:
            return proc
    proc.kill()
    proc.wait()
    raise RuntimeError(f"ps server failed to start: {''.join(lines)!r}")


def launch_local(num_workers: int, num_servers: int, command: list,
                 env_extra=None, elastic: bool = False,
                 async_staleness=None, ps_server: str = "auto") -> int:
    """Spawn the workers (and a server) on this host; returns the first
    non-zero worker exit code."""
    base_env = dict(os.environ)
    base_env.update(env_extra or {})
    elastic = elastic or base_env.get("MXNET_ELASTIC", "") not in ("", "0")
    base_env["DMLC_NUM_WORKER"] = str(num_workers)
    base_env["DMLC_NUM_SERVER"] = str(num_servers)
    if elastic:
        # elastic dist_sync rides the PS wire for membership and its
        # reduces: a server is needed even in sync mode
        base_env["MXNET_ELASTIC"] = "1"
        num_servers = max(1, num_servers)
    if async_staleness is not None:
        base_env["MXNET_ASYNC_STALENESS"] = str(int(async_staleness))
        num_servers = max(1, num_servers)

    ps_proc = None
    if num_servers > 0:
        ps_port = _free_port()
        ps_proc = start_ps_server(ps_port, num_workers, elastic=elastic,
                                  async_staleness=async_staleness,
                                  kind=ps_server)
        base_env["MXNET_PS_ADDR"] = "127.0.0.1"
        base_env["MXNET_PS_PORT"] = str(ps_port)
    else:
        base_env["MXNET_COORDINATOR"] = f"127.0.0.1:{_free_port()}"

    workers = []
    rc = 0
    try:
        for rank in range(num_workers):
            env = dict(base_env)
            env["DMLC_ROLE"] = "worker"
            env["DMLC_WORKER_ID"] = str(rank)
            workers.append(subprocess.Popen(command, env=env))
        for w in workers:
            w.wait()
            rc = rc or w.returncode
    except KeyboardInterrupt:
        for w in workers:
            w.send_signal(signal.SIGINT)
        rc = 130
    finally:
        for w in workers:  # a worker that outlives a failure is stopped
            if w.poll() is None:
                w.kill()
                w.wait()
        if ps_proc is not None:
            ps_proc.terminate()
            try:
                ps_proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                ps_proc.kill()
                ps_proc.wait()
            ps_proc.stdout.close()
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="launch a distributed mxnet_tpu_torch job on this host",
        usage="launch.py [-h] -n NUM_WORKERS [-s NUM_SERVERS] [-e] "
              "command ...")
    p.add_argument("-n", "--num-workers", type=int, required=True)
    p.add_argument("-s", "--num-servers", type=int, default=0,
                   help="PS processes (dist_async); 0 = a collective "
                   "dist_sync over torch.distributed")
    p.add_argument("-e", "--elastic", action="store_true",
                   help="elastic training: PS-backed generation-scoped "
                   "sync, worker heartbeats, survivable barriers; implies "
                   "a Python PS process")
    p.add_argument("--async-staleness", type=int, default=None,
                   metavar="N",
                   help="bounded-staleness dist_async: workers more than "
                   "N steps ahead of the fleet's committed-clock floor "
                   "block at pull; implies a Python PS process")
    p.add_argument("--ps-server", default="auto",
                   choices=["auto", "native", "python"],
                   help="which parameter server to start (auto: native "
                   "unless elastic or bounded-staleness)")
    p.add_argument("--launcher", default="local",
                   choices=["local", "ssh", "mpi", "yarn", "sge"])
    p.add_argument("command", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.launcher != "local":
        raise SystemExit(
            f"--launcher {args.launcher}: only 'local' spawns processes "
            "from here; on many hosts, start the same command on each with "
            "DMLC_NUM_WORKER, DMLC_WORKER_ID and MXNET_COORDINATOR set")
    if not args.command:
        p.error("no command given")
    return launch_local(args.num_workers, args.num_servers, args.command,
                        elastic=args.elastic,
                        async_staleness=args.async_staleness,
                        ps_server=args.ps_server)


if __name__ == "__main__":
    sys.exit(main())
