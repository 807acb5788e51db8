"""The port's distributed stores with real worker processes on the CPU,
started by ``mxnet_tpu_torch/tools/launch.py``; the workers are
``python -m mxnet_tpu_torch.tools.dist_worker``.

- ``dist_sync`` over a gloo ``torch.distributed`` group, 2 and 3 workers,
  and ``dist_async`` against the port's Python server and the native one
  (``native/ps/ps_server.cc``, built into ``build/mxnet_tpu_torch/``):
  the known-value worker of the reference's ``tests/dist_worker.py``
  (exact sums, merges, 2-bit with error feedback, row_sparse, the
  optimizer on the store); ``dist_async`` also with bounded staleness
  (``--async-staleness 2``, the gated pulls). The reference's own ``dist_sync`` cannot run
  on this CPU (jaxlib has no multiprocess CPU collectives; its test is
  xfail), so the known values, which are analytic, are the oracle.
- elastic ``dist_sync``, 3 workers, against the port's server and against
  the reference's (``python -m mxnet_tpu.kvstore.ps_server``): the same
  known values over the generation-scoped reduce; and the elastic
  ``Module.fit`` worker, whose final loss is equal on every rank and
  within the reference's tolerance (0.25x) of the reference's own
  elastic worker.
- a 2-layer, 64-unit LM trained by two gloo workers through
  ``gluon.Trainer(kvstore="dist_sync")``: the ranks' weights bitwise
  equal after every step, and the step-1 weights held to the reference's
  one-process Trainer on the concatenated batch (``step(2)``) from the
  same starting weights, within 1e-5 of each tensor's largest magnitude or
  1e-2 of the learning rate, whichever is larger (zero-initialized biases
  hold one Adam step, which is at most the learning rate).
"""
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = [sys.executable, "-m", "mxnet_tpu_torch.tools.dist_worker"]


def _env(**extra):
    env = dict(os.environ)
    for var in ("DMLC_NUM_WORKER", "DMLC_WORKER_ID", "MXNET_COORDINATOR",
                "MXNET_PS_ADDR", "MXNET_PS_PORT", "MXNET_ELASTIC"):
        env.pop(var, None)
    env.update({"MXNET_ELASTIC_HEARTBEAT_S": "0.2", "JAX_PLATFORMS": "cpu",
                "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
                "OMP_NUM_THREADS": "1"})
    env.update(extra)
    return env


def _launch(launch_args, worker_args, timeout=240, env=None):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch",
           *launch_args, *WORKER, *worker_args]
    proc = subprocess.run(cmd, cwd=REPO, env=env or _env(),
                          timeout=timeout, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, \
        f"launcher rc={proc.returncode}\n{proc.stdout[-4000:]}"
    return proc.stdout


@pytest.mark.parametrize("n", [2, 3])
def test_dist_sync_gloo_known_values(n):
    out = _launch(["-n", str(n)], ["known", "dist_sync", "--device", "cpu"])
    assert out.count("backend=gloo: OK") == n, out[-2000:]
    assert out.count("over torch.distributed gloo (no card)") == n


@pytest.mark.parametrize("server", ["python", "native"])
def test_dist_async_known_values(server):
    if server == "native":
        from mxnet_tpu_torch import native

        if native.ps_server_binary() is None:
            pytest.skip(f"no C++ toolchain: {native.ps_server_error()}")
    out = _launch(["-n", "2", "-s", "1", "--ps-server", server],
                  ["known", "dist_async", "--device", "cpu"])
    assert out.count("mode=dist_async device=cpu backend=None: OK") == 2, \
        out[-2000:]


def test_dist_async_bounded_staleness_known_values():
    out = _launch(["-n", "2", "--async-staleness", "2"],
                  ["known", "dist_async", "--device", "cpu"])
    assert out.count("mode=dist_async device=cpu backend=None: OK") == 2, \
        out[-2000:]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(n, worker_args, env, timeout=240):
    procs = [subprocess.Popen(
        WORKER + worker_args, cwd=REPO,
        env={**env, "DMLC_NUM_WORKER": str(n), "DMLC_WORKER_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.parametrize("server", ["port", "reference"])
def test_elastic_known_values_three_workers(server):
    """The dist_sync known values over the elastic reduce, against the
    port's server (through the launcher) and the reference's."""
    args = ["known", "dist_sync", "--device", "cpu"]
    if server == "port":
        out = _launch(["-n", "3", "-e"], args)
        assert out.count("backend=None: OK") == 3, out[-2000:]
        return
    port = _free_port()
    ps = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu.kvstore.ps_server", "--port",
         str(port), "--num-workers", "3"], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        while "listening" not in line:
            line = ps.stdout.readline()
            assert line, "the reference's server did not start"
        outs = _run_workers(3, args, _env(
            MXNET_ELASTIC="1", MXNET_PS_ADDR="127.0.0.1",
            MXNET_PS_PORT=str(port)))
    finally:
        ps.kill()
        ps.wait()
    assert all("backend=None: OK" in o for o in outs), outs


def _final_losses(out):
    return [float(v) for v in re.findall(r"FINAL_LOSS ([0-9.]+)", out)]


def test_elastic_module_fit_three_workers(tmp_path):
    out = _launch(["-n", "3", "-e"],
                  ["elastic", "--device", "cpu", "--ckpt-dir",
                   str(tmp_path / "port")])
    losses = _final_losses(out)
    assert len(losses) == 3 and len(set(losses)) == 1, out[-2000:]
    assert out.count("parts=3") == 12  # 4 epochs x 3 ranks
    ref = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "launch.py"), "-n",
         "3", "-e", sys.executable, os.path.join(REPO, "tests",
                                                 "elastic_worker.py"),
         "--ckpt-dir", str(tmp_path / "ref")], cwd=REPO, env=_env(),
        timeout=240, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    assert ref.returncode == 0, ref.stdout[-3000:]
    want = _final_losses(ref.stdout)[0]
    assert abs(losses[0] - want) <= 0.25 * max(want, 1.0), (losses, want)


def test_rank_without_a_group_raises(monkeypatch):
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch import kv

    for var in ("MXNET_COORDINATOR", "DMLC_PS_ROOT_URI", "MXNET_PS_ADDR",
                "MXNET_ELASTIC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "1")
    with pytest.raises(MXNetError, match="MXNET_COORDINATOR"):
        kv.create("dist_sync")
    monkeypatch.setenv("MXNET_COORDINATOR", "127.0.0.1:not-a-port")
    with pytest.raises(MXNetError, match="could not form its gloo"):
        kv.create("dist_sync")


_LM = dict(vocab=97, units=64, layers=2, heads=4, seq=16, batch=2, lr=1e-4)


def test_two_worker_lm_matches_one_process_reference(tmp_path):
    prefix = str(tmp_path / "lm")
    out = _launch(["-n", "2"],
                  ["lm", "--device", "cpu", "--vocab", str(_LM["vocab"]),
                   "--units", str(_LM["units"]), "--layers",
                   str(_LM["layers"]), "--heads", str(_LM["heads"]),
                   "--seq", str(_LM["seq"]), "--batch", str(_LM["batch"]),
                   "--lr", str(_LM["lr"]), "--steps", "3", "--out", prefix])
    reports = [json.loads(ln[len("DIST_LM "):]) for ln in out.splitlines()
               if ln.startswith("DIST_LM ")]
    assert len(reports) == 2 and all(r["weights_equal"] == [True] * 3
                                     for r in reports), out[-2000:]
    assert all(r["backend"] == "gloo" for r in reports)
    start = np.load(prefix + "-start.npz")
    step1 = np.load(prefix + "-step1.npz")

    import mxnet_tpu.gluon.block as jblock
    from mxnet_tpu import autograd, gluon, nd
    from mxnet_tpu.models import transformer_lm

    jblock._SCOPE.counters = {}
    net = transformer_lm(vocab_size=_LM["vocab"], units=_LM["units"],
                         hidden_size=4 * _LM["units"],
                         num_layers=_LM["layers"], num_heads=_LM["heads"],
                         max_length=_LM["seq"])
    net.initialize()
    params = net.collect_params()
    assert sorted(params.keys()) == sorted(start.files)
    for k, p in params.items():
        p.set_data(nd.array(start[k]))
    tokens = np.random.RandomState(0).randint(
        0, _LM["vocab"], (2 * _LM["batch"], _LM["seq"]))
    x = nd.array(tokens, dtype="int32")
    tr = gluon.Trainer(params, "adam", {"learning_rate": _LM["lr"]})
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), x)
    loss.backward()
    tr.step(_LM["batch"])
    for k, p in params.items():
        want, got = p.data().asnumpy(), step1[k]
        tol = max(1e-5 * np.abs(want).max(), 1e-2 * _LM["lr"])
        assert np.abs(got - want).max() <= tol, (k, np.abs(got - want).max(),
                                                 tol)
