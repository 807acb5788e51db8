"""Kill-and-resume harness: a SIGKILL at any step costs nothing
(counterpart of ``tools/chaos_kill.py``).

Orchestrator mode (default) runs the same small deterministic training
job three ways and compares the final parameters byte for byte:

  1. reference: an uninterrupted run to completion
  2. killed:    SIGKILL delivered the moment ``CHAOS_STEP <n>`` reaches
                ``--kill-at-step`` (as a preempted machine vanishes); it
                runs beside the reference
  3. resumed:   the same checkpoint dir, ``resume="auto"``: restarts from
                the newest *valid* checkpoint and runs to completion

Checkpoints capture parameters, optimizer slots and counters, RNG streams
and the iterator's cursor, so the resumed run must be bitwise identical
to the reference; any drift means the capture is incomplete. On the card
each worker runs under ``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (fixed-order cuBLAS reductions).

    python -m mxnet_tpu_torch.tools.chaos_kill --kill-at-step 7
    python -m mxnet_tpu_torch.tools.chaos_kill --kill-at-step 7 \\
        --chaos-kill ckpt:pre_rename@2 --device cpu

``--chaos-kill`` forwards ``MXNET_CHAOS_KILL`` to the victim, e.g. to die
mid-rename inside the checkpoint writer on top of the step kill.

Worker mode (``--train``) is the training job itself: a fixed-seed MLP on
synthetic data through ``Module.fit`` with crash-safe checkpoints. It
prints ``CHAOS_STEP <n>`` after every optimizer step (the orchestrator's
kill trigger) and writes ``final.params`` when done. It runs on the card
unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

SEED = 77
NUM_EPOCH = 3
BATCH = 8
NSAMPLES = 64
FINAL = "final.params"
WORKER_TIMEOUT = 300.0  # seconds, any one worker
CUBLAS_WORKSPACE = ":4096:8"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def train(ckpt_dir: str, resume="auto", batch_period=2,
          device="gpu") -> int:
    """The deterministic training job (worker mode)."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import platform

    if device == "cpu":
        platform.devices_or_exit(what="tools/chaos_kill.py", backend="cpu")
        ctx = mx.cpu()
    else:
        platform.devices_or_exit(what="tools/chaos_kill.py")
        torch.use_deterministic_algorithms(True)
        ctx = mx.gpu(0)
    with ctx:
        return _fit(ckpt_dir, resume, batch_period, ctx)


def _fit(ckpt_dir, resume, batch_period, ctx) -> int:
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ndarray.serialization import save_nd

    np.random.seed(SEED)
    mx.random.seed(SEED)
    # the dataset comes from a private stream, identical in every run
    # wherever the consumer's RNG state was checkpointed
    rng = np.random.RandomState(1234)
    X = rng.randn(NSAMPLES, 10).astype(np.float32)
    y = rng.randint(0, 4, NSAMPLES).astype(np.float32)
    it = NDArrayIter(X, y, batch_size=BATCH, shuffle=True,
                     label_name="softmax_label")

    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    mod = Module(net, context=ctx)

    def on_batch(param):
        # the orchestrator kills on this marker; printed AFTER the update,
        # so "killed at step n" means n optimizer steps are on disk
        print(f"CHAOS_STEP {param.locals['global_step']}", flush=True)

    mod.fit(it, num_epoch=NUM_EPOCH, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            batch_end_callback=on_batch,
            checkpoint=ckpt_dir, resume=resume,
            checkpoint_batch_period=batch_period)

    arg, _aux = mod.get_params()
    names = sorted(arg)
    save_nd(os.path.join(ckpt_dir, FINAL),
            [np.asarray(arg[n].asnumpy()) for n in names], names)
    print("TRAIN_DONE", flush=True)
    return 0


def _worker_cmd(ckpt_dir: str, device: str) -> list:
    return [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_kill",
            "--train", "--ckpt-dir", ckpt_dir, "--device", device]


def _worker_env(chaos_kill: str = "") -> dict:
    env = dict(os.environ)
    # the worker imports the port whatever the caller's cwd
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    if chaos_kill:
        env["MXNET_CHAOS_KILL"] = chaos_kill
    else:
        env.pop("MXNET_CHAOS_KILL", None)
    return env


def orchestrate(kill_at_step: int, workdir: str, chaos_kill: str = "",
                device: str = "gpu") -> int:
    from mxnet_tpu_torch.chaos.proc import run_to_completion, run_until_step

    ref_dir = os.path.join(workdir, "ref")
    vic_dir = os.path.join(workdir, "victim")
    os.makedirs(ref_dir)
    os.makedirs(vic_dir)

    # the reference and the victim are independent: they run side by side
    print(f"[1/3] reference run (uninterrupted) -> {ref_dir}", flush=True)
    print(f"[2/3] victim run, SIGKILL at step {kill_at_step} -> {vic_dir}",
          flush=True)
    with ThreadPoolExecutor(2) as ex:
        ref_run = ex.submit(run_to_completion, _worker_cmd(ref_dir, device),
                            env=_worker_env(), timeout=WORKER_TIMEOUT)
        vic_run = ex.submit(run_until_step, _worker_cmd(vic_dir, device),
                            kill_at_step, env=_worker_env(chaos_kill),
                            timeout=WORKER_TIMEOUT)
        (rc, out), (vic_rc, vic_out) = ref_run.result(), vic_run.result()
    if rc != 0 or "TRAIN_DONE" not in out:
        print(out[-3000:])
        print("reference run failed")
        return 2
    if vic_rc != -9:
        print(vic_out[-3000:])
        print(f"victim exited rc={vic_rc} before reaching step "
              f"{kill_at_step}")
        return 2

    print("[3/3] resume with resume='auto' from the same directory",
          flush=True)
    rc, out = run_to_completion(_worker_cmd(vic_dir, device),
                                env=_worker_env(), timeout=WORKER_TIMEOUT)
    if rc != 0 or "TRAIN_DONE" not in out:
        print(out[-3000:])
        print("resumed run failed")
        return 2

    with open(os.path.join(ref_dir, FINAL), "rb") as f:
        ref_bytes = f.read()
    with open(os.path.join(vic_dir, FINAL), "rb") as f:
        vic_bytes = f.read()
    if ref_bytes == vic_bytes:
        print("BITWISE MATCH: resumed final params == uninterrupted run")
        return 0
    import numpy as np

    from mxnet_tpu_torch.ndarray.serialization import load_nd

    ref = load_nd(os.path.join(ref_dir, FINAL))
    vic = load_nd(os.path.join(vic_dir, FINAL))
    for n in sorted(ref):
        delta = float(np.abs(np.asarray(ref[n]) - np.asarray(vic[n])).max())
        print(f"  {n}: max |delta| = {delta:g}")
    print("MISMATCH: resumed run drifted from the uninterrupted one")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SIGKILL a training run at step N, resume, diff params")
    ap.add_argument("--train", action="store_true",
                    help="worker mode: run the training job itself")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (worker) / scratch "
                         "(orchestrator)")
    ap.add_argument("--resume", default="auto", help='worker: "auto"|"never"')
    ap.add_argument("--batch-period", type=int, default=2,
                    help="worker: checkpoint every N steps")
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"),
                    help="where the workers train (default: the card)")
    ap.add_argument("--kill-at-step", type=int, default=7,
                    help="orchestrator: SIGKILL when CHAOS_STEP reaches N")
    ap.add_argument("--chaos-kill", default="",
                    help="orchestrator: MXNET_CHAOS_KILL for the victim, "
                         "e.g. ckpt:pre_rename@2")
    args = ap.parse_args(argv)

    if args.train:
        if not args.ckpt_dir:
            ap.error("--train requires --ckpt-dir")
        return train(args.ckpt_dir, resume=args.resume,
                     batch_period=args.batch_period, device=args.device)

    workdir = args.ckpt_dir or tempfile.mkdtemp(prefix="chaos_kill_")
    cleanup = args.ckpt_dir is None
    try:
        return orchestrate(args.kill_at_step, workdir,
                           chaos_kill=args.chaos_kill, device=args.device)
    finally:
        if cleanup:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
