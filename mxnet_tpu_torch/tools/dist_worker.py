"""Workers for the distributed stores, run under ``tools/launch.py`` (the
counterpart of the reference's ``tests/dist_worker.py`` and
``tests/elastic_worker.py``, plus a Gluon LM trainer).

    python -m mxnet_tpu_torch.tools.launch -n 2 \\
        python -m mxnet_tpu_torch.tools.dist_worker known dist_sync
    python -m mxnet_tpu_torch.tools.launch -n 2 -s 1 \\
        python -m mxnet_tpu_torch.tools.dist_worker known dist_async
    python -m mxnet_tpu_torch.tools.launch -n 2 \\
        python -m mxnet_tpu_torch.tools.dist_worker lm --layers 2 ...
    python -m mxnet_tpu_torch.tools.launch -n 3 -e \\
        python -m mxnet_tpu_torch.tools.dist_worker elastic --ckpt-dir D
    python -m mxnet_tpu_torch.tools.launch -n 3 -e \\
        python -m mxnet_tpu_torch.tools.dist_worker elastic_lm --steps 12

- ``known``: every rank pushes rank-determined values and asserts the
  exact aggregates (rank 0 wins at init, dense sums, merged pushes, 2-bit
  compression with error feedback, row_sparse, an optimizer on the
  store), so a lost, duplicated or reordered reduction fails loudly.
- ``lm``: ``transformer_lm`` trained with Adam through
  ``gluon.Trainer(kvstore="dist_sync")``, each rank on its slice of one
  seeded batch; after every step the ranks' weights are checked bitwise
  equal. Rank 0 prints a ``DIST_LM {json}`` line for each rank (times,
  launches, bytes) and,
  with ``--out``, saves the starting weights, step 1's summed gradients
  and the step-1 weights.
- ``elastic``: a linear regression through ``Module.fit`` on an elastic
  ``dist_sync`` store, with checkpoints in a shared directory; it prints
  ``CHAOS_STEP <n>``, ``EPOCH_START <e> parts=<p>``, ``FINAL_LOSS`` and
  ``ELASTIC_TIMES {json}`` for the harness that kills and restarts it
  (``--start-after FILE`` makes a warm standby that joins once FILE
  exists).
- ``elastic_lm``: ``transformer_lm`` traced to a Symbol under
  ``SoftmaxOutput`` and trained by ``Module.fit`` (SGD, lr 1e-5) on an
  elastic ``dist_sync`` store, each rank on its shard of ``--steps``
  batches of one row a rank; with ``MXNET_OBS=1`` the fit's phases ride
  the heartbeats to the server's fleet plane, the last windows on the
  beat that the store's close sends. It prints ``ELASTIC_LM {json}``: its flash
  launches and, per step, the forward+backward device ms from CUDA
  events (wall ms off the card).

``--device cuda`` (the default) puts every array on the card and checks
that it stays there; ``--device cpu`` runs on the host. Exit code 0 means
every check passed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _say(line: str) -> None:
    """One line in one write: the workers share the launcher's stdout,
    and ``print`` may write the text and its newline separately."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def _ctx(mx, device):
    return mx.gpu(0) if device == "cuda" else mx.cpu()


def _on(arr, device):
    if arr._data.device.type != device:
        raise AssertionError(f"array on {arr._data.device}, not {device}")
    return arr.asnumpy()


def run_known(mode: str, device: str) -> None:
    """The known-value checks of ``tests/dist_worker.py``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ndarray.sparse import RowSparseNDArray

    kv = mx.kv.create(mode)
    rank, n = kv.rank, kv.num_workers
    assert n >= 2, f"need >=2 workers, got {n}"
    ctx = _ctx(mx, device)
    shape = (2, 3)

    def arr(v):
        return nd.array(np.asarray(v, np.float32), ctx=ctx)

    # init: rank 0's value wins everywhere
    kv.init("w", arr(np.full(shape, 5.0 + rank)))
    out = nd.zeros(shape, ctx=ctx)
    if mode == "dist_sync":
        kv.pull("w", out=out)
        np.testing.assert_array_equal(_on(out, device), np.full(shape, 5.0))
    else:  # async: any rank's init may win, but all agree on which
        kv.barrier()
        kv.pull("w", out=out)
        first = _on(out, device)
        assert np.all(first == first.flat[0]), first
        kv.barrier()  # nobody pushes before everyone read the init

    # push: the aggregate is the exact cross-worker sum
    kv.push("w", arr(np.full(shape, float(rank + 1))))
    kv.barrier()
    kv.pull("w", out=out)
    expect_sum = n * (n + 1) / 2.0
    if mode == "dist_sync":
        # a push replaces the value with the aggregate
        np.testing.assert_array_equal(_on(out, device),
                                      np.full(shape, expect_sum))
    else:  # the async server accumulates into the stored weight
        np.testing.assert_array_equal(
            _on(out, device), np.full(shape, first.flat[0] + expect_sum))

    if mode == "dist_sync":
        # two pushes before a pull merge
        kv.init("g", nd.zeros(shape, ctx=ctx))
        kv.push("g", arr(np.full(shape, 1.0)))
        kv.push("g", arr(np.full(shape, 10.0)))
        kv.pull("g", out=out)
        np.testing.assert_array_equal(_on(out, device),
                                      np.full(shape, 11.0 * n))
        # 2-bit: packed uint8 gathered, the decoded sum with error feedback
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init("c", nd.zeros(shape, ctx=ctx))
        kv.push("c", arr(np.full(shape, 1.0)))
        kv.barrier()
        kv.pull("c", out=out)
        # each worker's residual 1.0 quantizes to +0.5
        np.testing.assert_array_equal(_on(out, device),
                                      np.full(shape, 0.5 * n))
        # the 0.5 left on every worker drains on a zero push
        kv.push("c", nd.zeros(shape, ctx=ctx))
        kv.barrier()
        kv.pull("c", out=out)
        np.testing.assert_array_equal(_on(out, device),
                                      np.full(shape, 0.5 * n))
        kv.set_gradient_compression({"type": "none"})

    # row_sparse: rows {rank, rank+1} pushed with value rank+1
    vocab, dim = n + 2, 3
    kv.init("emb", nd.zeros((vocab, dim), ctx=ctx))
    kv.barrier()
    dense = np.zeros((vocab, dim), np.float32)
    dense[rank] = rank + 1.0
    dense[rank + 1] = rank + 1.0
    kv.push("emb", RowSparseNDArray.from_dense(arr(dense)))
    kv.barrier()
    sp_out = nd.zeros((vocab, dim), ctx=ctx)
    kv.row_sparse_pull("emb", out=sp_out,
                       row_ids=nd.array(np.arange(vocab).astype(np.int32),
                                        ctx=ctx))
    expect_emb = np.zeros((vocab, dim), np.float32)
    for r in range(n):
        expect_emb[r] += r + 1.0
        expect_emb[r + 1] += r + 1.0
    np.testing.assert_allclose(_on(sp_out, device), expect_emb, rtol=1e-6)
    kv.barrier()

    # an optimizer on the store: w -= lr * sum(grads) on every rank (async:
    # n sequential SGD steps, one a push)
    kv.init("opt_w", arr(np.ones(shape)))
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, rescale_grad=1.0))
    kv.barrier()
    kv.push("opt_w", arr(np.full(shape, float(rank + 1))))
    kv.barrier()
    kv.pull("opt_w", out=out)
    np.testing.assert_allclose(_on(out, device),
                               np.full(shape, 1.0 - 0.1 * expect_sum),
                               rtol=1e-5, atol=1e-6)
    kv.barrier()
    backend = getattr(kv, "backend", None)
    kv.close()
    _say(f"dist_worker rank {rank}/{n} mode={mode} device={device} "
         f"backend={backend}: OK")


def _flat_params(torch, net):
    return torch.cat([p.data().astorch().detach().reshape(-1)
                      for p in net.collect_params().values()])


def _save_params(path, net):
    np.savez(path, **{name: p.data().asnumpy()
                      for name, p in net.collect_params().items()})


def _profile_idle(torch, step):
    """One call of ``step`` under torch.profiler: (wall ms, the share of
    it the card ran no kernel); the share is None without device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if busy_us <= 0:
        return 1e3 * wall, None
    return 1e3 * wall, max(0.0, 1.0 - busy_us / (1e6 * wall))


def run_lm(args) -> None:
    """``transformer_lm`` through ``gluon.Trainer(kvstore="dist_sync")``."""
    import torch
    import torch.distributed as dist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd
    from mxnet_tpu_torch.gluon import block
    from mxnet_tpu_torch.models import transformer_lm
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)

    cuda = args.device == "cuda"
    ctx = _ctx(mx, args.device)
    block._SCOPE.counters = {}
    mx.random.seed(args.seed)
    cfg = dict(vocab_size=args.vocab, units=args.units,
               hidden_size=4 * args.units, num_layers=args.layers,
               num_heads=args.heads, max_length=args.seq)
    net = transformer_lm(**cfg)
    net.initialize(ctx=ctx)
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": args.lr}, kvstore="dist_sync")
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    rank = int(os.environ["DMLC_WORKER_ID"])
    n = int(os.environ["DMLC_NUM_WORKER"])
    tokens = np.random.RandomState(args.seed).randint(
        0, args.vocab, (args.batch * n, args.seq))
    x = nd.array(tokens[rank * args.batch:(rank + 1) * args.batch],
                 ctx=ctx, dtype="int32")
    if rank == 0 and args.out:
        _save_params(args.out + "-start.npz", net)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def fwd_bwd():
        with autograd.record():
            loss = loss_fn(net(x), x)
        loss.backward()
        return loss

    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    fb_ms, ar_ms, up_ms, losses, equal = [], [], [], [], []
    for step in range(args.steps):
        sync()
        t0 = time.perf_counter()
        loss = fwd_bwd()
        sync()
        t1 = time.perf_counter()
        trainer.allreduce_grads()
        sync()
        t2 = time.perf_counter()
        if step == 0 and rank == 0 and args.out:
            np.savez(args.out + "-grads1.npz", **{
                name: p.data().grad.asnumpy()
                for name, p in net.collect_params().items()})
        trainer.update(args.batch)
        sync()
        t3 = time.perf_counter()
        fb_ms.append(1e3 * (t1 - t0))
        ar_ms.append(1e3 * (t2 - t1))
        up_ms.append(1e3 * (t3 - t2))
        losses.append(float(loss.mean().asscalar()))
        # the ranks' weights, bitwise: rank 0's flat copy against each
        flat = _flat_params(torch, net)
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        same = torch.tensor([int(torch.equal(flat, ref))],
                            device=flat.device)
        dist.all_reduce(same, op=dist.ReduceOp.MIN)
        equal.append(bool(same.item()))
        if not equal[-1]:
            raise AssertionError(f"step {step}: the ranks' weights differ")
        if step == 0 and rank == 0 and args.out:
            _save_params(args.out + "-step1.npz", net)
    idle = None
    if cuda and args.profile:
        def step_once():
            fwd_bwd()
            trainer.step(args.batch)
        _wall_ms, idle = _profile_idle(torch, step_once)
    launches = {"flash_attention_fwd": flash_attention_fwd.launches,
                "flash_attention_bwd": flash_attention_bwd.launches}
    grad_bytes = sum(4 * int(np.prod(p.shape))
                     for p in net.collect_params().values()
                     if p.grad_req != "null")
    kv = trainer._kvstore
    report = {"rank": rank, "workers": n, "backend": kv.backend,
              "device": str(x._data.device),
              "steps": args.steps, "losses": losses,
              "weights_equal": equal,
              "step_ms": [a + b + c for a, b, c in zip(fb_ms, ar_ms, up_ms)],
              "fwd_bwd_ms": fb_ms, "allreduce_ms": ar_ms, "update_ms": up_ms,
              "grad_bytes": grad_bytes,
              "allreduce_gb_per_s": [grad_bytes / (1e6 * ms) for ms in ar_ms],
              "idle_share": idle, "kernel_launches": launches}
    if cuda:
        report["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # rank 0 prints every rank's report, one a line (two processes writing
    # one pipe at once would interleave)
    reports = [None] * n
    dist.all_gather_object(reports, report)
    if rank == 0:
        for r in reports:
            _say("DIST_LM " + json.dumps(r))
    kv.close()


def run_elastic(args) -> None:
    """The linear-regression ``Module.fit`` of the reference's elastic
    worker, on an elastic ``dist_sync`` store."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io import NDArrayIter

    if args.start_after:
        # a warm standby: the interpreter and the device are up; it joins
        # the fleet (a fresh member) once the file appears
        mx.nd.zeros((1,), ctx=_ctx(mx, args.device)).asnumpy()
        _say("STANDBY")
        while not os.path.exists(args.start_after):
            time.sleep(0.02)
    t_start = time.perf_counter()
    kv = mx.kv.create("dist_sync")
    rank = kv.rank
    rng = np.random.RandomState(args.seed)
    x = rng.randn(args.samples, 16).astype(np.float32)
    w = rng.randn(16, 1).astype(np.float32)
    y = (x @ w).ravel() + 0.01 * rng.randn(args.samples).astype(np.float32)
    mx.random.seed(args.seed)
    np.random.seed(args.seed)
    ctx = _ctx(mx, args.device)

    data = mx.sym.Variable("data")
    label = mx.sym.Variable("lin_label")
    fc = mx.sym.FullyConnected(data, num_hidden=1, name="fc")
    out = mx.sym.LinearRegressionOutput(fc, label, name="lro")
    mod = mx.mod.Module(out, data_names=("data",),
                        label_names=("lin_label",), context=ctx)
    it = NDArrayIter({"data": x}, {"lin_label": y},
                     batch_size=args.batch_size, shuffle=False,
                     label_name="lin_label")
    state = {"step": 0, "epoch": None, "first_step_s": None}

    def on_batch(param):
        if param.epoch != state["epoch"]:
            state["epoch"] = param.epoch
            _say(f"EPOCH_START {param.epoch} parts={it.num_parts}")
        state["step"] += 1
        if state["first_step_s"] is None:
            state["first_step_s"] = time.perf_counter() - t_start
            grad = mod._exec.grad_dict["fc_weight"]
            if grad._data.device.type != args.device:
                raise AssertionError(f"gradients on {grad._data.device}")
        _say(f"CHAOS_STEP {state['step']}")
        if args.step_delay:
            time.sleep(args.step_delay)

    mod.fit(it, num_epoch=args.epochs, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05,
                              "rescale_grad": 1.0 / args.batch_size},
            eval_metric="mse", checkpoint=args.ckpt_dir, resume="auto",
            checkpoint_period=1, batch_end_callback=on_batch,
            handle_preemption=False)
    full = NDArrayIter({"data": x}, {"lin_label": y},
                       batch_size=args.batch_size, label_name="lin_label")
    loss = dict(mod.score(full, "mse"))["mse"]
    _say(f"FINAL_LOSS {loss:.6f}")
    _say("ELASTIC_TIMES " + json.dumps(
        {"rank": rank, "first_step_s": state["first_step_s"],
         "wall_s": time.perf_counter() - t_start}))
    kv.close()
    _say(f"elastic_worker rank {rank}: OK")


# elastic_lm's fixed run: one row of --seq tokens a rank a step, SGD
ELASTIC_LM_BATCH, ELASTIC_LM_LR, ELASTIC_LM_SEED = 1, 1e-5, 0


def run_elastic_lm(args) -> None:
    """The LM's ``Module.fit`` on an elastic ``dist_sync`` store."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.models.transformer import transformer_lm
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)

    cuda = args.device == "cuda"
    ctx = _ctx(mx, args.device)
    kv = mx.kv.create("dist_sync")  # joins the fleet
    rank, n = kv.rank, kv.num_workers
    batch = ELASTIC_LM_BATCH
    mx.random.seed(ELASTIC_LM_SEED)
    net = transformer_lm(vocab_size=args.vocab, units=args.units,
                         hidden_size=4 * args.units,
                         num_layers=args.layers, num_heads=args.heads,
                         max_length=args.seq)
    net.initialize(ctx=ctx)
    with mx.name.NameManager():
        logits = net(sym.var("data", shape=(batch, args.seq)))
        label = sym.var("softmax_label", shape=(batch, args.seq))
        out = sym.SoftmaxOutput(logits.reshape((-1, args.vocab)),
                                label.reshape((-1,)), name="softmax")
    arg_params = {p.name: p.data() for p in net.collect_params().values()}
    del net
    # every rank holds the whole seeded set; the fit trains its shard
    xs = np.random.RandomState(ELASTIC_LM_SEED + 1).randint(
        0, args.vocab, (args.steps * batch * n, args.seq)).astype(
        np.float32)
    it = NDArrayIter(xs, xs, batch_size=batch)
    mod = Module(out, context=ctx)
    fit_fb = mod.forward_backward
    fb_ms = []

    def timed_fb(batch):
        # the forward+backward's device time (CUDA events) beside the
        # fleet plane's host-side accounting of the same phases
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fit_fb(batch)
            ev[1].record()
            fb_ms.append(ev)
        else:
            t0 = time.perf_counter()
            fit_fb(batch)
            fb_ms.append(1e3 * (time.perf_counter() - t0))

    mod.forward_backward = timed_fb
    flash_attention_fwd.launches = flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, kvstore=kv, eval_metric="ce",
            optimizer="sgd", optimizer_params={"learning_rate": ELASTIC_LM_LR},
            arg_params=arg_params, handle_preemption=False)
    if cuda:
        torch.cuda.synchronize()
        fb_ms = [a.elapsed_time(b) for a, b in fb_ms]
    wall = time.perf_counter() - t0
    _say("ELASTIC_LM " + json.dumps(
        {"rank": rank, "workers": n, "steps": len(fb_ms),
         "device": str(mod._exec._device), "fit_s": wall,
         "fwd_bwd_ms": fb_ms,
         "kernel_launches": {
             "flash_attention_fwd": flash_attention_fwd.launches,
             "flash_attention_bwd": flash_attention_bwd.launches}}))
    kv.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    k = sub.add_parser("known")
    k.add_argument("mode", choices=["dist_sync", "dist_async"])
    k.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    lm = sub.add_parser("lm")
    lm.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    lm.add_argument("--vocab", type=int, default=32000)
    lm.add_argument("--units", type=int, default=768)
    lm.add_argument("--layers", type=int, default=12)
    lm.add_argument("--heads", type=int, default=12)
    lm.add_argument("--seq", type=int, default=2048)
    lm.add_argument("--batch", type=int, default=2, help="rows a worker")
    lm.add_argument("--steps", type=int, default=3)
    lm.add_argument("--lr", type=float, default=1e-4)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--out", default=None,
                    help="path prefix of rank 0's weight and gradient "
                    "files")
    lm.add_argument("--profile", action="store_true",
                    help="profile one more step on the card (idle share)")
    el = sub.add_parser("elastic")
    el.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    el.add_argument("--ckpt-dir", required=True)
    el.add_argument("--epochs", type=int, default=4)
    el.add_argument("--seed", type=int, default=7)
    el.add_argument("--batch-size", type=int, default=8)
    # divisible by batch_size * parts for parts in {1, 2, 3}: every live
    # fleet size cuts to equal whole-batch shards (lockstep reduces)
    el.add_argument("--samples", type=int, default=96)
    el.add_argument("--step-delay", type=float, default=0.0,
                    help="sleep a step, so a restarted worker rejoins a "
                    "fleet that is still training")
    el.add_argument("--start-after", default=None, metavar="FILE",
                    help="start as a warm standby: join the fleet only "
                    "once FILE exists")
    elm = sub.add_parser("elastic_lm")
    elm.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    elm.add_argument("--vocab", type=int, default=32000)
    elm.add_argument("--units", type=int, default=768)
    elm.add_argument("--layers", type=int, default=12)
    elm.add_argument("--heads", type=int, default=12)
    elm.add_argument("--seq", type=int, default=2048)
    elm.add_argument("--steps", type=int, default=12, help="steps a rank")
    args = ap.parse_args(argv)
    if args.what == "known":
        run_known(args.mode, args.device)
    elif args.what == "lm":
        run_lm(args)
    elif args.what == "elastic_lm":
        import mxnet_tpu_torch as mx

        with _ctx(mx, args.device):  # the iterator's batches land there
            run_elastic_lm(args)
    else:
        import mxnet_tpu_torch as mx

        with _ctx(mx, args.device):  # the iterators' batches land there
            run_elastic(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
