"""The rank program of meshes of several ranks, run under
``tools/launch.py`` (one process per mesh device):

    python -m mxnet_tpu_torch.tools.launch -n 8 \\
        python -m mxnet_tpu_torch.tools.mesh_worker --device cpu \\
        --inputs IN.npz --out DIR ring_sp8 bert_dp2sp2tp2
    python -m mxnet_tpu_torch.tools.launch -n 4 \\
        python -m mxnet_tpu_torch.tools.mesh_worker --out DIR \\
        probe lm_dp2sp2 lm_sp2tp2

Every rank runs the named scenarios in order and writes rank ``r``'s
result of scenario ``s`` to ``DIR/s.r<r>.npz`` (its arrays) and
``DIR/s.r<r>.json`` (the rest). A scenario's inputs are the arrays
``s/<name>`` of ``--inputs`` (the tests write them, with the reference's
initialized parameters under ``s/param/<structural name>``); the
full-width scenarios make theirs from ``--seed``. ``--device cuda`` (the
default) runs on the card, ``--device cpu`` inside ``with mx.cpu():``.

Scenarios:

- ``axes``: ``make_mesh``/``mesh_axes``/``mesh_slices`` over the job's
  ranks, and a mesh larger than the job (``ValueError``);
- ``ring_*``: ``sequence_sharded_attention`` of given q, k, v on an
  ``sp`` mesh (``ring_grad_sp2``: also the gradients of a given
  cotangent);
- ``sgd_dp8``, ``bert_dp2sp2tp2`` and the ``*_dp2`` cases:
  ``ShardedTrainer`` on the nets of ``tests/test_parallel.py`` and
  ``tests/test_op_longtail.py`` (bf16 compute, BatchNorm, a uint8
  preprocess, grad_accum, SyncBatchNorm, remat), from given parameters
  and batches;
- ``probe``: which collectives (point-to-point too) the group takes on
  this device, and one ``DTensor`` redistribution of each kind the
  trainer makes;
- ``lm_dp2sp2``, ``lm_sp2tp2``, ``resnet_dp2``: the full-width
  ``transformer_lm()`` on ``dp2 x sp2`` (f32 step held to one process's,
  bf16 steps, a profiled step, flash launches by causal offset) and on
  ``sp2 x tp2`` under ``bert_sharding_rules()`` (f32 step held, the
  bytes of each rank's shards), and ResNet-50 v1 on ``dp2`` with
  ``BatchNorm`` and with ``SyncBatchNorm`` (f32 step held to one
  process's on the whole batch). Rank 0 computes the one-process step;
- ``serve_mlp_tp2``, ``serve_mlp_tp4``, ``serve_mlp_dp2tp2``: a sharded
  ``InferenceEngine`` (``tests/test_serve_mesh.py``'s MLP and rules) on
  the job's ranks: warmup, every bucket, a chunked request, repeats, a
  two-phase reload and an aval drift; ``serve_lm_tp2``: the LM traced to
  a Symbol outside any mesh scope, served on tp 2 under
  ``bert_sharding_rules()``, beside one process's engine (rank 0). A
  peer rank reports its shards. The replica-group factories
  ``mlp_server`` and ``zoo_server`` (``ReplicaPool.sharded`` takes them
  through ``functools.partial``) live here too.

Exit code 0 means every scenario ran; the checks against the references
are the caller's.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

_SCENARIOS = {}


def scenario(fn):
    _SCENARIOS[fn.__name__[3:]] = fn
    return fn


class _Run:
    """What a scenario sees: the package, the device, its inputs."""

    def __init__(self, name, device, inputs, seed):
        import torch

        import mxnet_tpu_torch as mx

        self.name, self.device, self.seed = name, device, seed
        self.torch, self.mx = torch, mx
        self._inputs = inputs
        self.ctx = mx.gpu(0) if device == "cuda" else mx.cpu()

    def arr(self, key):
        return self._inputs[f"{self.name}/{key}"]

    def params(self):
        pre = f"{self.name}/param/"
        return {k[len(pre):]: self._inputs[k] for k in self._inputs.files
                if k.startswith(pre)}

    def nd(self, a, dtype=None):
        return self.mx.nd.array(a, ctx=self.ctx, dtype=dtype or a.dtype)

    def sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()


def _rank():
    import torch.distributed as dist

    return dist.get_rank()


# ---------------------------------------------------------------------------
# nets shared with the tests (``mx`` is either package)
# ---------------------------------------------------------------------------

def net_mlp(mx, relu=True):
    """tests/test_parallel.py:89 and :284's two Dense layers."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, activation="relu" if relu else None,
                              in_units=8),
            mx.gluon.nn.Dense(4, in_units=16))
    return net


def net_conv_bn(mx, classes=4, use_bias=True, second=True):
    """The conv + BatchNorm nets of tests/test_parallel.py:185 (``second``)
    and :222."""
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, in_channels=3, use_bias=use_bias))
    net.add(nn.BatchNorm())
    net.add(nn.Activation("relu"))
    if second:
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=8,
                          use_bias=use_bias))
        net.add(nn.BatchNorm())
    net.add(nn.Flatten())
    net.add(nn.Dense(classes))
    return net


def net_sync_bn(mx):
    """tests/test_op_longtail.py:561's conv + SyncBatchNorm net."""
    from importlib import import_module

    nn = mx.gluon.nn
    sbn = import_module(mx.__name__ + ".gluon.contrib.nn").SyncBatchNorm
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3))
    net.add(sbn())
    net.add(nn.Activation("relu"))
    net.add(nn.Flatten())
    net.add(nn.Dense(2))
    return net


def net_bert(mx, vocab):
    return mx.models.bert_tiny(vocab_size=vocab, dropout=0.0, max_length=32)


UINT8_MEAN, UINT8_SCALE = 128.0, 64.0

NETS = {"sgd_dp8": lambda mx: net_mlp(mx),
        "bert_dp2sp2tp2": lambda mx: net_bert(mx, 100),
        "bf16_dp2": lambda mx: net_bert(mx, 64),
        "convbn_dp2": lambda mx: net_conv_bn(mx, use_bias=False),
        "uint8_dp2": lambda mx: net_conv_bn(mx, second=False),
        "accum_dp2": lambda mx: net_mlp(mx, relu=False),
        "syncbn_dp2": net_sync_bn,
        "remat_dp2": lambda mx: mx.models.transformer_lm(
            vocab_size=40, units=16, hidden_size=32, num_layers=1,
            num_heads=2, max_length=16, dropout=0.0)}

# (mesh, optimizer, optimizer params, steps, trainer options)
TRAIN_CASES = {
    "sgd_dp8": ({"dp": 8}, "sgd", {"learning_rate": 0.5}, 1, {}),
    "bert_dp2sp2tp2": ({"dp": 2, "sp": 2, "tp": 2}, "adam",
                       {"learning_rate": 1e-3}, 5, {"rules": "bert"}),
    "bf16_dp2": ({"dp": 2}, "adam", {"learning_rate": 1e-3}, 5,
                 {"compute_dtype": "bfloat16"}),
    "convbn_dp2": ({"dp": 2}, "sgd", {"learning_rate": 0.1,
                                      "momentum": 0.9, "wd": 1e-4}, 3, {}),
    "uint8_dp2": ({"dp": 2}, "sgd", {"learning_rate": 0.1}, 5,
                  {"preprocess": "uint8"}),
    "accum_dp2": ({"dp": 2}, "sgd", {"learning_rate": 0.1}, 1,
                  {"grad_accum": 4}),
    "syncbn_dp2": ({"dp": 2}, "sgd", {"learning_rate": 0.1}, 4, {}),
    "remat_dp2": ({"dp": 2}, "adam", {"learning_rate": 1e-2}, 3,
                  {"remat": True}),
}


def _port_net(run, build):
    from mxnet_tpu_torch.gluon.block import _SCOPE
    from mxnet_tpu_torch.gluon.utils import set_params_from_numpy

    _SCOPE.counters = {}
    net = build(run.mx)
    net.initialize(ctx=run.ctx)
    set_params_from_numpy(net, run.params())
    return net


def _structural(trainer):
    """The trainer's values by structural name, whole (every rank takes
    part in the gathers)."""
    by_param = {id(p): n for n, p in trainer._params.items()}
    out = {}
    for k, p in trainer.net._collect_params_with_prefix().items():
        v = trainer.param_vals[by_param[id(p)]]
        v = v.full_tensor() if hasattr(v, "full_tensor") else v
        out["param/" + k] = v.detach().float().cpu().numpy()
    return out


def _preprocess_uint8(torch):
    def pre(x):
        if x.dtype == torch.uint8:
            return (x.float() - UINT8_MEAN) / UINT8_SCALE
        return x
    return pre


def _train_case(run, name):
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.models import bert_sharding_rules

    axes, opt, opt_params, steps, kw = TRAIN_CASES[name]
    kw = dict(kw)
    if kw.pop("rules", None):
        kw["rules"] = bert_sharding_rules()
    if kw.pop("preprocess", None):
        kw["preprocess"] = _preprocess_uint8(run.torch)
    x, y = run.arr("x"), run.arr("y")
    net = _port_net(run, NETS[name])
    mesh = par.make_mesh(axes)
    tr = par.ShardedTrainer(net, run.mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                            mesh, optimizer=opt,
                            optimizer_params=dict(opt_params), **kw)
    losses = [float(tr.step(run.nd(x), run.nd(y)).asnumpy())
              for _ in range(steps)]
    out = {"losses": np.asarray(losses), **_structural(tr)}
    if name == "accum_dp2":  # the same step on the whole batch at once
        net1 = _port_net(run, NETS[name])
        tr1 = par.ShardedTrainer(
            net1, run.mx.gluon.loss.SoftmaxCrossEntropyLoss(), mesh,
            optimizer=opt, optimizer_params=dict(opt_params))
        out["full_loss"] = np.asarray(
            float(tr1.step(run.nd(x), run.nd(y)).asnumpy()))
        out.update({"full/" + k: v for k, v in _structural(tr1).items()})
    if name == "bf16_dp2":  # the first step of one process, same batch
        net1 = _port_net(run, NETS[name])
        tr1 = par.ShardedTrainer(
            net1, run.mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            par.make_mesh({"dp": 1}, devices=[mesh.local_device]),
            optimizer=opt, optimizer_params=dict(opt_params), **kw)
        out["one_process_loss"] = float(
            tr1.step(run.nd(x), run.nd(y)).asnumpy())
    out["dtypes"] = sorted({str(v.dtype) for v in tr.param_vals.values()})
    return out


for _name in TRAIN_CASES:
    _SCENARIOS[_name] = (lambda n: lambda run: _train_case(run, n))(_name)


# ---------------------------------------------------------------------------
# meshes and ring attention
# ---------------------------------------------------------------------------

@scenario
def sc_axes(run):
    from mxnet_tpu_torch import parallel as par

    out = {"world": par.local_device_count()}
    for key, axes in (("dp2tp4", {"dp": 2, "tp": 4}),
                      ("dpm1tp2", {"dp": -1, "tp": 2}),
                      ("sp8", {"sp": 8}), ("dp2sp2tp2",
                                           {"dp": 2, "sp": 2, "tp": 2})):
        m = par.make_mesh(axes)
        out[key] = {"axes": par.mesh_axes(m), "names": list(m.axis_names),
                    "ranks": m.ranks.tolist()}
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = par.make_mesh({"dp": 3})
    out["dp3"] = {"axes": par.mesh_axes(m), "size": m.size,
                  "warned": any("cover 3 of" in str(x.message) for x in w)}
    try:
        par.make_mesh({"dp": 16})
        out["too_large"] = "no error"
    except ValueError as e:
        out["too_large"] = "ValueError: " + str(e)
    m = par.make_mesh({"dp": 2, "sp": 2, "tp": 2})
    out["coordinate"] = [m.axis_index(a) for a in m.axis_names]
    out["slices"] = {}
    for axes, axis in (({"dp": 4, "tp": 2}, "dp"), ({"dp": 8}, "dp"),
                       ({"tp": 8}, "dp"), ({"dp": 2, "sp": 2, "tp": 2},
                                           "sp")):
        m = par.make_mesh(axes)
        out["slices"][f"{axes}/{axis}"] = [
            {"names": list(s.axis_names), "axes": par.mesh_axes(s),
             "ranks": s.ranks.tolist()} for s in par.mesh_slices(m, axis)]
    return out


RING_CASES = {  # mesh, causal values, use_flash values
    "ring_sp8": ({"sp": 8}, (False, True), (None,)),
    "ring_dp2sp2tp2": ({"dp": 2, "sp": 2, "tp": 2}, (False,), (None,)),
    "ring_flash_sp4": ({"dp": 2, "sp": 4}, (False, True), (True, False)),
}


def _ring_case(run, name):
    from mxnet_tpu_torch import parallel as par

    torch = run.torch
    axes, causals, flashes = RING_CASES[name]
    mesh = par.make_mesh(axes)
    dev = mesh.local_device
    q, k, v = (torch.as_tensor(run.arr(t)).to(dev) for t in "qkv")
    out = {}
    for causal in causals:
        for flash in flashes:
            o = par.sequence_sharded_attention(q, k, v, mesh, causal=causal,
                                               use_flash=flash)
            out[f"out/{int(causal)}/{flash}"] = \
                o.full_tensor().cpu().numpy()
    return out


for _name in RING_CASES:
    _SCENARIOS[_name] = (lambda n: lambda run: _ring_case(run, n))(_name)


@scenario
def sc_ring_grad_sp2(run):
    """Gradients through the flash blocks' lse combine across the ring:
    d/d(q, k, v) of sum(out * cot), causal, on ``dp4 x sp2``."""
    from torch.distributed.tensor import DTensor, Replicate

    from mxnet_tpu_torch import parallel as par

    torch = run.torch
    mesh = par.make_mesh({"dp": 4, "sp": 2})
    dm, dev = mesh.device_mesh, mesh.local_device
    leaves = [torch.as_tensor(run.arr(t)).to(dev).requires_grad_()
              for t in "qkv"]
    q, k, v = (DTensor.from_local(t, dm, [Replicate()] * 2, run_check=False)
               for t in leaves)
    cot = DTensor.from_local(torch.as_tensor(run.arr("cot")).to(dev), dm,
                             [Replicate()] * 2, run_check=False)
    o = par.sequence_sharded_attention(q, k, v, mesh, causal=True,
                                       use_flash=True)
    loss = (o * cot).sum().redistribute(dm, [Replicate()] * 2)
    loss.to_local().backward()
    return {"out": o.full_tensor().detach().cpu().numpy(),
            **{f"grad/{t}": x.grad.cpu().numpy()
               for t, x in zip("qkv", leaves)}}


# ---------------------------------------------------------------------------
# the collective probe
# ---------------------------------------------------------------------------

def _probe_collectives(torch, dev):
    """{collective: "ok" or the error} for the default group on ``dev``
    tensors; each is checked against its known result."""
    import torch.distributed as dist
    from torch.distributed.tensor import (DeviceMesh, DTensor, Partial,
                                          Replicate, Shard)

    rank, n = dist.get_rank(), dist.get_world_size()
    nxt, prv = (rank + 1) % n, (rank - 1) % n

    def full(shape, v):
        return torch.full(shape, float(v), device=dev)

    def all_reduce():
        x = full((4,), rank + 1)
        dist.all_reduce(x)
        return bool((x == n * (n + 1) / 2).all())

    def broadcast():
        x = full((4,), rank)
        dist.broadcast(x, 0)
        return bool((x == 0).all())

    def all_gather_into_tensor():
        out = torch.empty(3 * n, device=dev)
        dist.all_gather_into_tensor(out, full((3,), rank))
        return bool((out.view(n, 3)[:, 0].cpu()
                     == torch.arange(n).float()).all())

    def reduce_scatter_tensor():
        x = torch.arange(2 * n, device=dev, dtype=torch.float32)
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return bool((out == n * x[2 * rank:2 * rank + 2]).all())

    def all_to_all_single():
        out = torch.empty(n, device=dev)
        dist.all_to_all_single(out, full((n,), rank))
        return bool((out.cpu() == torch.arange(n).float()).all())

    def send_recv():
        x, y = full((3,), rank), torch.empty(3, device=dev)
        for w in (dist.isend(x, nxt), dist.irecv(y, prv)):
            w.wait()
        return bool((y == prv).all())

    dm = DeviceMesh(dev.type, torch.arange(n))
    base = torch.arange(8 * n * n, dtype=torch.float32,
                        device=dev).view(4 * n, 2 * n)

    def dt_shard_to_replicate():
        t = DTensor.from_local(base.chunk(n)[rank].clone(), dm, [Shard(0)])
        return bool((t.redistribute(dm, [Replicate()]).to_local()
                     == base).all())

    def dt_partial_to_replicate():
        t = DTensor.from_local(base.clone(), dm, [Partial()])
        return bool((t.redistribute(dm, [Replicate()]).to_local()
                     == n * base).all())

    def dt_partial_to_shard():
        t = DTensor.from_local(base.clone(), dm, [Partial()])
        return bool((t.redistribute(dm, [Shard(0)]).to_local()
                     == n * base.chunk(n)[rank]).all())

    def dt_replicate_to_shard():
        t = DTensor.from_local(base.clone(), dm, [Replicate()])
        return bool((t.redistribute(dm, [Shard(1)]).to_local()
                     == base.chunk(n, 1)[rank]).all())

    res = {}
    for fn in (all_reduce, broadcast, all_gather_into_tensor,
               reduce_scatter_tensor, all_to_all_single, send_recv,
               dt_shard_to_replicate, dt_partial_to_replicate,
               dt_partial_to_shard, dt_replicate_to_shard):
        try:
            res[fn.__name__] = "ok" if fn() else "wrong result"
        except Exception as e:  # noqa: BLE001 - the probe reports it
            res[fn.__name__] = f"{type(e).__name__}: " + \
                str(e).splitlines()[0][:200]
        dist.barrier()
    return res


@scenario
def sc_probe(run):
    import torch.distributed as dist

    from mxnet_tpu_torch import parallel as par

    from mxnet_tpu_torch.parallel.ring_attention import exchange_route

    dev = par.make_mesh().local_device
    return {"backend": str(dist.get_backend()), "device": str(dev),
            "ring_route": exchange_route(None, dev),
            "collectives": _probe_collectives(run.torch, dev)}


# ---------------------------------------------------------------------------
# the full-width scenarios
# ---------------------------------------------------------------------------

LM_BATCH, LM_LR = 4, 1e-4       # chip_smoke.py's train_path: 4 x 2048, Adam
LM_BF16_STEPS = 3               # then one profiled
ZOO_BATCH, ZOO_SIZE = 64, 224   # bench.py's ResNet-50 step
GRAD_TOL = 2e-4                 # of each gradient's largest magnitude
# where the step's f64 gradients are taken: each leaf's error against them
# may reach GRAD_F64_K times one process's error at the same leaf
GRAD_F64_K = 3.0
# the same step in f64 on the mesh against one process's, each gradient
# of its largest magnitude
GRAD_F64_STEP_TOL = 1e-6


def _flash():
    from mxnet_tpu_torch.ops import flash_attention as fa

    return fa.flash_attention_fwd, fa.flash_attention_bwd


class _Launches:
    """The flash launches of the mesh path on this rank, by kernel and
    causal offset; launches made while comparing (one process's step)
    stay out."""

    def __init__(self):
        self.counts = {"flash_attention_fwd": {}, "flash_attention_bwd": {}}
        for w in _flash():
            w.launches, w.by_offset = 0, {}

    def __call__(self, fn, *args):
        before = [dict(w.by_offset) for w in _flash()]
        out = fn(*args)
        for w, b in zip(_flash(), before):
            tally = self.counts[w.__name__]
            for off, n in w.by_offset.items():
                key = str(off)
                tally[key] = tally.get(key, 0) + n - b.get(off, 0)
        return out


def _digest(torch, t):
    """A position-weighted integer sum of the bits of ``t``: equal for
    bitwise equal tensors."""
    bits = t.detach().contiguous().view(-1)
    bits = bits.view(torch.int32 if bits.element_size() == 4
                     else torch.int16).long()
    w = torch.arange(bits.numel(), device=bits.device) % 1021 + 1
    return int((bits * w).sum())


def _replicas_equal(run, trainer, mesh):
    """Whether the ranks that hold the same shards (equal coordinates on
    every axis but dp) hold them bitwise equal."""
    import torch.distributed as dist

    mine = (tuple(mesh.axis_index(a) for a in mesh.axis_names
                  if a != "dp"),
            [_digest(run.torch, v.to_local())
             for v in trainer.param_vals.values()])
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    same = [d for c, d in every if c == mine[0]]
    return all(d == same[0] for d in same)


def _host_ms(run, fn, *args):
    run.sync()
    t0 = time.perf_counter()
    out = fn(*args)
    run.sync()
    return out, 1e3 * (time.perf_counter() - t0)


def _profiled(run, fn, *args):
    """One call of ``fn`` under torch.profiler: (wall ms, collective ms on
    the host, this rank's share of the wall with no kernel of its own on
    the card). The collectives are the c10d/gloo events."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if run.device == "cuda" else [])
    with profile(activities=acts) as prof:
        _, wall = _host_ms(run, fn, *args)
    busy = coll = 0.0
    for e in prof.key_averages():
        name = e.key.lower()
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith(
                "CUDA"):
            busy += dev_us / 1e3
        if any(k in name for k in ("c10d", "gloo", "nccl")):
            coll += e.self_cpu_time_total / 1e3
    idle = max(0.0, 1.0 - busy / wall) if busy > 0 else None
    return wall, coll, idle


def _seeded(run, build, sample=None):
    """``build()`` initialized from the seed; a forward of ``sample``
    resolves deferred shapes at once, so that every build draws the same
    weights."""
    from mxnet_tpu_torch.gluon.block import _SCOPE

    _SCOPE.counters = {}
    run.mx.random.seed(run.seed)
    net = build()
    net.initialize(ctx=run.ctx)
    if sample is not None:
        with run.mx.autograd.pause():
            net(sample)
    return net


def _full(v):
    return v.full_tensor() if hasattr(v, "full_tensor") else v


def _weight_tol(opt, lr, grad_err, weight_max):
    """How far one step may move a weight when its gradient differs by
    ``grad_err``: SGD moves it lr times as far; Adam's first update
    lr * m / (sqrt(v) + eps) up to lr * sqrt(1 - beta2) / eps times
    (at g = 0: 316 for lr 1e-4); plus the update's own rounding."""
    if opt == "sgd":
        return 1.01 * lr * grad_err + 1e-6 * weight_max + 1e-12
    return lr * math.sqrt(1 - 0.999) / 1e-8 * grad_err + 1e-2 * lr


def _held(run, tr, tr1, batch, launches, grads64=None):
    """The mesh trainer's first step held to one process's on the same
    global batch from the same weights (rank 0 checks): loss, every
    gradient, and the weights after the update. With ``grads64`` (the
    same step's gradients in f64), each f32 gradient is also measured
    against them, as a share of its largest magnitude, the mesh's and one
    process's at every leaf (``grad_f64_leaves``): ``grad_f64_excess`` is
    the largest over the leaves of the mesh's share over the larger of
    GRAD_TOL and GRAD_F64_K times one process's share at that leaf.
    Returns the metrics."""
    loss, grads, _aux = launches(tr.value_and_grad, *batch)
    grads = {n: _full(g) for n, g in grads.items()}
    out = {}
    if _rank() == 0:
        loss1, grads1, _ = tr1.value_and_grad(*batch)
        out["loss_f32"] = float(_full(loss))
        out["loss_one_process"] = float(loss1)
        out["loss_rel_err"] = abs(out["loss_f32"] - float(loss1)) / \
            abs(float(loss1))
        worst, errs, leaves = (0.0, ""), {}, {}
        for n, g in grads.items():
            want = grads1[n].float()
            errs[n] = float((g.float() - want).abs().max())
            share = errs[n] / max(float(want.abs().max()), 1e-30)
            worst = max(worst, (share, n))
            if grads64 is not None:
                exact = grads64[n]
                top = max(float(exact.abs().max()), 1e-30)
                leaves[n] = [float((g.double() - exact).abs().max()) / top,
                             float((want.double() - exact).abs().max())
                             / top]
        out["grad_worst_of_max"], out["grad_worst_at"] = worst
        if grads64 is not None:
            out["grad_f64_leaves"] = leaves  # [mesh's share, one's]
            out["grad_f64_excess"], out["grad_f64_excess_at"] = max(
                (m / max(GRAD_TOL, GRAD_F64_K * o), n)
                for n, (m, o) in leaves.items())
            for k, i in (("mesh", 0), ("one", 1)):
                out[f"grad_f64_{k}"], out[f"grad_f64_{k}_at"] = max(
                    (v[i], n) for n, v in leaves.items())
        del grads1
    del grads
    launches(tr.step, *batch)
    full = {n: _full(v) for n, v in tr.param_vals.items()}
    if _rank() == 0:
        tr1.step(*batch)
        worst = (0.0, "")
        for n, v in full.items():
            want = tr1.param_vals[n]
            err = float((v.float() - want.float()).abs().max())
            top = max(float(want.abs().max()), 1e-30)
            if n in errs:
                tol = _weight_tol(tr1._opt_name, tr1.learning_rate, errs[n],
                                  top)
            else:  # running statistics: the gradients' gate
                tol = GRAD_TOL * top
            worst = max(worst, (err / tol, n))
        out["step1_worst_of_tolerance"], out["step1_worst_at"] = worst
    return out


def _lm_case(run, axes, rules, bf16):
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.models import bert_sharding_rules, transformer_lm

    mx, torch = run.mx, run.torch
    kw = json.loads(os.environ.get("MXNET_MESH_LM", "{}"))
    batch = LM_BATCH
    mesh = par.make_mesh(axes)
    rules = bert_sharding_rules() if rules else None
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def trainer(mesh_, dtype=None):
        net = _seeded(run, lambda: transformer_lm(**kw))
        return par.ShardedTrainer(net, loss_fn, mesh_, rules=rules,
                                  optimizer="adam",
                                  optimizer_params={"learning_rate": LM_LR},
                                  compute_dtype=dtype)

    launches = _Launches()
    tr = trainer(mesh)
    # the TransformerLM defaults: 2048 positions, 32000 words
    seq, vocab = kw.get("max_length", 2048), kw.get("vocab_size", 32000)
    tokens = np.random.RandomState(run.seed).randint(
        0, vocab, (batch, seq)).astype(np.int32)
    x = run.nd(tokens)
    one = trainer(par.make_mesh({"dp": 1}, devices=[mesh.local_device])) \
        if _rank() == 0 else None
    out = {"axes": par.mesh_axes(mesh), "batch": batch, "seq": seq,
           "vocab": vocab, "device": str(mesh.local_device),
           "coordinate": {a: mesh.axis_index(a) for a in mesh.axis_names}}
    out.update(_held(run, tr, one, (x, x), launches))
    out["replicas_equal"] = [_replicas_equal(run, tr, mesh)]
    del one
    shards = {}
    for n, v in tr.param_vals.items():
        key = next((k for k in ("qkv_weight", "ffn1_weight", "proj_weight",
                                "ffn2_weight", "embed", "decoder_weight")
                    if k in n), None)
        if key is not None:
            loc = v.to_local()
            s_ = shards.setdefault(key, [0, 0])
            s_[0] += loc.numel() * loc.element_size()
            s_[1] += v.numel() * v.element_size()
    out["shard_bytes"] = shards  # [this rank's bytes, the whole tensors']
    if bf16:
        del tr
        if run.device == "cuda":
            torch.cuda.empty_cache()
        tr16 = trainer(mesh, "bfloat16")
        losses, ms = [], []
        for _ in range(LM_BF16_STEPS):
            loss, t = _host_ms(run, launches, tr16.step, x, x)
            losses.append(float(loss.asnumpy()))
            ms.append(t)
            out["replicas_equal"].append(_replicas_equal(run, tr16, mesh))
        wall, coll, idle = _profiled(run, launches, tr16.step, x, x)
        out["replicas_equal"].append(_replicas_equal(run, tr16, mesh))
        out.update({"bf16_losses": losses, "bf16_step_ms": ms,
                    "profiled_step_ms": wall, "collective_ms": coll,
                    "idle_share": idle})
    out["launches"] = launches.counts
    if run.device == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


@scenario
def sc_lm_dp2sp2(run):
    return _lm_case(run, {"dp": 2, "sp": 2}, rules=False, bf16=True)


@scenario
def sc_lm_sp2tp2(run):
    return _lm_case(run, {"sp": 2, "tp": 2}, rules=True, bf16=False)


def _sync_bn_net(net, mx):
    """``net`` with every BatchNorm turned into the SyncBatchNorm layer
    (the same parameters; only the op differs)."""
    from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm
    from mxnet_tpu_torch.gluon.nn import BatchNorm

    def walk(block):
        for child in block._children.values():
            if type(child) is BatchNorm:
                child.__class__ = SyncBatchNorm
                child._num_devices, child._axis_name = None, "dp"
            walk(child)
    walk(net)
    return net


@scenario
def sc_resnet_dp2(run):
    """ResNet-50 v1 on dp2, f32, with BatchNorm and with SyncBatchNorm:
    one SGD step held to one process's on the whole batch."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    mx = run.mx
    batch, size, model = ZOO_BATCH, ZOO_SIZE, "resnet50_v1"
    rng = np.random.RandomState(run.seed)
    x = run.nd(rng.rand(batch, 3, size, size).astype(np.float32))
    y = run.nd(rng.randint(0, 1000, batch).astype(np.int32))
    mesh = par.make_mesh({"dp": 2})
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = {"batch": batch, "size": size, "model": model,
           "device": str(mesh.local_device)}
    for norm in ("BatchNorm", "SyncBatchNorm"):
        def trainer(mesh_):
            net = _seeded(run, lambda: get_model(model, classes=1000),
                          x[:1])
            if norm == "SyncBatchNorm":
                _sync_bn_net(net, mx)
            return par.ShardedTrainer(
                net, loss_fn, mesh_, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4})

        def grads_f64(mesh_):
            # the step's gradients in f64 from the same weights
            tr64 = trainer(mesh_)
            tr64.param_vals = {n: v.double()
                               for n, v in tr64.param_vals.items()}
            _l, g, _a = tr64.value_and_grad(x.astorch().double(), y)
            return {n: _full(v) for n, v in g.items()}

        tr = trainer(mesh)
        one_mesh = par.make_mesh({"dp": 1}, devices=[mesh.local_device])
        one = trainer(one_mesh) if _rank() == 0 else None
        # the step's exact gradients: a BatchNorm net's conv gradients are
        # small differences of large terms, which two f32 sums of the
        # batch in other orders round apart
        grads64 = grads_f64(one_mesh) if _rank() == 0 else None
        launches = _Launches()
        res, ms = _host_ms(run, _held, run, tr, one, (x, y), launches,
                           grads64)
        res["held_ms"] = ms
        res["replicas_equal"] = _replicas_equal(run, tr, mesh)
        del tr, one
        # the mesh's f64 step, where rounding no longer hides a fault of
        # the cross-rank backward, against one process's
        mesh64 = grads_f64(mesh)
        if _rank() == 0:
            res["grad_f64_step_of_max"], res["grad_f64_step_at"] = max(
                (float((g - grads64[n]).abs().max())
                 / max(float(grads64[n].abs().max()), 1e-30), n)
                for n, g in mesh64.items())
        del grads64, mesh64
        out[norm] = res
    if run.device == "cuda":
        out["peak_mem_gb"] = run.torch.cuda.max_memory_allocated() / 1e9
    return out


# ---------------------------------------------------------------------------
# starting a job and reading its results
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# sharded serving: engines on a job's ranks, and replica-group factories
# ---------------------------------------------------------------------------

# the graphs of tests/test_serve_mesh.py:_mlp ("mlp") and of
# tests/test_autoscale.py:_tiny_pool_and_router ("fc"), by input features
SERVE_FEATURES = {"mlp": 32, "fc": 4}


def serve_symbol(sym, kind):
    data = sym.Variable("data")
    if kind == "fc":
        return sym.FullyConnected(data, num_hidden=16, no_bias=True,
                                  name="fc")
    net = sym.FullyConnected(data, num_hidden=64, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=8, name="fc2")
    return sym.softmax(net, name="prob")


def serve_rules(par, kind):
    """The reference tests' rules: fc1 row-parallel and fc2 column-
    parallel (one all-reduce at fc2's output), or the one fc's rows."""
    if kind == "fc":
        return par.ShardingRules([("fc_weight", par.P("tp"))])
    return par.ShardingRules([("fc1_weight|fc1_bias", par.P("tp")),
                              ("fc2_weight", par.P(None, "tp"))])


def mlp_server(kind, params_path, max_batch_size, submesh, warmup=True):
    """A replica group's ``make_server`` (bind the leading arguments with
    ``functools.partial``): ``kind``'s graph with the parameters of the
    ``.npz`` at ``params_path``, sharded by :func:`serve_rules` over
    ``submesh``, every bucket warmed, behind a started ``ServeServer``."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch import symbol as sym

    arg = dict(np.load(params_path))
    eng = serve.InferenceEngine(serve_symbol(sym, kind), arg,
                                max_batch_size=max_batch_size, lint="off",
                                mesh=submesh, rules=serve_rules(par, kind))
    if warmup:
        eng.warmup((SERVE_FEATURES[kind],))
    srv = serve.ServeServer(eng, port=0, max_linger_ms=0.0)
    srv.start()
    return srv


def zoo_server(prefix, epoch, buckets, shape, submesh):
    """A replica group's ``make_server`` for a ``Module`` checkpoint (the
    smoke's ResNet-50): replicated parameters (the empty rule table),
    every bucket warmed, cuDNN's deterministic algorithms, behind a
    started ``ServeServer``."""
    import torch

    from mxnet_tpu_torch import serve

    torch.backends.cudnn.deterministic = True
    eng = serve.load(prefix, epoch=epoch, buckets=buckets, lint="off",
                     mesh=submesh)
    eng.warmup(tuple(shape))
    srv = serve.ServeServer(eng, port=0, max_linger_ms=2.0)
    srv.start()
    return srv


def _peer_report(engine):
    """What a peer rank reports of its engine: the shape of each sharded
    parameter's local piece, its version, the flash launches of this
    process."""
    shards = {n: list(v.to_local().shape)
              for n, v in zip(engine._param_names, engine._params.arg_vals)
              if hasattr(v, "to_local")}
    return {"peer": True, "shards": shards, "version": engine.version,
            "flash_fwd_launches": _flash()[0].launches}


def _engine(report, *args, **kw):
    """``InferenceEngine(*args, **kw)`` on every rank: the leader's engine,
    or None on a peer once its leader closed it (its report in
    ``report``)."""
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.serve.group import PeerExit

    try:
        return serve.InferenceEngine(*args, **kw)
    except PeerExit as e:
        report.update(_peer_report(e.engine))
        return None


def _serve_mlp_case(run, axes):
    """tests/test_serve_mesh.py:117-190 on ``axes``: warmup, every bucket,
    a chunked 19-row request, repeats, the stats, a two-phase reload to
    doubled parameters and an aval drift."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.serve import ServeError

    arg = run.params()
    res = {}
    eng = _engine(res, serve_symbol(sym, "mlp"), arg, max_batch_size=8,
                  lint="off", mesh=par.make_mesh(axes),
                  rules=serve_rules(par, "mlp"))
    if eng is None:
        return res
    res["warmup"] = eng.warmup((32,))
    compiles = len(eng.compile_log)
    for n in range(1, 9):
        res[f"out{n}"] = eng.predict(run.arr(f"x{n}"))
    res["big"] = eng.predict(run.arr("big"))
    res["repeats_bitwise"] = all(
        np.array_equal(eng.predict(run.arr("x5")), res["out5"])
        for _ in range(3))
    st = eng.stats()
    res.update({"mesh": st["mesh"], "mesh_devices": st["mesh_devices"],
                "sharded_params": st["sharded_params"],
                "num_programs": eng.num_programs,
                "buckets": len(eng.buckets),
                "compiles_added": len(eng.compile_log) - compiles})
    arg2 = {k: np.asarray(v) * 2.0 for k, v in arg.items()}
    res["staged"] = eng.prepare_reload(arg2)
    res["version_while_staged"] = eng.version
    res["committed"] = eng.commit_reload()
    res["reloaded"] = eng.predict(run.arr("x3"))
    res["compiles_after_reload"] = len(eng.compile_log) - compiles
    bad = dict(arg2)
    bad["fc1_weight"] = np.zeros((32, 64), np.float32)
    try:
        eng.prepare_reload(bad)
        res["aval_error"] = ""
    except ServeError as e:
        res["aval_error"] = str(e)
    res["leader_shards"] = _peer_report(eng)["shards"]
    eng.close()
    return res


@scenario
def sc_serve_mlp_tp2(run):
    return _serve_mlp_case(run, {"tp": 2})


@scenario
def sc_serve_mlp_tp4(run):
    return _serve_mlp_case(run, {"tp": 4})


@scenario
def sc_serve_mlp_dp2tp2(run):
    return _serve_mlp_case(run, {"dp": 2, "tp": 2})


SERVE_LM_ROWS = 2              # scored at 1 and 2 rows
SERVE_LM_RELOAD_SCALE = 1.05   # the reload's changed weights


@scenario
def sc_serve_lm_tp2(run):
    """The LM traced to a Symbol outside any mesh scope (batch 0), served
    on tp 2 under ``bert_sharding_rules()``: warmup, 1 and 2 rows, a
    repeat, one profiled forward, a reload to weights scaled by
    SERVE_LM_RELOAD_SCALE and an aval drift; then (the leader) one
    process's unsharded engine on the same tokens and weights, before and
    after the same reload. The parameters are the inputs' (by structural
    name, with ``MXNET_MESH_LM`` the LM's kwargs) or drawn from the
    seed (``transformer_lm()`` at its defaults)."""
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.gluon.utils import set_params_from_numpy
    from mxnet_tpu_torch.models import bert_sharding_rules, transformer_lm

    mx = run.mx
    kw = json.loads(os.environ.get("MXNET_MESH_LM", "{}"))
    net = _seeded(run, lambda: transformer_lm(**kw))
    if run._inputs is not None:
        set_params_from_numpy(net, run.params())
    seq, vocab = kw.get("max_length", 2048), kw.get("vocab_size", 32000)
    tokens = np.random.RandomState(run.seed).randint(
        0, vocab, (SERVE_LM_ROWS, seq)).astype(np.float32)
    with mx.name.NameManager():
        logits = net(sym.var("data", shape=(0, seq)))  # 0: any batch
    arg = {p.name: p.data() for p in net.collect_params().values()}
    buckets = tuple(range(1, SERVE_LM_ROWS + 1))
    res = {"seq": seq, "vocab": vocab, "device": str(run.ctx)}
    fwd = _flash()[0]
    fwd.launches = 0
    eng = _engine(res, logits, arg, buckets=buckets, lint="off",
                  mesh=par.make_mesh({"tp": 2}), rules=bert_sharding_rules())
    if eng is None:
        return res
    res["warmup"] = eng.warmup((seq,))
    for n in buckets:
        res[f"out{n}"], ms = _host_ms(run, eng.predict, tokens[:n])
        res[f"ms{n}"] = ms
    top = res[f"out{SERVE_LM_ROWS}"]
    res["repeat_bitwise"] = bool(np.array_equal(
        eng.predict(tokens), top))
    wall, coll, idle = _profiled(run, eng.predict, tokens)
    res.update({"profiled_ms": wall, "collective_ms": coll,
                "idle_share": idle})
    compiles = len(eng.compile_log)
    arg2 = {k: v.asnumpy() * SERVE_LM_RELOAD_SCALE for k, v in arg.items()}
    res["staged"] = eng.prepare_reload(arg2)
    res["committed"] = eng.commit_reload()
    res["reloaded"] = eng.predict(tokens)
    res["compiles_after_reload"] = len(eng.compile_log) - compiles
    bad = dict(arg2)
    name = next(n for n in bad if n.endswith("qkv_weight"))
    bad[name] = bad[name].T.copy()
    try:
        eng.prepare_reload(bad)
        res["aval_error"] = ""
    except serve.ServeError as e:
        res["aval_error"] = str(e)
    res.update({"leader_shards": _peer_report(eng)["shards"],
                "flash_fwd_launches": fwd.launches,
                "num_programs": eng.num_programs,
                "stats_mesh": eng.stats()["mesh"],
                "sharded_params": eng.stats()["sharded_params"],
                "whole_shapes": {n: list(v.shape) for n, v in zip(
                    eng._param_names, eng._params.arg_vals)}})
    eng.close()
    del eng
    one = serve.InferenceEngine(logits, arg, buckets=buckets, lint="off",
                                ctx=run.ctx)
    for n in buckets:
        res[f"one{n}"] = one.predict(tokens[:n])
    one.reload(arg2)
    res["one_reloaded"] = one.predict(tokens)
    pairs = [(f"out{n}", f"one{n}") for n in buckets] + [
        ("reloaded", "one_reloaded")]
    res["err_of_max_logit"] = {
        k: float(np.abs(res[k] - res[o]).max() / np.abs(res[o]).max())
        for k, o in pairs}
    res["reload_moved"] = not np.allclose(res["reloaded"], top)
    if run._inputs is None:  # the full-width logits stay here (GBs)
        for k, o in pairs:
            del res[k], res[o]
    return res


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def start_job(n, scenarios, out_dir, device="cuda", inputs=None, seed=0,
              env=None):
    """Start ``n`` ranks of this program through ``tools/launch.py``, in a
    session of their own; returns the ``Popen`` (its output piped). ``inputs``: a dict of numpy
    arrays, saved beside ``out_dir``."""
    import subprocess

    os.makedirs(out_dir, exist_ok=True)
    args = ["--device", device, "--out", out_dir, "--seed", str(seed)]
    if inputs is not None:
        path = os.path.join(out_dir, "inputs.npz")
        np.savez(path, **inputs)
        args += ["--inputs", path]
    full_env = dict(os.environ)
    for var in ("DMLC_NUM_WORKER", "DMLC_WORKER_ID", "MXNET_COORDINATOR",
                "MXNET_PS_ADDR", "MXNET_PS_PORT", "MXNET_ELASTIC"):
        full_env.pop(var, None)
    full_env["PYTHONPATH"] = _REPO + os.pathsep + full_env.get(
        "PYTHONPATH", "")
    if device == "cpu":
        full_env["OMP_NUM_THREADS"] = "1"
    full_env.update(env or {})
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), sys.executable, "-m", "mxnet_tpu_torch.tools.mesh_worker",
           *args, *scenarios]
    return subprocess.Popen(cmd, cwd=_REPO, env=full_env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


def job_results(proc, n, scenarios, out_dir, timeout):
    """Wait for a job from :func:`start_job`: ``({scenario: [rank 0's
    result, ...]}, its output)``, each result its arrays and its JSON
    fields in one dict. A job that fails or outlasts ``timeout`` seconds
    (then its session is killed) raises ``RuntimeError`` with the tail of
    its output."""
    import subprocess

    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        import signal

        os.killpg(proc.pid, signal.SIGKILL)  # the launcher and its ranks
        log, _ = proc.communicate()
        raise RuntimeError(f"mesh job outlasted {timeout} s:\n"
                           f"{log[-4000:]}")
    if proc.returncode != 0:
        raise RuntimeError(f"mesh job exited {proc.returncode}:\n"
                           f"{log[-4000:]}")
    out = {}
    for s in scenarios:
        ranks = []
        for r in range(n):
            base = os.path.join(out_dir, f"{s}.r{r}")
            res = dict(np.load(base + ".npz"))
            with open(base + ".json") as f:
                res.update(json.load(f))
            ranks.append(res)
        out[s] = ranks
    return out, log


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _save(out_dir, name, rank, res):
    arrays = {k: v for k, v in res.items() if isinstance(v, np.ndarray)}
    rest = {k: v for k, v in res.items() if not isinstance(v, np.ndarray)}
    np.savez(os.path.join(out_dir, f"{name}.r{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"{name}.r{rank}.json"), "w") as f:
        json.dump(rest, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scenarios", nargs="+", choices=sorted(_SCENARIOS))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--inputs", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if args.device == "cpu":
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        raise SystemExit("mesh_worker: --device cuda but CUDA is not "
                         "available")
    from mxnet_tpu_torch.kvstore.dist import join_process_group, launcher_rank

    inputs = np.load(args.inputs) if args.inputs else None
    os.makedirs(args.out, exist_ok=True)
    import mxnet_tpu_torch as mx

    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    with ctx:
        join_process_group(*launcher_rank(), who="mesh_worker")
        rank = _rank()
        for name in args.scenarios:
            run = _Run(name, args.device, inputs, args.seed)
            t0 = time.perf_counter()
            res = _SCENARIOS[name](run)
            res["seconds"] = time.perf_counter() - t0
            _save(args.out, name, rank, res)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
