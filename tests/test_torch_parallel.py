"""The port's ``parallel`` package (``functionalize``, ``make_mesh``,
``ShardingRules``, ``ShardedTrainer`` on Gluon blocks) against the
reference's on a one-device mesh, on the CPU.

Both packages build the same net; the reference's seeded weights are
carried into the port by structural name. In f32 the port must reproduce
the reference's trainer: the first step's loss (the same weights) at rtol
1e-5, parameters (running statistics included) at atol 1e-5 and the later
losses at rtol 1e-4, the tolerances of the reference's own trainer tests
(``tests/test_parallel.py:106, 277``): the loss of a BatchNorm net on a
batch of 4 turns the ~1e-7 rounding differences of the updated
parameters into ~1e-5 relative after two Adam steps (measured on the CPU:
on identical weights the two packages' losses are equal). Under bf16
compute the two
frameworks round at other places: losses at rtol 2e-2. The reference's
own cases (``tests/test_parallel.py:77, 185, 222, 255, 284, 328``) run
through the port beside them, and so do ``bench.py``'s ResNet and BERT
trainer set-ups (at small sizes).
"""
import contextlib
import warnings

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jpar
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd, nd
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.utils import set_params_from_numpy
from mxnet_tpu_torch.models import (bert_sharding_rules, bert_tiny,
                                    transformer_lm)
from mxnet_tpu_torch.parallel import P
from torch.distributed.tensor import Replicate

torch.set_num_threads(1)


@contextlib.contextmanager
def _no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield

TOL = 1e-5
LATER_LOSS_RTOL = 1e-4


def _conv_bn(mx, classes=4, use_bias=True):
    """The reference's conv + BatchNorm regression net (its BatchNorm
    in_channels deferred)."""
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Conv2D(8, 3, padding=1, in_channels=3,
                               use_bias=use_bias))
    net.add(mx.gluon.nn.BatchNorm())
    net.add(mx.gluon.nn.Activation("relu"))
    net.add(mx.gluon.nn.Conv2D(8, 3, padding=1, in_channels=8,
                               use_bias=use_bias))
    net.add(mx.gluon.nn.BatchNorm())
    net.add(mx.gluon.nn.Flatten())
    net.add(mx.gluon.nn.Dense(classes))
    return net


def _pair(build, x, seed=7):
    """(reference net, port net) with the reference's seeded weights in
    both; the reference's forward on ``x`` resolves deferred shapes."""
    jmx.random.seed(seed)
    ref = build(jmx)
    ref.initialize()
    ref(jnd.array(x))
    arrays = {k: p.data().asnumpy()
              for k, p in ref._collect_params_with_prefix().items()}
    with tmx.cpu():
        net = build(tmx)
        net.initialize()
        set_params_from_numpy(net, arrays)
    return ref, net


def _structural(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _run_ref(ref, x, y, steps, **kw):
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    tr = jpar.ShardedTrainer(ref, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             mesh, donate=False, **kw)
    losses = [float(tr.step(jnd.array(x), jnd.array(y)).asnumpy())
              for _ in range(steps)]
    tr.sync_to_net()
    return losses, _structural(ref)


def _run_port(net, x, y, steps, **kw):
    with tmx.cpu():
        mesh = par.make_mesh({"dp": 1})
        tr = par.ShardedTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                mesh, **kw)
        losses = [float(tr.step(nd.array(x), nd.array(y)).asnumpy())
                  for _ in range(steps)]
        tr.sync_to_net()
    return losses, _structural(net), tr


def _structural_vals(tr):
    """The trainer's values by structural name (``Parameter.name``s
    differ between two builds of a net)."""
    by_param = {id(p): n for n, p in tr._params.items()}
    return {k: tr.param_vals[by_param[id(p)]].clone()
            for k, p in tr.net._collect_params_with_prefix().items()}


def _conv_batch(seed=0, n=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, 8, 8).astype(np.float32),
            rng.randint(0, 4, n).astype(np.int32))


def _assert_losses(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)
    np.testing.assert_allclose(got, want, rtol=LATER_LOSS_RTOL)


def _assert_params(got, want, atol=TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# functionalize
# ---------------------------------------------------------------------------

def test_functionalize_batchnorm_aux():
    """The reference's case (tests/test_parallel.py:77), with the outputs
    and aux values held to the reference's."""
    def build(mx):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(4, in_units=3),
                mx.gluon.nn.BatchNorm(in_channels=4))
        return net

    x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    ref, net = _pair(build, x)
    jnames, japply = jpar.functionalize(ref, train=True)
    jout, jaux = japply({p.name: p.data()._data for p in ref._iter_params()},
                        jnd.array(x)._data)
    names, apply = par.functionalize(net, train=True)
    assert len(names) == len(jnames)
    vals = {p.name: p.data()._data.clone().requires_grad_(
        p.grad_req != "null") for p in net._iter_params()}
    out, aux = apply(vals, torch.from_numpy(x))
    assert any("running_mean" in k for k in aux)
    assert any("running_var" in k for k in aux)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=TOL, atol=1e-6)
    ref_aux = {k.split("_", 1)[1]: np.asarray(v) for k, v in jaux.items()}
    got_aux = {k.split("_", 1)[1]: v.numpy() for k, v in aux.items()}
    assert set(got_aux) == set(ref_aux) == {"running_mean", "running_var"}
    for k in ref_aux:
        np.testing.assert_allclose(got_aux[k], ref_aux[k], rtol=TOL,
                                   atol=1e-6)
    # the graph reaches the given tensors, and no NDArray.grad is written
    g = torch.autograd.grad(out.sum(), [vals[n] for n in names
                                        if vals[n].requires_grad])
    assert all(t is not None for t in g)
    assert all(float(p.grad().asnumpy().__abs__().sum()) == 0.0
               for p in net._iter_params() if p.grad_req != "null")
    # the parameters' own tensors are restored
    assert all(p.data()._data is not vals[p.name] for p in net._iter_params())


# ---------------------------------------------------------------------------
# meshes and sharding rules
# ---------------------------------------------------------------------------

def test_make_mesh_one_device():
    with tmx.cpu():
        mesh = par.make_mesh({"dp": 1})
        assert par.mesh_axes(mesh) == {"dp": 1}
        assert mesh.devices.size == 1
        assert mesh.devices.flat[0] == torch.device("cpu")
        assert par.mesh_axes(par.make_mesh({"dp": -1, "tp": 1})) == {
            "dp": 1, "tp": 1}
        assert par.mesh_axes(par.make_mesh()) == {"dp": 1}
        assert par.local_device_count() == 1
        assert par.current_mesh() is None
        with par.mesh_scope(mesh):
            assert par.current_mesh() is mesh
        assert par.current_mesh() is None


@pytest.mark.parametrize("axes", [{"dp": 2}, {"dp": 2, "tp": 4},
                                  {"sp": 8}, {"dp": -1}])
def test_multi_device_mesh_raises_naming_a14(axes):
    """Meshes of several devices (queue item A14) are rank arrays now;
    their DeviceMesh needs a job of that many ranks, and outside one it
    raises, naming the launcher."""
    devices = [torch.device("cpu")] * 8
    with pytest.warns(UserWarning) if -1 not in axes.values() and \
            np.prod(list(axes.values())) < 8 else _no_warning():
        mesh = par.make_mesh(axes, devices=devices)
    want = {a: (8 if v == -1 else v) for a, v in axes.items()}
    assert par.mesh_axes(mesh) == want
    assert mesh.distributed
    with pytest.raises(MXNetError, match="mxnet_tpu_torch.tools.launch"):
        mesh.device_mesh


def test_sharding_rules_prune_to_replicated_on_one_device():
    """The reference's pruning (tests/test_parallel.py:34) on the port's
    meshes: every tp rule collapses, a dp batch spec stays."""
    rules = bert_sharding_rules()
    with tmx.cpu():
        mesh = par.make_mesh({"dp": 1})
    assert rules.spec_for("bert0_enc_layer0_attn_qkv_weight", (192, 64),
                          mesh) == P()
    assert rules.spec_for("x_proj_weight", (64, 64), mesh) == P()
    # without a mesh the spec stays as written, with its trailing None
    assert rules.spec_for("x_qkv_weight", (6, 5)) == P("tp", None)
    assert par.batch_sharding(mesh).spec == P("dp")
    assert par.replicated(mesh).spec == P()
    sh = par.param_sharding(mesh, rules, {"a_ffn1_weight": (8, 4)})
    assert sh["a_ffn1_weight"].spec == P()
    assert sh["a_ffn1_weight"].placements == (Replicate(),)
    # the same names and specs as the reference's table
    jrules = jmx.models.bert_sharding_rules()
    assert [(p.pattern, tuple(s)) for p, s in rules.rules] == \
        [(p.pattern, tuple(s)) for p, s in jrules.rules]


# ---------------------------------------------------------------------------
# ShardedTrainer against the reference's
# ---------------------------------------------------------------------------

# AdamW adds no wd to the gradient, so an element whose gradient is float
# noise moves by about lr * m / sqrt(v) = O(lr) with the noise's sign in
# either package; lr 1e-3 keeps that inside the 1e-5 tolerance.
TRAIN_OPTS = [("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
              ("adam", {"learning_rate": 1e-3}),
              ("adamw", {"learning_rate": 1e-3, "wd": 0.01})]


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("name,params", TRAIN_OPTS,
                         ids=["sgd_mom", "adam", "adamw"])
def test_trainer_matches_reference_conv_bn(name, params, steps):
    """The conv + BatchNorm net, f32: losses, trained parameters and the
    running statistics merged back after each update. Its convolutions
    have no bias, as ResNet's: a bias before BatchNorm has a gradient of
    float noise, which Adam scales to O(lr) steps of the noise's sign."""
    x, y = _conv_batch()
    ref, net = _pair(lambda mx: _conv_bn(mx, use_bias=False), x)
    kw = dict(optimizer=name, optimizer_params=dict(params))
    want_l, want_p = _run_ref(ref, x, y, steps, **kw)
    got_l, got_p, tr = _run_port(net, x, y, steps, **kw)
    _assert_losses(got_l, want_l)
    _assert_params(got_p, want_p)
    with tmx.cpu():
        assert isinstance(tr.step(nd.array(x), nd.array(y)), nd.NDArray)


@pytest.mark.parametrize("name,params", TRAIN_OPTS[1:],
                         ids=["adam", "adamw"])
def test_trainer_matches_reference_bert_tiny(name, params):
    """bert_tiny under bert_sharding_rules: the Gluon BERT through the
    trainer, three f32 steps."""
    x = np.random.RandomState(2).randint(0, 50, (4, 12)).astype(np.int32)

    def build(mx):
        return mx.models.bert_tiny(vocab_size=50, dropout=0.0,
                                   max_length=16)

    ref, net = _pair(build, x)
    kw = dict(optimizer=name, optimizer_params=dict(params))
    want_l, want_p = _run_ref(ref, x, x, 3, rules=jmx.models
                              .bert_sharding_rules(), **kw)
    got_l, got_p, _ = _run_port(net, x, x, 3, rules=bert_sharding_rules(),
                                **kw)
    _assert_losses(got_l, want_l)
    _assert_params(got_p, want_p)


def test_trainer_bf16_conv_bn_matches_reference():
    """AMP on the conv + BN net (tests/test_parallel.py:185): bf16 forward
    and backward, f32 master weights; BatchNorm's scale and shift trained
    (their deferred shapes captured at the first step), its statistics
    kept f32 and moving; the first step's loss (the same weights) within
    bf16 rounding of the reference's. The later ones shrink toward 0 on
    the fixed batch, where the two packages' rounding differs by more
    than a relative 2e-2, so they are held to the reference's own checks:
    finite and falling."""
    x, y = _conv_batch()
    ref, net = _pair(_conv_bn, x)
    kw = dict(optimizer="sgd", compute_dtype="bfloat16",
              optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    want_l, _ = _run_ref(ref, x, y, 5, **kw)
    got_l, _, tr = _run_port(net, x, y, 5, **kw)
    np.testing.assert_allclose(got_l[0], want_l[0], rtol=2e-2)
    assert all(np.isfinite(got_l)) and got_l[-1] < got_l[0]
    gammas = [n for n in tr.param_vals if "gamma" in n]
    rmeans = [n for n in tr.param_vals if "running_mean" in n]
    assert gammas and rmeans
    assert all(g in tr._grad_names for g in gammas)
    for n, v in tr.param_vals.items():
        assert v.dtype == torch.float32, n
    assert all(bool((tr.param_vals[n] != 0).any()) for n in rmeans)


@pytest.mark.parametrize("with_mesh", [True, False],
                         ids=["mesh", "default_mesh"])
def test_trainer_deferred_shapes_captured_at_first_step(with_mesh):
    """A trainer built before the net has run captures at its first step,
    so the deferred BatchNorm and Dense parameters train; without a mesh
    it takes a one-device mesh over the device the net was initialized
    on."""
    with tmx.cpu():
        net = _conv_bn(tmx)
        net.initialize()
        mesh = par.make_mesh({"dp": 1}) if with_mesh else None
        tr = par.ShardedTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                mesh)
        assert tr.device == torch.device("cpu")
        assert not tr.param_vals
        x, y = _conv_batch()
        tr.step(nd.array(x), nd.array(y))
    assert len(tr.param_vals) == len(list(net._iter_params()))
    assert any("dense" in n for n in tr._grad_names)


def test_trainer_preprocess_uint8():
    """preprocess= on raw uint8 batches (tests/test_parallel.py:222):
    deferred shapes resolve through preprocess, f32 labels."""
    mean = torch.full((3, 1, 1), 128.0)

    def preprocess(x):
        if x.dtype == torch.uint8:
            return (x.to(torch.float32) - mean) / 64.0
        return x

    with tmx.cpu():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3), nn.BatchNorm(),
                nn.Activation("relu"), nn.Flatten(), nn.Dense(4))
        net.initialize()
        tr = par.ShardedTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                par.make_mesh({"dp": 1}), optimizer="sgd",
                                optimizer_params={"learning_rate": 0.1},
                                preprocess=preprocess)
        rng = np.random.RandomState(0)
        x = nd.array(rng.randint(0, 255, (8, 3, 8, 8)).astype(np.uint8))
        y = nd.array(rng.randint(0, 4, 8).astype(np.float32))
        losses = [float(tr.step(x, y).asnumpy()) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def _lm(seed, dropout=0.0):
    tmx.random.seed(seed)
    with tmx.cpu():
        net = transformer_lm(vocab_size=40, units=16, hidden_size=32,
                             num_layers=1, num_heads=2, max_length=16,
                             dropout=dropout)
        net.initialize()
    return net


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_trainer_remat_matches_plain(dropout):
    """remat=True trains as the plain step does (tests/test_parallel.py:
    255); with dropout the recompute replays the same masks."""
    x = np.random.RandomState(0).randint(0, 40, (2, 16)).astype(np.int32)
    runs = {}
    for remat in (False, True):
        net = _lm(11, dropout)
        with tmx.cpu():
            tr = par.ShardedTrainer(
                net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                par.make_mesh({"dp": 1}), optimizer="adam",
                optimizer_params={"learning_rate": 1e-2}, remat=remat)
            tmx.random.seed(5)
            runs[remat] = ([float(tr.step(nd.array(x), nd.array(x))
                                  .asnumpy()) for _ in range(3)],
                           _structural_vals(tr))
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-6)
    for k, v in runs[False][1].items():
        torch.testing.assert_close(runs[True][1][k], v, rtol=0, atol=1e-6)
    assert runs[True][0][-1] < runs[True][0][0]


def test_grad_accum_matches_full_batch():
    """grad_accum=4 equals the full-batch step (tests/test_parallel.py:
    284), and the reference's grad_accum step."""
    def build(mx):
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(16, in_units=8))
        net.add(mx.gluon.nn.Dense(4, in_units=16))
        return net

    rng = np.random.RandomState(0)
    x = rng.rand(8, 8).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.int32)
    kw = dict(optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    ref, net1 = _pair(build, x, seed=0)
    _ref4, net4 = _pair(build, x, seed=0)
    want_l, want_p = _run_ref(ref, x, y, 1, grad_accum=4, **kw)
    l1, p1, _ = _run_port(net1, x, y, 1, **kw)
    l4, p4, _ = _run_port(net4, x, y, 1, grad_accum=4, **kw)
    np.testing.assert_allclose(l4, l1, rtol=1e-5)
    np.testing.assert_allclose(l4, want_l, rtol=1e-5)
    _assert_params(p4, p1, atol=1e-6)
    _assert_params(p4, want_p, atol=1e-6)


def test_grad_accum_aux_from_last_micro_batch():
    """Under grad_accum the running statistics merged back are those of
    the last micro-batch, as in the reference."""
    x, y = _conv_batch(n=4)
    ref, net = _pair(_conv_bn, x)
    kw = dict(optimizer="sgd", optimizer_params={"learning_rate": 0.1},
              grad_accum=2)
    want_l, want_p = _run_ref(ref, x, y, 1, **kw)
    got_l, got_p, _ = _run_port(net, x, y, 1, **kw)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL)
    _assert_params(got_p, want_p)


def test_grad_accum_rejects_indivisible_batch():
    with tmx.cpu():
        net = nn.Dense(2, in_units=3)
        net.initialize()
        tr = par.ShardedTrainer(net, tmx.gluon.loss.L2Loss(),
                                par.make_mesh({"dp": 1}), grad_accum=3)
        with pytest.raises(ValueError, match="grad_accum"):
            tr.step(nd.array(np.ones((4, 3), np.float32)),
                    nd.array(np.ones((4, 2), np.float32)))
        with pytest.raises(ValueError, match="grad_accum"):
            par.ShardedTrainer(net, tmx.gluon.loss.L2Loss(), grad_accum=0)
        with pytest.raises(ValueError, match="not in"):
            par.ShardedTrainer(net, tmx.gluon.loss.L2Loss(),
                               optimizer="lamb")


def test_net_changes_only_at_sync_to_net():
    net = _lm(2)
    before = _structural(net)
    with tmx.cpu():
        tr = par.ShardedTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                optimizer="adam",
                                optimizer_params={"learning_rate": 1e-2})
        x = nd.array(np.random.RandomState(12).randint(0, 40, (2, 16))
                     .astype(np.int32))
        for _ in range(2):
            loss = tr.step(x, x)
    assert loss.shape == () and loss.context == tmx.cpu()
    _assert_params(_structural(net), before, atol=0)
    tr.sync_to_net()
    after = _structural(net)
    changed = [k for k in before if not np.array_equal(after[k], before[k])]
    assert len(changed) > len(before) // 2
    for n, p in tr._params.items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      tr.param_vals[n].numpy())
    assert p.data()._data is not tr.param_vals[n]
    assert tr.learning_rate == 1e-2
    tr.set_learning_rate(0.05)
    assert tr.learning_rate == 0.05
    tr.block_until_ready()


# ---------------------------------------------------------------------------
# bench.py's trainer set-ups, the port's imports
# ---------------------------------------------------------------------------

def _resnet_trainer(mx, par, get_model, mesh, compute_dtype=None,
                    preprocess=None, name="resnet50_v1", **net_kw):
    """bench.py::_resnet_trainer, with the model name and its keywords
    made parameters so that a test can run it small."""
    mx.random.seed(0)
    net = get_model(name, classes=1000, **net_kw)
    net.initialize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    return net, loss_fn, par.ShardedTrainer(
        net, loss_fn, mesh, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        compute_dtype=compute_dtype, preprocess=preprocess)


def test_bench_resnet_trainer_matches_reference():
    """bench_resnet's loop (the trainer built before the net has run,
    ``net(x)`` to resolve shapes, then steps) on ResNet-18 v1 thumbnails,
    f32, in both packages: the reference's weights carried into the port
    between ``net(x)`` and the first step."""
    from mxnet_tpu.gluon.model_zoo import get_model as jget
    from mxnet_tpu_torch.gluon.model_zoo import get_model as tget

    rng = np.random.RandomState(0)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 1000, 2).astype(np.int32)
    small = dict(name="resnet18_v1", thumbnail=True)
    jmesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    ref, _, jtr = _resnet_trainer(jmx, jpar, jget, jmesh, **small)
    ref(jnd.array(x))
    want = [float(jtr.step(jnd.array(x), jnd.array(y)).asnumpy())
            for _ in range(2)]
    with tmx.cpu():
        mesh = par.make_mesh({"dp": 1}, devices=[torch.device("cpu")])
        net, _, tr = _resnet_trainer(tmx, par, tget, mesh, **small)
        net(nd.array(x))
        jmx.random.seed(0)
        ref0 = jget("resnet18_v1", classes=1000, thumbnail=True)
        ref0.initialize()
        ref0(jnd.array(x[:1]))
        set_params_from_numpy(net, _structural(ref0))
        got = [float(tr.step(nd.array(x), nd.array(y)).asnumpy())
               for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=TOL)


def test_bench_bert_trainer_runs():
    """bench_bert's set-up (rules, Adam 1e-4, bf16 compute, one-device
    mesh) on bert_tiny: losses finite and falling on the fixed batch,
    master weights f32."""
    with tmx.cpu():
        tmx.random.seed(0)
        vocab, seq, batch = 64, 16, 4
        net = bert_tiny(vocab_size=vocab, max_length=seq, dropout=0.0)
        net.initialize()
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        mesh = par.make_mesh({"dp": 1}, devices=[torch.device("cpu")])
        trainer = par.ShardedTrainer(net, loss_fn, mesh,
                                     rules=bert_sharding_rules(),
                                     optimizer="adam",
                                     optimizer_params={"learning_rate": 1e-3},
                                     compute_dtype="bfloat16")
        rng = np.random.RandomState(0)
        x = nd.array(rng.randint(0, vocab, (batch, seq)).astype(np.int32))
        net(x)
        losses = [float(trainer.step(x, x).asnumpy()) for _ in range(5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert all(v.dtype == torch.float32 for v in trainer.param_vals.values())


def test_trainer_on_hybridized_block_equals_plain():
    """A hybridized block trains through the trainer as the plain one does
    (its cached op runs inside ``functionalize`` and returns BatchNorm's
    statistics as aux outputs): the same losses, parameters and running
    statistics over two steps."""
    x, y = _conv_batch()
    runs = []
    for hybrid in (False, True):
        _ref, net = _pair(lambda mx: _conv_bn(mx, use_bias=False), x)
        if hybrid:
            net.hybridize()
        losses, params, tr = _run_port(
            net, x, y, 2, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        runs.append((losses, params))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    _assert_params(runs[1][1], runs[0][1], atol=1e-6)
    assert net._cached_op is not None and net._cached_op._cache
