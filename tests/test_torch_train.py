"""The port's training path (mxnet_tpu_torch.parallel.ShardedTrainer,
optimizer, gluon.loss, TransformerLM.forward) against the JAX package, on
the CPU.

Inputs come from numpy seeds and go to both packages; the LM's weights
are the reference's own, carried across with ``from_numpy_params``. In
f32 the port must reproduce the reference: losses at rtol 1e-5,
parameters after the steps at atol 1e-5 (the tolerance of the reference's
own trainer tests, tests/test_parallel.py). Under bf16 compute the two
frameworks round at other places, so losses are held at rtol 2e-2 (about
five bf16 ulps of a loss near ln 64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.optimizer import create as jcreate
from mxnet_tpu.optimizer.fused import lower_update as jlower
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.optimizer import create as tcreate
from mxnet_tpu_torch.optimizer.fused import lower_update as tlower
from mxnet_tpu_torch.parallel import ShardedTrainer

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
             num_heads=4, max_length=32)
SEED = 20261017
TOL = 1e-5


def _ref_net():
    mx.random.seed(SEED)
    net = jt.transformer_lm(dropout=0.0, **SMALL)
    net.initialize()
    net(nd.zeros((1, 8)))  # deferred-init shape inference
    return net


def _batch(seed=0, batch=2):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], (batch, SMALL["max_length"])).astype(np.int32)


def _port_lm(net):
    cfg, params = jt.decode_config(net), jt.decode_params(net)
    return tt.from_numpy_params(cfg, params, device="cpu")


def _flat(params):
    out = {k: np.asarray(v) for k, v in params.items() if k != "layers"}
    for i, lp in enumerate(params["layers"]):
        out.update({f"{i}.{k}": np.asarray(v) for k, v in lp.items()})
    return out


def _ref_run(opt, opt_params, steps, x, **kw):
    net = _ref_net()
    mesh = jpar.make_mesh({"dp": 1}, devices=jax.devices()[:1])
    tr = jpar.ShardedTrainer(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             mesh, optimizer=opt,
                             optimizer_params=dict(opt_params),
                             donate=False, **kw)
    losses = [float(tr.step(x, x).asnumpy()) for _ in range(steps)]
    tr.sync_to_net()
    return losses, _flat(jt.decode_params(net))


def _port_run(opt, opt_params, steps, x, **kw):
    lm = _port_lm(_ref_net())
    tr = ShardedTrainer(lm, SoftmaxCrossEntropyLoss(), optimizer=opt,
                        optimizer_params=dict(opt_params), **kw)
    losses = [float(tr.step(x, x)) for _ in range(steps)]
    tr.sync_to_net()
    return losses, _flat(tt.decode_params(lm)), tr


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_ce_loss_matches_reference(sparse, weighted):
    rng = np.random.RandomState(1)
    pred = rng.randn(3, 5, 7).astype(np.float32)
    if sparse:
        label = rng.randint(0, 7, (3, 5)).astype(np.float32)
    else:
        label = rng.dirichlet(np.ones(7), (3, 5)).astype(np.float32)
    kw = dict(sparse_label=sparse, weight=0.5 if weighted else None)
    sw = rng.rand(3, 1, 1).astype(np.float32) if weighted else None
    ref = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)
    want = ref(nd.array(pred), nd.array(label),
               *([nd.array(sw)] if weighted else [])).asnumpy()
    got = SoftmaxCrossEntropyLoss(**kw)(
        torch.from_numpy(pred), torch.from_numpy(label),
        *([torch.from_numpy(sw)] if weighted else []))
    assert tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_softmax_ce_loss_batch_axis_and_clip():
    rng = np.random.RandomState(2)
    pred = rng.randn(4, 3, 6).astype(np.float32)
    label = np.array([[0, 5, 9], [2, -1, 3], [1, 1, 1], [4, 0, 2]],
                     np.float32)  # out of range: clipped like pick
    kw = dict(batch_axis=1)
    want = mx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(
        nd.array(pred), nd.array(label)).asnumpy()
    got = SoftmaxCrossEntropyLoss(**kw)(torch.from_numpy(pred),
                                        torch.from_numpy(label))
    assert tuple(got.shape) == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPTS = [("sgd", {"learning_rate": 0.1}),
        ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
        ("adam", {"learning_rate": 0.01}),
        ("adamw", {"learning_rate": 0.01})]


def _opt_case(seed=3, n=3):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(4, 5).astype(np.float32), rng.randn(7).astype(np.float32)]
    gs = [[3 * rng.randn(*w.shape).astype(np.float32) for w in ws]
          for _ in range(n)]
    return ws, gs


@pytest.mark.parametrize("name,params", OPTS,
                         ids=["sgd", "sgd_mom", "adam", "adamw"])
def test_lower_update_matches_reference(name, params):
    """Three steps with wd, rescale and clipping, all parameters in one
    multi-tensor call against the reference's per-parameter lowering."""
    kw = dict(params, wd=0.01, clip_gradient=1.0)
    ws, gs = _opt_case()
    jopt, topt = jcreate(name, **kw), tcreate(name, **kw)
    jw = [jnp.asarray(w) for w in ws]
    jst = [jopt.create_state(i, nd.array(w)) for i, w in enumerate(ws)]
    jst = [None if s is None else
           (s._data if not isinstance(s, tuple) else
            tuple(x._data for x in s)) for s in jst]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    tst = [topt.create_state(i, w) for i, w in enumerate(tw)]
    for t, step in enumerate(gs, start=1):
        for i, g in enumerate(step):
            jw[i], jst[i], _ = jlower(jopt, jw[i], jnp.asarray(g), jst[i],
                                      lr=kw["learning_rate"], wd=0.01, t=t,
                                      rescale=0.5)
        tlower(topt, tw, [torch.from_numpy(g) for g in step], tst,
               lr=kw["learning_rate"], wd=0.01, t=t, rescale=0.5)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize("name,params", OPTS,
                         ids=["sgd", "sgd_mom", "adam", "adamw"])
def test_optimizer_update_matches_reference(name, params):
    """Optimizer.update (the per-tensor ops of optimizer_ops) against the
    reference's eager Optimizer.update."""
    kw = dict(params, wd=0.01, clip_gradient=1.0, rescale_grad=0.5)
    ws, gs = _opt_case(seed=4)
    jopt, topt = jcreate(name, **kw), tcreate(name, **kw)
    jw = [nd.array(w) for w in ws]
    jst = [jopt.create_state(i, w) for i, w in enumerate(jw)]
    tw = [torch.from_numpy(w.copy()) for w in ws]
    tst = [topt.create_state(i, w) for i, w in enumerate(tw)]
    for step in gs:
        for i, g in enumerate(step):
            jopt.update(i, jw[i], nd.array(g), jst[i])
            topt.update(i, tw[i], torch.from_numpy(g), tst[i])
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), b.asnumpy(), rtol=0, atol=TOL)


def test_optimizer_registry():
    assert isinstance(tcreate("Adam"), type(tcreate("adam")))
    opt = tcreate("sgd", learning_rate=0.5)
    assert tcreate(opt) is opt and opt.learning_rate == 0.5
    opt.set_learning_rate(0.25)
    assert opt.learning_rate == 0.25
    with pytest.raises(ValueError, match="unknown optimizer"):
        tcreate("lamb")


# ---------------------------------------------------------------------------
# TransformerLM training forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_training_forward_matches_reference(impl, monkeypatch):
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", impl)
    net = _ref_net()
    lm = _port_lm(net)
    x = _batch(5)
    want = net(nd.array(x)).asnumpy()
    before = tfa.flash_attention_fwd.launches
    with torch.no_grad():
        got = lm(torch.from_numpy(x))
        prefill, _k, _v = tt.lm_prefill(tt.decode_config(lm),
                                        tt.decode_params(lm),
                                        torch.from_numpy(x))
    assert tfa.flash_attention_fwd.launches == before  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), prefill.numpy(), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# ShardedTrainer
# ---------------------------------------------------------------------------

# AdamW adds no wd to the gradient, so an element whose gradient is float
# noise moves by about lr * m / sqrt(v) = O(lr) with the noise's sign in
# either package; lr 1e-3 keeps that inside the 1e-5 tolerance.
TRAIN_OPTS = [("adam", {"learning_rate": 1e-2}),
              ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
              ("adamw", {"learning_rate": 1e-3, "wd": 0.01})]


@pytest.mark.parametrize("name,params", TRAIN_OPTS,
                         ids=["adam", "sgd_mom", "adamw"])
def test_trainer_matches_reference(name, params, monkeypatch):
    """Three f32 steps of the small LM, flash attention in both packages
    (the reference's interpreted Pallas forward and blocked backward, the
    port's plain versions)."""
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    x = _batch(6)
    want_l, want_p = _ref_run(name, params, 3, x)
    got_l, got_p, _ = _port_run(name, params, 3, x)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL)
    assert got_l[-1] < got_l[0]
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_trainer_grad_clip_matches_reference(monkeypatch):
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    x = _batch(7)
    opt = ("adam", {"learning_rate": 1e-2})
    want_l, want_p = _ref_run(*opt, 3, x, grad_clip=1e-3)
    got_l, got_p, _ = _port_run(*opt, 3, x, grad_clip=1e-3)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_trainer_bf16_matches_reference(monkeypatch):
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    x = _batch(8)
    opt = ("adam", {"learning_rate": 1e-2})
    want_l, _ = _ref_run(*opt, 3, x, compute_dtype="bfloat16")
    got_l, got_p, tr = _port_run(*opt, 3, x, compute_dtype="bfloat16")
    np.testing.assert_allclose(got_l, want_l, rtol=2e-2)
    assert got_l[-1] < got_l[0]
    # master weights and optimizer state stay f32
    assert all(v.dtype == torch.float32 for v in tr.param_vals.values())
    assert all(s.dtype == torch.float32 for st in tr.opt_state.values()
               for s in st)
    assert all(np.isfinite(v).all() for v in got_p.values())


@pytest.mark.parametrize("variant", [{"grad_accum": 2}, {"remat": True}],
                         ids=["grad_accum", "remat"])
def test_trainer_variants_match_plain_step(variant, monkeypatch):
    """grad_accum (micro-batches, averaged grads, one update) and remat
    (checkpointed forward) train as the plain step does."""
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    x = _batch(9, batch=4)
    opt = ("adam", {"learning_rate": 1e-2})
    base_l, base_p, _ = _port_run(*opt, 3, x)
    got_l, got_p, _ = _port_run(*opt, 3, x, **variant)
    np.testing.assert_allclose(got_l, base_l, rtol=TOL)
    for k in base_p:
        np.testing.assert_allclose(got_p[k], base_p[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_grad_accum_matches_reference(monkeypatch):
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    x = _batch(10, batch=4)
    opt = ("adam", {"learning_rate": 1e-2})
    want_l, want_p = _ref_run(*opt, 2, x, grad_accum=2)
    got_l, got_p, _ = _port_run(*opt, 2, x, grad_accum=2)
    np.testing.assert_allclose(got_l, want_l, rtol=TOL)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=TOL,
                                   err_msg=k)


def test_grad_accum_rejects_indivisible_batch():
    lm = tt.transformer_lm(device="cpu", seed=1, **SMALL)
    tr = ShardedTrainer(lm, SoftmaxCrossEntropyLoss(), grad_accum=3)
    with pytest.raises(ValueError, match="does not divide"):
        tr.step(_batch(11, batch=4), _batch(11, batch=4))


def test_net_changes_only_at_sync_to_net():
    lm = tt.transformer_lm(device="cpu", seed=2, **SMALL)
    before = {n: p.detach().clone() for n, p in lm.named_parameters()}
    tr = ShardedTrainer(lm, SoftmaxCrossEntropyLoss(), optimizer="adam",
                        optimizer_params={"learning_rate": 1e-2})
    x = _batch(12)
    for _ in range(2):
        loss = tr.step(x, x)
    assert loss.dim() == 0 and loss.device.type == "cpu"
    for n, p in lm.named_parameters():
        torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)
    tr.sync_to_net()
    changed = [n for n, p in lm.named_parameters()
               if not torch.equal(p.detach(), before[n])]
    assert "embed" in changed and len(changed) > len(before) // 2
    for n, p in lm.named_parameters():
        torch.testing.assert_close(p.detach(), tr.param_vals[n], rtol=0,
                                   atol=0)


def test_preprocess_runs_on_inputs_only():
    vocab = SMALL["vocab_size"]
    x = _batch(13)
    runs = []
    for pre, data in ((None, x), (lambda t: t % vocab, x + vocab)):
        lm = tt.transformer_lm(device="cpu", seed=3, **SMALL)
        tr = ShardedTrainer(lm, SoftmaxCrossEntropyLoss(), preprocess=pre,
                            optimizer_params={"learning_rate": 0.1})
        runs.append([float(tr.step(data, x)) for _ in range(2)])
    np.testing.assert_allclose(runs[1], runs[0], rtol=0, atol=0)


def test_trainer_settings_and_rejections():
    lm = tt.transformer_lm(device="cpu", seed=4, **SMALL)
    loss = SoftmaxCrossEntropyLoss()
    tr = ShardedTrainer(lm, loss, optimizer_params={"lr": 0.3})
    assert tr.learning_rate == 0.3
    tr.set_learning_rate(0.05)
    assert tr.learning_rate == 0.05
    tr.block_until_ready()
    with pytest.raises(ValueError, match="not in"):
        ShardedTrainer(lm, loss, optimizer="lamb")
    with pytest.raises(MXNetError, match="mesh must be None"):
        ShardedTrainer(lm, loss, jpar.make_mesh({"dp": 1},
                                                devices=jax.devices()[:1]))
    with pytest.raises(MXNetError, match="input_specs must be None"):
        ShardedTrainer(lm, loss, input_specs=("dp",))
    with pytest.raises(ValueError, match="grad_accum"):
        ShardedTrainer(lm, loss, grad_accum=0)


def test_value_and_grad_matches_autograd():
    """The step's gradients are those of the loss of the net's forward."""
    lm = tt.transformer_lm(device="cpu", seed=5, **SMALL)
    x = torch.from_numpy(_batch(14)).long()
    loss_fn = SoftmaxCrossEntropyLoss()
    tr = ShardedTrainer(lm, loss_fn)
    loss, grads = tr.value_and_grad(x, x)
    want = loss_fn(lm(x), x).mean()
    want.backward()
    assert abs(float(loss) - float(want.detach())) < 1e-6
    for n, p in lm.named_parameters():
        torch.testing.assert_close(grads[n], p.grad, rtol=1e-5, atol=1e-6)
