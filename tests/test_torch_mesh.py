"""Meshes of several ranks in the port (``parallel/mesh.py``,
``parallel/sharding.py``, ``parallel/train_step.py``) against the JAX
package, on the CPU.

Two jobs of ranks (``tools/launch.py`` running ``tools/mesh_worker.py``,
one process a mesh device, gloo), each module-scoped; every scenario is
its own test. While they run, this process computes the reference's
results on its 8-device CPU mesh from the same numpy inputs; the nets
start from the reference's own initialized parameters, carried by
structural name.

- 8 ranks: ``make_mesh``/``mesh_axes``/``mesh_slices`` equal the
  reference's axes and slice partitions (``tests/test_parallel.py:20``,
  ``tests/test_serve_mesh.py:87``), and a mesh larger than the job raises
  ``ValueError``; ``ShardedTrainer`` SGD on ``dp8`` against the
  reference's and against serial SGD (rtol 1e-4, atol 1e-5,
  ``tests/test_parallel.py:89``); ``bert_tiny`` under
  ``bert_sharding_rules()`` on ``dp2 x sp2 x tp2``, five Adam steps,
  losses within 1e-4 relative of the reference's and falling.
- 2 ranks, ``dp2``: bf16 compute (the first loss, a bf16 mean, within
  one bf16 unit of the port's one-process loss on the same batch, every
  loss within the 2e-2 that two frameworks' bf16 rounding allows, master
  weights f32), the conv +
  BatchNorm net (global batch statistics), uint8 ``preprocess``,
  ``grad_accum`` against the whole batch, ``SyncBatchNorm``
  (``tests/test_op_longtail.py:561``) and ``remat`` on the LM
  (``tests/test_parallel.py:255``): f32 losses within 1e-5 relative
  at the first step and 1e-4 after (``tests/test_torch_parallel.py``'s
  tolerances), parameters and running statistics within 1e-5.

Every rank reports the same losses, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import parallel as jpar
from mxnet_tpu_torch.tools import mesh_worker as W
from test_torch_ring_attention import run_job

torch.set_num_threads(1)

TOL, LATER_LOSS_RTOL = 1e-5, 1e-4
BF16_RTOL = 2e-2


def _batch(name):
    rng = np.random.RandomState(3)
    if name == "sgd_dp8":
        return rng.randn(16, 8).astype(np.float32), \
            rng.randint(0, 4, 16).astype(np.int32)
    if name == "bert_dp2sp2tp2":
        x = np.random.RandomState(0).randint(0, 100, (8, 16)) \
            .astype(np.int32)
        return x, x
    if name == "bf16_dp2":
        x = np.random.RandomState(1).randint(0, 64, (4, 16)).astype(np.int32)
        return x, x
    if name == "convbn_dp2":
        return rng.rand(4, 3, 8, 8).astype(np.float32), \
            rng.randint(0, 4, 4).astype(np.int32)
    if name == "uint8_dp2":
        return rng.randint(0, 255, (8, 3, 8, 8)).astype(np.uint8), \
            rng.randint(0, 4, 8).astype(np.float32)
    if name == "accum_dp2":
        return rng.rand(8, 8).astype(np.float32), \
            rng.randint(0, 4, 8).astype(np.int32)
    if name == "syncbn_dp2":
        rng = np.random.RandomState(17)
        return rng.rand(8, 3, 6, 6).astype(np.float32), \
            rng.randint(0, 2, 8).astype(np.float32)
    if name == "remat_dp2":
        x = np.random.RandomState(0).randint(0, 40, (2, 16)).astype(np.int32)
        return x, x
    raise KeyError(name)


def _ref_net(name, x):
    """The reference's net, seeded and its deferred shapes resolved."""
    jmx.random.seed(7)
    net = W.NETS[name](jmx)
    net.initialize()
    if x.dtype == np.uint8:  # shapes resolve through the preprocess
        x = (x.astype(np.float32) - W.UINT8_MEAN) / W.UINT8_SCALE
    net(jnd.array(x))
    return net


def _ref_train(name, net, x, y, mesh_axes=None, **extra):
    axes, opt, opt_params, steps, kw = W.TRAIN_CASES[name]
    kw = dict(kw, **extra)
    if kw.pop("rules", None):
        kw["rules"] = jmx.models.bert_sharding_rules()
    if kw.pop("preprocess", None):
        mean = jnp.float32(W.UINT8_MEAN)

        def pre(b):
            if b.dtype == jnp.uint8:
                return (b.astype(jnp.float32) - mean) / W.UINT8_SCALE
            return b
        kw["preprocess"] = pre
    axes = mesh_axes or axes
    n = int(np.prod(list(axes.values())))
    mesh = jpar.make_mesh(axes, devices=jax.devices()[:n])
    tr = jpar.ShardedTrainer(net, jmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             mesh, optimizer=opt,
                             optimizer_params=dict(opt_params),
                             donate=False, **kw)
    losses = [float(tr.step(jnd.array(x), jnd.array(y)).asnumpy())
              for _ in range(steps)]
    tr.sync_to_net()
    return losses, {k: p.data().asnumpy()
                    for k, p in net._collect_params_with_prefix().items()}


def _inputs(names):
    inputs, nets = {}, {}
    for name in names:
        x, y = _batch(name)
        net = _ref_net(name, x)
        nets[name] = (net, x, y)
        inputs[f"{name}/x"], inputs[f"{name}/y"] = x, y
        for k, p in net._collect_params_with_prefix().items():
            inputs[f"{name}/param/{k}"] = p.data().asnumpy()
    return inputs, nets


JOB8 = ["axes", "sgd_dp8", "bert_dp2sp2tp2"]
JOB2 = ["bf16_dp2", "convbn_dp2", "uint8_dp2", "accum_dp2", "syncbn_dp2",
        "remat_dp2"]


def _run_job(tmp_path_factory, n, scenarios, references):
    work = str(tmp_path_factory.mktemp(f"mesh{n}"))
    inputs, nets = _inputs([s for s in scenarios if s in W.TRAIN_CASES])
    return run_job(n, scenarios, work, inputs, lambda: references(nets))


def _refs8(nets):
    refs = {}
    net, x, y = nets["sgd_dp8"]
    # serial SGD through autograd, from the same weights
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with jmx.autograd.record():
        loss = loss_fn(net(jnd.array(x)), jnd.array(y)).mean()
    loss.backward()
    lr = W.TRAIN_CASES["sgd_dp8"][2]["learning_rate"]
    refs["sgd_dp8/serial"] = {
        k: p.data().asnumpy() - lr * p.grad().asnumpy()
        for k, p in net._collect_params_with_prefix().items()}
    for name in ("sgd_dp8", "bert_dp2sp2tp2"):
        net, x, y = nets[name]
        refs[name] = _ref_train(name, net, x, y)
    return refs


def _refs2(nets):
    refs = {}
    for name in JOB2:
        net, x, y = nets[name]
        refs[name] = _ref_train(name, net, x, y)
    return refs


@pytest.fixture(scope="module")
def job8(tmp_path_factory):
    return _run_job(tmp_path_factory, 8, JOB8, _refs8)


@pytest.fixture(scope="module")
def job2(tmp_path_factory):
    return _run_job(tmp_path_factory, 2, JOB2, _refs2)


def _same_on_every_rank(results, key="losses"):
    for res in results[1:]:
        np.testing.assert_array_equal(res[key], results[0][key])


def _params(res, prefix="param/"):
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _assert_params(got, want, atol=TOL, rtol=0.0):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _assert_losses(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)
    np.testing.assert_allclose(got, want, rtol=LATER_LOSS_RTOL)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

AXES_CASES = {"dp2tp4": {"dp": 2, "tp": 4}, "dpm1tp2": {"dp": -1, "tp": 2},
              "sp8": {"sp": 8}, "dp2sp2tp2": {"dp": 2, "sp": 2, "tp": 2}}


@pytest.mark.parametrize("key", sorted(AXES_CASES))
def test_make_mesh_matches_reference(job8, key):
    results, _ = job8
    ref = jpar.make_mesh(AXES_CASES[key])
    for res in results["axes"]:
        assert res["world"] == 8
        got = res[key]
        assert got["axes"] == jpar.mesh_axes(ref)
        assert tuple(got["names"]) == tuple(ref.axis_names)
        ids = np.vectorize(lambda d: d.id)(ref.devices)
        assert got["ranks"] == ids.tolist()


def test_make_mesh_subset_and_too_large(job8):
    results, _ = job8
    with pytest.warns(UserWarning, match="cover 3 of"):
        ref = jpar.make_mesh({"dp": 3})
    for res in results["axes"]:
        assert res["dp3"] == {"axes": jpar.mesh_axes(ref), "size": 3,
                              "warned": True}
        assert res["too_large"].startswith("ValueError: mesh axes")
    # the rank coordinates follow the axis order, tp innermost
    coords = [res["coordinate"] for res in results["axes"]]
    assert coords == [list(np.unravel_index(r, (2, 2, 2)))
                      for r in range(8)]


def test_too_large_mesh_raises_outside_a_job():
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import parallel as par

    with tmx.cpu():
        assert par.local_device_count() == 1
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            par.make_mesh({"dp": 2})


SLICE_CASES = [({"dp": 4, "tp": 2}, "dp"), ({"dp": 8}, "dp"),
               ({"tp": 8}, "dp"), ({"dp": 2, "sp": 2, "tp": 2}, "sp")]


@pytest.mark.parametrize("axes,axis", SLICE_CASES,
                         ids=[f"{'x'.join(f'{k}{v}' for k, v in a.items())}"
                              f"-{x}" for a, x in SLICE_CASES])
def test_mesh_slices_match_reference(job8, axes, axis):
    results, _ = job8
    ref = jpar.mesh_slices(jpar.make_mesh(axes), axis)
    want = [{"names": list(s.axis_names), "axes": jpar.mesh_axes(s),
             "ranks": np.vectorize(lambda d: d.id)(s.devices).tolist()}
            for s in ref]
    for res in results["axes"]:
        assert res["slices"][f"{axes}/{axis}"] == want


def test_rule_pruning_on_rank_arrays():
    """tests/test_parallel.py:34 on meshes built without processes, and
    the placements each pruned spec gives."""
    from torch.distributed.tensor import Replicate, Shard

    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.models import bert_sharding_rules
    from mxnet_tpu_torch.parallel import P

    cpu = [torch.device("cpu")] * 8
    rules = bert_sharding_rules()
    jrules = jmx.models.bert_sharding_rules()
    mesh = par.make_mesh({"dp": 2, "tp": 4}, devices=cpu)
    jmesh = jpar.make_mesh({"dp": 2, "tp": 4})
    for name, shape in (("bert0_enc_layer0_attn_qkv_weight", (192, 64)),
                        ("bert0_enc_layer0_attn_proj_weight", (64, 64)),
                        ("x_qkv_weight", (6, 5)),
                        ("bert0_word_embed_weight", (100, 64)),
                        ("bert0_enc_layer0_ffn_ffn2_weight", (64, 128)),
                        ("bert0_enc_layer0_ln1_gamma", (64,))):
        assert tuple(rules.spec_for(name, shape, mesh)) == \
            tuple(jrules.spec_for(name, shape, jmesh)), name
    assert rules.spec_for("bert0_enc_layer0_attn_qkv_weight", (192, 64),
                          mesh) == P("tp")
    assert rules.sharding_for("a_qkv_weight", mesh, (192, 64)).placements \
        == (Replicate(), Shard(0))
    assert rules.sharding_for("a_proj_weight", mesh, (64, 64)).placements \
        == (Replicate(), Shard(1))
    assert par.batch_sharding(mesh, P("dp"), (6, 3)).placements == \
        (Shard(0), Replicate())
    assert par.batch_sharding(mesh, P("dp"), (5, 3)).spec == P()
    dp_mesh = par.make_mesh({"dp": 8}, devices=cpu)
    assert rules.spec_for("bert0_enc_layer0_attn_qkv_weight", (192, 64),
                          dp_mesh) == P()
    both = par.NamedSharding(par.make_mesh({"dp": 2, "sp": 2, "tp": 2},
                                           devices=cpu), P(("dp", "sp")))
    assert both.placements == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="order"):
        par.NamedSharding(both.mesh, P(("sp", "dp"))).placements


# ---------------------------------------------------------------------------
# ShardedTrainer on meshes of several ranks
# ---------------------------------------------------------------------------

def test_sgd_dp8_matches_reference_and_serial(job8):
    results, refs = job8
    res = results["sgd_dp8"]
    _same_on_every_rank(res)
    got = _params(res[0])
    _assert_params(got, refs["sgd_dp8"][1], atol=1e-5, rtol=1e-4)
    _assert_params(got, refs["sgd_dp8/serial"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(res[0]["losses"], refs["sgd_dp8"][0],
                               rtol=TOL)


def test_bert_dp2sp2tp2_matches_reference(job8):
    results, refs = job8
    res = results["bert_dp2sp2tp2"]
    _same_on_every_rank(res)
    got, want = res[0]["losses"], refs["bert_dp2sp2tp2"][0]
    assert len(got) == 5 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("name", [n for n in JOB2 if n != "bf16_dp2"])
def test_dp2_trainer_matches_reference(job2, name):
    results, refs = job2
    res = results[name]
    _same_on_every_rank(res)
    want_l, want_p = refs[name]
    _assert_losses(res[0]["losses"], want_l)
    atol = 1e-6 if name == "accum_dp2" else TOL
    _assert_params(_params(res[0]), want_p, atol=atol)
    if name == "accum_dp2":  # four micro-batches against the whole batch
        np.testing.assert_allclose(res[0]["losses"][0], res[0]["full_loss"],
                                   rtol=TOL)
        _assert_params(_params(res[0]), _params(res[0], "full/param/"),
                       atol=1e-6, rtol=1e-5)
    if name == "syncbn_dp2":
        assert res[0]["losses"][-1] < res[0]["losses"][0]
    if name in ("convbn_dp2", "syncbn_dp2"):
        # the running statistics are the global batch's, not a shard's
        stats = [k for k in want_p if "running" in k]
        assert stats
        for k in stats:
            assert np.abs(_params(res[0])[k] - want_p[k]).max() <= TOL


def test_dp2_bf16_compute(job2):
    results, refs = job2
    res = results["bf16_dp2"]
    _same_on_every_rank(res)
    got, want = res[0]["losses"], refs["bf16_dp2"][0]
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL)
    # the loss is a bf16 mean: summed in another order over two ranks, it
    # may round to the neighbouring bf16 value (2**-7 relative spacing)
    one = res[0]["one_process_loss"]
    assert abs(got[0] - one) <= 2.0 ** -7 * abs(one), (got[0], one)
    assert np.isfinite(got).all() and got[-1] < got[0]
    assert res[0]["dtypes"] == ["torch.float32"]


# ---------------------------------------------------------------------------
# the host-staged process group and the smoke's scenarios, at a small size
# ---------------------------------------------------------------------------

SMALL_LM = '{"units": 32, "hidden_size": 64, "num_layers": 2, ' \
    '"num_heads": 4, "max_length": 32, "vocab_size": 50}'
STAGED = ["probe", "lm_dp2sp2", "lm_sp2tp2"]


@pytest.fixture(scope="module")
def staged_job(tmp_path_factory):
    """4 ranks whose group is ``parallel/host_staged.py``'s ``gloo_host``
    (the group of every gloo job, ranks sharing a card too; here on CPU
    tensors), running the smoke's probe and LM scenarios on a small LM."""
    work = str(tmp_path_factory.mktemp("staged"))
    return run_job(4, STAGED, work, {}, lambda: None,
                   env={"MXNET_MESH_LM": SMALL_LM})[0]


def test_staged_group_probe(staged_job):
    for res in staged_job["probe"]:
        assert res["backend"] == "gloo_host"
        assert res["ring_route"] == "gloo_host"
        assert all(v == "ok" for v in res["collectives"].values()), \
            res["collectives"]


@pytest.mark.parametrize("name", ["lm_dp2sp2", "lm_sp2tp2"])
def test_staged_group_lm_step_held_to_one_process(staged_job, name):
    ranks = staged_job[name]
    r0 = ranks[0]
    assert r0["loss_rel_err"] <= 1e-5
    assert r0["grad_worst_of_max"] <= 2e-4
    assert r0["step1_worst_of_tolerance"] <= 1.0
    assert all(all(res["replicas_equal"]) for res in ranks)
    if name == "lm_sp2tp2":
        for res in ranks:
            for mine, whole in res["shard_bytes"].values():
                assert 2 * mine == whole
    else:
        losses = [res["bf16_losses"] for res in ranks]
        assert all(ls == losses[0] for ls in losses)
        assert abs(losses[0][0] - r0["loss_f32"]) <= 5e-2
