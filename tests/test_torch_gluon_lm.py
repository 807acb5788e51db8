"""The Gluon TransformerLM of the port (mxnet_tpu_torch.models.transformer:
MultiHeadAttention, PositionwiseFFN, TransformerEncoderCell, BERTEncoder,
TransformerLM) against the JAX package's, on the CPU: 2 layers, 64 units,
4 heads, S 64, with the reference's weights carried by name.

With ``MXNET_ATTENTION_IMPL=flash`` the reference runs its Pallas kernels
as tests/test_flash_attention.py runs them on the CPU (interpret mode,
``MXNET_FLASH_BWD=pallas`` for the backward) and the port its plain flash
versions. Logits to 1e-5; the loss to rtol 1e-5 and every gradient to
1e-4 of its parameter's largest reference gradient (tests/test_torch_nd_lm
.py's limits); weights after two Adam steps of ``gluon.Trainer`` to 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import transformer as jt
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ndarray.ndarray import invoke
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.serve import DecodeEngine, DecodeScheduler

torch.set_num_threads(1)

SMALL = dict(vocab_size=97, units=64, hidden_size=128, num_layers=2,
             num_heads=4, max_length=64)
BATCH, SEQ = 2, 64


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with tmx.cpu():
        yield


def _nets(seed=0):
    """(reference LM, port LM), the port holding the reference's
    weights, carried by name through Parameter.set_data."""
    jmx.random.seed(seed)
    ref = jt.transformer_lm(**SMALL)
    ref.initialize()
    rng = np.random.RandomState(seed)
    for p in ref.collect_params().values():  # positions are zeros at init
        if p.name.endswith("position_weight"):
            p.set_data(jnd.array(rng.uniform(-0.1, 0.1, p.shape)
                                 .astype(np.float32)))
    port = tt.transformer_lm(**SMALL)
    port.initialize()
    for name, p in ref.collect_params().items():
        port.collect_params()[name].set_data(p.data().asnumpy())
    return ref, port


def _tokens(seed=1):
    return np.random.RandomState(seed).randint(0, SMALL["vocab_size"],
                                               (BATCH, SEQ))


def test_collect_params_names_and_shapes_equal_reference():
    ref = jt.transformer_lm(**SMALL)
    port = tt.transformer_lm(**SMALL)
    want = [(n, tuple(p.shape)) for n, p in ref.collect_params().items()]
    got = [(n, tuple(p.shape)) for n, p in port.collect_params().items()]
    assert got == want and len(got) == 6 + 12 * SMALL["num_layers"]
    assert got[0] == ("transformerlm0_word_embed_weight", (97, 64))
    assert isinstance(port, tmx.gluon.HybridBlock)
    port.initialize()
    pos = port.encoder.position_weight.data().asnumpy()
    assert not pos.any()  # zero-initialized, as the reference's


def test_logits_match_reference():
    ref, port = _nets()
    x = _tokens()
    want = ref(jnd.array(x)).asnumpy()
    got = port(tnd.array(x, dtype="int32")).asnumpy()
    assert got.shape == (BATCH, SEQ, SMALL["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _loss_and_grads(pkg, nd, ag, net, x, monkeypatch=None):
    if monkeypatch is not None:
        monkeypatch.setenv("MXNET_FLASH_BWD", "pallas")
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = nd.array(x, dtype="int32")
    with ag.record():
        loss = loss_fn(net(xs), xs).mean()
    loss.backward()
    if monkeypatch is not None:
        monkeypatch.delenv("MXNET_FLASH_BWD")
    return float(loss.asscalar()), {n: p.grad().asnumpy() for n, p in
                                    net.collect_params().items()}


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid"])
def test_loss_and_gradients_match_reference(hybrid, monkeypatch):
    ref, port = _nets(2)
    if hybrid:
        port.hybridize()
    x = _tokens(3)
    want_loss, want = _loss_and_grads(jmx, jnd, jag, ref, x, monkeypatch)
    before = tfa.flash_attention_fwd.launches
    got_loss, got = _loss_and_grads(tmx, tnd, tag, port, x)
    assert tfa.flash_attention_fwd.launches == before  # CPU: plain version
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for name, g in got.items():
        r = want[name]
        bound = 1e-4 * np.abs(r).max() + 1e-7
        assert np.abs(g - r).max() <= bound, (name, np.abs(g - r).max())


def test_hybridized_equals_plain_bitwise():
    _, plain = _nets(4)
    _, hybrid = _nets(4)
    hybrid.hybridize()
    x = _tokens(5)
    runs = []
    for net in (plain, hybrid):
        calls = invoke.calls
        loss, grads = _loss_and_grads(tmx, tnd, tag, net, x)
        runs.append((loss, grads, invoke.calls - calls))
    assert runs[0][0] == runs[1][0]
    # the second build's names carry the next counter: compare in order
    for a, b in zip(runs[0][1].values(), runs[1][1].values(), strict=True):
        np.testing.assert_array_equal(b, a)
    assert len(hybrid._cached_op._cache) == 1
    # one invoke more: the cached op; its hybridized children run inline
    assert runs[1][2] == runs[0][2] + 1


@pytest.mark.parametrize("hybrid", [False, True], ids=["plain", "hybrid"])
def test_trainer_adam_steps_match_reference(hybrid, monkeypatch):
    """Two ``gluon.Trainer("adam")`` steps of the LM in both packages."""
    ref, port = _nets(6)
    if hybrid:
        port.hybridize()
    x = _tokens(7)
    kw = {"learning_rate": 1e-3}
    losses = []
    for pkg, nd, ag, net, mp in ((jmx, jnd, jag, ref, monkeypatch),
                                 (tmx, tnd, tag, port, None)):
        tr = pkg.gluon.Trainer(net.collect_params(), "adam", kw)
        run = []
        for _ in range(2):
            loss, _ = _loss_and_grads(pkg, nd, ag, net, x, mp)
            tr.step(1)
            run.append(loss)
        losses.append(run)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for name, p in ref.collect_params().items():
        np.testing.assert_allclose(port.collect_params()[name].data()
                                   .asnumpy(), p.data().asnumpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_decode_params_equal_reference():
    ref, port = _nets(8)
    want, got = jt.decode_params(ref), tt.decode_params(port)
    assert tt.decode_config(port) == jt.decode_config(ref)
    for k in ("embed", "pos", "final_g", "final_b", "dec_w", "dec_b"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for lg, lw in zip(got["layers"], want["layers"], strict=True):
        assert set(lg) == set(lw)
        for k in lw:
            np.testing.assert_array_equal(lg[k].numpy(), lw[k], err_msg=k)


def test_gluon_lm_serves_as_the_module_does():
    """DecodeEngine takes the Gluon LM: its greedy stream equals the one
    from the LM that ``from_numpy_params`` builds on the same weights and
    the one from the engine fed the config and parameter dict."""
    _, port = _nets(9)
    cfg, params = tt.decode_config(port), tt.decode_params(port)
    copy = tt.from_numpy_params(cfg, params, device="cpu")
    engine = dict(slots=2, page_size=8, num_pages=20, prompt_buckets=[8, 16],
                  device="cpu")
    streams = []
    for args in ((port,), (copy,), (cfg, params)):
        eng = DecodeEngine(*args, **engine)
        sched = DecodeScheduler(eng, max_new_tokens=6)
        try:
            streams.append([list(sched.generate(np.arange(1, n + 1) % 90
                                                + 1)) for n in (3, 11)])
        finally:
            sched.close()
    assert streams[0] == streams[1] == streams[2]
    assert len(streams[0][0]) == 6


def _oracle_loss_and_grads(lm, x):
    """The plain-tensor oracle of chip_smoke.py: ``lm_prefill`` (the
    training forward with dense attention) on leaf copies of the LM's
    parameters, the mean cross-entropy, ``torch.autograd``. Returns (loss,
    {Parameter.name: gradient})."""
    cfg = tt.decode_config(lm)
    named = tt.gluon_parameters(lm)
    leaves = {k: p.data()._data.detach().clone().requires_grad_()
              for k, p in named.items() if k != "layers"}
    leaves["layers"] = [{k: p.data()._data.detach().clone()
                         .requires_grad_() for k, p in lp.items()}
                        for lp in named["layers"]]
    xt = torch.from_numpy(x)
    logits, _k, _v = tt.lm_prefill(cfg, leaves, xt)
    loss = -torch.log_softmax(logits, -1).gather(-1, xt[..., None]).mean()
    loss.backward()
    grads = {p.name: leaves[k].grad.numpy() for k, p in named.items()
             if k != "layers"}
    for lp, ll in zip(named["layers"], leaves["layers"]):
        grads.update({p.name: ll[k].grad.numpy() for k, p in lp.items()})
    return loss.item(), grads


def test_module_path_equals_gluon_path():
    """The check chip_smoke.py's gluon_path makes at full width: the
    Gluon LM's loss and every gradient equal the plain-tensor oracle's
    (``lm_prefill`` + torch.autograd on leaf tensors) on the same weights
    and batch."""
    _, port = _nets(10)
    x = _tokens(11)
    loss, grads = _loss_and_grads(tmx, tnd, tag, port, x)
    ref_loss, ref_grads = _oracle_loss_and_grads(port, x)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    assert set(grads) == set(ref_grads)
    for name, r in ref_grads.items():
        assert np.abs(grads[name] - r).max() <= 1e-5 * np.abs(r).max(), name


def test_amp_bf16_lm_trains_near_f32():
    """amp.convert_hybrid_block casts the LM to bf16 (LayerNorm stays
    f32); its loss is within 5e-2 of the f32 loss and Adam with
    multi_precision keeps f32 master weights."""
    from mxnet_tpu_torch import amp

    _, f32 = _nets(12)
    _, b16 = _nets(12)
    x = _tokens(13)
    want, _ = _loss_and_grads(tmx, tnd, tag, f32, x)
    amp.init("bfloat16")
    try:
        amp.convert_hybrid_block(b16)
        tr = tmx.gluon.Trainer(b16.collect_params(), "adam",
                               {"learning_rate": 1e-3,
                                "multi_precision": True})
        assert amp.init_trainer(tr) is None
        got, grads = _loss_and_grads(tmx, tnd, tag, b16, x)
        tr.step(1)
    finally:
        amp._TARGET["dtype"] = None
    assert abs(got - want) <= 5e-2
    assert b16.decoder.weight.data()._data.dtype == torch.bfloat16
    assert b16.final_ln.gamma.data()._data.dtype == torch.float32
    state = tr._updaters[0].states[0]
    assert state[-1]._data.dtype == torch.float32  # the master copy


def test_amp_bf16_lm_matches_reference():
    """The reference's AMP policy in both packages: after
    convert_hybrid_block the LayerNorm parameters stay f32, so their
    outputs, and the products that take them, promote to f32; the bf16
    losses agree to 2e-2 (bf16 rounding at other places)."""
    from mxnet_tpu import amp as jamp
    from mxnet_tpu_torch import amp as tamp

    ref, port = _nets(14)
    x = _tokens(15)
    jamp.convert_hybrid_block(ref)
    tamp.convert_hybrid_block(port)
    xs = [jnd.array(x, dtype="int32"), tnd.array(x, dtype="int32")]
    want = ref(xs[0]).asnumpy()
    got = port(xs[1])
    assert got._data.dtype == torch.float32  # the final LN promoted
    np.testing.assert_allclose(got.asnumpy(), want, rtol=2e-2, atol=2e-2)


def test_dropout_raises():
    """Dropout on the LM path is ported: ``transformer_lm(dropout=0.1)``
    no longer raises. On the same weights its predict-mode logits equal
    the dropout-free LM's, and its training-mode logits differ."""
    _ref, port = _nets(16)
    tmx.random.seed(0)
    drop = tt.transformer_lm(dropout=0.1, **SMALL)
    drop.initialize()
    for p, q in zip(port.collect_params().values(),
                    drop.collect_params().values()):
        q.set_data(p.data().asnumpy())
    x = tnd.array(_tokens(17), dtype="int32")
    want = port(x).asnumpy()
    np.testing.assert_array_equal(drop(x).asnumpy(), want)
    with tag.train_mode():
        assert not np.array_equal(drop(x).asnumpy(), want)
