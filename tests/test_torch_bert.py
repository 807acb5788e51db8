"""The port's BERT (``BERTModel``, ``bert_tiny``/``bert_base``/
``bert_large``) and dropout on the transformer path, against the JAX
package on the CPU.

``bert_tiny``'s forward, with and without token types, takes the
reference's seeded weights (carried by structural name with
``gluon.utils.set_params_from_numpy``) and must give its logits within
1e-4 (the reference's transformer tolerance, tests/test_transformer.py).
Dropout is held by distribution, since torch's generator and
``jax.random`` give different bits: in training mode each unit of the
layer's output is dropped with probability p (the share within 0.02 over
a few thousand units) and kept ones are the dropout-free output scaled by
1 / (1 - p); in predict mode the output is the dropout-free one.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch.gluon.utils import set_params_from_numpy
from mxnet_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

LOGIT_TOL = 1e-4
TINY = dict(vocab_size=60, max_length=16)


def _tiny_pair(seed=0, **kw):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, TINY["vocab_size"], (2, 12)).astype(np.int32)
    types = rng.randint(0, 2, (2, 12)).astype(np.int32)
    jmx.random.seed(seed)
    ref = jmx.models.bert_tiny(**TINY, **kw)
    ref.initialize()
    arrays = {}
    for k, p in ref._collect_params_with_prefix().items():
        a = p.data().asnumpy()
        if k.endswith("position_weight"):  # zero-initialized: draw them
            a = rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
            p.set_data(jnd.array(a))
        arrays[k] = a
    with tmx.cpu():
        net = tt.bert_tiny(**TINY, **kw)
        net.initialize()
        set_params_from_numpy(net, arrays)
    return ref, net, x, types


@pytest.mark.parametrize("token_types", [False, True])
def test_bert_tiny_forward_matches_reference(token_types):
    ref, net, x, types = _tiny_pair(dropout=0.1)
    extra = [types] if token_types else []
    want = ref(*[jnd.array(a) for a in [x, *extra]]).asnumpy()
    with tmx.cpu():
        got = net(*[nd.array(a) for a in [x, *extra]]).asnumpy()
    assert got.shape == (2, 12, TINY["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_bert_tiny_hybridized_equals_eager():
    _ref, net, x, types = _tiny_pair(seed=1, dropout=0.0)
    with tmx.cpu():
        eager = net(nd.array(x), nd.array(types)).asnumpy()
        net.hybridize()
        hyb = net(nd.array(x), nd.array(types)).asnumpy()
    np.testing.assert_array_equal(hyb, eager)


def test_bert_configs_match_reference():
    """bert_base / bert_large / bert_tiny build the reference's parameter
    set: the same structural names and shapes."""
    for name, kw in (("bert_tiny", {}), ("bert_base", {"vocab_size": 100}),
                     ("bert_large", {"vocab_size": 100})):
        ref = getattr(jmx.models, name)(**kw)
        with tmx.cpu():
            net = getattr(tt, name)(**kw)
        want = {k: tuple(p.shape)
                for k, p in ref._collect_params_with_prefix().items()}
        got = {k: tuple(p.shape)
               for k, p in net._collect_params_with_prefix().items()}
        assert got == want, name


def _ffn_pair(p):
    """A PositionwiseFFN with dropout p and its dropout-free twin (the
    same weights), and an input."""
    with tmx.cpu():
        drop = tt.PositionwiseFFN(16, 32, dropout=p)
        plain = tt.PositionwiseFFN(16, 32, dropout=0.0)
        for blk in (drop, plain):
            blk.initialize()
        set_params_from_numpy(plain, {
            k: q.data().asnumpy()
            for k, q in drop._collect_params_with_prefix().items()})
        x = nd.array(np.random.RandomState(3).randn(4, 50, 16)
                     .astype(np.float32))
    return drop, plain, x


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_by_distribution_in_training(p):
    drop, plain, x = _ffn_pair(p)
    with tmx.cpu():
        want = plain(x).asnumpy()
        tmx.random.seed(0)
        with autograd.train_mode():
            got = drop(x).asnumpy()
    kept = got != 0
    assert abs((~kept).mean() - p) < 0.02, (~kept).mean()
    np.testing.assert_allclose(got[kept], want[kept] / (1 - p), rtol=1e-5,
                               atol=1e-6)


def test_dropout_is_identity_in_predict_mode():
    drop, plain, x = _ffn_pair(0.5)
    with tmx.cpu():
        np.testing.assert_array_equal(drop(x).asnumpy(), plain(x).asnumpy())
    # the whole BERT: its predict-mode forward ignores dropout
    _ref, net, x, types = _tiny_pair(seed=2, dropout=0.1)
    _ref, net0, _x, _t = _tiny_pair(seed=2, dropout=0.0)
    with tmx.cpu():
        np.testing.assert_array_equal(net(nd.array(x)).asnumpy(),
                                      net0(nd.array(x)).asnumpy())
        with autograd.train_mode():
            assert not np.array_equal(net(nd.array(x)).asnumpy(),
                                      net0(nd.array(x)).asnumpy())


@pytest.mark.parametrize("model", ["transformer_lm", "bert_tiny"])
def test_dropout_model_trains(model):
    """TransformerLM(dropout=0.1) (which the port once refused) and
    bert_tiny(dropout=0.1) train through the ShardedTrainer: finite,
    falling losses on a fixed batch."""
    tmx.random.seed(0)
    with tmx.cpu():
        if model == "transformer_lm":
            net = tt.transformer_lm(vocab_size=40, units=32, hidden_size=64,
                                    num_layers=2, num_heads=4,
                                    max_length=16, dropout=0.1)
        else:
            net = tt.bert_tiny(vocab_size=40, max_length=16, dropout=0.1)
        net.initialize()
        tr = par.ShardedTrainer(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                                par.make_mesh({"dp": 1}), optimizer="adam",
                                optimizer_params={"learning_rate": 1e-2})
        x = nd.array(np.random.RandomState(4).randint(0, 40, (4, 16))
                     .astype(np.int32))
        losses = [float(tr.step(x, x).asnumpy()) for _ in range(8)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
