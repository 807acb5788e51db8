"""The port's NMT transformer (``mxnet_tpu_torch/models/seq2seq.py``)
against the JAX package, on the CPU: a small ``Seq2SeqTransformer``
(2 + 2 layers, 32 units, 4 heads) with the reference's weights carried
by name, its forward and gradients (rtol 1e-5 / atol 1e-5, gradients
rtol 1e-4 / atol 1e-6), ``label_smoothing_loss`` values and gradients
with and without ``ignore_index`` (rtol 1e-5), and ``beam_search``,
whose tokens must equal the reference's and whose scores agree to
rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu.gluon.block as jblock
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import seq2seq as jseq
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.models import seq2seq as tseq

torch.set_num_threads(1)

_CFG = dict(src_vocab=50, tgt_vocab=40, units=32, hidden_size=64,
            num_layers=2, num_heads=4, max_length=16, dropout=0.0)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _pair(seed=0, **over):
    """(reference, port) models with the same random weights (every
    parameter, the zero-initialized position tables too)."""
    cfg = dict(_CFG, **over)
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    ref = jseq.Seq2SeqTransformer(**cfg)
    port = tseq.Seq2SeqTransformer(**cfg)
    ref.initialize()
    port.initialize(ctx=tmx.cpu())
    rp, pp = ref.collect_params(), port.collect_params()
    assert list(rp) == list(pp)
    rng = np.random.RandomState(seed)
    for name, p in rp.items():
        v = (rng.randn(*p.shape) * 0.2).astype(np.float32)
        p.set_data(jnd.array(v))
        pp[name].set_data(v)
    return ref, port


def _tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["eager", "hybridized"])
def test_forward_and_grads_match_reference(hybridize):
    ref, port = _pair()
    if hybridize:
        port.hybridize()
    src, tgt = _tokens(1, 3, 7, 50), _tokens(2, 3, 5, 40)
    labels = _tokens(3, 3, 5, 40).astype(np.float32)
    res = []
    for net, mod_nd, ag, loss_fn in ((ref, jnd, jag,
                                      jseq.label_smoothing_loss),
                                     (port, tnd, tag,
                                      tseq.label_smoothing_loss)):
        with ag.record():
            logits = net(mod_nd.array(src), mod_nd.array(tgt))
            loss = loss_fn(logits, mod_nd.array(labels), epsilon=0.1)
        loss.backward()
        res.append((logits.asnumpy(), float(loss.asnumpy()),
                    {k: p.grad().asnumpy()
                     for k, p in net.collect_params().items()}))
    (w_lg, w_loss, w_g), (g_lg, g_loss, g_g) = res
    assert g_lg.shape == (3, 5, 40)
    np.testing.assert_allclose(g_lg, w_lg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-5)
    for k in w_g:
        np.testing.assert_allclose(g_g[k], w_g[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_encode_decode_match_reference():
    ref, port = _pair(seed=4)
    src, tgt = _tokens(5, 2, 9, 50), _tokens(6, 2, 4, 40)
    mem_w = ref.encode(jnd.array(src))
    mem_g = port.encode(tnd.array(src))
    np.testing.assert_allclose(mem_g.asnumpy(), mem_w.asnumpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        port.decode(tnd.array(tgt), mem_g).asnumpy(),
        ref.decode(jnd.array(tgt), mem_w).asnumpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ignore_index", [None, 0, -1],
                         ids=["none", "ignore-0", "ignore-neg"])
@pytest.mark.parametrize("epsilon", [0.0, 0.1])
def test_label_smoothing_loss_values_and_grads(ignore_index, epsilon):
    rng = np.random.RandomState(7)
    logits = (rng.randn(4, 6, 11) * 2).astype(np.float32)
    labels = rng.randint(0, 11, (4, 6)).astype(np.float32)
    labels[0, :3] = 0 if ignore_index != -1 else -1
    res = []
    for mod_nd, ag, fn in ((jnd, jag, jseq.label_smoothing_loss),
                           (tnd, tag, tseq.label_smoothing_loss)):
        lg = mod_nd.array(logits)
        lg.attach_grad()
        with ag.record():
            loss = fn(lg, mod_nd.array(labels), epsilon=epsilon,
                      ignore_index=ignore_index)
        loss.backward()
        res.append((float(loss.asnumpy()), lg.grad.asnumpy()))
    (w, wg), (g, gg) = res
    np.testing.assert_allclose(g, w, rtol=1e-5)
    np.testing.assert_allclose(gg, wg, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("beam_size,alpha", [(1, 0.0), (4, 0.6)])
def test_beam_search_equals_reference(beam_size, alpha):
    ref, port = _pair(seed=8)
    src = _tokens(9, 2, 6, 50)
    want_tok, want_sc = jseq.beam_search(ref, jnd.array(src),
                                         beam_size=beam_size, max_length=6,
                                         alpha=alpha)
    got_tok, got_sc = tseq.beam_search(port, tnd.array(src),
                                       beam_size=beam_size, max_length=6,
                                       alpha=alpha)
    assert got_tok.dtype == want_tok.dtype and got_tok.shape == (2, 6)
    np.testing.assert_array_equal(got_tok, want_tok)
    np.testing.assert_allclose(got_sc, want_sc, rtol=1e-5)
    assert (got_tok[:, 0] == 1).all() and np.isfinite(got_sc).all()
    again_tok, again_sc = tseq.beam_search(port, src, beam_size=beam_size,
                                           max_length=6, alpha=alpha)
    np.testing.assert_array_equal(again_tok, got_tok)
    np.testing.assert_array_equal(again_sc, got_sc)


def test_beam_search_stops_when_every_beam_ended():
    _, port = _pair(seed=10)
    # make eos (2) the only likely token: every beam ends at step 1
    bias = port.out_proj.bias.data().asnumpy()
    bias[2] = 100.0
    port.out_proj.bias.set_data(bias)
    tok, sc = tseq.beam_search(port, _tokens(11, 2, 5, 50), beam_size=2,
                               max_length=6)
    np.testing.assert_array_equal(tok[:, 0], [1, 1])
    assert (tok[:, 1:] == 2).all() and np.isfinite(sc).all()


def test_default_config_is_transformer_base():
    tblock._SCOPE.counters = {}
    net = tseq.Seq2SeqTransformer()
    assert len(net.dec_cells) == 6 and len(net.encoder.cells) == 6
    shapes = {k: p.shape for k, p in net.collect_params().items()}
    assert shapes["seq2seqtransformer0_src_embed_weight"] == (32000, 512)
    assert shapes["seq2seqtransformer0_out_weight"] == (32000, 512)
    assert shapes["seq2seqtransformer0_dec0_ffn_ffn1_weight"] == (2048, 512)
    assert tmx.models.Seq2SeqTransformer is tseq.Seq2SeqTransformer
