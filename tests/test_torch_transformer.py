"""TransformerLM decode interface: the port (mxnet_tpu_torch) against the
JAX package, with the reference's own initialized weights carried across
(``from_numpy_params``). Tolerance 1e-4, that of
tests/test_decode.py::test_prefill_matches_training_forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import transformer as jt
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.models import transformer as tt

# tiny shapes need no intra-op threads; the suite runs test files in
# parallel workers beside timing-sensitive tests
torch.set_num_threads(1)

TOL = 1e-4
SMALL = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
             num_heads=4, max_length=64)


@pytest.fixture(scope="module")
def ref_lm():
    mx.random.seed(20261016)
    model = jt.transformer_lm(dropout=0.0, **SMALL)
    model.initialize()
    model(nd.zeros((1, 8)))  # deferred-init shape inference
    return model


@pytest.fixture(scope="module")
def carried(ref_lm):
    cfg, params = jt.decode_config(ref_lm), jt.decode_params(ref_lm)
    return cfg, params, tt.from_numpy_params(cfg, params, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_from_numpy_params_roundtrip(carried):
    cfg, params, lm = carried
    assert tt.decode_config(lm) == cfg
    back = tt.decode_params(lm)
    for k in ("embed", "pos", "final_g", "final_b", "dec_w", "dec_b"):
        np.testing.assert_array_equal(back[k].numpy(), params[k])
    for mine, ref in zip(back["layers"], params["layers"], strict=True):
        assert set(mine) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(mine[k].numpy(), ref[k])


def test_lm_prefill_matches_jax(carried):
    cfg, params, lm = carried
    toks = np.random.RandomState(0).randint(1, 97, size=(2, 12))
    logits, k, v = jt.lm_prefill(cfg, params, toks.astype(np.int32))
    with torch.no_grad():
        tl, tk, tv = tt.lm_prefill(cfg, tt.decode_params(lm),
                                   torch.from_numpy(toks))
    assert tuple(tk.shape) == (2, 2, 12, 4, 8)  # (L, B, S, H, D)
    for got, want in ((tl, logits), (tk, k), (tv, v)):
        _close(got.numpy(), want)


def test_lm_decode_step_matches_jax(carried):
    cfg, params, lm = carried
    rng = np.random.RandomState(1)
    b, cap = 3, 16
    L, H, D = cfg["layers"], cfg["heads"], cfg["head_dim"]
    k0 = rng.randn(L, b, cap, H, D).astype(np.float32)
    v0 = rng.randn(L, b, cap, H, D).astype(np.float32)
    toks = rng.randint(1, 97, size=(b,)).astype(np.int32)
    pos = np.array([0, 5, 15], np.int32)
    logits, (k1, v1) = jt.lm_decode_step(
        cfg, params, toks, (jnp.asarray(k0), jnp.asarray(v0)), pos)
    tk, tv = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    with torch.no_grad():
        tl, (tk1, tv1) = tt.lm_decode_step(cfg, tt.decode_params(lm),
                                           torch.from_numpy(toks), (tk, tv),
                                           torch.from_numpy(pos))
    assert tk1 is tk and tv1 is tv  # updated in place
    _close(tl.numpy(), logits)
    _close(tk1.numpy(), k1)
    _close(tv1.numpy(), v1)


def test_forward_matches_gluon_forward(ref_lm, carried):
    _cfg, _params, lm = carried
    toks = np.random.RandomState(2).randint(1, 97, size=(2, 8))
    want = ref_lm(nd.array(toks)).asnumpy()
    with tmx.cpu():
        got = lm(tnd.array(toks)).asnumpy()
    _close(got, want)


def test_sample_token_greedy_and_temperature():
    logits = np.asarray([[0.1, 3.0, -1.0], [5.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jt.sample_token(logits, jax.random.PRNGKey(0), 0.0))
    got = tt.sample_token(torch.from_numpy(logits), None, 0.0)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist() == [1, 0]
    # per-row temperature: row 0 greedy, row 1 drawn (valid + reproducible)
    t = torch.tensor([0.0, 1.0])

    def draw(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return tt.sample_token(torch.from_numpy(logits), gen, t).tolist()

    a, b = draw(7), draw(7)
    assert a == b and a[0] == 1 and 0 <= a[1] < 3


def test_sample_token_distribution():
    """Temperature draws follow softmax(logits / t): compared with the
    reference by distribution, since torch and jax.random differ in bits."""
    n = 4000
    logits = np.tile(np.asarray([[1.0, 0.0, -1.0]], np.float32), (n, 1))
    gen = torch.Generator()
    gen.manual_seed(0)
    ours = tt.sample_token(torch.from_numpy(logits), gen, 2.0).numpy()
    theirs = np.asarray(jt.sample_token(logits, jax.random.PRNGKey(0), 2.0))
    want = np.exp(logits[0] / 2.0) / np.exp(logits[0] / 2.0).sum()
    for drawn in (ours, theirs):
        freq = np.bincount(drawn, minlength=3) / n
        np.testing.assert_allclose(freq, want, atol=0.03)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tt.transformer_lm(**SMALL).initialize()
    from mxnet_tpu_torch.context import default_device
    with pytest.raises(MXNetError):
        default_device()
    cfg = {"vocab": 97, "units": 32, "heads": 4, "head_dim": 8,
           "layers": 2, "max_length": 64}
    params = _random_params(cfg, 64, seed=4)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tt.from_numpy_params(cfg, params)
    lm = tt.from_numpy_params(cfg, params, device="cpu")
    assert lm.word_embed.weight.data()._data.device.type == "cpu"


def _random_params(cfg, hidden, seed):
    """A decode_params-layout dict of seeded numpy weights."""
    rng = np.random.RandomState(seed)
    u, v = cfg["units"], cfg["vocab"]

    def w(*shape):
        return rng.uniform(-0.07, 0.07, shape).astype(np.float32)

    layer = dict(qkv_w=(3 * u, u), qkv_b=(3 * u,), proj_w=(u, u),
                 proj_b=(u,), ln1_g=(u,), ln1_b=(u,), ffn1_w=(hidden, u),
                 ffn1_b=(hidden,), ffn2_w=(u, hidden), ffn2_b=(u,),
                 ln2_g=(u,), ln2_b=(u,))
    return {"embed": w(v, u), "pos": w(cfg["max_length"], u),
            "final_g": 1 + w(u), "final_b": w(u), "dec_w": w(v, u),
            "dec_b": w(v),
            "layers": [{k: w(*s) for k, s in layer.items()}
                       for _ in range(cfg["layers"])]}


def test_out_of_range_ids_match_jax():
    """Token ids at or past the vocabulary, and negative ones, are read as
    the reference's gather reads them (clamped; negatives from the end):
    lm_prefill and lm_decode_step give the reference's logits at vocab
    32000 instead of raising."""
    cfg = {"vocab": 32000, "units": 32, "heads": 4, "head_dim": 8,
           "layers": 2, "max_length": 16}
    params = _random_params(cfg, 64, seed=5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    lm = tt.from_numpy_params(cfg, params, device="cpu")
    toks = np.array([[5, 40000, 31999, 32000, -1, -40000, 7, 123456]],
                    np.int32)
    logits, _k, _v = jt.lm_prefill(cfg, jparams, jnp.asarray(toks))
    with torch.no_grad():
        tl, _tk, _tv = tt.lm_prefill(cfg, tt.decode_params(lm),
                                     torch.from_numpy(toks))
    _close(tl.numpy(), logits)

    rng = np.random.RandomState(6)
    shape = (cfg["layers"], 3, 8, cfg["heads"], cfg["head_dim"])
    k0 = rng.randn(*shape).astype(np.float32)
    v0 = rng.randn(*shape).astype(np.float32)
    step = np.array([40000, -2, 31999], np.int32)
    pos = np.array([0, 3, 7], np.int32)
    want, _kv = jt.lm_decode_step(cfg, jparams, jnp.asarray(step),
                                  (jnp.asarray(k0), jnp.asarray(v0)),
                                  jnp.asarray(pos))
    with torch.no_grad():
        got, _ = tt.lm_decode_step(
            cfg, tt.decode_params(lm), torch.from_numpy(step),
            (torch.from_numpy(k0), torch.from_numpy(v0)),
            torch.from_numpy(pos))
    _close(got.numpy(), want)
