"""Flash attention of the port (mxnet_tpu_torch.ops.flash_attention and
ops.attention) against the JAX package, on the CPU.

On CPU tensors the port computes its kernels' plain PyTorch versions;
they are held here to the reference's Pallas kernels run in interpret
mode, to its blocked backward (``MXNET_FLASH_BWD=blocked``) and to its
interpreted Pallas backward (``MXNET_FLASH_BWD=pallas``). The same numpy
inputs go to both packages. Tolerances are the reference's own
(tests/test_flash_attention.py): 2e-5 for out and lse, 5e-4 for
gradients.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import attention as tatt
from mxnet_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = 2e-5, 5e-4


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _t(arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_interpreted_pallas(causal):
    arrs = _inputs((2, 3, 256, 64))
    scale = 1.0 / np.sqrt(64)
    out, lse = jfa._fwd_pallas(*map(jnp.asarray, arrs), 0, scale, causal,
                               64, 64, True)
    got_o, got_l = tfa._flash_attention_plain(*_t(arrs), causal, scale, 0,
                                              64, 64)
    _close(got_o.numpy(), out, OUT_TOL)
    _close(got_l.numpy(), lse, OUT_TOL)
    # and the public entry point against the reference's plain attention
    ref = jatt.plain_attention(*map(jnp.asarray, arrs), causal=causal)
    with torch.no_grad():
        pub = tfa.flash_attention(*_t(arrs), causal=causal, block_q=64,
                                  block_k=64)
    _close(pub.numpy(), ref, OUT_TOL)


@pytest.mark.parametrize("bwd", ["blocked", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_reference(causal, bwd, monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_BWD", bwd)
    arrs = _inputs((1, 2, 128, 32), seed=1)

    def loss(q, k, v):
        return (jfa.flash_attention(q, k, v, causal=causal, block_q=32,
                                    block_k=32) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    monkeypatch.setenv("MXNET_FLASH_BWD", "auto")  # the port's CPU path
    q, k, v = _t(arrs, grad=True)
    (tfa.flash_attention(q, k, v, causal=causal, block_q=32,
                         block_k=32) ** 2).sum().backward()
    for t, w in zip((q, k, v), want):
        _close(t.grad.numpy(), w, GRAD_TOL)
    # the port's flash gradients equal its plain attention's
    q2, k2, v2 = _t(arrs, grad=True)
    (tatt.plain_attention(q2, k2, v2, causal=causal) ** 2).sum().backward()
    for a, b in zip((q, k, v), (q2, k2, v2)):
        _close(a.grad.numpy(), b.grad.numpy(), GRAD_TOL)


@pytest.mark.parametrize("bwd", ["blocked", "pallas"])
@pytest.mark.parametrize("offset", [-8, -4, 0, 4])
def test_offsets_match_reference(offset, bwd, monkeypatch):
    """Dynamic causal offsets, including negative ones where some rows see
    nothing (out 0, lse -1e30, finite zero gradients)."""
    monkeypatch.setenv("MXNET_FLASH_BWD", bwd)
    arrs = _inputs((1, 1, 16, 16), seed=2)

    def fl(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, causal=True,
                                            offset=offset, block_q=8,
                                            block_k=8)

    (out, lse) = fl(*map(jnp.asarray, arrs))
    want = jax.grad(lambda *a: (fl(*a)[0] ** 2).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    monkeypatch.setenv("MXNET_FLASH_BWD", "auto")
    q, k, v = _t(arrs, grad=True)
    got_o, got_l = tfa.flash_attention_with_lse(q, k, v, causal=True,
                                                offset=offset, block_q=8,
                                                block_k=8)
    _close(got_o.detach().numpy(), out, OUT_TOL)
    np.testing.assert_array_equal(got_l.detach().numpy() <= -1e29,
                                  np.asarray(lse) <= -1e29)
    live = np.asarray(lse) > -1e29
    _close(got_l.detach().numpy()[live], np.asarray(lse)[live], OUT_TOL)
    (got_o ** 2).sum().backward()
    for t, w in zip((q, k, v), want):
        g = t.grad.numpy()
        assert np.isfinite(g).all(), f"non-finite grads offset={offset}"
        _close(g, w, GRAD_TOL)


@pytest.mark.parametrize("bwd", ["blocked", "pallas"])
def test_lse_cotangent_matches_reference(bwd, monkeypatch):
    """A loss on lse as well as out: the lse cotangent enters dS."""
    monkeypatch.setenv("MXNET_FLASH_BWD", bwd)
    arrs = _inputs((1, 2, 64, 16), seed=3)
    w_o = np.random.RandomState(4).randn(1, 2, 64, 16).astype(np.float32)
    w_l = np.random.RandomState(5).randn(1, 2, 64).astype(np.float32)

    def jloss(q, k, v):
        o, l_ = jfa.flash_attention_with_lse(q, k, v, causal=True,
                                             block_q=16, block_k=16)
        return (o * w_o).sum() + (l_ * w_l).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    monkeypatch.setenv("MXNET_FLASH_BWD", "auto")
    q, k, v = _t(arrs, grad=True)
    o, l_ = tfa.flash_attention_with_lse(q, k, v, causal=True, block_q=16,
                                         block_k=16)
    ((o * torch.from_numpy(w_o)).sum()
     + (l_ * torch.from_numpy(w_l)).sum()).backward()
    for t, w in zip((q, k, v), want):
        _close(t.grad.numpy(), w, GRAD_TOL)


def test_plain_bwd_matches_blocked_reference_directly():
    """_flash_bwd_plain against _bwd_blocked on one residual set, with an
    lse cotangent."""
    arrs = _inputs((2, 2, 64, 32), seed=6)
    rng = np.random.RandomState(7)
    do = rng.randn(2, 2, 64, 32).astype(np.float32)
    g_lse = rng.randn(2, 2, 64).astype(np.float32)
    scale = 1.0 / np.sqrt(32)
    q, k, v = map(jnp.asarray, arrs)
    out, lse = jfa._fwd_pallas(q, k, v, 0, scale, True, 16, 16, True)
    want = jfa._bwd_blocked(scale, True, 16, (q, k, v, jnp.int32(0), out,
                                              lse),
                            (jnp.asarray(do), jnp.asarray(g_lse)))[:3]
    got = tfa._flash_bwd_plain(*_t(arrs), torch.from_numpy(np.array(out)),
                               torch.from_numpy(np.array(lse)),
                               torch.from_numpy(do), torch.from_numpy(g_lse),
                               True, scale, 0, 16)
    for g, w in zip(got, want):
        _close(g.numpy(), w, GRAD_TOL)


def test_lse_matches_logsumexp():
    arrs = _inputs((2, 2, 128, 32), seed=8)
    with torch.no_grad():
        _, lse = tfa.flash_attention_with_lse(*_t(arrs), block_q=32,
                                              block_k=32)
    q, k, _ = arrs
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(32)
    ref = jax.scipy.special.logsumexp(scores, axis=-1)
    _close(lse.numpy(), ref, OUT_TOL)


def test_odd_seq_block_shrink():
    """S=40: a requested block of 32 shrinks to a divisor (8) instead of
    failing; the default 512 becomes the whole sequence."""
    arrs = _inputs((1, 1, 40, 16), seed=9)
    assert tfa._resolve_blocks(40, 16, 32, 32) == (8, 8)
    assert tfa._resolve_blocks(40, 16, None, None) == (40, 40)
    ref = jatt.plain_attention(*map(jnp.asarray, arrs), causal=True)
    with torch.no_grad():
        for blk in (None, 32):
            out = tfa.flash_attention(*_t(arrs), causal=True, block_q=blk,
                                      block_k=blk)
            _close(out.numpy(), ref, OUT_TOL)


@pytest.mark.parametrize("s,d", [(40, 16), (256, 64), (2048, 64),
                                 (1024, 128)])
def test_block_resolution_matches_reference(s, d, monkeypatch):
    assert tfa._resolve_blocks(s, d, None, None) == \
        jfa._resolve_blocks(s, d, None, None)
    assert tfa._resolve_blocks(s, d, 64, 32) == \
        jfa._resolve_blocks(s, d, 64, 32)
    monkeypatch.setenv("MXNET_FLASH_BLOCK_Q", "128")
    monkeypatch.setenv("MXNET_FLASH_BLOCK_K", "16")
    assert tfa._resolve_blocks(s, d, None, None) == \
        jfa._resolve_blocks(s, d, None, None)
    assert tfa._resolve_blocks(s, d, 32, None) == \
        jfa._resolve_blocks(s, d, 32, None)


def test_dispatcher_policy(monkeypatch):
    arrs = _inputs((1, 1, 64, 16), seed=10)
    ref = np.asarray(jatt.plain_attention(*map(jnp.asarray, arrs)))
    for impl in ("auto", "plain", "flash"):
        monkeypatch.setenv("MXNET_ATTENTION_IMPL", impl)
        want = jatt.fused_attention(*map(jnp.asarray, arrs))
        with torch.no_grad():
            got = tatt.fused_attention(*_t(arrs))
        _close(got.numpy(), want, OUT_TOL)
        _close(got.numpy(), ref, OUT_TOL)
    # masks always take the plain path, also under impl=flash
    mask = np.tril(np.ones((64, 64), bool))
    want = jatt.fused_attention(*map(jnp.asarray, arrs),
                                mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tatt.fused_attention(*_t(arrs), mask=torch.from_numpy(mask))
    _close(got.numpy(), want, OUT_TOL)
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "bogus")
    with pytest.raises(MXNetError, match="auto|plain|flash"):
        tatt.fused_attention(*_t(arrs))


def test_dispatch_picks_flash_by_length(monkeypatch):
    """auto: flash from _FLASH_MIN_SEQ on, plain below; unequal or
    non-multiple-of-8 lengths never take flash."""
    calls = []
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape[-2]))
    monkeypatch.delenv("MXNET_ATTENTION_IMPL", raising=False)
    for s in (1023, 1024):
        q = torch.zeros((1, 1, s, 8))
        tatt.fused_attention(q, q, q, causal=True)
    q, k = torch.zeros((1, 1, 1032, 8)), torch.zeros((1, 1, 1040, 8))
    tatt.fused_attention(q, k, k)
    assert calls == [1024]
    assert tatt._flash_ok(q, q) and not tatt._flash_ok(q, k)
    assert not tatt._flash_ok(torch.zeros((1, 1, 12, 8)),
                              torch.zeros((1, 1, 12, 8)))


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_matches_reference(causal):
    """Including s_q != s_k, where the causal mask is tril(k=s_k-s_q)."""
    rng = np.random.RandomState(11)
    q = rng.randn(2, 2, 8, 16).astype(np.float32)
    k = rng.randn(2, 2, 12, 16).astype(np.float32)
    v = rng.randn(2, 2, 12, 16).astype(np.float32)
    want = jatt.plain_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal)
    got = tatt.plain_attention(*_t([q, k, v]), causal=causal)
    _close(got.numpy(), want, OUT_TOL)


def test_cpu_wrappers_count_nothing_and_bwd_env(monkeypatch):
    arrs = _inputs((1, 1, 16, 16), seed=12)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd.launches)
    q, k, v = _t(arrs, grad=True)
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd.launches) == before
    grads = [t.grad.clone() for t in (q, k, v)]
    monkeypatch.setenv("MXNET_FLASH_BWD", "plain")
    q, k, v = _t(arrs, grad=True)
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    for a, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(t.grad, a, rtol=0, atol=0)
    for impl, match in (("kernel", "needs CUDA"), ("pallas", "expected")):
        monkeypatch.setenv("MXNET_FLASH_BWD", impl)
        q, k, v = _t(arrs, grad=True)
        out = tfa.flash_attention(q, k, v, causal=True)
        with pytest.raises(MXNetError, match=match):
            out.sum().backward()


def _cuda_constants(source):
    """The ``constexpr int`` constants of ``mxnet_tpu_torch/csrc/<source>``."""
    text = (Path(tfa.__file__).resolve().parents[1] / "csrc" / source
            ).read_text()
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}, text


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_kernel_tiles_match_cuda_sources(d):
    """The tiles the wrappers accept on a CUDA tensor are those the kernels
    were written for."""
    fwd, _ = _cuda_constants("flash_attention_fwd.cu")
    bwd, bwd_text = _cuda_constants("flash_attention_bwd.cu")
    common, _ = _cuda_constants("flash_common.cuh")
    d16_keys = int(re.search(r"BN = D == 16 \? (\d+) : kBwdBN;",
                             bwd_text).group(1))
    if d == 64:
        want_bwd = (bwd["kWgBM"], bwd["kWgBN"])
    else:
        want_bwd = (bwd["kBwdBM"], d16_keys if d == 16 else bwd["kBwdBN"])
    for dt in (torch.bfloat16, torch.float16):
        assert tfa._kernel_tiles("fwd", dt, d) == (fwd["kFwdBM"],
                                                   fwd["kFwdBN"])
        assert tfa._kernel_tiles("bwd", dt, d) == want_bwd
    for which in ("fwd", "bwd"):
        assert tfa._kernel_tiles(which, torch.float32, d) == (common["kBQ"],
                                                              common["kBK"])
