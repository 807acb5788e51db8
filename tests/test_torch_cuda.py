"""The port's CUDA kernels, its decode path and its training path on a CUDA
card.

Every test here needs the card: it is marked ``cuda`` and skips without
one. This file imports neither JAX nor the JAX package, so that it runs on
a machine with PyTorch and CUDA alone; there, without this repo's
conftest (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version (f32 to the reference's
2e-5, flash gradients to its 5e-4; bf16/f16 to 2e-2), the engine and the
trainer on the card to the same on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.serve import DecodeEngine, DecodeScheduler

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(dev, dtype, dim, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    page, heads, n_pages, max_pages = 16, 3, 40, 8
    pool = torch.randn((n_pages, 2, 2, page, heads, dim), generator=gen,
                       device=dev).to(dtype)
    q = torch.randn((5, heads, dim), generator=gen, device=dev).to(dtype)
    lengths = torch.tensor([0, 1, 16, 17, 128], dtype=torch.int32,
                           device=dev)
    table = torch.zeros((5, max_pages), dtype=torch.int32, device=dev)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    table[1, :1] = perm[:1]
    table[2, :1] = perm[1:2]
    table[3, :2] = perm[2:4]
    table[4, :8] = perm[4:12]
    return q, pool[:, 1, 0], pool[:, 1, 1], table, lengths


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("dim", [8, 64, 96, 256])
def test_kernel_matches_plain(cuda_device, dtype, tol, dim):
    q, k, v, table, lengths = _case(cuda_device, dtype, dim, seed=dim)
    before = tfa.flash_decode_attention.launches
    out = tfa.flash_decode_attention(q, k, v, table, lengths)
    torch.cuda.synchronize()
    assert tfa.flash_decode_attention.launches == before + 1
    ref = tfa._decode_attention_plain(q.float(), k, v, table, lengths,
                                      1.0 / math.sqrt(dim))
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out[1:].float(), ref[1:], rtol=0, atol=tol)
    assert torch.count_nonzero(out[0]) == 0  # length 0 writes 0


def test_dispatch_counts_only_kernel_launches(cuda_device, monkeypatch):
    q, k, v, table, lengths = _case(cuda_device, torch.float32, 64, seed=1)
    before = tfa.flash_decode_attention.launches
    monkeypatch.setenv("MXNET_DECODE_ATTN", "plain")
    plain = tfa.decode_attention(q, k, v, table, lengths)
    assert tfa.flash_decode_attention.launches == before
    for impl in ("auto", "kernel"):
        monkeypatch.setenv("MXNET_DECODE_ATTN", impl)
        out = tfa.decode_attention(q, k, v, table, lengths)
        torch.testing.assert_close(out[1:], plain[1:], rtol=0, atol=2e-5)
    assert tfa.flash_decode_attention.launches == before + 2


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    q = torch.randn((2, 2, 8), device=cuda_device)
    pages = torch.randn((4, 4, 2, 8), device=cuda_device)
    table = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    lengths = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(MXNetError, match="int32"):
        tfa.flash_decode_attention(q, pages, pages, table.long(), lengths)
    with pytest.raises(MXNetError, match="dtypes"):
        tfa.flash_decode_attention(q, pages.half(), pages.half(), table,
                                   lengths)
    with pytest.raises(MXNetError, match="on cuda"):
        tfa.flash_decode_attention(q, pages, pages, table.cpu(), lengths)


def test_engine_on_card_matches_engine_on_cpu(cuda_device):
    small = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
                 num_heads=4, max_length=64, seed=3)
    engine = dict(slots=4, page_size=8, num_pages=16, prompt_buckets=[8, 16])
    # one set of weights: a CPU and a CUDA generator draw different numbers
    lm = tt.transformer_lm(device="cpu", **small)
    cfg, params = tt.decode_config(lm), tt.decode_params(lm)
    streams = {}
    for dev in ("cpu", cuda_device):
        eng = DecodeEngine(cfg, params, device=dev, **engine)
        assert eng.warmup() == 3
        before = tfa.flash_decode_attention.launches
        sched = DecodeScheduler(eng, max_new_tokens=6)
        try:
            streams[str(dev)] = [
                list(sched.generate(np.arange(1, n + 1) % 90 + 1))
                for n in (3, 8, 13)]
            steps = sched.stats()["steps"]
        finally:
            sched.close()
        eng.pool.assert_baseline()
        launched = tfa.flash_decode_attention.launches - before
        assert launched == (2 * steps if eng.device.type == "cuda" else 0)
    assert streams["cpu"] == streams[str(cuda_device)]


# ---------------------------------------------------------------------------
# flash attention (training slice)
# ---------------------------------------------------------------------------

def _qkv(dev, dtype, b, h, s, d, seed):
    """q/k/v as the model makes them: transposed views of one (B, S, 3, H, D)
    projection output."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)] + [do]


def _assert_near(got, want, tol):
    """|got - want| <= tol * max(1, |want|): absolute below 1, relative
    above, so bf16/f16 results that the output rounding moves by one ulp of
    a large value still pass."""
    got, want = got.float(), want.float()
    bound = tol * want.abs().clamp_min(1.0)
    assert bool(((got - want).abs() <= bound).all()), \
        float((got - want).abs().max())


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 2e-5, 5e-4),
                                            (torch.bfloat16, 2e-2, 2e-2),
                                            (torch.float16, 2e-2, 2e-2)])
@pytest.mark.parametrize("causal,offset", [(True, 0), (True, -8), (True, 4),
                                           (False, 0)])
# S 40: ragged, below one tile; 130, 200, 384, 1000 straddle the 128-row
# forward tiles and 64/128-key backward tiles; D 16 is one k-step of 16
@pytest.mark.parametrize("s,d", [(40, 16), (256, 64), (200, 128), (130, 32),
                                 (384, 64), (1000, 128)])
def test_flash_kernels_match_plain(cuda_device, dtype, tol, gtol, causal,
                                   offset, s, d):
    q, k, v, do = _qkv(cuda_device, dtype, 2, 3, s, d, seed=s + d)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd.launches)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, None, offset)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, causal,
                                         None, offset)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref_o, ref_l = tfa._flash_attention_plain(q, k, v, causal, None, offset)
    assert out.dtype == dtype and out.shape == q.shape
    _assert_near(out, ref_o, tol)
    dead = ref_l <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    _assert_near(lse[~dead], ref_l[~dead], 2e-5)
    refs = tfa._flash_bwd_plain(q, k, v, out, lse, do, None, causal, None,
                                offset)
    for g, r in zip((dq, dk, dv), refs):
        assert g.dtype == dtype and torch.isfinite(g).all()
        _assert_near(g, r, gtol)


@pytest.mark.parametrize("causal,offset", [(True, 0), (True, -8),
                                           (False, 0)])
def test_flash_unaligned_views_match_plain(cuda_device, causal, offset):
    """q/k/v/dO whose rows do not start on 16-byte boundaries take the
    kernels' plain-load path, never the plain version."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)
    b, h, s, d = 1, 2, 200, 64
    flat = torch.randn((b * s * 3 * h * d + 1,), generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    qkv = flat[1:].view(b, s, 3, h, d)  # 2 bytes past an aligned start
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = flat[1:1 + b * h * s * d].view(b, h, s, d)
    before = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, None, offset)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, causal,
                                    None, offset)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    ref_o, ref_l = tfa._flash_attention_plain(q, k, v, causal, None, offset)
    _assert_near(out, ref_o, 2e-2)
    dead = ref_l <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    _assert_near(lse[~dead], ref_l[~dead], 2e-5)
    refs = tfa._flash_bwd_plain(q, k, v, out, lse, do, None, causal, None,
                                offset)
    for g, r in zip(grads, refs):
        _assert_near(g, r, 2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_repeats(cuda_device, dtype):
    """Two backward runs on the same inputs: dK and dV are the same bits;
    dQ, summed by atomics in an order that changes from run to run, agrees
    within the 16-bit tolerance."""
    q, k, v, do = _qkv(cuda_device, dtype, 2, 3, 384, 64, seed=7)
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    first = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, True)
    second = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, True)
    torch.cuda.synchronize()
    _assert_near(second[0], first[0], 2e-2)
    assert torch.equal(second[1], first[1]) and torch.equal(second[2], first[2])


def test_flash_autograd_launches_kernels(cuda_device, monkeypatch):
    q, k, v, do = _qkv(cuda_device, torch.bfloat16, 2, 2, 128, 64, seed=1)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd
    before = (fwd.launches, bwd.launches)
    out = tfa.flash_attention(q, k, v, causal=True)
    (out.float() * do.float()).sum().backward()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    grads = [t.grad.clone() for t in (q, k, v)]
    monkeypatch.setenv("MXNET_FLASH_BWD", "plain")
    for t in (q, k, v):
        t.grad = None
    out = tfa.flash_attention(q, k, v, causal=True)
    (out.float() * do.float()).sum().backward()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 1)
    for g, t in zip(grads, (q, k, v)):
        _assert_near(t.grad, g, 2e-2)


def test_flash_rejects_what_it_cannot_take(cuda_device):
    q, k, v, _ = _qkv(cuda_device, torch.float32, 1, 2, 64, 64, seed=2)
    with pytest.raises(MXNetError, match="tiles"):
        tfa.flash_attention_fwd(q, k, v, block_q=32)  # no kernel's tile
    with pytest.raises(MXNetError, match="dtypes differ"):
        tfa.flash_attention_fwd(q, k.half(), v)
    with pytest.raises(MXNetError, match="head dim"):
        tfa.flash_attention_fwd(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(MXNetError, match="contiguous last dim"):
        tfa.flash_attention_fwd(q.transpose(2, 3), k.transpose(2, 3),
                                v.transpose(2, 3))
    with pytest.raises(MXNetError, match="shapes"):
        tfa.flash_attention_fwd(q, k[:, :, :32], v[:, :, :32])
    with pytest.raises(MXNetError, match="on cuda"):
        tfa.flash_attention_fwd(q, k.cpu(), v)
    # bf16 at D 32: the forward takes 128-row tiles, the backward 64; with
    # gradients wanted the request is refused before the backward
    q, k, v, _ = _qkv(cuda_device, torch.bfloat16, 1, 2, 256, 32, seed=2)
    tfa.flash_attention(q, k, v, block_q=128)
    with pytest.raises(MXNetError, match="bwd kernel's tiles"):
        tfa.flash_attention(q.detach().requires_grad_(), k, v, block_q=128)


def test_trainer_on_card_matches_trainer_on_cpu(cuda_device, monkeypatch):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    small = dict(vocab_size=97, units=64, hidden_size=128, num_layers=2,
                 num_heads=2, max_length=128, seed=3)
    x = np.random.RandomState(0).randint(0, 97, (2, 128))
    losses = {}
    for dev in ("cpu", cuda_device):
        lm = tt.transformer_lm(device="cpu", **small).to(dev)
        tr = ShardedTrainer(lm, SoftmaxCrossEntropyLoss(), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-3})
        before = tfa.flash_attention_bwd.launches
        losses[str(dev)] = [float(tr.step(x, x)) for _ in range(3)]
        launched = tfa.flash_attention_bwd.launches - before
        assert launched == (6 if tr.device.type == "cuda" else 0)
    np.testing.assert_allclose(losses[str(cuda_device)], losses["cpu"],
                               rtol=1e-4)


def test_copy_probe_on_card(cuda_device):
    from mxnet_tpu_torch.tools.launch_cost_probe import copy_probe

    x = torch.randn((8, 128), device=cuda_device)
    before = copy_probe.launches
    y = copy_probe(x)
    torch.cuda.synchronize()
    assert copy_probe.launches == before + 1
    torch.testing.assert_close(y, x + 1.0, rtol=0, atol=0)
    with pytest.raises(MXNetError, match="float32"):
        copy_probe(x.half())
