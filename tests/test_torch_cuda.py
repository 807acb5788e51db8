"""The port's CUDA kernels, its decode path and its training path on a CUDA
card.

Every test here needs the card: it is marked ``cuda`` and skips without
one. This file imports neither JAX nor the JAX package, so that it runs on
a machine with PyTorch and CUDA alone; there, without this repo's
conftest (which configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held to its plain PyTorch version (f32 to the reference's
2e-5, flash gradients to its 5e-4; bf16/f16 to 2e-2), the engine and the
trainer on the card to the same on the CPU, the imperative ``nd`` path on
the card to the same on the CPU, the convolution, BatchNorm and pooling
ops (cuDNN and the card's elementwise kernels) to the same ops on the CPU,
the fixed-order f32 backward (under ``torch.use_deterministic_algorithms``)
bitwise across calls, and the batch-serving engine on the card bitwise to
``Module.predict``
there, as are the replies of a fleet of two card replicas through a kill,
a restart and a fleet reload; a ``ProcReplica`` child serves on the card,
and streams relayed by a ``FleetServer`` through the paged kernel equal
the plain version's. The device store on CUDA tensors equals the same
store on the CPU, and two ``dist_sync`` ranks sharing the card form a
gloo group and pass the known values on CUDA tensors. The device plane's
cost records of a decode engine on the card equal those on the CPU. A
``Module.fit`` with the training-fleet plane on books the card's
forward+backward time as compute. The paged kernel loads from its
program-cache entry with no ``nvcc`` run, bitwise the built library, and
a truncated entry is rejected and rebuilt.
"""
import contextlib
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


def _long_case(dev, dtype, dim, seed, chunk):
    """Rows longer than one chunk: lengths 0, 1, chunk - 1, chunk,
    chunk + 1, 2 * chunk + 3 and the full row of max_pages * page, on a
    strided pool view."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    page, heads, n_pages, max_pages = 16, 3, 97, 64
    full = max_pages * page
    pool = torch.randn((n_pages, 2, 2, page, heads, dim), generator=gen,
                       device=dev).to(dtype)
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, min(2 * chunk + 3, full),
               full]
    q = torch.randn((len(lengths), heads, dim), generator=gen,
                    device=dev).to(dtype)
    table = torch.randint(1, n_pages, (len(lengths), max_pages),
                          generator=gen, device=dev, dtype=torch.int32)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pool[:, 0, 0], pool[:, 0, 1], table, lengths


def _assert_rows_close(out, ref, dtype, tol):
    """Rows from 1 on: f32 within ``tol``; bf16/f16 within ``tol`` times
    the row's largest |ref|, since a long row averages to values far below
    1, where an absolute 2e-2 would hide a 16-bit fault."""
    got, want = out[1:].float(), ref[1:]
    limit = torch.full((want.shape[0],), tol, device=want.device)
    if dtype != torch.float32:
        limit = limit * want.abs().flatten(1).amax(1)
    err = (got - want).abs().flatten(1).amax(1)
    assert bool((err <= limit).all()), (err.tolist(), limit.tolist())


def _chosen_chunk(q, k, table):
    return tfa._decode_chunk(q.shape[0], q.shape[1],
                             table.shape[1] * k.shape[1], k.shape[1],
                             torch.cuda.get_device_properties(q.device)
                             .multi_processor_count)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 2e-2)])
@pytest.mark.parametrize("dim", [8, 64, 96, 256])
def test_kernel_long_rows_match_plain(cuda_device, dtype, tol, dim):
    probe = _long_case(cuda_device, dtype, dim, seed=dim, chunk=64)
    chunk = _chosen_chunk(*probe[:2], probe[3])
    q, k, v, table, lengths = _long_case(cuda_device, dtype, dim, seed=dim,
                                         chunk=chunk)
    before = tfa.flash_decode_attention.launches
    out = tfa.flash_decode_attention(q, k, v, table, lengths)
    torch.cuda.synchronize()
    assert tfa.flash_decode_attention.launches == before + 1
    ref = tfa._decode_attention_plain(q.float(), k, v, table, lengths,
                                      1.0 / math.sqrt(dim))
    _assert_rows_close(out, ref, dtype, tol)
    assert torch.count_nonzero(out[0]) == 0  # length 0 writes 0


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("chunk", [16, 64, 128, 256, 512, 1024])
def test_kernel_every_chunk_matches_plain(cuda_device, dtype, tol, chunk):
    q, k, v, table, lengths = _long_case(cuda_device, dtype, 64, seed=2,
                                         chunk=min(chunk, 500))
    scale = 1.0 / math.sqrt(64)
    out = tfa._paged_decode_launch(q, k, v, table, lengths, scale, chunk)
    ref = tfa._decode_attention_plain(q.float(), k, v, table, lengths, scale)
    _assert_rows_close(out, ref, dtype, tol)
    assert torch.count_nonzero(out[0]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_repeats_bitwise(cuda_device, dtype):
    q, k, v, table, lengths = _long_case(cuda_device, dtype, 64, seed=3,
                                         chunk=64)
    outs = [tfa.flash_decode_attention(q, k, v, table, lengths)
            for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_kernel_unaligned_views_match_plain(cuda_device):
    """Views whose pointers are not on 16 bytes take element loads."""
    q, k, v, table, lengths = _long_case(cuda_device, torch.float32, 64,
                                         seed=4, chunk=64)
    flat = torch.empty(k.numel() * 4 + 1, device=cuda_device)
    pool = flat[1:1 + k.shape[0] * 2 * k[0].numel()].view(
        k.shape[0], 2, *k.shape[1:])
    pool[:, 0], pool[:, 1] = k, v
    ku, vu = pool[:, 0], pool[:, 1]
    assert ku.data_ptr() % 16 != 0
    out = tfa.flash_decode_attention(q, ku, vu, table, lengths)
    ref = tfa._decode_attention_plain(q, k, v, table, lengths,
                                      1.0 / math.sqrt(64))
    torch.testing.assert_close(out[1:], ref[1:], rtol=0, atol=2e-5)


def test_launch_path_raises_and_counts(cuda_device):
    """Every wrapper on the shared launch path still checks its inputs and
    counts exactly its launches."""
    from mxnet_tpu_torch.tools.launch_cost_probe import copy_probe

    x = torch.randn((8, 128), device=cuda_device)
    q, k, v, table, lengths = _case(cuda_device, torch.float32, 64, seed=5)
    fq, fk, fv, _ = _qkv(cuda_device, torch.bfloat16, 1, 2, 128, 64, seed=5)
    counts = lambda: (copy_probe.launches,  # noqa: E731
                      tfa.flash_decode_attention.launches,
                      tfa.flash_attention_fwd.launches)
    before = counts()
    for bad in (lambda: copy_probe(x.double()),
                lambda: copy_probe(x.t()),
                lambda: tfa.flash_decode_attention(q.half(), k, v, table,
                                                   lengths),
                lambda: tfa.flash_decode_attention(q, k, v, table.cpu(),
                                                   lengths),
                lambda: tfa.flash_attention_fwd(fq, fk.float(), fv),
                lambda: tfa.flash_attention_fwd(fq, fk.cpu(), fv)):
        with pytest.raises(MXNetError):
            bad()
    assert counts() == before
    copy_probe(x)
    tfa.flash_decode_attention(q, k, v, table, lengths)
    tfa.flash_attention_fwd(fq, fk, fv, True)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)


def _seeded_lm(seed=3, **small):
    """(config, parameter dict) of a Gluon LM initialized on the CPU from
    ``seed``: one set of weights for both devices, since a CPU and a CUDA
    generator draw different numbers."""
    import mxnet_tpu_torch as mx

    mx.random.seed(seed)
    lm = tt.transformer_lm(**small)
    lm.initialize(ctx=mx.cpu())
    return tt.decode_config(lm), tt.decode_params(lm)


def test_engine_on_card_matches_engine_on_cpu(cuda_device):
    small = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
                 num_heads=4, max_length=64)
    engine = dict(slots=4, page_size=8, num_pages=16, prompt_buckets=[8, 16])
    cfg, params = _seeded_lm(**small)
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


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 2e-5, 5e-4),
                                            (torch.bfloat16, 2e-2, 2e-2)])
@pytest.mark.parametrize("offset", [0, 128, -128],
                         ids=["diagonal", "past_block", "future_block"])
def test_flash_kernels_at_ring_offsets_with_lse_cotangent(cuda_device, dtype,
                                                          tol, gtol, offset):
    """Ring attention's blocks (a rank's S rows against one visiting
    block): offset 0, +S (every key visible) and -S (every row dead: out
    0, lse -1e30, gradients 0), with a random nonzero lse cotangent in the
    backward, as the logsumexp combine sends it."""
    s = 128
    q, k, v, do = _qkv(cuda_device, dtype, 2, 3, s, 64, seed=31)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(32)
    g_lse = torch.randn((2, 3, s), generator=gen, device=cuda_device)
    out, lse = tfa.flash_attention_fwd(q, k, v, True, None, offset)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, do, g_lse, True,
                                    None, offset)
    torch.cuda.synchronize()
    ref_o, ref_l = tfa._flash_attention_plain(q, k, v, True, None, offset)
    _assert_near(out, ref_o, tol)
    dead = ref_l <= -1e29
    assert torch.equal(lse <= -1e29, dead)
    if offset < 0:
        assert bool(dead.all()) and not bool(out.float().abs().max() > 0)
    else:
        _assert_near(lse[~dead], ref_l[~dead], 2e-5)
    refs = tfa._flash_bwd_plain(q, k, v, out, lse, do, g_lse, True, None,
                                offset)
    for g, r in zip(grads, refs):
        assert torch.isfinite(g).all()
        _assert_near(g, r, gtol)
        if offset < 0:
            assert not bool(g.float().abs().max() > 0)


@pytest.mark.parametrize("dtype,tol,gtol", [(torch.float32, 2e-5, 5e-4),
                                            (torch.bfloat16, 2e-2, 2e-2),
                                            (torch.float16, 2e-2, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
# bf16/f16 head dims the tensor-core kernels are not built for run at the
# next built one (16, 32, 64, 128, 256) with the columns past d zero; 12 is
# not a whole number of 16-byte chunks, so its rows take the element loads;
# f32 at every d, and bf16/f16 past 256, run on the FFMA kernels (264 and
# 320 end in a part-filled slab, 512 fills four forward and eight backward
# slabs)
@pytest.mark.parametrize("d", [8, 12, 48, 80, 96, 256, 264, 320, 512])
def test_flash_kernels_any_head_dim_match_plain(cuda_device, dtype, tol, gtol,
                                                causal, d):
    s = 200
    q, k, v, do = _qkv(cuda_device, dtype, 2, 3, s, d, seed=d)
    before = (tfa.flash_attention_fwd.launches,
              tfa.flash_attention_bwd.launches)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_fwd.launches,
            tfa.flash_attention_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    ref_o, ref_l = tfa._flash_attention_plain(q, k, v, causal)
    assert out.shape == q.shape and out.dtype == dtype
    _assert_near(out, ref_o, tol)
    _assert_near(lse, ref_l, 2e-5)
    refs = tfa._flash_bwd_plain(q, k, v, out, lse, do, None, causal)
    for g, r in zip((dq, dk, dv), refs):
        assert g.shape == q.shape and torch.isfinite(g).all()
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


@pytest.mark.parametrize("d", [64, 320])
def test_flash_bwd_f32_repeats(cuda_device, d):
    """What the f32 backward promises across two runs on the same inputs:
    dK and dV are the same bits (each summed in one order by one block);
    dQ, added into its f32 accumulator by atomics in an order that changes
    from run to run, agrees within the reference's f32 2e-5."""
    q, k, v, do = _qkv(cuda_device, torch.float32, 2, 3, 384, d, seed=8)
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    first = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, True)
    second = tfa.flash_attention_bwd(q, k, v, out, lse, do, None, True)
    torch.cuda.synchronize()
    _assert_near(second[0], first[0], 2e-5)
    assert torch.equal(second[1], first[1]) and torch.equal(second[2], first[2])


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


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` inside the block (the
    plain versions run outside it: their cuBLAS products would need
    ``CUBLAS_WORKSPACE_CONFIG`` under the switch)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


# ragged S below and across the 64-row tiles, head dims of one and of
# several slabs, the ring's offsets with the lse cotangent
@pytest.mark.parametrize("s,d", [(40, 16), (384, 64), (200, 96), (130, 320)])
@pytest.mark.parametrize("causal,offset", [(True, 0), (True, -8),
                                           (True, 128), (True, -128),
                                           (False, 0)])
def test_flash_bwd_f32_fixed_order_bitwise_and_near_plain(
        cuda_device, s, d, causal, offset):
    """Under torch.use_deterministic_algorithms the f32 backward launches
    its fixed-order variant: dQ summed over the key tiles in key order.
    Two calls give the same bits in dQ, dK and dV, each within the
    reference's 5e-4 of the plain version."""
    q, k, v, do = _qkv(cuda_device, torch.float32, 2, 3, s, d, seed=s + d)
    g_lse = torch.randn(q.shape[:3], device=cuda_device)
    out, lse = tfa.flash_attention_fwd(q, k, v, causal, None, offset)
    before = (tfa.flash_attention_bwd.launches,
              tfa.flash_attention_bwd.ordered_launches)
    with _deterministic():
        first = tfa.flash_attention_bwd(q, k, v, out, lse, do, g_lse,
                                        causal, None, offset)
        second = tfa.flash_attention_bwd(q, k, v, out, lse, do, g_lse,
                                         causal, None, offset)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_bwd.launches,
            tfa.flash_attention_bwd.ordered_launches) == (before[0] + 2,
                                                          before[1] + 2)
    refs = tfa._flash_bwd_plain(q, k, v, out, lse, do, g_lse, causal, None,
                                offset)
    for a, b, r in zip(first, second, refs):
        assert torch.equal(a, b)
        assert torch.isfinite(a).all()
        _assert_near(a, r, 5e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_bwd_16bit_raises_under_the_switch(cuda_device, dtype):
    """The tensor-core backward sums dQ by atomics: under the switch it
    raises as PyTorch's own non-deterministic operators do, launching
    nothing; the forward, in one order, still runs."""
    q, k, v, do = _qkv(cuda_device, dtype, 2, 3, 256, 64, seed=3)
    out, lse = tfa.flash_attention_fwd(q, k, v, True)
    before = tfa.flash_attention_bwd.launches
    with _deterministic(), pytest.raises(RuntimeError,
                                         match="deterministic"):
        tfa.flash_attention_bwd(q, k, v, out, lse, do, None, True)
    assert tfa.flash_attention_bwd.launches == before


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
    # a head dim past the tensor-core kernels' 256 runs (the FFMA kernels)
    wide = _qkv(cuda_device, torch.float32, 1, 2, 64, 264, seed=2)[:3]
    out, lse = tfa.flash_attention_fwd(*wide)
    torch.cuda.synchronize()
    assert out.shape == wide[0].shape and bool(torch.isfinite(out).all())
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
    cfg, params = _seeded_lm(vocab_size=97, units=64, hidden_size=128,
                             num_layers=2, num_heads=2, max_length=128)
    x = np.random.RandomState(0).randint(0, 97, (2, 128))
    losses = {}
    for dev in ("cpu", cuda_device):
        lm = tt.from_numpy_params(cfg, params, device=dev)
        tr = ShardedTrainer(lm, SoftmaxCrossEntropyLoss(), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-3})
        before = tfa.flash_attention_bwd.launches
        losses[str(dev)] = [float(tr.step(x, x).asnumpy())
                            for _ in range(3)]
        launched = tfa.flash_attention_bwd.launches - before
        assert launched == (6 if tr.device.type == "cuda" else 0)
    np.testing.assert_allclose(losses[str(cuda_device)], losses["cpu"],
                               rtol=1e-4)


def test_step_cost_on_card_equals_cpu_and_counts_the_backward(cuda_device,
                                                             monkeypatch):
    """ShardedTrainer.step_cost on the card: the flash backward, which the
    autograd engine runs on its own thread there, is counted once a layer
    by its formula, and the record's operations equal the CPU's."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    monkeypatch.setenv("MXNET_DEVICE_COST", "1")
    cfg, params = _seeded_lm(vocab_size=97, units=64, hidden_size=128,
                             num_layers=2, num_heads=2, max_length=128)
    x = np.random.RandomState(0).randint(0, 97, (2, 128))
    costs = {}
    for dev in ("cpu", cuda_device):
        lm = tt.from_numpy_params(cfg, params, device=dev)
        tr = ShardedTrainer(lm, SoftmaxCrossEntropyLoss(), optimizer="adam",
                            optimizer_params={"learning_rate": 1e-3})
        tr.step(x, x)
        costs[str(dev)] = tr.step_cost
    card = costs[str(cuda_device)]
    assert card["kernels"]["flash_attention_bwd"]["calls"] == 2
    assert card["kernels"] == costs["cpu"]["kernels"]
    assert card["flops"] == costs["cpu"]["flops"]


def test_leak_detector_flags_retained_card_tensors(cuda_device):
    """Retained CUDA tensors show in live_bytes and trip the detector."""
    from mxnet_tpu_torch.obs import device as tdev

    det = tdev.LeakDetector(window=8, warmup=2,
                            threshold_bytes_per_step=1000)
    retained, fired = [], None
    for _ in range(30):
        retained.append(torch.ones(1 << 16, device=cuda_device))  # 256 KB
        fired = fired or det.observe(tdev.live_bytes())
    assert fired is not None and fired["slope_bytes_per_step"] > 1 << 17
    del retained


def test_nd_path_on_card_matches_nd_path_on_cpu(cuda_device, monkeypatch):
    """The imperative path (the reference's model code on nd arrays,
    record/backward) on the card, where arrays land by default, against
    the same on the CPU: the tape reaches both flash kernels once per
    layer, and loss and gradients agree within the flash kernels' f32
    tolerances (loss 1e-5 relative, gradients 5e-4 of max(1, |cpu|))."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.ndarray.ndarray import invoke_fn
    from mxnet_tpu_torch.ops.attention import fused_attention
    from mxnet_tpu_torch.tools import nd_lm

    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    _cfg, params = _seeded_lm(vocab_size=97, units=64, hidden_size=128,
                              num_layers=2, num_heads=2, max_length=128)
    x = np.random.RandomState(0).randint(0, 97, (2, 128))
    assert nd.zeros((1,)).context == mx.gpu(0)  # no scope: the card
    runs = {}
    for ctx in (mx.cpu(), None):
        with ctx or mx.current_context():
            arrays = {k: nd.array(v) for k, v in params.items()
                      if k != "layers"}
            arrays["layers"] = [{k: nd.array(v) for k, v in lp.items()}
                                for lp in params["layers"]]
            flat = nd_lm.flat_params(arrays)
            for _, a in flat:
                a.attach_grad()
            xs = nd.array(x, dtype="int32")
            before = (tfa.flash_attention_fwd.launches,
                      tfa.flash_attention_bwd.launches)
            with autograd.record():
                loss = nd_lm.lm_loss(nd, invoke_fn, fused_attention, arrays,
                                     xs, xs, heads=2)
            loss.backward()
            launched = (tfa.flash_attention_fwd.launches - before[0],
                        tfa.flash_attention_bwd.launches - before[1])
            runs[xs.context.device_type] = (
                float(loss.asscalar()), launched,
                {n: a.grad.astorch().cpu() for n, a in flat})
    cpu_loss, cpu_launched, cpu_grads = runs["cpu"]
    gpu_loss, gpu_launched, gpu_grads = runs["gpu"]
    assert cpu_launched == (0, 0) and gpu_launched == (2, 2)
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-5)
    for name, g in gpu_grads.items():
        _assert_near(g, cpu_grads[name], 5e-4)


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


# ---------------------------------------------------------------------------
# the Gluon slice on the card
# ---------------------------------------------------------------------------

def _gluon_lm(ctx, hybrid, seed=3):
    import mxnet_tpu_torch as mx

    mx.random.seed(seed)
    net = tt.transformer_lm(vocab_size=97, units=64, hidden_size=128,
                            num_layers=2, num_heads=2, max_length=128)
    net.initialize(ctx=ctx)
    if hybrid:
        net.hybridize()
    return net


def test_gluon_lm_on_card_hybridized_equals_plain(cuda_device, monkeypatch):
    """The Gluon LM on the card: the hybridized forward and backward equal
    the plain ones bit for bit, and each step launches one flash forward
    and one flash backward per layer."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, nd

    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    x = np.random.RandomState(0).randint(0, 97, (2, 128))
    runs = []
    for hybrid in (False, True):
        net = _gluon_lm(mx.gpu(0), hybrid)  # seeded: the same weights
        xs = nd.array(x, dtype="int32", ctx=mx.gpu(0))
        before = (tfa.flash_attention_fwd.launches,
                  tfa.flash_attention_bwd.launches)
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(xs), xs)
        loss.backward()
        torch.cuda.synchronize()
        launched = (tfa.flash_attention_fwd.launches - before[0],
                    tfa.flash_attention_bwd.launches - before[1])
        assert launched == (2, 2)
        runs.append((loss.astorch().cpu(),
                     [p.grad().astorch().cpu()
                      for p in net.collect_params().values()]))
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)
    for a, b in zip(runs[0][1], runs[1][1], strict=True):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


_CARD_OPTS = ["sgd", "nag", "adam", "adamw", "lamb", "rmsprop", "adagrad",
              "adadelta", "ftrl", "ftml", "signum", "adamax", "nadam",
              "sgld", "dcasgd", "lars"]


@pytest.mark.parametrize("name", _CARD_OPTS)
def test_fused_update_equals_eager_on_card(cuda_device, name, monkeypatch):
    """The multi-tensor engine against MXNET_FUSED_UPDATE=0 on CUDA
    tensors, three steps, to 1e-6."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch.ndarray import NDArray

    shapes = [(64, 33), (7,), (3, 5, 2)]
    kw = {"sgd": {"momentum": 0.9, "wd": 0.01},
          "rmsprop": {"centered": True}, "dcasgd": {"momentum": 0.5},
          "signum": {"wd_lh": 0.001}}.get(name, {})
    results = []
    for fused in ("1", "0"):
        monkeypatch.setenv("MXNET_FUSED_UPDATE", fused)
        mx.random.seed(7)
        up = opt_mod.Updater(opt_mod.create(name, rescale_grad=0.5, **kw))
        rng = np.random.RandomState(1)
        ws = [NDArray(rng.randn(*s).astype(np.float32), ctx=mx.gpu(0))
              for s in shapes]
        for _ in range(3):
            gs = [NDArray(rng.randn(*s).astype(np.float32), ctx=mx.gpu(0))
                  for s in shapes]
            up.update_batch(list(range(len(ws))), gs, ws)
        assert (up._engine is not None) == (fused == "1")
        results.append([w.astorch().cpu() for w in ws])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_trainer_step_makes_no_host_sync_with_loss_scaler(cuda_device):
    """Trainer.step with a LossScaler attached (unscale, found-inf, skip,
    scale update, global-norm clip) reads nothing back from the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon, nd

    net = gluon.nn.Dense(8, in_units=16)
    net.initialize(ctx=mx.gpu(0))
    tr = gluon.Trainer(net.collect_params(), "adam",
                       {"learning_rate": 1e-3}, clip_global_norm=1.0)
    scaler = amp.init_trainer(tr, amp.LossScaler())
    x = nd.ones((4, 16), ctx=mx.gpu(0))
    for step in range(3):
        with autograd.record():
            loss = amp.scale_loss((net(x) ** 2).sum(), scaler)
        loss.backward()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tr.step(4)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(scaler.last_overflow) is False
    assert np.isfinite(net.weight.data().asnumpy()).all()


_CONV_CASES = [
    ("Convolution", [(4, 8, 17, 17), (16, 4, 3, 3), (16,)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "num_filter": 16,
      "num_group": 2}),
    ("Deconvolution", [(2, 8, 9, 9), (8, 4, 3, 3)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
      "num_filter": 4}),
    ("BatchNorm", [(8, 16, 7, 7), (16,), (16,), (16,), (16,)],
     {"fix_gamma": False, "output_mean_var": True, "_train": True}),
    ("Pooling", [(4, 8, 15, 15)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
      "pool_type": "max"}),
    ("Pooling", [(4, 8, 16, 16)],
     {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
      "pooling_convention": "full", "count_include_pad": False}),
    ("Pooling", [(4, 8, 7, 7)], {"pool_type": "avg", "global_pool": True}),
]


@pytest.mark.parametrize("name,shapes,kwargs", _CONV_CASES,
                         ids=["conv", "deconv", "batchnorm", "maxpool",
                              "avgpool_full", "global_avgpool"])
def test_conv_ops_on_card_match_cpu(cuda_device, name, shapes, kwargs):
    """The convolution stack on the card (cuDNN with TF32 off, the card's
    reductions) against the same op on the CPU, forward and input
    gradients under seeded head gradients: f32 within 1e-4 of
    max(1, |cpu|) (sums in other orders)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    rng = np.random.RandomState(0)
    arrays = [rng.uniform(0.5, 1.5, s).astype(np.float32) for s in shapes]
    runs = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            xs = [nd.array(a) for a in arrays]
            for x in xs:
                x.attach_grad()
            with autograd.record():
                out = getattr(nd, name)(*xs, **kwargs)
            outs = list(out) if isinstance(out, tuple) else [out]
            seeds = [nd.array(np.random.RandomState(7 + i).randn(*o.shape)
                              .astype(np.float32))
                     for i, o in enumerate(outs)]
            autograd.backward(outs, seeds)
            runs[ctx.device_type] = ([o.astorch().cpu() for o in outs],
                                     [x.grad.astorch().cpu() for x in xs])
            assert all(o.astorch().device == ctx.torch_device()
                       for o in outs)
    for got, want in zip(runs["gpu"][0] + runs["gpu"][1],
                         runs["cpu"][0] + runs["cpu"][1]):
        _assert_near(got, want, 1e-4)


def test_conv_bn_trainer_on_card_matches_trainer_on_cpu(cuda_device):
    """A conv + BatchNorm net (the reference's ResNet-shaped regression
    net, tests/test_parallel.py:185, its convolutions without the bias
    whose gradient before BatchNorm is rounding noise, as in ResNet's)
    through the Gluon ShardedTrainer on
    a one-device mesh, SGD momentum as bench.py's, from the same weights
    on the card and on the CPU: the first step's loss, every gradient and
    the running statistics within 1e-4 of their largest element (sums in
    other orders), and three steps of finite, falling losses. (Through a
    ResNet-18 thumbnail at a random start the first layer's gradients of
    an H100 and the CPU differ by 3.5e-3 of their largest element: each
    of 18 BatchNorm backwards cancels most of its input gradient.)"""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd, parallel
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.utils import set_params_from_numpy

    rng = np.random.RandomState(0)
    x = rng.rand(8, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.int32)
    weights, runs = None, {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            mx.random.seed(0)
            net = nn.HybridSequential()
            net.add(nn.Conv2D(8, 3, padding=1, in_channels=3,
                              use_bias=False),
                    nn.BatchNorm(), nn.Activation("relu"),
                    nn.Conv2D(8, 3, padding=1, in_channels=8,
                              use_bias=False),
                    nn.BatchNorm(), nn.Flatten(), nn.Dense(4))
            net.initialize()
            net(nd.array(x))
            if weights is None:
                weights = {k: p.data().asnumpy() for k, p in
                           net._collect_params_with_prefix().items()}
            set_params_from_numpy(net, weights)
            tr = parallel.ShardedTrainer(
                net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                parallel.make_mesh({"dp": 1}), optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4})
            assert tr.device.type == ("cuda" if ctx == mx.gpu(0) else "cpu")
            loss, grads, aux = tr.value_and_grad(nd.array(x), nd.array(y))
            by_name = {p.name: k for k, p in
                       net._collect_params_with_prefix().items()}
            first = {by_name[n]: g.cpu() for n, g in {**grads, **aux}
                     .items()}
            losses = [float(tr.step(nd.array(x), nd.array(y)).asnumpy())
                      for _ in range(3)]
            runs[ctx.device_type] = (float(loss), first, losses)
    cpu_loss, cpu_first, _ = runs["cpu"]
    gpu_loss, gpu_first, gpu_losses = runs["gpu"]
    _assert_near(torch.tensor(gpu_loss), torch.tensor(cpu_loss), 1e-4)
    assert set(gpu_first) == set(cpu_first) and any(
        "running_mean" in k for k in gpu_first)
    for k, want in cpu_first.items():
        err = float((gpu_first[k] - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-12, (k, err)
    assert np.isfinite(gpu_losses).all() and gpu_losses[-1] < gpu_losses[0]


# ---------------------------------------------------------------------------
# slice 6: Module, Executor and .params files on the card
# ---------------------------------------------------------------------------

def _module_mlp():
    from mxnet_tpu_torch import symbol as sym

    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=3, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def test_module_and_executor_default_to_the_card(cuda_device):
    """Module, simple_bind and nd.load with no context land on cuda:0; a
    step on the card equals the same step on the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.module import Module

    exe = _module_mlp().simple_bind(data=(4, 5))
    assert exe.arg_dict["fc1_weight"].astorch().is_cuda
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    init = {"fc1_weight": rng.randn(8, 5).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(8, np.float32),
            "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(3, np.float32)}
    weights = []
    for ctx in (None, mx.cpu()):
        mod = Module(_module_mlp(), context=ctx)
        mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
        mod.init_params(arg_params=init)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        with mx.Context(mod._context):
            batch = DataBatch([nd.array(x)], [nd.array(y)])
        mod.forward_backward(batch)
        mod.update()
        w = mod.get_params()[0]["fc1_weight"]
        assert w.astorch().is_cuda == (ctx is None)
        weights.append(w.asnumpy())
    np.testing.assert_allclose(weights[0], weights[1], rtol=1e-5, atol=1e-6)


def test_nd_load_lands_on_the_card(cuda_device, tmp_path):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    path = str(tmp_path / "a.params")
    with mx.cpu():
        nd.save(path, {"w": nd.array(np.arange(6, dtype=np.float32)),
                       "h": nd.array(np.ones(3, np.float32)).astype(
                           "bfloat16")})
    out = nd.load(path)
    assert out["w"].astorch().device == torch.device("cuda", 0)
    assert out["h"].dtype == torch.bfloat16 and out["h"].astorch().is_cuda
    np.testing.assert_array_equal(out["w"].asnumpy(), np.arange(6))
    assert nd.load(path, ctx=mx.cpu())["w"].context == mx.cpu()


# ---------------------------------------------------------------------------
# the data plane, the monitor and fold_bn on the card
# ---------------------------------------------------------------------------

def _write_jpeg_records(prefix, n, size):
    from mxnet_tpu_torch.io.recordio import (IRHeader, MXIndexedRecordIO,
                                             pack_img)

    rec = MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    rng = np.random.RandomState(0)
    for i in range(n):
        img = rng.randint(0, 255, (size, size, 3), np.uint8)
        rec.write_idx(i, pack_img(IRHeader(0, float(i % 10), i, 0), img,
                                  quality=80))
    rec.close()
    return prefix + ".rec"


def test_pin_memory_loader_batches_arrive_on_cuda(cuda_device):
    """pin_memory=True: host-made batches reach cuda:0 by one non_blocking
    copy each, bitwise equal to the same loader's batches on the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import (SyntheticImageDataset,
                                                   transforms)

    ds = SyntheticImageDataset(length=40, shape=(3, 32, 32), num_classes=10)
    ds = ds.transform_first(transforms.Normalize((0.5, 0.4, 0.3),
                                                 (0.2, 0.2, 0.2)))
    card = []
    for data, label in DataLoader(ds, batch_size=8, num_workers=3,
                                  pin_memory=True, last_batch="discard"):
        assert data.astorch().device == cuda_device
        assert label.astorch().device == cuda_device
        # work queued behind the copy on the consumer's stream
        card.append((data.astorch() * 1.0).cpu().numpy())
    with mx.cpu():
        host = [d.asnumpy() for d, _ in DataLoader(ds, batch_size=8)]
    assert len(card) == len(host) == 5
    for a, b in zip(card, host):
        np.testing.assert_array_equal(a, b)


def test_prefetch_stream_bitwise_equal_serial_read(cuda_device, tmp_path):
    """PrefetchingIter copies on its own stream from pinned memory; the
    consumer's stream waits for each batch. With the card busy between
    batches, every prefetched batch still equals a serial read of the same
    seeded iterator, bitwise."""
    from mxnet_tpu_torch.io import ImageRecordIter, PrefetchingIter

    uri = _write_jpeg_records(str(tmp_path / "r"), 48, 64)
    kw = dict(path_imgrec=uri, data_shape=(3, 56, 56), batch_size=8,
              rand_crop=True, rand_mirror=True, resize=60,
              preprocess_threads=2, dtype="uint8")
    np.random.seed(7)
    serial = [(b.data[0].asnumpy(), b.label[0].asnumpy())
              for b in ImageRecordIter(**kw)]
    np.random.seed(7)
    it = PrefetchingIter(ImageRecordIter(**kw), prefetch=3)
    busy = torch.randn(2048, 2048, device=cuda_device)
    got = []
    for b in it:
        assert b.data[0].astorch().device == cuda_device
        for _ in range(4):
            busy = torch.tanh(busy @ busy) * 0.5
        got.append((b.data[0].astorch().float().sum().item(),
                    b.data[0].asnumpy(), b.label[0].asnumpy()))
    it.close()
    assert len(got) == len(serial) == 6
    for (_, d, lab), (sd, sl) in zip(got, serial):
        np.testing.assert_array_equal(d, sd)
        np.testing.assert_array_equal(lab, sl)


def test_prefetching_ndarray_iter_on_card(cuda_device):
    from mxnet_tpu_torch.io import NDArrayIter, PrefetchingIter

    x = np.arange(64, dtype=np.float32).reshape(32, 2)
    it = PrefetchingIter(NDArrayIter(x, np.zeros(32, np.float32),
                                     batch_size=4), prefetch=3)
    got = np.concatenate([b.data[0].asnumpy() for b in it])
    it.close()
    np.testing.assert_array_equal(got, x)


def test_monitor_and_fold_bn_on_card(cuda_device):
    """Monitor stats of a net on the card equal the same net's on the CPU
    (rtol 1e-6), and fold_bn keeps the folded weights on the card."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import block

    stats, weights = [], None
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx:
            block._SCOPE.counters = {}  # the same block names on both
            net = mx.gluon.nn.HybridSequential()
            net.add(mx.gluon.nn.Dense(6, in_units=4),
                    mx.gluon.nn.Dense(3, in_units=6))
            net.initialize()
            params = list(net.collect_params().values())
            if weights is None:  # the card's net takes the CPU net's weights
                weights = [p.data().asnumpy() for p in params]
            for p, w in zip(params, weights):
                p.set_data(w)
            net.hybridize()
            mon = mx.monitor.Monitor(1, sort=True)
            mon.install_gluon(net)
            mon.tic()
            net(nd.array(np.linspace(-1, 1, 8, dtype=np.float32)
                         .reshape(2, 4)))
            stats.append(mon.toc())
    assert [t for _, t, _ in stats[0]] == [t for _, t, _ in stats[1]]
    for (_, _, a), (_, _, b) in zip(*stats):
        np.testing.assert_allclose(a, b, rtol=1e-6)

    data = mx.sym.Variable("data")
    conv = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                              no_bias=True, name="c")
    out = mx.sym.BatchNorm(conv, fix_gamma=False, name="b")
    rng = np.random.RandomState(0)
    args = {"c_weight": nd.array(rng.rand(4, 3, 3, 3).astype(np.float32)),
            "b_gamma": nd.array(rng.rand(4).astype(np.float32) + 0.5),
            "b_beta": nd.array(rng.rand(4).astype(np.float32))}
    aux = {"b_moving_mean": nd.array(rng.rand(4).astype(np.float32)),
           "b_moving_var": nd.array(rng.rand(4).astype(np.float32) + 0.5)}
    x = nd.array(rng.rand(2, 3, 8, 8).astype(np.float32))
    want = out.bind(args={**args, "data": x}, aux_states=aux).forward()[0]
    folded = out.optimize_for("fold_bn", args, aux)
    assert folded._optimized_args["c_bias"].astorch().is_cuda
    got = folded.bind(args={**folded._optimized_args, "data": x}).forward()[0]
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bidir"])
def test_rnn_op_runs_cudnn_and_matches_the_loop(cuda_device, mode, bidir):
    """On the card the RNN op runs cuDNN (its route counter moves); its
    outputs and gradients equal the per-step loop's on the same card to
    1e-4 of each tensor's largest magnitude. cuDNN's f32 RNN is not exact
    to the last bits, so elementwise f32 limits do not apply. On an
    NVIDIA H100 (torch 2.11, CUDA 12.8) the worst of these ratios was
    6.32e-5 (rnn_tanh, bidirectional, the gradient of h0: room 1.58x),
    every other tensor's at most 3.16e-5 (room 3.16x), bitwise the same
    in three processes; each case prints its ratios (pytest -s)."""
    from mxnet_tpu_torch.ops import rnn as trnn
    from mxnet_tpu_torch.ops.registry import get_op

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    T, N, C, H, L = 7, 5, 6, 8, 2
    dirs = 2 if bidir else 1
    size = trnn.rnn_param_size(mode, C, H, L, bidir)

    def rand(*shape, scale=0.4):
        return (torch.randn(shape, generator=gen, device=cuda_device)
                * scale).requires_grad_(True)

    ins = [rand(T, N, C, scale=1.0), rand(size), rand(L * dirs, N, H)]
    if mode == "lstm":
        ins.append(rand(L * dirs, N, H))
    kw = dict(state_size=H, num_layers=L, mode=mode, bidirectional=bidir,
              state_outputs=True)
    before = trnn.rnn_calls["cudnn"]
    got = get_op("RNN").fn(*ins, **kw)
    assert trnn.rnn_calls["cudnn"] == before + 1
    g_got = torch.autograd.grad(sum(o.square().sum() for o in got), ins)
    layers = trnn.rnn_unpack_params(ins[1], mode, C, H, L, bidir)
    out, hs, cs = trnn.rnn_loop(ins[0], layers, ins[2],
                                ins[3] if mode == "lstm" else None, mode,
                                0.0, False)
    want = [out, torch.stack(hs)] + ([torch.stack(cs)] if cs else [])
    g_want = torch.autograd.grad(sum(o.square().sum() for o in want), ins)
    names = ["out", "h", "c"][:len(want)] + [
        "d_data", "d_params", "d_h0", "d_c0"][:len(ins)]
    errs = {}
    for name, a, b in zip(names, list(got) + list(g_got),
                          want + list(g_want)):
        assert a.shape == b.shape
        errs[name] = float((a - b).detach().abs().max()
                           / b.detach().abs().max().clamp_min(1e-30))
    # one line per case (pytest -s) so a passing run records the margin
    print(f"rnn_cudnn_vs_loop {mode} {'bidir' if bidir else 'uni'} "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items()))
    assert max(errs.values()) <= 1e-4, errs


def test_rnn_op_on_card_raises_without_cudnn(cuda_device, monkeypatch):
    from mxnet_tpu_torch.ops.registry import get_op

    x = torch.zeros((3, 2, 4), device=cuda_device)
    monkeypatch.setattr(torch.backends.cudnn, "enabled", False)
    with pytest.raises(MXNetError, match="cuDNN"):
        get_op("RNN").fn(x, torch.zeros(220, device=cuda_device),
                         torch.zeros((1, 2, 5), device=cuda_device),
                         torch.zeros((1, 2, 5), device=cuda_device),
                         state_size=5, num_layers=1, mode="lstm")


# ---------------------------------------------------------------------------
# detection, image and nn extras, int8 products
# ---------------------------------------------------------------------------

def _op(name):
    from mxnet_tpu_torch.ops.registry import get_op

    return get_op(name).fn


def _on(dev, *arrays):
    return [None if a is None else torch.from_numpy(np.array(a)).to(dev)
            for a in arrays]


def _nms_rows(seed, b=4, n=700, levels=6):
    """Rows [id, score, l, t, r, b] with many tied scores."""
    rng = np.random.RandomState(seed)
    d = np.zeros((b, n, 6), np.float32)
    d[..., 0] = rng.randint(0, 4, (b, n))
    d[..., 1] = np.round(rng.rand(b, n) * levels) / levels
    d[..., 2:4] = rng.rand(b, n, 2) * 0.7
    d[..., 4:6] = d[..., 2:4] + 0.05 + rng.rand(b, n, 2) * 0.3
    return d


@pytest.mark.parametrize("topk", [-1, 400])
@pytest.mark.parametrize("id_index", [-1, 0])
def test_box_nms_on_card_equals_cpu_bitwise(cuda_device, topk, id_index):
    from mxnet_tpu_torch.ops import contrib

    d = _nms_rows(topk + id_index + 2)
    kw = dict(overlap_thresh=0.45, valid_thresh=0.1, topk=topk,
              id_index=id_index)
    iters = contrib.nms_keep_fixed_point.iterations
    got = _op("_contrib_box_nms")(*_on(cuda_device, d), **kw)
    assert contrib.nms_keep_fixed_point.iterations > iters
    want = _op("_contrib_box_nms")(torch.from_numpy(d), **kw)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("t", [2, 3, 6, 7, 10, 11])
def test_box_nms_chain_on_card_equals_plain_loop(cuda_device, t):
    """Each box overlaps only the next, so the keep mask alternates and
    the fixed point needs t - 1 rounds: held bitwise to the per-row loop,
    for every t modulo the rounds between convergence tests."""
    from mxnet_tpu_torch.ops import contrib

    d = np.zeros((1, t, 6), np.float32)
    d[0, :, 1] = np.linspace(0.9, 0.5, t, dtype=np.float32)
    d[0, :, 2] = np.arange(t, dtype=np.float32) * 0.3
    d[0, :, 4] = d[0, :, 2] + 1.0
    d[0, :, 5] = 1.0
    iters = contrib.nms_keep_fixed_point.iterations
    got = _op("_contrib_box_nms")(*_on(cuda_device, d), overlap_thresh=0.45)
    assert contrib.nms_keep_fixed_point.iterations > iters
    want = contrib.box_nms_plain(torch.from_numpy(d), overlap_thresh=0.45)
    assert torch.equal(got.cpu(), want)
    assert (got[0, :, 0].cpu() >= 0).tolist() == [i % 2 == 0
                                                   for i in range(t)]


@pytest.mark.parametrize("nms_topk", [-1, 400])
def test_multibox_detection_on_card_equals_cpu(cuda_device, nms_topk):
    rng = np.random.RandomState(1)
    anchors = _op("_contrib_MultiBoxPrior")(
        torch.zeros(1, 1, 20, 20), sizes=(0.2, 0.3), ratios=(1, 2, 0.5)) \
        .numpy()
    n = anchors.shape[1]
    prob = rng.rand(2, 6, n).astype(np.float32)
    prob[:, :, ::7] = prob[:, :, :1]  # tied scores
    prob /= prob.sum(1, keepdims=True)
    loc = (rng.randn(2, n * 4) * 0.3).astype(np.float32)
    kw = dict(nms_threshold=0.45, threshold=0.01, nms_topk=nms_topk)
    fn = _op("_contrib_MultiBoxDetection")
    from mxnet_tpu_torch.ops.contrib import multibox_decode

    got = fn(*_on(cuda_device, prob, loc, anchors), **kw)
    # the card's rows against the plain per-row loop on the card's own
    # decoded rows (decode may differ by rounding between devices)
    decoded = multibox_decode(*_on(cuda_device, prob, loc, anchors),
                              threshold=0.01)
    want = _op("_contrib_box_nms")(decoded.cpu(), overlap_thresh=0.45,
                                   valid_thresh=0.01, topk=nms_topk,
                                   id_index=0)
    assert torch.equal(got.cpu(), want)
    cpu = fn(*[torch.from_numpy(a) for a in (prob, loc, anchors)], **kw)
    assert torch.equal(got[..., 0].cpu() >= 0, cpu[..., 0] >= 0)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-6)


def test_multibox_target_on_card_equals_cpu(cuda_device):
    rng = np.random.RandomState(2)
    anchors = _op("_contrib_MultiBoxPrior")(
        torch.zeros(1, 1, 19, 19), sizes=(0.2, 0.272), ratios=(1, 2, 0.5))
    n = anchors.shape[1]
    label = np.full((8, 3, 5), -1, np.float32)
    for b in range(8):
        for k in range(rng.randint(1, 4)):
            x0, y0 = rng.rand(2) * 0.6
            w, h = 0.2 + rng.rand(2) * 0.2
            label[b, k] = [rng.randint(0, 20), x0, y0, x0 + w, y0 + h]
    cls_pred = np.zeros((8, 21, n), np.float32)
    fn = _op("_contrib_MultiBoxTarget")
    got = fn(anchors.to(cuda_device), *_on(cuda_device, label, cls_pred))
    want = fn(anchors, torch.from_numpy(label), torch.from_numpy(cls_pred))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.parametrize("k", [147, 576, 4608])
@pytest.mark.parametrize("rows", [3, 16, 50])
def test_quantized_products_on_card_are_exact(cuda_device, k, rows):
    from mxnet_tpu_torch.ops import quantization as q

    rng = np.random.RandomState(k + rows)
    n = 13  # not a multiple of 8
    x = rng.randint(-127, 128, (rows, k)).astype(np.int8)
    w = rng.randint(-127, 128, (n, k)).astype(np.int8)
    r = [np.array([v], np.float32) for v in (-1.0, 1.0, -1.0, 1.0)]
    before = q.int8_matmul.launches
    acc = _op("_contrib_quantized_fully_connected")(
        *_on(cuda_device, x, w, None, *r), num_hidden=n, no_bias=True)[0]
    assert q.int8_matmul.launches == before + 1
    assert acc.dtype == torch.int32
    assert torch.equal(acc.cpu(), q.int8_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(w).t()))
    # a convolution with the same k: k = c * 3 * 3 (147 = 3 * 7 * 7)
    kh = 7 if k == 147 else 3
    c = k // (kh * kh)
    xc = rng.randint(-127, 128, (2, c, 9, 9)).astype(np.int8)
    wc = rng.randint(-127, 128, (n, c, kh, kh)).astype(np.int8)
    kw = dict(kernel=(kh, kh), pad=(kh // 2, kh // 2), num_filter=n,
              no_bias=True)
    got = _op("_contrib_quantized_conv")(*_on(cuda_device, xc, wc, None, *r),
                                         **kw)[0]
    want = q.int8_conv_plain(torch.from_numpy(xc), torch.from_numpy(wc),
                             (1, 1), (kh // 2, kh // 2), (1, 1), 1)
    assert torch.equal(got.cpu(), want)


def test_quantize_dequantize_on_card_bitwise(cuda_device):
    rng = np.random.RandomState(3)
    x = (rng.randn(10000) * 3).astype(np.float32)
    lo, hi = np.array([-4.1], np.float32), np.array([5.3], np.float32)
    for name, args in (("_contrib_quantize", (x, lo, hi)),
                       ("_contrib_quantize_v2", (x,))):
        got = _op(name)(*_on(cuda_device, *args))
        want = _op(name)(*[torch.from_numpy(a) for a in args])
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        deq = _op("_contrib_dequantize")(*got)
        assert torch.equal(deq.cpu(), _op("_contrib_dequantize")(*want))


def test_int8_product_raises_off_int8(cuda_device):
    from mxnet_tpu_torch.ops import quantization as q

    a = torch.ones(20, 8, device=cuda_device)
    with pytest.raises(TypeError, match="int8"):
        q.int8_matmul(a, a.t())


_EXTRA_CASES = {
    "roi_align": ("_contrib_ROIAlign",
                  lambda r: [r.randn(2, 3, 9, 11).astype(np.float32),
                             np.array([[0, 1.0, 2.0, 13.0, 15.0],
                                       [1, 5.5, 3.2, 18.0, 16.0]],
                                      np.float32)],
                  dict(pooled_size=(3, 3), spatial_scale=0.5)),
    "deformable": ("_contrib_DeformableConvolution",
                   lambda r: [r.randn(2, 4, 7, 8).astype(np.float32),
                              (r.randn(2, 18, 7, 8) * 1.5).astype(
                                  np.float32),
                              r.randn(6, 4, 3, 3).astype(np.float32),
                              r.randn(6).astype(np.float32)],
                   dict(kernel=(3, 3), pad=(1, 1), num_filter=6)),
    "bilinear_resize": ("_contrib_BilinearResize2D",
                        lambda r: [r.randn(2, 3, 8, 10).astype(np.float32)],
                        dict(height=5, width=13)),
    "adaptive_pool": ("_contrib_AdaptiveAvgPooling2D",
                      lambda r: [r.randn(2, 3, 7, 9).astype(np.float32)],
                      dict(output_size=(3, 4))),
    "sync_bn": ("_contrib_SyncBatchNorm",
                lambda r: [r.randn(4, 3, 5, 5).astype(np.float32),
                           np.ones(3, np.float32), np.zeros(3, np.float32),
                           np.zeros(3, np.float32), np.ones(3, np.float32)],
                dict(fix_gamma=False, _train=True)),
    "image_resize": ("_image_resize",
                     lambda r: [r.rand(2, 8, 10, 3).astype(np.float32)],
                     dict(size=(13, 5))),
    "upsampling": ("UpSampling",
                   lambda r: [r.randn(2, 3, 4, 5).astype(np.float32),
                              np.zeros((3, 1, 4, 4), np.float32)],
                   dict(scale=2, sample_type="bilinear", num_filter=3)),
    "spatial_transformer": ("SpatialTransformer",
                            lambda r: [r.randn(2, 3, 6, 7).astype(np.float32),
                                       np.array([[0.9, 0.1, 0.05, -0.1, 1.1,
                                                  0.0]] * 2, np.float32)],
                            dict(target_shape=(5, 4))),
    "correlation": ("Correlation",
                    lambda r: [r.rand(1, 3, 9, 9).astype(np.float32),
                               r.rand(1, 3, 9, 9).astype(np.float32)],
                    dict(kernel_size=3, max_displacement=2, stride2=2,
                         pad_size=2)),
    "lrn": ("LRN", lambda r: [r.randn(2, 7, 3, 4).astype(np.float32)], {}),
    "interleaved": ("_contrib_interleaved_matmul_selfatt_qk",
                    lambda r: [r.rand(6, 2, 24).astype(np.float32)],
                    dict(heads=2)),
}


@pytest.mark.parametrize("case", sorted(_EXTRA_CASES))
def test_new_ops_on_card_match_cpu(cuda_device, case):
    name, make, kw = _EXTRA_CASES[case]
    arrays = make(np.random.RandomState(4))
    fn = _op(name)
    got = fn(*_on(cuda_device, *arrays), **kw)
    want = fn(*[torch.from_numpy(a) for a in arrays], **kw)
    got = got[0] if isinstance(got, tuple) else got
    want = want[0] if isinstance(want, tuple) else want
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# batch serving, the numpy front end, sparse arrays and custom ops
# ---------------------------------------------------------------------------

def _serve_mlp(sym):
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    arg = {"fc1_weight": rng.randn(16, 6).astype(np.float32) * 0.3,
           "fc1_bias": rng.randn(16).astype(np.float32) * 0.1,
           "fc2_weight": rng.randn(4, 16).astype(np.float32) * 0.3,
           "fc2_bias": np.zeros(4, np.float32)}
    return net, arg


def test_inference_engine_on_card_equals_module_predict(cuda_device):
    """Each bucket's rows bitwise equal to Module.predict at that batch on
    the card, with cuDNN pinned (a convolution and BatchNorm in the
    graph), and within 1e-5 of the same engine on the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serve, sym
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module

    data = sym.Variable("data")
    net = sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                          name="c")
    net = sym.Activation(sym.BatchNorm(net, name="bn"), act_type="relu")
    net = sym.SoftmaxOutput(sym.FullyConnected(sym.Flatten(net),
                                               num_hidden=5, name="fc"),
                            name="softmax")
    rng = np.random.RandomState(1)
    x = rng.rand(8, 3, 12, 12).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.float32)
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mod = Module(net, context=mx.gpu(0))
        mod.fit(NDArrayIter(x, y, batch_size=4), num_epoch=1,
                optimizer_params={"learning_rate": 0.05})
        arg, aux = mod.get_params()
        engine = serve.InferenceEngine(net, arg, aux, buckets=(2, 4, 8),
                                       lint="off")
        cpu = serve.InferenceEngine(net, arg, aux, buckets=(2, 4, 8),
                                    lint="off", ctx=mx.cpu())
        q = rng.rand(8, 3, 12, 12).astype(np.float32)
        for b in (2, 4, 8):
            ref = mod.predict(NDArrayIter(q, None, batch_size=b)).asnumpy()
            for lo in range(0, 8, b):
                got = engine.predict(q[lo:lo + b])
                assert np.array_equal(got, ref[lo:lo + b]), (b, lo)
            np.testing.assert_allclose(engine.predict(q[:b]),
                                       cpu.predict(q[:b]), rtol=1e-5,
                                       atol=1e-6)
        assert engine.num_programs == 3
    finally:
        torch.backends.cudnn.deterministic = was


def test_serve_over_the_wire_on_card(cuda_device):
    from mxnet_tpu_torch import serve, sym

    net, arg = _serve_mlp(sym)
    engine = serve.InferenceEngine(net, arg, max_batch_size=8, lint="off")
    srv = serve.ServeServer(engine, port=0, max_linger_ms=1.0)
    srv.start()
    cli = serve.ServeClient("127.0.0.1", srv.port)
    try:
        x = np.random.RandomState(2).rand(5, 6).astype(np.float32)
        out, ver = cli.infer(x, return_version=True)
        assert ver == 0 and np.array_equal(out, engine.predict(x))
        assert cli.ready_version() == (True, 0)
        st = cli.stats()
        assert st["engine"]["num_programs"] >= 1
    finally:
        cli.close()
        srv.stop()


def test_numpy_front_end_on_card_matches_cpu(cuda_device):
    """An mx.np/npx step with a Custom op, on the card and on the CPU."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd

    mnp, npx = mx.np, mx.npx

    @mx.operator.register("card_test_swish")
    class _Prop(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * npx.sigmoid(in_data[0]))
            return _Op()

    def run(ctx):
        with ctx:
            rng = np.random.RandomState(4)
            x = mnp.array(rng.randn(16, 24).astype(np.float32))
            w = mnp.array(rng.randn(24, 8).astype(np.float32))
            w.attach_grad()
            with autograd.record():
                h = nd.Custom(mnp.matmul(x, w), op_type="card_test_swish")
                loss = mnp.sum(mnp.square(h))
            loss.backward()
            dense = rng.randn(6, 24).astype(np.float32)
            dense[dense < 0.5] = 0
            prod = nd.dot(nd.sparse.csr_matrix(dense), w)
            assert w.grad.context == ctx and prod.context == ctx
            return [loss.asnumpy(), w.grad.asnumpy(), prod.asnumpy(),
                    mnp.argsort(x, axis=1).asnumpy(),
                    mnp.divide(mnp.array([1, 2], dtype="int32"),
                               2).asnumpy()]

    card, host = run(mx.gpu(0)), run(mx.cpu())
    for c, h in zip(card, host):
        assert c.dtype == h.dtype
        np.testing.assert_allclose(c, h, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the serving fleet on the card
# ---------------------------------------------------------------------------

def _conv_checkpoints(mx, sym, prefix):
    """Two generations of a small conv net trained on the card, saved as
    Module checkpoints 1 and 2; returns (net, the Module)."""
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module

    data = sym.Variable("data")
    net = sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                          name="c")
    net = sym.Activation(sym.BatchNorm(net, name="bn"), act_type="relu")
    net = sym.SoftmaxOutput(sym.FullyConnected(sym.Flatten(net),
                                               num_hidden=5, name="fc"),
                            name="softmax")
    rng = np.random.RandomState(1)
    x = rng.rand(8, 3, 12, 12).astype(np.float32)
    y = rng.randint(0, 5, 8).astype(np.float32)
    mod = Module(net, context=mx.gpu(0))
    for epoch in (1, 2):
        mod.fit(NDArrayIter(x, y, batch_size=4), num_epoch=1,
                optimizer_params={"learning_rate": 0.05})
        mod.save_checkpoint(prefix, epoch)
    return net, mod


def test_fleet_of_card_replicas_answers_module_predict(cuda_device,
                                                       tmp_path):
    """Two card replicas behind a Router: every reply bitwise
    ``Module.predict``'s for the version it carries, through a kill, the
    restart and a fleet reload; the killed engine's memory comes back."""
    import gc
    import time
    import weakref

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serve, sym
    from mxnet_tpu_torch.io import NDArrayIter

    prefix = str(tmp_path / "conv")
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    pool = None
    try:
        net, mod = _conv_checkpoints(mx, sym, prefix)
        q = np.random.RandomState(2).rand(8, 3, 12, 12).astype(np.float32)
        refs = {}
        for ver, epoch in ((0, 1), (1, 2)):
            arg, aux = serve.load_params(prefix, epoch=epoch)
            mod.set_params(arg, aux)
            refs[ver] = {b: mod.predict(NDArrayIter(q, None, batch_size=b))
                         .asnumpy() for b in (2, 4, 8)}

        def factory():
            eng = serve.load(prefix, epoch=1, buckets=(2, 4, 8), lint="off")
            eng.warmup((3, 12, 12))
            srv = serve.ServeServer(eng, port=0, max_linger_ms=0.0)
            srv.start()
            return srv

        pool = serve.ReplicaPool.local(factory, 2, probe_interval=0.1,
                                       backoff_base=0.05).start()
        router = serve.Router(pool)

        def check(ver_want):
            for b in (2, 4, 8):
                for lo in range(0, 8, b):
                    outs, ver = router.infer([q[lo:lo + b]],
                                             deadline_ms=60000)
                    assert ver == ver_want
                    assert np.array_equal(outs[0], refs[ver][b][lo:lo + b])

        check(0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        dead = weakref.ref(pool.members()[1].handle.server._engine)
        pool.kill(1)
        check(0)
        m1 = pool.members()[1]
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not (
                m1.restarts >= 1 and m1.state == "ready"):
            time.sleep(0.05)
        assert m1.restarts >= 1 and m1.state == "ready"
        # the killed incarnation's engine, and so its parameters on the
        # card, are gone; what is allocated differs from before the kill
        # by less than a replica's parameters and the allocator's blocks
        deadline = time.monotonic() + 30
        while dead() is not None and time.monotonic() < deadline:
            gc.collect()
            time.sleep(0.05)
        assert dead() is None
        torch.cuda.synchronize()
        params = sum(4 * v.size for v in mod.get_params()[0].values())
        assert abs(torch.cuda.memory_allocated() - before) <= params + 65536
        assert router.reload(prefix, epoch=2) == 1
        check(1)
    finally:
        if pool is not None:
            pool.stop()
        torch.backends.cudnn.deterministic = was


def test_proc_replica_child_serves_on_the_card(cuda_device, tmp_path):
    """A child with no MXNET_SERVE_PLATFORM places its engine on the card
    and answers as the same engine in process."""
    import time

    from mxnet_tpu_torch import serve, sym
    from mxnet_tpu_torch.model import save_checkpoint
    from mxnet_tpu_torch import nd

    net, arg = _serve_mlp(sym)
    prefix = str(tmp_path / "mlp")
    save_checkpoint(prefix, 0, net, {k: nd.array(v) for k, v in arg.items()},
                    {})
    rep = serve.ProcReplica(prefix, env={"MXNET_SERVE_PLATFORM": ""},
                            log_path=str(tmp_path / "child.log"))
    rep.idx = 0
    addr = rep.start()
    cli = serve.ServeClient(*addr, timeout=5.0)
    try:
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline and rep.alive():
            try:
                if cli.ready():
                    break
            except serve.ServeError:
                pass
            time.sleep(0.1)
        assert rep.alive(), open(tmp_path / "child.log").read()[-2000:]
        assert cli.stats()["engine"]["device"] == "cuda:0"
        x = np.random.RandomState(3).rand(5, 6).astype(np.float32)
        eng = serve.InferenceEngine(net, arg, max_batch_size=32, lint="off")
        assert np.array_equal(cli.infer(x), eng.predict(x))
    finally:
        cli.close()
        rep.kill()
        rep.stop()


def test_fleet_streams_through_the_paged_kernel_equal_plain(cuda_device,
                                                          monkeypatch):
    """Greedy streams relayed by a FleetServer from two card replicas (the
    paged kernel) equal an in-process engine's on the plain version."""
    import threading

    from mxnet_tpu_torch import serve

    small = dict(vocab_size=97, units=32, hidden_size=64, num_layers=2,
                 num_heads=4, max_length=64)
    kw = dict(slots=4, page_size=8, num_pages=16, prompt_buckets=[8, 16])
    cfg, params = _seeded_lm(**small)
    prompts = [np.arange(1, n + 1) % 90 + 1 for n in (3, 8, 13, 5)]
    monkeypatch.setenv("MXNET_DECODE_ATTN", "plain")
    eng = DecodeEngine(cfg, params, device=cuda_device, **kw)
    sched = DecodeScheduler(eng, max_new_tokens=6)
    want = [list(sched.generate(p)) for p in prompts]
    sched.close()
    monkeypatch.setenv("MXNET_DECODE_ATTN", "kernel")

    def factory():
        e = DecodeEngine(cfg, params, device=cuda_device, **kw)
        e.warmup()
        srv = serve.ServeServer(decode=DecodeScheduler(e, max_new_tokens=6),
                                port=0)
        srv.start()
        return srv

    pool = serve.ReplicaPool.local(factory, 2, probe_interval=0.2).start()
    front = serve.FleetServer(serve.Router(pool), port=0)
    front.start()
    before = tfa.flash_decode_attention.launches
    got = [None] * len(prompts)
    try:
        def stream(i):
            cli = serve.ServeClient("127.0.0.1", front.port)
            got[i] = list(cli.generate(prompts[i]))
            cli.close()

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        front.stop()
        pool.stop()
    assert got == want
    assert tfa.flash_decode_attention.launches > before


def _device_store_run(ctx):
    """Merged pushes, a batched optimizer on the store, row_sparse_pull
    and 2-bit compression through kv.create("device") on ``ctx``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import nd

    rng = np.random.RandomState(0)
    vals = [rng.randn(6, 5).astype(np.float32) for _ in range(4)]
    got, where = {}, set()
    kv = mx.kv.create("device")
    kv.init("a", nd.array(vals[0], ctx=ctx))
    kv.push("a", [nd.array(v, ctx=ctx) for v in vals[1:]])
    out = nd.zeros((6, 5), ctx=ctx)
    kv.pull("a", out=out)
    got["merged"], where = out.asnumpy(), {out.context}
    rows = nd.zeros((2, 5), ctx=ctx)
    kv.row_sparse_pull("a", out=rows, row_ids=nd.array(
        np.array([5, 1], np.int32), ctx=ctx))
    got["rows"] = rows.asnumpy()
    kv2 = mx.kv.create("device")
    kv2.set_optimizer(mx.optimizer.create("adam", learning_rate=0.1))
    for i in range(3):
        kv2.init(i, nd.array(vals[i], ctx=ctx))
    kv2.push([0, 1, 2], [nd.array(v, ctx=ctx) for v in vals[1:]])
    outs = [nd.zeros((6, 5), ctx=ctx) for _ in range(3)]
    kv2.pull([0, 1, 2], out=outs)
    got["adam"] = [o.asnumpy() for o in outs]
    direct = [nd.array(vals[i], ctx=ctx) for i in range(3)]
    upd = mx.optimizer.Updater(mx.optimizer.create("adam",
                                                   learning_rate=0.1))
    for i in range(3):
        upd(i, nd.array(vals[i + 1], ctx=ctx), direct[i])
    got["adam_direct"] = [d.asnumpy() for d in direct]
    kv3 = mx.kv.create("nccl")
    kv3.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv3.init("c", nd.zeros((6, 5), ctx=ctx))
    kv3.push("c", nd.array(vals[3], ctx=ctx))
    kv3.pull("c", out=out)
    got["two_bit"] = out.asnumpy()
    where |= {o.context for o in outs} | {kv3._store["c"].context}
    return got, where


def test_device_store_on_card_matches_cpu(cuda_device):
    import mxnet_tpu_torch as mx

    card, where = _device_store_run(mx.gpu(0))
    host, _ = _device_store_run(mx.cpu())
    assert where == {mx.gpu(0)}
    for k in ("merged", "rows", "two_bit"):
        np.testing.assert_array_equal(card[k], host[k], err_msg=k)
    for a, b, c in zip(card["adam"], host["adam"], card["adam_direct"]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-6)


def test_gloo_two_ranks_share_the_card(cuda_device):
    """Two dist_sync ranks on one card form a gloo group (NCCL refuses two
    ranks on one card) and pass the known values on CUDA tensors."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", "2",
         sys.executable, "-m", "mxnet_tpu_torch.tools.dist_worker", "known",
         "dist_sync", "--device", "cuda"], cwd=repo, timeout=300,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, proc.stdout[-3000:]
    assert proc.stdout.count("device=cuda backend=gloo: OK") == 2
    assert proc.stdout.count("gloo (2 ranks a card)") == 2


def test_decode_capture_on_card_equals_cpu(cuda_device):
    """The device plane's cost records of a small ``DecodeEngine``'s
    prefill and step on the card equal the same engine's on the CPU: the
    paged kernel is counted once by its formula on both (the card launches
    it, the CPU computes its plain version), the other ops by dispatch.
    Only the peak-memory fields, each allocator's own, may differ."""
    from mxnet_tpu_torch import obs

    cfg, params = _seeded_lm(vocab_size=97, units=32, hidden_size=64,
                             num_layers=2, num_heads=4, max_length=64)
    kw = dict(slots=4, page_size=8, num_pages=24, prompt_buckets=[8, 16])
    was = obs.enabled()
    obs.enable()
    try:
        recs = {}
        for dev in ("cpu", cuda_device):
            eng = DecodeEngine(cfg, params, device=dev, **kw)
            eng.warmup()
            recs[str(dev)] = {e["label"]: e for e in eng.compile_log}
    finally:
        if not was:
            obs.disable()
        obs.reset()
    cpu, card = recs["cpu"], recs[str(cuda_device)]
    assert set(cpu) == set(card) == {"prefill8", "prefill16", "step"}
    for label in cpu:
        for key in ("flops", "bytes_accessed", "argument_bytes",
                    "output_bytes", "dtype", "kernels"):
            assert card[label][key] == cpu[label][key], (label, key)
        assert card[label]["device"] == "cuda"
    step = card["step"]["kernels"]["paged_decode_attention"]
    assert step["calls"] == cfg["layers"]


def test_fleet_accounting_books_card_time_as_compute(cuda_device):
    """A one-process ``Module.fit`` of an LM on the card with the
    training-fleet plane on: the ``compute`` category a step is at least
    0.9 x the forward+backward's CUDA-event time. The backward phase ends
    with a synchronize of the card while the plane records, so the queued
    device work is booked as compute, not as the next host read's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import obs
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.obs import fleetstats

    vocab, seq, batch, steps = 8000, 1024, 8, 6
    ctx = mx.gpu(0)
    mx.random.seed(0)
    net = tt.transformer_lm(vocab_size=vocab, units=1024, hidden_size=4096,
                            num_layers=2, num_heads=8, max_length=seq)
    net.initialize(ctx=ctx)
    with mx.name.NameManager():
        logits = net(sym.var("data", shape=(batch, seq)))
        label = sym.var("softmax_label", shape=(batch, seq))
        out = sym.SoftmaxOutput(logits.reshape((-1, vocab)),
                                label.reshape((-1,)), name="softmax")
    arg_params = {p.name: p.data() for p in net.collect_params().values()}
    xs = np.random.RandomState(1).randint(
        0, vocab, (steps * batch, seq)).astype(np.float32)
    with ctx:
        it = NDArrayIter(xs, xs, batch_size=batch)
    mod = Module(out, context=ctx)
    fit_fb, events = mod.forward_backward, []

    def timed(data_batch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fit_fb(data_batch)
        ev[1].record()
        events.append(ev)

    mod.forward_backward = timed
    was = obs.enabled()
    obs.enable()
    fleetstats.reset()
    try:
        mod.fit(it, num_epoch=1, eval_metric="ce", optimizer="sgd",
                optimizer_params={"learning_rate": 1e-5},
                arg_params=arg_params, handle_preemption=False)
        windows = list(fleetstats._ACC.windows)
    finally:
        fleetstats.reset()
        if not was:
            obs.disable()
        obs.reset()
    torch.cuda.synchronize()
    fb_s = sum(a.elapsed_time(b) for a, b in events) / len(events) / 1e3
    summary = fleetstats.summarize_windows(windows)
    assert summary["steps"] == steps
    assert summary["phases"]["compute"] >= 0.9 * fb_s, (summary, fb_s)


def test_kernel_entry_loads_without_nvcc_and_rejects_truncated(
        cuda_device, tmp_path, monkeypatch):
    """The program cache's kernel entries on the card (``progcache``,
    ``ops/_kernels``): with a temporary build dir and cache, the paged
    kernel built by ``nvcc`` goes into the cache; from a second empty build
    dir it loads from its entry with no ``nvcc`` run, the same bytes, and
    its output is bitwise the built library's; a truncated entry is a
    counted reject followed by a build that replaces it."""
    from mxnet_tpu_torch import progcache
    from mxnet_tpu_torch.ops import _kernels

    name = "paged_decode_attention"
    q, k, v, table, lengths = _case(cuda_device, torch.float32, 64, seed=9)
    pc = progcache.ProgramCache(str(tmp_path / "pc"))

    def fresh(build_dir):  # as a new process on an empty build dir
        _kernels._loaded.pop(name, None)
        _kernels._entries.pop(name, None)
        monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / build_dir)

    def run():
        out = tfa.flash_decode_attention(q, k, v, table, lengths)
        torch.cuda.synchronize()
        return out

    try:
        fresh("build1")
        builds = _kernels.build_stats()["count"]
        _kernels.load(name, cache=pc)
        assert _kernels.build_stats()["count"] == builds + 1
        built = _kernels._lib_path(name).read_bytes()
        want = run()
        key = _kernels.kernel_key(name)
        assert pc.stats["write"] == 1 and pc.has(key)

        fresh("build2")
        _kernels.preload({name: key.digest}, pc)
        assert _kernels.build_stats()["count"] == builds + 1
        assert pc.stats["hit"] == 1 and pc.stats["reject"] == 0
        assert _kernels._lib_path(name).read_bytes() == built
        assert torch.equal(run(), want)

        path = pc._path(key.digest)
        with open(path, "rb") as f:
            raw = f.read()
        with open(path, "wb") as f:
            f.write(raw[:len(raw) // 2])
        fresh("build3")
        _kernels.load(name, cache=pc)
        assert pc.stats["reject"] == 1
        assert _kernels.build_stats()["count"] == builds + 2
        assert isinstance(pc._read_entry(path, key, "gpu"), tuple)
        assert torch.equal(run(), want)
    finally:
        fresh("build1")
        _kernels._loaded.pop(name, None)
        monkeypatch.undo()


def test_lint_error_preflight_and_program_bounds_on_the_card(cuda_device):
    """A small LM at S = the flash length, traced with any batch and
    loaded by ``InferenceEngine(lint="error")`` on the card: the
    pre-flight finds no error, the serve engine's program bound holds
    after mixed traffic (``TraceLinter.check_serve_engine`` is empty) and
    its forwards launch the flash-forward kernel; a decode engine's
    two-program bound holds after mixed prompts and its steps launch the
    paged kernel."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.analysis import TraceLinter
    from mxnet_tpu_torch.ops.attention import _FLASH_MIN_SEQ

    seq = _FLASH_MIN_SEQ
    mx.random.seed(5)
    with mx.gpu(0):
        net = tt.transformer_lm(vocab_size=97, units=64, hidden_size=128,
                                num_layers=2, num_heads=4, max_length=seq)
        net.initialize()
        with mx.name.NameManager():
            logits = net(sym.var("data", shape=(0, seq)))
    arg = {p.name: p.data() for p in net.collect_params().values()}
    engine = serve.InferenceEngine(logits, arg, buckets=(1, 2, 4),
                                   lint="error", ctx=mx.gpu(0))
    assert engine.lint_report is not None
    assert not engine.lint_report.has_errors, engine.lint_report.format()
    flash0 = tfa.flash_attention_fwd.launches
    rng = np.random.RandomState(0)
    for n in (1, 3, 2, 4, 1, 3):
        rows = rng.randint(0, 97, (n, seq)).astype(np.float32)
        outs, _v = engine.infer([rows])
        assert outs[0].shape == (n, seq, 97) and np.isfinite(outs[0]).all()
    assert tfa.flash_attention_fwd.launches > flash0
    assert len(engine.compile_log) == 3
    assert TraceLinter().check_serve_engine(engine) == []

    cfg, params = _seeded_lm(vocab_size=97, units=32, hidden_size=64,
                             num_layers=2, num_heads=4, max_length=64)
    eng = DecodeEngine(cfg, params, device=cuda_device, slots=4,
                       page_size=8, num_pages=16, prompt_buckets=[8, 16])
    paged0 = tfa.flash_decode_attention.launches
    sched = DecodeScheduler(eng, max_new_tokens=4)
    try:
        for n in (3, 13, 8, 5, 16):
            assert len(list(sched.generate(np.arange(1, n + 1) % 90 + 1))) \
                == 4
    finally:
        sched.close()
    assert tfa.flash_decode_attention.launches > paged0
    assert sorted(e["kind"] for e in eng.compile_log) == [
        "prefill", "prefill", "step"]
    assert TraceLinter().check_decode_engine(eng) == []
