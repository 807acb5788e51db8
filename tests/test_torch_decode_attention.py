"""Paged decode attention: the port (mxnet_tpu_torch) against the JAX
package.

On the CPU the port's wrappers run their plain version; they are held to
the reference's XLA path and to its Pallas kernel in interpret mode, at the
reference's own tolerance (rtol = atol = 2e-5, tests/test_decode.py). The
CUDA kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu.ops.flash_attention import (_decode_attention_xla,
                                           flash_decode_attention as jax_fda)
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import flash_attention as tfa

# tiny shapes need no intra-op threads; the suite runs test files in
# parallel workers beside timing-sensitive tests
torch.set_num_threads(1)

TOL = 2e-5


def _jax_xla(q, k, v, table, lengths):
    return _decode_attention_xla(q, k, v, table, lengths,
                                 1.0 / math.sqrt(q.shape[-1]))


def _jax_pallas(q, k, v, table, lengths):
    return jax_fda(q, k, v, table, lengths, interpret=True)


REFERENCES = {"xla": _jax_xla, "pallas_interpret": _jax_pallas}


def _port(q, k, v, table, lengths):
    t = torch.from_numpy
    return tfa.decode_attention(t(q), t(k), t(v), t(table),
                                t(lengths)).numpy()


def _small_case():
    """The case of tests/test_decode.py::test_decode_attention_parity."""
    rng = np.random.RandomState(3)
    n_pages, page, heads, dim, max_pages = 7, 4, 2, 8, 4
    q = rng.randn(3, heads, dim).astype(np.float32)
    k_pages = rng.randn(n_pages, page, heads, dim).astype(np.float32)
    v_pages = rng.randn(n_pages, page, heads, dim).astype(np.float32)
    table = np.zeros((3, max_pages), np.int32)
    table[0, :2] = [1, 2]
    table[1, :4] = [3, 4, 5, 6]
    lengths = np.array([5, 13, 0], np.int32)  # row 2 inactive
    return q, k_pages, v_pages, table, lengths


@pytest.mark.parametrize("ref", sorted(REFERENCES))
def test_decode_attention_matches_reference(ref):
    q, k, v, table, lengths = _small_case()
    out = _port(q, k, v, table, lengths)
    want = np.asarray(REFERENCES[ref](q, k, v, table, lengths))
    assert out.shape == q.shape and out.dtype == np.float32
    np.testing.assert_allclose(out[:2], want[:2], rtol=TOL, atol=TOL)
    assert np.isfinite(out).all()


def _pool_case(seed=5):
    """A 6-d pool (pages, layers, 2, page, H, D) like the engine's, with
    ragged lengths: one mid-page, one an exact multiple of the page, one
    spanning every table entry, and one inactive row (length 0)."""
    rng = np.random.RandomState(seed)
    n_pages, layers, page, heads, dim, max_pages = 11, 3, 4, 2, 8, 4
    pool = rng.randn(n_pages, layers, 2, page, heads, dim).astype(np.float32)
    q = rng.randn(4, heads, dim).astype(np.float32)
    table = np.zeros((4, max_pages), np.int32)
    table[0, :2] = [7, 2]
    table[1, :2] = [9, 4]
    table[2, :4] = [1, 10, 3, 6]
    lengths = np.array([6, 8, 16, 0], np.int32)
    return pool, q, table, lengths


@pytest.mark.parametrize("ref", sorted(REFERENCES))
@pytest.mark.parametrize("layer", [0, 2])
def test_strided_pool_view_matches_reference(ref, layer):
    pool, q, table, lengths = _pool_case()
    tpool = torch.from_numpy(pool)
    k, v = tpool[:, layer, 0], tpool[:, layer, 1]
    assert not k.is_contiguous()  # the engine's view, never copied
    out = tfa.decode_attention(torch.from_numpy(q), k, v,
                               torch.from_numpy(table),
                               torch.from_numpy(lengths)).numpy()
    want = np.asarray(REFERENCES[ref](q, pool[:, layer, 0], pool[:, layer, 1],
                                      table, lengths))
    live = lengths > 0
    np.testing.assert_allclose(out[live], want[live], rtol=TOL, atol=TOL)
    assert np.isfinite(out[~live]).all()  # length 0: finite, not compared


def test_cpu_wrapper_runs_plain_version_without_counting():
    pool, q, table, lengths = _pool_case()
    tpool = torch.from_numpy(pool)
    args = (torch.from_numpy(q), tpool[:, 1, 0], tpool[:, 1, 1],
            torch.from_numpy(table), torch.from_numpy(lengths))
    before = tfa.flash_decode_attention.launches
    out = tfa.flash_decode_attention(*args)
    assert tfa.flash_decode_attention.launches == before
    plain = tfa._decode_attention_plain(*args, 1.0 / math.sqrt(q.shape[-1]))
    assert torch.equal(out, plain)


def test_decode_attn_env_values(monkeypatch):
    q, k, v, table, lengths = _small_case()
    want = _port(q, k, v, table, lengths)
    monkeypatch.setenv("MXNET_DECODE_ATTN", "plain")
    np.testing.assert_array_equal(_port(q, k, v, table, lengths), want)
    monkeypatch.setenv("MXNET_DECODE_ATTN", "kernel")
    with pytest.raises(MXNetError, match="CUDA"):
        _port(q, k, v, table, lengths)
    monkeypatch.setenv("MXNET_DECODE_ATTN", "pallas")
    with pytest.raises(MXNetError, match="auto|kernel|plain"):
        _port(q, k, v, table, lengths)


def test_plain_version_casts_to_query_dtype():
    q, k, v, table, lengths = _small_case()
    t = torch.from_numpy
    out = tfa.decode_attention(t(q).to(torch.bfloat16),
                               t(k).to(torch.bfloat16),
                               t(v).to(torch.bfloat16), t(table), t(lengths))
    assert out.dtype == torch.bfloat16
    want = _port(q, k, v, table, lengths)
    np.testing.assert_allclose(out.float().numpy()[:2], want[:2], atol=5e-2)


# ---------------------------------------------------------------------------
# the paged kernel's split: the plain version's chunked form and the rule
# that picks the chunk
# ---------------------------------------------------------------------------

_FULL = 192  # 12 pages of 16 per table row


def _chunk_case(chunk, seed=7):
    """A 6-d pool (pages, layers, 2, page, H, D) and rows of lengths 0, 1,
    chunk - 1, chunk, chunk + 1 (at most the full row) and the full row: the
    later chunks of every short row are empty."""
    rng = np.random.RandomState(seed)
    n_pages, layers, page, heads, dim = 80, 2, 16, 2, 8
    max_pages = _FULL // page
    lengths = np.array([0, 1, chunk - 1, chunk, min(chunk + 1, _FULL),
                        _FULL], np.int32)
    pool = rng.randn(n_pages, layers, 2, page, heads, dim).astype(np.float32)
    q = rng.randn(len(lengths), heads, dim).astype(np.float32)
    table = np.zeros((len(lengths), max_pages), np.int32)  # padding: page 0
    free = list(rng.permutation(np.arange(1, n_pages)))
    for b, n in enumerate(lengths):
        live = -(-int(n) // page)
        table[b, :live] = [free.pop() for _ in range(live)]
    return pool, q, table, lengths


@pytest.mark.parametrize("ref", sorted(REFERENCES))
@pytest.mark.parametrize("chunk", [16, 48, 128, _FULL])
def test_chunked_plain_version_matches_reference(ref, chunk):
    pool, q, table, lengths = _chunk_case(chunk)
    tpool = torch.from_numpy(pool)
    k, v = tpool[:, 1, 0], tpool[:, 1, 1]  # the engine's strided view
    assert not k.is_contiguous()
    out = tfa._decode_attention_plain(
        torch.from_numpy(q), k, v, torch.from_numpy(table),
        torch.from_numpy(lengths), 1.0 / math.sqrt(q.shape[-1]),
        chunk=chunk).numpy()
    want = np.asarray(REFERENCES[ref](q, pool[:, 1, 0], pool[:, 1, 1], table,
                                      lengths))
    live = lengths > 0
    np.testing.assert_allclose(out[live], want[live], rtol=TOL, atol=TOL)
    # the kernel's merge of empty partials: a length-0 row is exactly 0
    assert not out[~live].any()


def test_chunked_plain_version_is_the_unchunked_one():
    pool, q, table, lengths = _chunk_case(48)
    tpool = torch.from_numpy(pool)
    args = (torch.from_numpy(q), tpool[:, 0, 0], tpool[:, 0, 1],
            torch.from_numpy(table), torch.from_numpy(lengths), 0.3)
    whole = tfa._decode_attention_plain(*args)
    live = torch.from_numpy(lengths > 0)
    for chunk in (16, 32, 64, 160, 1024):
        split = tfa._decode_attention_plain(*args, chunk=chunk)
        torch.testing.assert_close(split[live], whole[live], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("shape,want", [
    ((8, 12, 2048, 16, 132), 256),  # the serving path: 8 chunks a row
    ((1, 12, 2048, 16, 132), 64),   # too few rows for 4 blocks an SM
    ((64, 32, 2048, 16, 132), 512),  # enough blocks at the largest
    ((8, 12, 2048, 48, 132), 240),  # rounded down to whole pages
    ((8, 12, 4096, 1024, 132), 1024),  # pages longer than any chunk
    ((5, 3, 128, 16, 132), 64),     # rows shorter than the chunks
])
def test_decode_chunk_from_static_shapes(shape, want):
    batch, heads, max_len, page, sms = shape
    chunk = tfa._decode_chunk(*shape)
    assert chunk == want
    assert chunk % page == 0 and chunk // page <= 512


def test_decode_chunk_shrinks_as_the_card_grows():
    chunks = [tfa._decode_chunk(8, 12, 2048, 16, sms)
              for sms in (1, 16, 66, 132, 264, 1024)]
    assert chunks == sorted(chunks, reverse=True)
    assert chunks[0] == 512 and chunks[-1] == 64
