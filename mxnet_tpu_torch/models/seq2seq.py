"""Encoder-decoder transformer for NMT, label smoothing and beam search
(counterpart of ``mxnet_tpu/models/seq2seq.py``).

``Seq2SeqTransformer`` at its defaults is the Transformer-base of
Vaswani et al. (2017): 6 + 6 layers, 512 units, 2048 hidden, 8 heads.
Its decoder cells add causal self-attention (``MultiHeadAttention``) and
cross-attention over the encoder's memory (``CrossAttention``, through
``ops.attention.plain_attention``: the query and key lengths differ, so
the flash kernels never apply). ``beam_search`` is the reference's
algorithm: a loop of fixed length that decodes the whole prefix again
at each step, top-k on the host, and the length penalty
``((5 + len) ** alpha) / 6 ** alpha``; there is no KV cache, as the
reference has none.
"""
from __future__ import annotations

import numpy as np
import torch

from ..gluon import nn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import NDArray, invoke_fn
from ..ops.attention import plain_attention
from .transformer import BERTEncoder, MultiHeadAttention, PositionwiseFFN

__all__ = ["CrossAttention", "TransformerDecoderCell", "Seq2SeqTransformer",
           "beam_search", "label_smoothing_loss"]


class CrossAttention(HybridBlock):
    """Q from the decoder, K/V from the encoder's memory."""

    def __init__(self, units, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._heads = num_heads
        self.q_proj = nn.Dense(units, flatten=False, in_units=units,
                               prefix=self.prefix + "q_")
        self.kv_proj = nn.Dense(2 * units, flatten=False, in_units=units,
                                prefix=self.prefix + "kv_")
        self.proj = nn.Dense(units, flatten=False, in_units=units,
                             prefix=self.prefix + "proj_")
        self._dropout = dropout

    def hybrid_forward(self, F, x, memory):
        b, sq, u = x.shape
        sk = memory.shape[1]
        h, d = self._heads, self._units // self._heads
        q = self.q_proj(x).reshape((b, sq, h, d)).transpose((0, 2, 1, 3))
        kv = self.kv_proj(memory).reshape((b, sk, 2, h, d))
        k, v = F.split(kv, num_outputs=2, axis=2, squeeze_axis=True)
        k = k.transpose((0, 2, 1, 3))  # (B, H, Sk, D)
        v = v.transpose((0, 2, 1, 3))
        out = invoke_fn(lambda qq, kk, vv: plain_attention(qq, kk, vv),
                        [q, k, v])
        out = out.transpose((0, 2, 1, 3)).reshape((b, sq, u))
        out = self.proj(out)
        if self._dropout:
            out = F.Dropout(out, p=self._dropout)
        return out


class TransformerDecoderCell(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0, **kwargs):
        super().__init__(**kwargs)
        self.self_attn = MultiHeadAttention(units, num_heads, dropout=dropout,
                                            causal=True,
                                            prefix=self.prefix + "selfattn_")
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.cross_attn = CrossAttention(units, num_heads, dropout=dropout,
                                         prefix=self.prefix + "crossattn_")
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                   prefix=self.prefix + "ffn_")
        self.ln3 = nn.LayerNorm(in_channels=units)

    def hybrid_forward(self, F, x, memory):
        x = self.ln1(x + self.self_attn(x))
        x = self.ln2(x + self.cross_attn(x, memory))
        return self.ln3(x + self.ffn(x))


class Seq2SeqTransformer(HybridBlock):
    """The encoder-decoder NMT model (gluon-nlp's / Sockeye's transformer):
    ``net(src, tgt)`` gives the target logits (B, S_tgt, tgt_vocab)."""

    def __init__(self, src_vocab=32000, tgt_vocab=32000, units=512,
                 hidden_size=2048, num_layers=6, num_heads=8, max_length=512,
                 dropout=0.1, tie_embeddings=False, **kwargs):
        super().__init__(**kwargs)
        self.src_embed = nn.Embedding(src_vocab, units,
                                      prefix=self.prefix + "src_embed_")
        self.tgt_embed = nn.Embedding(tgt_vocab, units,
                                      prefix=self.prefix + "tgt_embed_")
        self.encoder = BERTEncoder(units, hidden_size, num_layers, num_heads,
                                   max_length, dropout,
                                   prefix=self.prefix + "enc_")
        self.dec_pos = self.params.get("dec_position_weight",
                                       shape=(max_length, units),
                                       init="zeros")
        self.dec_cells = []
        for i in range(num_layers):
            cell = TransformerDecoderCell(units, hidden_size, num_heads,
                                          dropout,
                                          prefix=f"{self.prefix}dec{i}_")
            self.register_child(cell, f"dec{i}")
            self.dec_cells.append(cell)
        self.out_proj = nn.Dense(tgt_vocab, flatten=False, in_units=units,
                                 prefix=self.prefix + "out_")
        self._units = units
        self._dropout = dropout

    def encode(self, src):
        return self.encoder(self.src_embed(src))

    def decode(self, tgt, memory, dec_pos=None):
        """``dec_pos`` is the decoder's position table: a forward argument
        when traced or cached, the parameter's array when called alone
        (beam search)."""
        from ..symbol.symbol import Symbol

        if isinstance(tgt, Symbol):
            from .. import symbol as F
        else:
            from .. import ndarray as F
        b, s = tgt.shape[0], tgt.shape[1]
        x = self.tgt_embed(tgt)
        w = dec_pos if dec_pos is not None else self.dec_pos.data()
        pos = F.slice_axis(w, axis=0, begin=0,
                           end=s).reshape((1, s, self._units))
        x = x + pos
        if self._dropout:
            x = F.Dropout(x, p=self._dropout)
        for cell in self.dec_cells:
            x = cell(x, memory)
        return self.out_proj(x)

    def hybrid_forward(self, F, src, tgt, dec_pos=None):
        memory = self.encode(src)
        return self.decode(tgt, memory, dec_pos)


def _smoothed_nll(lg, lb, epsilon, ignore_index):
    """Mean over the (unignored) positions of the cross-entropy against
    ``(1 - eps) * one_hot + eps / V``, written as
    ``-(1 - eps) * logp[label] - eps / V * sum(logp)``: the reference's
    sum over the smoothed one-hot rows, without building them. Labels
    read as the reference's ``eye(V)[label]`` reads them (negative from
    the end, past the end clamped)."""
    v = lg.shape[-1]
    logp = torch.log_softmax(lg, dim=-1)
    idx = lb.to(torch.int32).to(torch.int64)
    idx = torch.where(idx < 0, idx + v, idx).clamp(0, v - 1)
    picked = torch.gather(logp, -1, idx[..., None])[..., 0]
    nll = -(1 - epsilon) * picked - (epsilon / v) * logp.sum(dim=-1)
    if ignore_index is not None:
        mask = (lb != ignore_index).to(lg.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def label_smoothing_loss(logits, labels, epsilon=0.1, ignore_index=None):
    """Label-smoothed cross-entropy, averaged to one scalar."""
    return invoke_fn(lambda lg, lb: _smoothed_nll(lg, lb, epsilon,
                                                  ignore_index),
                     [logits, labels])


def beam_search(model: Seq2SeqTransformer, src, beam_size=4, max_length=30,
                bos=1, eos=2, alpha=0.6):
    """Beam search of fixed length: returns (the best sequence of each
    source (B, max_length) int32, its length-normalized score (B,))."""
    from .. import ndarray as F

    src_nd = src if isinstance(src, NDArray) else F.array(
        np.asarray(src, np.int32))
    b = src_nd.shape[0]
    memory = model.encode(src_nd)  # (B, S, U)
    dev = memory._data.device
    mem_rep = NDArray(torch.repeat_interleave(memory._data, beam_size,
                                              dim=0))  # (B*K, S, U)

    seqs = np.full((b * beam_size, max_length), eos, np.int32)
    seqs[:, 0] = bos
    scores = np.full((b, beam_size), -1e9, np.float32)
    scores[:, 0] = 0.0  # only the first beam is live at first
    alive = np.ones((b * beam_size,), bool)

    for t in range(1, max_length):
        prefix = NDArray(torch.from_numpy(seqs[:, :t].copy()).to(dev))
        logits = model.decode(prefix, mem_rep)  # (B*K, t, V)
        logp = np.array(F.log_softmax(logits[:, t - 1], axis=-1).asnumpy())
        v = logp.shape[-1]
        # dead beams only extend with eos, at no cost
        logp[~alive] = -1e9
        logp[~alive, eos] = 0.0
        total = (scores.reshape(-1, 1) + logp).reshape(b, beam_size * v)
        topk_idx = np.argsort(-total, axis=1)[:, :beam_size]
        topk_score = np.take_along_axis(total, topk_idx, axis=1)
        beam_src = topk_idx // v
        token = (topk_idx % v).astype(np.int32)
        new_seqs = np.empty_like(seqs)
        for bi in range(b):
            for k in range(beam_size):
                parent = bi * beam_size + int(beam_src[bi, k])
                row = bi * beam_size + k
                new_seqs[row] = seqs[parent]
                new_seqs[row, t] = token[bi, k]
        seqs = new_seqs
        scores = topk_score
        alive = (seqs[:, t] != eos) & alive[
            (np.arange(b)[:, None] * beam_size + beam_src).reshape(-1)]
        if not alive.any():
            break

    # the best beam after length normalization
    lengths = (seqs != eos).sum(axis=1).reshape(b, beam_size)
    lp = ((5 + lengths) ** alpha) / ((5 + 1) ** alpha)
    final = scores / lp
    best = np.argmax(final, axis=1)
    out = np.stack([seqs[bi * beam_size + best[bi]] for bi in range(b)])
    return out, final[np.arange(b), best]
