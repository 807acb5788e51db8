"""The transformer family: BERT and the decoder-only causal
TransformerLM as Gluon blocks, and the LM's decode interface.

Counterpart of ``mxnet_tpu/models/transformer.py``. The reference's Gluon
classes under its names: ``MultiHeadAttention`` (one fused QKV projection,
``F.split``, attention through ``invoke_fn(fused_attention)``, so the
flash kernels at long sequences and plain attention below
``_FLASH_MIN_SEQ``), ``PositionwiseFFN``, ``TransformerEncoderCell``,
``BERTEncoder`` (zero-initialized positions), ``BERTModel`` (the MLM
head), ``TransformerLM``, the constructors ``bert_tiny``/``bert_base``/
``bert_large``/``transformer_lm`` and ``bert_sharding_rules``, built from
``gluon.nn`` layers, so that ``collect_params()`` holds the reference's
names and shapes. Dropout draws from the framework's random stream
(``mxnet_tpu_torch.random``) in training mode.

And the pure functions of the causal-LM decode interface
(``decode_config``, ``decode_params``, ``prefill_layer``, ``decode_layer``,
``lm_prefill``, ``lm_decode_step``, ``sample_token``), on torch tensors.
``lm_prefill`` keeps its dense masked attention, as the reference's does:
it is also the plain-tensor oracle of the training forward. The layout is
the reference's: post-LN blocks, gluon ``Dense`` weights kept
``(out, in)`` so ``y = x @ w.T + b``, learned positions, and a flat
parameter dict (top-level embed/pos/final-LN/decoder plus one dict per
layer under ``"layers"``).

Weights carry across packages: by structural name
(``gluon.utils.set_params_from_numpy``), or as the numpy dict the JAX
package's ``decode_params`` returns (:func:`from_numpy_params`).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..context import Context, as_device
from ..gluon import nn as gnn
from ..gluon.block import HybridBlock
from ..ndarray.ndarray import invoke_fn
from ..base import MXNetError
from ..ops.attention import fused_attention, sharded_attention
from ..parallel.mesh import current_mesh
from ..parallel.ring_attention import sequence_sharded_attention

__all__ = ["MultiHeadAttention", "PositionwiseFFN", "TransformerEncoderCell",
           "BERTEncoder", "BERTModel", "TransformerLM", "bert_base",
           "bert_large", "bert_tiny", "transformer_lm",
           "bert_sharding_rules", "gluon_parameters", "from_numpy_params",
           "decode_config", "decode_params", "prefill_layer",
           "decode_layer", "embed_ids", "lm_prefill", "lm_decode_step",
           "sample_token"]

_LN_EPS = 1e-5  # gluon nn.LayerNorm default


# ---------------------------------------------------------------------------
# The Gluon model (the reference's classes)
# ---------------------------------------------------------------------------

def _whole_dim(x, dim):
    """``x`` (a ``DTensor``) with dimension ``dim`` unsharded. The layer
    gathers the ring's output: outside attention the sequence stays
    whole, since a batch dim sharded over dp flattened with a sequence
    dim sharded over sp gives a strided sharding whose redistribution
    plans DTensor searches for at length on meshes of three axes."""
    from torch.distributed.tensor import Replicate

    dim %= x.ndim
    pl = [Replicate() if p.is_shard() and p.dim % x.ndim == dim else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def _run_mesh(t):
    """The mesh of the running scope when ``t`` is a ``DTensor`` over its
    ranks, else None (plain tensors attend on their own device)."""
    mesh = current_mesh()
    if mesh is None or not mesh.distributed:
        return None
    from torch.distributed.tensor import DTensor

    return mesh if isinstance(t, DTensor) else None


class MultiHeadAttention(HybridBlock):
    """Fused-QKV multi-head self-attention."""

    def __init__(self, units, num_heads, dropout=0.0, causal=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert units % num_heads == 0
        self._units = units
        self._heads = num_heads
        self._causal = causal
        self.qkv = gnn.Dense(3 * units, flatten=False, use_bias=True,
                             in_units=units, prefix=self.prefix + "qkv_")
        self.proj = gnn.Dense(units, flatten=False, use_bias=True,
                              in_units=units, prefix=self.prefix + "proj_")
        self._dropout = dropout

    def hybrid_forward(self, F, x, mask=None):
        b, s, u = x.shape  # (B, S, U)
        h, d = self._heads, self._units // self._heads
        # a tp-sharded fused projection is gathered by the reshape
        # (ops/matrix.py), where its shards would cut through q/k/v
        qkv = self.qkv(x).reshape((b, s, 3, h, d))
        q, k, v = F.split(qkv, num_outputs=3, axis=2, squeeze_axis=True)
        q = q.transpose((0, 2, 1, 3))  # (B, H, S, D)
        k = k.transpose((0, 2, 1, 3))
        v = v.transpose((0, 2, 1, 3))
        causal = self._causal

        def attn(qq, kk, vv, mm=None):
            # the mesh is looked up when the layer runs, so a graph traced
            # outside a mesh scope attends over the one it runs under
            mesh = _run_mesh(qq)
            if mesh is not None and mesh.shape.get("sp", 1) > 1:
                if mm is not None:
                    raise MXNetError("MultiHeadAttention: ring attention "
                                     "over sp takes no mask")
                return _whole_dim(sequence_sharded_attention(
                    qq, kk, vv, mesh, causal=causal), 2)
            if mesh is not None:
                return sharded_attention(qq, kk, vv, mesh, mask=mm,
                                         causal=causal)
            return fused_attention(qq, kk, vv, mask=mm, causal=causal)

        out = invoke_fn(attn, [q, k, v] + ([mask] if mask is not None
                                           else []))
        out = out.transpose((0, 2, 1, 3)).reshape((b, s, u))
        out = self.proj(out)
        if self._dropout:
            out = F.Dropout(out, p=self._dropout)
        return out


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, activation="gelu",
                 **kwargs):
        super().__init__(**kwargs)
        self.ffn_1 = gnn.Dense(hidden_size, flatten=False, in_units=units,
                               prefix=self.prefix + "ffn1_")
        self.ffn_2 = gnn.Dense(units, flatten=False, in_units=hidden_size,
                               prefix=self.prefix + "ffn2_")
        self._act = activation
        self._dropout = dropout

    def hybrid_forward(self, F, x):
        out = self.ffn_1(x)
        out = F.Activation(out, act_type=self._act) if self._act != "gelu" \
            else F.gelu(out, approximation="tanh")
        out = self.ffn_2(out)
        if self._dropout:
            out = F.Dropout(out, p=self._dropout)
        return out


class TransformerEncoderCell(HybridBlock):
    """Post-LN transformer block (BERT layout)."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 causal=False, **kwargs):
        super().__init__(**kwargs)
        self.attention = MultiHeadAttention(units, num_heads, dropout=dropout,
                                            causal=causal,
                                            prefix=self.prefix + "attn_")
        self.ln1 = gnn.LayerNorm(in_channels=units)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout,
                                   prefix=self.prefix + "ffn_")
        self.ln2 = gnn.LayerNorm(in_channels=units)
        self._dropout = dropout

    def hybrid_forward(self, F, x, mask=None):
        att = self.attention(x, mask)
        x = self.ln1(x + att)
        out = self.ffn(x)
        return self.ln2(x + out)


class BERTEncoder(HybridBlock):
    def __init__(self, units=768, hidden_size=3072, num_layers=12,
                 num_heads=12, max_length=512, dropout=0.1, causal=False,
                 **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._max_length = max_length
        self.position_weight = self.params.get(
            "position_weight", shape=(max_length, units), init="zeros")
        self.cells = []
        for i in range(num_layers):
            cell = TransformerEncoderCell(units, hidden_size, num_heads,
                                          dropout=dropout, causal=causal,
                                          prefix=f"{self.prefix}layer{i}_")
            self.register_child(cell, f"layer{i}")
            self.cells.append(cell)
        self._dropout = dropout

    def hybrid_forward(self, F, x, position_weight, mask=None):
        b, s, u = x.shape
        pos = F.slice_axis(position_weight, axis=0, begin=0,
                           end=s).reshape((1, s, u))
        x = x + pos
        if self._dropout:
            x = F.Dropout(x, p=self._dropout)
        for cell in self.cells:
            x = cell(x, mask)
        return x


class BERTModel(HybridBlock):
    """BERT with the MLM head (gluon-nlp's ``BERTModel``): word and
    token-type embeddings, their LayerNorm, a bidirectional
    ``BERTEncoder``, then dense, gelu, LayerNorm and the decoder."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, dropout=0.1,
                 num_token_types=2, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self.word_embed = gnn.Embedding(vocab_size, units,
                                        prefix=self.prefix + "word_embed_")
        self.token_type_embed = gnn.Embedding(
            num_token_types, units, prefix=self.prefix + "type_embed_")
        self.embed_ln = gnn.LayerNorm(in_channels=units)
        self.encoder = BERTEncoder(units, hidden_size, num_layers, num_heads,
                                   max_length, dropout,
                                   prefix=self.prefix + "enc_")
        self.mlm_dense = gnn.Dense(units, flatten=False, in_units=units,
                                   prefix=self.prefix + "mlm_dense_")
        self.mlm_ln = gnn.LayerNorm(in_channels=units)
        self.mlm_decoder = gnn.Dense(vocab_size, flatten=False,
                                     in_units=units,
                                     prefix=self.prefix + "mlm_decoder_")

    def hybrid_forward(self, F, inputs, token_types=None):
        x = self.word_embed(inputs)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_ln(x)
        seq = self.encoder(x)
        h = self.mlm_dense(seq)
        h = F.gelu(h, approximation="tanh")
        h = self.mlm_ln(h)
        return self.mlm_decoder(h)


class TransformerLM(HybridBlock):
    """Decoder-only causal LM (GPT-style), the reference's flagship: token
    embedding, a causal ``BERTEncoder``, the final LayerNorm and the
    decoder."""

    def __init__(self, vocab_size=32000, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=2048, dropout=0.0,
                 **kwargs):
        super().__init__(**kwargs)
        self.word_embed = gnn.Embedding(vocab_size, units,
                                        prefix=self.prefix + "word_embed_")
        self.encoder = BERTEncoder(units, hidden_size, num_layers, num_heads,
                                   max_length, dropout, causal=True,
                                   prefix=self.prefix + "enc_")
        self.final_ln = gnn.LayerNorm(in_channels=units)
        self.decoder = gnn.Dense(vocab_size, flatten=False, in_units=units,
                                 prefix=self.prefix + "decoder_")

    def hybrid_forward(self, F, inputs):
        x = self.word_embed(inputs)
        x = self.encoder(x)
        x = self.final_ln(x)
        return self.decoder(x)


def bert_sharding_rules():
    """Megatron-style tensor-parallel rules for BERT/TransformerLM
    parameters: QKV and FFN-in sharded over ``tp`` on the output dim,
    out-projection and FFN-out on the input dim. On a mesh without ``tp``
    (every mesh of the port) they collapse to replicated."""
    from ..parallel import P, ShardingRules

    return ShardingRules([
        (r"qkv_weight$", P("tp", None)),        # column parallel
        (r"ffn1_weight$", P("tp", None)),
        (r"qkv_bias$", P("tp")),
        (r"ffn1_bias$", P("tp")),
        (r"proj_weight$", P(None, "tp")),       # row parallel
        (r"ffn2_weight$", P(None, "tp")),
        (r"(word_embed|mlm_decoder|decoder)\d*_weight$", P("tp", None)),
    ], default=P())


def bert_tiny(vocab_size=1000, **kw):
    kw.setdefault("units", 64)
    kw.setdefault("hidden_size", 128)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("max_length", 128)
    return BERTModel(vocab_size=vocab_size, **kw)


def bert_base(vocab_size=30522, **kw):
    return BERTModel(vocab_size=vocab_size, units=768, hidden_size=3072,
                     num_layers=12, num_heads=12, **kw)


def bert_large(vocab_size=30522, **kw):
    return BERTModel(vocab_size=vocab_size, units=1024, hidden_size=4096,
                     num_layers=24, num_heads=16, **kw)


def transformer_lm(vocab_size=32000, **kw) -> TransformerLM:
    return TransformerLM(vocab_size=vocab_size, **kw)


# ---------------------------------------------------------------------------
# Weights across packages
# ---------------------------------------------------------------------------

def gluon_parameters(lm: "TransformerLM") -> dict:
    """The Gluon LM's ``Parameter``s in the layout of ``decode_params``
    (top-level embed/pos/final-LN/decoder, one dict per layer under
    ``"layers"``)."""
    def layer(cell):
        att, ffn = cell.attention, cell.ffn
        return {"qkv_w": att.qkv.weight, "qkv_b": att.qkv.bias,
                "proj_w": att.proj.weight, "proj_b": att.proj.bias,
                "ln1_g": cell.ln1.gamma, "ln1_b": cell.ln1.beta,
                "ffn1_w": ffn.ffn_1.weight, "ffn1_b": ffn.ffn_1.bias,
                "ffn2_w": ffn.ffn_2.weight, "ffn2_b": ffn.ffn_2.bias,
                "ln2_g": cell.ln2.gamma, "ln2_b": cell.ln2.beta}

    return {"embed": lm.word_embed.weight,
            "pos": lm.encoder.position_weight,
            "final_g": lm.final_ln.gamma, "final_b": lm.final_ln.beta,
            "dec_w": lm.decoder.weight, "dec_b": lm.decoder.bias,
            "layers": [layer(c) for c in lm.encoder.cells]}


def decode_config(lm: TransformerLM) -> dict:
    """Static shape/config facts of an LM, for building decode
    programs."""
    att = lm.encoder.cells[0].attention
    return {"vocab": lm.decoder._units, "units": att._units,
            "heads": att._heads, "head_dim": att._units // att._heads,
            "layers": len(lm.encoder.cells),
            "max_length": lm.encoder._max_length}


def decode_params(lm: TransformerLM) -> dict:
    """The LM's parameters as a flat dict of (detached) tensors, in the
    layout of the reference's ``decode_params``. The block must have been
    initialized (its shapes are all declared)."""
    gp = gluon_parameters(lm)
    out = {k: p.data()._data.detach() for k, p in gp.items()
           if k != "layers"}
    out["layers"] = [{k: p.data()._data.detach() for k, p in lp.items()}
                     for lp in gp["layers"]]
    return out


@torch.no_grad()
def from_numpy_params(cfg: dict, params: dict, device=None) -> TransformerLM:
    """Build an initialized Gluon :class:`TransformerLM` holding ``params``
    (the dict of numpy arrays the JAX package's ``decode_params(lm)``
    returns, or tensors in that layout) for the config ``cfg`` (its
    ``decode_config``), on ``device`` (the card unless named)."""
    hidden = int(np.shape(params["layers"][0]["ffn1_w"])[0])
    lm = TransformerLM(vocab_size=cfg["vocab"], units=cfg["units"],
                       hidden_size=hidden, num_layers=cfg["layers"],
                       num_heads=cfg["heads"], max_length=cfg["max_length"])
    lm.initialize(ctx=Context(as_device(device)))
    mine = gluon_parameters(lm)
    pairs = [(mine[k], params[k]) for k in mine if k != "layers"]
    for lp_mine, lp in zip(mine["layers"], params["layers"], strict=True):
        pairs += [(lp_mine[k], lp[k]) for k in lp_mine]
    for dst, src in pairs:
        if tuple(np.shape(src)) != dst.shape:
            raise ValueError(f"parameter shape {tuple(np.shape(src))} does "
                             f"not match {dst.shape} of {dst.name}")
        dst.set_data(src)
    return lm


# ---------------------------------------------------------------------------
# Causal-LM decode interface (serve/decode.py consumes this)
# ---------------------------------------------------------------------------

def _ln(x, g, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + _LN_EPS) * g + b


def _dense(x, w, b):
    # gluon Dense stores weight as (out, in): y = x @ w.T + b
    return x @ w.T + b


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def embed_ids(tokens, vocab):
    """Token ids as the reference's gather reads them
    (``params["embed"][tokens]`` in JAX): a negative id counts from the
    end, and an id still outside [0, vocab) is clamped to the nearest
    row. Torch indexing would raise instead, and on CUDA assert on the
    device."""
    tokens = tokens.long()
    tokens = torch.where(tokens < 0, tokens + vocab, tokens)
    return tokens.clamp(0, vocab - 1)


def _split_heads(qkv, heads, head_dim):
    # qkv (..., 3U) -> q, k, v each (..., H, D), views of qkv
    return qkv.reshape(qkv.shape[:-1] + (3, heads, head_dim)).unbind(-3)


def prefill_layer(cfg, lp, x, mask):
    """One post-LN block over a full prompt. x (B, S, U), mask (S, S) or
    (B, S, S) boolean (True = attend). Returns (x', k, v) with k/v shaped
    (B, S, H, D)."""
    h, d = cfg["heads"], cfg["head_dim"]
    q, k, v = _split_heads(_dense(x, lp["qkv_w"], lp["qkv_b"]), h, d)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m = mask[:, None] if mask.dim() == 3 else mask
    scores = scores.masked_fill(~m, -1e30)
    p = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p, v)
    att = _dense(ctx.reshape(x.shape), lp["proj_w"], lp["proj_b"])
    x = _ln(x + att, lp["ln1_g"], lp["ln1_b"])
    out = _dense(_gelu(_dense(x, lp["ffn1_w"], lp["ffn1_b"])),
                 lp["ffn2_w"], lp["ffn2_b"])
    return _ln(x + out, lp["ln2_g"], lp["ln2_b"]), k, v


def decode_layer(cfg, lp, x, attend):
    """One post-LN block for a single new position per sequence.

    x (B, U); ``attend(q, k_new, v_new) -> ctx`` supplies attention over
    the cached history (q/k_new/v_new/ctx all (B, H, D)). Returns
    (x', k_new, v_new)."""
    h, d = cfg["heads"], cfg["head_dim"]
    q, k, v = _split_heads(_dense(x, lp["qkv_w"], lp["qkv_b"]), h, d)
    ctx = attend(q, k, v)
    att = _dense(ctx.reshape(x.shape), lp["proj_w"], lp["proj_b"])
    x = _ln(x + att, lp["ln1_g"], lp["ln1_b"])
    out = _dense(_gelu(_dense(x, lp["ffn1_w"], lp["ffn1_b"])),
                 lp["ffn2_w"], lp["ffn2_b"])
    return _ln(x + out, lp["ln2_g"], lp["ln2_b"]), k, v


def lm_prefill(cfg, params, tokens):
    """Causal forward over a prompt batch. tokens (B, S) integer tensor.

    Returns (logits (B, S, V), k (L, B, S, H, D), v (L, B, S, H, D)).
    Padded positions are harmless: row i only sees columns <= i."""
    s = tokens.shape[1]
    x = params["embed"][embed_ids(tokens, cfg["vocab"])] + params["pos"][:s]
    causal = torch.ones((s, s), dtype=torch.bool,
                        device=tokens.device).tril()
    ks, vs = [], []
    for lp in params["layers"]:
        x, k, v = prefill_layer(cfg, lp, x, causal)
        ks.append(k)
        vs.append(v)
    x = _ln(x, params["final_g"], params["final_b"])
    logits = _dense(x, params["dec_w"], params["dec_b"])
    return logits, torch.stack(ks), torch.stack(vs)


def lm_decode_step(cfg, params, tokens, kv, positions):
    """One decode step over dense KV (the paged engine's reference).

    tokens (B,) int; kv = (k, v) each (L, B, S, H, D) with S the cache
    capacity, UPDATED IN PLACE (the reference returns new arrays);
    positions (B,) int — the index written this step. Returns
    (logits (B, V), (k, v))."""
    k_all, v_all = kv
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    positions = positions.long()
    x = (params["embed"][embed_ids(tokens, cfg["vocab"])]
         + params["pos"][positions])
    scale = 1.0 / math.sqrt(cfg["head_dim"])
    cols = torch.arange(k_all.shape[2], device=tokens.device)
    live = cols[None, :] <= positions[:, None]  # (B, S)
    for i, lp in enumerate(params["layers"]):
        def attend(q, k_new, v_new, _i=i):
            k_all[_i, rows, positions] = k_new
            v_all[_i, rows, positions] = v_new
            scores = torch.einsum("bhd,bshd->bhs", q.float(),
                                  k_all[_i].float()) * scale
            scores = scores.masked_fill(~live[:, None], -1e30)
            p = torch.softmax(scores, dim=-1).to(q.dtype)
            return torch.einsum("bhs,bshd->bhd", p, v_all[_i])

        x, _, _ = decode_layer(cfg, lp, x, attend)
    x = _ln(x, params["final_g"], params["final_b"])
    return _dense(x, params["dec_w"], params["dec_b"]), (k_all, v_all)


def sample_token(logits, generator: Optional[torch.Generator], temperature):
    """Sampling on the logits' device: temperature > 0 draws from
    softmax(logits / t) (Gumbel-max with ``generator``'s noise), temperature
    <= 0 is greedy argmax. ``temperature`` may be a scalar or per-row (B,).
    Returns int32 (B,). The draw follows torch's generator, not
    ``jax.random``: it matches the reference in distribution only."""
    if isinstance(temperature, torch.Tensor):
        t = temperature.to(device=logits.device, dtype=torch.float32)
        t = t.expand(logits.shape[:-1])
    else:  # a fill on the device, not a host-to-device copy
        t = torch.full(logits.shape[:-1], float(temperature),
                       dtype=torch.float32, device=logits.device)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    safe_t = t.clamp_min(1e-4)[..., None]
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    drawn = torch.argmax(logits.float() / safe_t + gumbel,
                         dim=-1).to(torch.int32)
    return torch.where(t > 0, drawn, greedy)
