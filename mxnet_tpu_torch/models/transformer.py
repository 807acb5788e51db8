"""Decoder-only causal TransformerLM: training forward and decode interface.

Counterpart of ``mxnet_tpu/models/transformer.py``: ``TransformerLM``,
whose ``forward`` is the training path (``TransformerEncoderCell`` ->
``multi_head_attention`` -> ``ops.attention.fused_attention``, the flash
kernels at long sequences), and the pure functions of its causal-LM
decode interface (``decode_config``, ``decode_params``, ``prefill_layer``,
``decode_layer``, ``lm_prefill``, ``lm_decode_step``, ``sample_token``),
on torch tensors. ``lm_prefill`` keeps its dense masked attention, as the
reference's does. The layout is the reference's: post-LN blocks, one
fused QKV projection, gluon ``Dense`` weights kept ``(out, in)`` so
``y = x @ w.T + b``, learned positions, and a flat parameter dict
(top-level embed/pos/final-LN/decoder plus one dict per layer under
``"layers"``). Dropout and the encoder family (BERT) belong to a later
slice.

Weights carry across packages: :func:`from_numpy_params` builds the port's
module from the numpy dict the JAX package's ``decode_params`` returns, and
:func:`decode_params` gives the same layout back as tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..context import as_device
from ..ops.attention import fused_attention

__all__ = ["TransformerLM", "TransformerEncoderCell", "transformer_lm",
           "multi_head_attention", "positionwise_ffn", "from_numpy_params",
           "decode_config", "decode_params", "prefill_layer", "decode_layer",
           "lm_prefill", "lm_decode_step", "sample_token"]

_LN_EPS = 1e-5  # gluon nn.LayerNorm default
_INIT_SCALE = 0.07  # gluon's default Uniform(0.07) weight initializer


def multi_head_attention(x, qkv_w, qkv_b, proj_w, proj_b, heads,
                         causal=False):
    """The reference's ``MultiHeadAttention`` forward: the fused QKV
    projection, q/k/v as (B, H, S, D) views of it (no copies), attention
    through :func:`fused_attention` (``MXNET_ATTENTION_IMPL``), then the
    output projection. x (B, S, U)."""
    b, s, u = x.shape
    q, k, v = (t.transpose(1, 2) for t in
               _split_heads(_dense(x, qkv_w, qkv_b), heads, u // heads))
    out = fused_attention(q, k, v, causal=causal)
    return _dense(out.transpose(1, 2).reshape(b, s, u), proj_w, proj_b)


def positionwise_ffn(x, ffn1_w, ffn1_b, ffn2_w, ffn2_b):
    """The reference's ``PositionwiseFFN`` forward (gelu, tanh form)."""
    return _dense(_gelu(_dense(x, ffn1_w, ffn1_b)), ffn2_w, ffn2_b)


class TransformerEncoderCell(nn.Module):
    """Post-LN transformer block (the reference's ``TransformerEncoderCell``
    with its ``MultiHeadAttention`` and ``PositionwiseFFN``). Its
    parameters are named as in ``decode_params``, so the cell holds them
    itself instead of in sub-blocks."""

    def __init__(self, units, hidden_size, num_heads, causal=False,
                 device=None):
        super().__init__()

        def p(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self._heads, self._causal = int(num_heads), bool(causal)
        self.qkv_w, self.qkv_b = p(3 * units, units), p(3 * units)
        self.proj_w, self.proj_b = p(units, units), p(units)
        self.ln1_g, self.ln1_b = p(units), p(units)
        self.ffn1_w, self.ffn1_b = p(hidden_size, units), p(hidden_size)
        self.ffn2_w, self.ffn2_b = p(units, hidden_size), p(units)
        self.ln2_g, self.ln2_b = p(units), p(units)

    def forward(self, x):
        att = multi_head_attention(x, self.qkv_w, self.qkv_b, self.proj_w,
                                   self.proj_b, self._heads, self._causal)
        x = _ln(x + att, self.ln1_g, self.ln1_b)
        out = positionwise_ffn(x, self.ffn1_w, self.ffn1_b, self.ffn2_w,
                               self.ffn2_b)
        return _ln(x + out, self.ln2_g, self.ln2_b)


class TransformerLM(nn.Module):
    """Decoder-only causal LM (GPT-style), the reference's flagship.

    ``forward(tokens)`` (B, S) returns the training-path logits
    (B, S, vocab), equal to :func:`lm_prefill`'s. Parameters are
    initialized from ``seed`` as gluon does by default (weights and
    embeddings Uniform(±0.07), biases and LN betas 0, LN gammas 1), except
    that positions are drawn like the weights instead of zeroed, so that a
    randomly initialized model depends on position. Runs on ``cuda`` unless
    ``device`` names another device; with no card it raises.
    """

    def __init__(self, vocab_size=32000, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=2048, dropout=0.0,
                 *, device=None, seed: int = 0):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units={units} not divisible by "
                             f"num_heads={num_heads}")
        if dropout:
            raise NotImplementedError(
                "dropout belongs to a later slice of the port")
        device = as_device(device)
        self._units, self._heads = int(units), int(num_heads)
        self._max_length = int(max_length)
        self._vocab = int(vocab_size)
        self.embed = nn.Parameter(torch.empty(vocab_size, units,
                                              device=device))
        self.pos = nn.Parameter(torch.empty(max_length, units, device=device))
        self.layers = nn.ModuleList(
            TransformerEncoderCell(units, hidden_size, num_heads,
                                   causal=True, device=device)
            for _ in range(num_layers))
        self.final_g = nn.Parameter(torch.empty(units, device=device))
        self.final_b = nn.Parameter(torch.empty(units, device=device))
        self.dec_w = nn.Parameter(torch.empty(vocab_size, units,
                                              device=device))
        self.dec_b = nn.Parameter(torch.empty(vocab_size, device=device))
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator(device=self.embed.device)
        gen.manual_seed(int(seed))
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_g"):
                p.fill_(1.0)
            elif leaf.endswith("_b"):
                p.zero_()
            else:
                p.uniform_(-_INIT_SCALE, _INIT_SCALE, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _param_dict(self) -> dict:
        return {
            "embed": self.embed, "pos": self.pos,
            "final_g": self.final_g, "final_b": self.final_b,
            "dec_w": self.dec_w, "dec_b": self.dec_b,
            "layers": [dict(layer.named_parameters())
                       for layer in self.layers],
        }

    def forward(self, tokens):
        """The training path (the reference's ``hybrid_forward`` through
        ``BERTEncoder``): embedding plus positions, the causal cells, the
        final LN and the decoder. tokens (B, S) -> logits (B, S, vocab).
        Token ids are clamped to the vocabulary, as gluon's Embedding
        does."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        s = tokens.shape[1]
        x = self.embed[tokens.clamp(0, self._vocab - 1)] + self.pos[:s]
        for cell in self.layers:
            x = cell(x)
        x = _ln(x, self.final_g, self.final_b)
        return _dense(x, self.dec_w, self.dec_b)


def transformer_lm(vocab_size=32000, **kw) -> TransformerLM:
    return TransformerLM(vocab_size=vocab_size, **kw)


# ---------------------------------------------------------------------------
# Weights across packages
# ---------------------------------------------------------------------------

def decode_config(lm: TransformerLM) -> dict:
    """Static shape/config facts of an LM, for building decode programs."""
    return {
        "vocab": lm._vocab,
        "units": lm._units,
        "heads": lm._heads,
        "head_dim": lm._units // lm._heads,
        "layers": len(lm.layers),
        "max_length": lm._max_length,
    }


def decode_params(lm: TransformerLM) -> dict:
    """The LM's parameters as a flat dict of (detached) tensors, in the
    layout of the reference's ``decode_params``."""
    d = lm._param_dict()
    out = {k: v.detach() for k, v in d.items() if k != "layers"}
    out["layers"] = [{k: v.detach() for k, v in lp.items()}
                     for lp in d["layers"]]
    return out


@torch.no_grad()
def from_numpy_params(cfg: dict, params: dict, device=None) -> TransformerLM:
    """Build a :class:`TransformerLM` holding ``params`` — the dict of numpy
    arrays the JAX package's ``decode_params(lm)`` returns — for the
    config ``cfg`` (its ``decode_config``)."""
    hidden = int(np.shape(params["layers"][0]["ffn1_w"])[0])
    lm = TransformerLM(vocab_size=cfg["vocab"], units=cfg["units"],
                       hidden_size=hidden, num_layers=cfg["layers"],
                       num_heads=cfg["heads"], max_length=cfg["max_length"],
                       device=device)
    mine = lm._param_dict()
    pairs = [(mine[k], params[k]) for k in mine if k != "layers"]
    for lp_mine, lp in zip(mine["layers"], params["layers"], strict=True):
        pairs += [(lp_mine[k], lp[k]) for k in lp_mine]
    for dst, src in pairs:
        src = torch.as_tensor(np.array(src), dtype=dst.dtype)
        if src.shape != dst.shape:
            raise ValueError(f"parameter shape {tuple(src.shape)} does not "
                             f"match {tuple(dst.shape)}")
        dst.copy_(src)
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
    x = params["embed"][tokens] + params["pos"][:s]
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
    x = params["embed"][tokens] + params["pos"][positions]
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
