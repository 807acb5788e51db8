"""The fused ``RNN`` op: LSTM, GRU and vanilla RNN, multi-layer and
bidirectional (counterpart of ``mxnet_tpu/ops/rnn.py``).

All weights come packed in one flat vector, in the reference's layout:
``W_i2h`` (G*H, in) and ``W_h2h`` (G*H, H) for every (layer, direction)
first, then ``b_i2h`` and ``b_h2h`` in the same order
(:func:`rnn_unpack_params`). Gate orders are cuDNN's: LSTM ``[i, f, g, o]``,
GRU ``[r, z, n]`` with the recurrent candidate term biased on its own
(linear before reset).

Two routes compute it, chosen by the data's device (:func:`rnn_route`):

- ``"cudnn"`` on a CUDA tensor: torch's cuDNN-backed RNN functions
  (``torch._VF.lstm``/``gru``/``rnn_tanh``/``rnn_relu``), given the
  weights as :func:`rnn_unpack_params` splits them. They stand where the
  reference has what XLA generates from its ``lax.scan``; its upstream's
  own path is cuDNN. With cuDNN unavailable or disabled the op raises:
  it never falls back to the loop on the card.
- ``"loop"`` elsewhere (the CPU, the shape engine's meta tensors): the
  explicit per-step loop below, one counterpart of each of the
  reference's three scans (``_lstm_scan``, ``_gru_scan``,
  ``_vanilla_scan``). It is the plain version, the tests' oracle.

Inter-layer dropout draws its mask from the framework's generator
(``mxnet_tpu_torch.random``) in both routes, so with ``p > 0`` in
training the cuDNN route runs one layer per call; its masks match the
reference's in distribution only. ``lstm_state_clip_*`` clips the final
cell state, as the reference does. ``rnn_calls`` counts the op's calls
by route.
"""
from __future__ import annotations

import warnings

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["rnn_param_size", "rnn_unpack_params", "rnn_route", "rnn_calls",
           "rnn_loop", "rnn_cudnn"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}

rnn_calls = {"cudnn": 0, "loop": 0}


def rnn_param_size(mode, input_size, state_size, num_layers=1,
                   bidirectional=False):
    """Length of the packed parameter vector."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else state_size * dirs
        size += dirs * g * state_size * (isz + state_size + 2)
    return size


def rnn_unpack_params(params, mode, input_size, state_size, num_layers,
                      bidirectional):
    """Split the flat vector into ``[layer][direction] = [w_ih, w_hh, b_ih,
    b_hh]`` views: every weight first, then every bias."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    h = state_size
    out = []
    off = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else h * dirs
        parts = []
        for _ in range(dirs):
            w_ih = params.narrow(0, off, g * h * isz).reshape(g * h, isz)
            off += g * h * isz
            w_hh = params.narrow(0, off, g * h * h).reshape(g * h, h)
            off += g * h * h
            parts.append([w_ih, w_hh])
        out.append(parts)
    for layer in range(num_layers):
        for d in range(dirs):
            b_ih = params.narrow(0, off, g * h)
            off += g * h
            b_hh = params.narrow(0, off, g * h)
            off += g * h
            out[layer][d].extend([b_ih, b_hh])
    return out


def rnn_route(device) -> str:
    """``"cudnn"`` for a CUDA device, ``"loop"`` for any other."""
    return "cudnn" if torch.device(device).type == "cuda" else "loop"


# ---------------------------------------------------------------------------
# The plain version: one explicit step at a time
# ---------------------------------------------------------------------------

def _steps(t, reverse):
    return range(t - 1, -1, -1) if reverse else range(t)


def _lstm_loop(xs, h0, c0, w_ih, w_hh, b_ih, b_hh, reverse):
    x_proj = torch.matmul(xs, w_ih.T) + b_ih  # the input GEMM, hoisted
    h, c = h0, c0
    ys = [None] * xs.shape[0]
    for t in _steps(xs.shape[0], reverse):
        gates = x_proj[t] + torch.matmul(h, w_hh.T) + b_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys[t] = h
    return torch.stack(ys), h, c


def _gru_loop(xs, h0, w_ih, w_hh, b_ih, b_hh, reverse):
    x_proj = torch.matmul(xs, w_ih.T) + b_ih
    h = h0
    ys = [None] * xs.shape[0]
    for t in _steps(xs.shape[0], reverse):
        h_proj = torch.matmul(h, w_hh.T) + b_hh
        xr, xz, xn = x_proj[t].chunk(3, dim=-1)
        hr, hz, hn = h_proj.chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        ys[t] = h
    return torch.stack(ys), h


def _vanilla_loop(xs, h0, w_ih, w_hh, b_ih, b_hh, act, reverse):
    x_proj = torch.matmul(xs, w_ih.T) + b_ih
    h = h0
    ys = [None] * xs.shape[0]
    for t in _steps(xs.shape[0], reverse):
        h = act(x_proj[t] + torch.matmul(h, w_hh.T) + b_hh)
        ys[t] = h
    return torch.stack(ys), h


def _dropout(xs, p):
    from ..random import generator

    keep = torch.rand(xs.shape, generator=generator(xs.device),
                      device=xs.device) < 1.0 - p
    return torch.where(keep, xs / (1.0 - p), torch.zeros_like(xs))


def rnn_loop(data, layers, state, state_cell, mode, p, train):
    """The per-step route over unpacked ``layers``: (output, [h_T], [c_T])
    with one final state per (layer, direction)."""
    dirs = len(layers[0])
    act = torch.relu if mode == "rnn_relu" else torch.tanh
    xs = data
    h_finals, c_finals = [], []
    for li, layer in enumerate(layers):
        if p and train and li > 0:
            xs = _dropout(xs, p)
        outs = []
        for d, (w_ih, w_hh, b_ih, b_hh) in enumerate(layer):
            h0 = state[li * dirs + d]
            rev = d == 1
            if mode == "lstm":
                ys, h_t, c_t = _lstm_loop(xs, h0, state_cell[li * dirs + d],
                                          w_ih, w_hh, b_ih, b_hh, rev)
                c_finals.append(c_t)
            elif mode == "gru":
                ys, h_t = _gru_loop(xs, h0, w_ih, w_hh, b_ih, b_hh, rev)
            else:
                ys, h_t = _vanilla_loop(xs, h0, w_ih, w_hh, b_ih, b_hh, act,
                                        rev)
            outs.append(ys)
            h_finals.append(h_t)
        xs = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
    return xs, h_finals, c_finals


# ---------------------------------------------------------------------------
# The cuDNN route
# ---------------------------------------------------------------------------

def _vf_call(mode, xs, hx, cx, weights, num_layers, bidirectional):
    fn = getattr(torch._VF, mode)  # lstm, gru, rnn_tanh, rnn_relu
    # cuDNN keeps what its backward needs only in "training" mode; the
    # dropout torch would apply is 0 here (the framework's is outside)
    train = torch.is_grad_enabled()
    with warnings.catch_warnings():
        # the weights are views of the packed vector, not one cuDNN
        # buffer: torch copies them into one each call and says so
        warnings.filterwarnings("ignore", message=".*contiguous chunk")
        if mode == "lstm":
            out, h_n, c_n = fn(xs, (hx, cx), weights, True, num_layers, 0.0,
                               train, bidirectional, False)
            return out, h_n, c_n
        out, h_n = fn(xs, hx, weights, True, num_layers, 0.0, train,
                      bidirectional, False)
        return out, h_n, None


def rnn_cudnn(data, layers, state, state_cell, mode, p, train):
    """The library route over unpacked ``layers``: all layers in one call,
    or one call per layer with the framework's dropout between them.
    Returns (output, h_n, c_n) with the states stacked as the loop's."""
    dirs = len(layers[0])
    bidir = dirs == 2
    flat = [w for layer in layers for d in layer for w in d]
    if not (p and train) or len(layers) == 1:
        cx = state_cell if mode == "lstm" else None
        return _vf_call(mode, data, state.contiguous(),
                        None if cx is None else cx.contiguous(), flat,
                        len(layers), bidir)
    xs = data
    hs, cs = [], []
    for li, layer in enumerate(layers):
        if li > 0:
            xs = _dropout(xs, p)
        sl = slice(li * dirs, (li + 1) * dirs)
        xs, h_n, c_n = _vf_call(
            mode, xs, state[sl].contiguous(),
            None if mode != "lstm" else state_cell[sl].contiguous(),
            [w for d in layer for w in d], 1, bidir)
        hs.append(h_n)
        cs.append(c_n)
    return xs, torch.cat(hs), (torch.cat(cs) if mode == "lstm" else None)


def _rnn_n_out(kwargs):
    if not kwargs.get("state_outputs", False):
        return 1
    return 3 if kwargs.get("mode", "lstm") == "lstm" else 2


@register("RNN", num_outputs=_rnn_n_out,
          ndarray_inputs=["data", "parameters", "state", "state_cell"])
def _rnn(data, parameters, state, state_cell=None, *, state_size, num_layers,
         mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
         projection_size=None, lstm_state_clip_min=None,
         lstm_state_clip_max=None, sequence_length=None,
         use_sequence_length=False):
    """data (T, N, C) sequence-major; state (L*dirs, N, H); parameters
    flat. Returns output (T, N, H*dirs) [+ final h [+ final c for lstm]
    when ``state_outputs``]."""
    if projection_size:
        raise NotImplementedError("RNN projection_size is not supported")
    t, n, input_size = data.shape
    layers = rnn_unpack_params(parameters.to(data.dtype), mode, input_size,
                               int(state_size), int(num_layers),
                               bool(bidirectional))
    from .nn import _is_training

    train = _is_training()
    route = rnn_route(data.device)
    if route == "cudnn":
        if not (torch.backends.cudnn.is_available()
                and torch.backends.cudnn.enabled):
            raise MXNetError("RNN on a CUDA tensor runs cuDNN, which is "
                             "unavailable or disabled")
        xs, h_out, c_out = rnn_cudnn(data, layers, state, state_cell, mode,
                                     p, train)
    else:
        xs, hs, cs = rnn_loop(data, layers, state, state_cell, mode, p,
                              train)
        h_out = torch.stack(hs)
        c_out = torch.stack(cs) if mode == "lstm" else None
    rnn_calls[route] += 1
    if mode == "lstm" and (lstm_state_clip_min is not None
                           or lstm_state_clip_max is not None):
        c_out = torch.clamp(c_out, lstm_state_clip_min, lstm_state_clip_max)
    if use_sequence_length and sequence_length is not None:
        mask = (torch.arange(t, device=data.device)[:, None]
                < sequence_length.to(torch.int32)[None, :])
        xs = torch.where(mask[:, :, None], xs, torch.zeros_like(xs))
    if not state_outputs:
        return xs
    if mode == "lstm":
        return xs, h_out, c_out
    return xs, h_out
