"""The symbolic RNN cells of ``mx.rnn`` (counterpart of
``mxnet_tpu/rnn/rnn_cell.py``): the API the ``BucketingModule`` examples
drive, building per-step symbol graphs over explicit parameter
variables, then ``unroll``.

Gate orders are the fused ``RNN`` op's (``ops/rnn.py``): LSTM
``[i, f, g, o]``, GRU ``[r, z, n]``, so ``FusedRNNCell`` and the unfused
cells share weights: ``FusedRNNCell.pack_weights`` / ``unpack_weights``
convert between per-cell arrays and the packed vector (one direction,
as the reference's).
"""
from __future__ import annotations

from typing import List

from .. import symbol as sym

__all__ = ["BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "FusedRNNCell",
           "BidirectionalCell", "ResidualCell", "ZoneoutCell"]


class BaseRNNCell:
    def __init__(self, prefix=""):
        self._prefix = prefix
        self._counter = 0
        self._own_params = {}

    def _var(self, name):
        full = self._prefix + name
        if full not in self._own_params:
            self._own_params[full] = sym.Variable(full)
        return self._own_params[full]

    @property
    def state_info(self):
        raise NotImplementedError

    def begin_state(self, func=None, batch_size=0, **kwargs):
        """Zero begin states. With ``func``+``batch_size`` this builds
        concrete symbols (legacy ``func=mx.sym.zeros`` pattern); otherwise
        it returns None placeholders that ``__call__``/``unroll``
        materialize from the step input's batch dimension."""
        if func is not None and batch_size:
            return [func(shape=(batch_size, n)) for n in self.state_info]
        return [None for _ in self.state_info]

    def _materialize(self, inputs, states):
        """Replace None begin-state placeholders with input-derived zeros
        so the manual per-step pattern (`out, st = cell(x_t, st)`) works."""
        return [self._zeros_like_state(inputs, n) if s is None else s
                for s, n in zip(states, self.state_info)]

    def __call__(self, inputs, states):
        raise NotImplementedError

    def reset(self):
        self._counter = 0

    def _zeros_like_state(self, x_t, n):
        """(B, n) zeros built from a (B, C) step input — keeps the graph
        free of concrete batch sizes."""
        z = sym.mean(x_t, axis=-1, keepdims=True) * 0.0  # (B, 1)
        return sym.tile(z, reps=(1, n))

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """inputs: one (N, T, C) symbol (layout NTC) or a list of T
        step symbols. Returns (outputs, states)."""
        self.reset()
        if isinstance(inputs, (list, tuple)):
            steps = list(inputs)
        else:
            axis = layout.find("T")
            steps = [sym.squeeze(sym.slice_axis(inputs, axis=axis, begin=t,
                                                end=t + 1), axis=axis)
                     for t in range(length)]
        states = begin_state if begin_state is not None \
            else self.begin_state()
        outputs = []
        for t in range(length):
            if any(s is None for s in states):
                states = [self._zeros_like_state(steps[t], info)
                          if s is None else s
                          for s, info in zip(states, self.state_info)]
            out, states = self(steps[t], states)
            outputs.append(out)
        if merge_outputs:
            axis = layout.find("T")
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, states


class RNNCell(BaseRNNCell):
    def __init__(self, num_hidden, activation="tanh", prefix="rnn_"):
        super().__init__(prefix)
        self._h = num_hidden
        self._act = activation

    @property
    def state_info(self):
        return [self._h]

    def __call__(self, inputs, states):
        states = self._materialize(inputs, states)
        i2h = sym.FullyConnected(inputs, self._var("i2h_weight"),
                                 self._var("i2h_bias"),
                                 num_hidden=self._h, flatten=False)
        h2h = sym.FullyConnected(states[0], self._var("h2h_weight"),
                                 self._var("h2h_bias"),
                                 num_hidden=self._h, flatten=False)
        out = sym.Activation(i2h + h2h, act_type=self._act)
        return out, [out]


class LSTMCell(BaseRNNCell):
    def __init__(self, num_hidden, prefix="lstm_"):
        super().__init__(prefix)
        self._h = num_hidden

    @property
    def state_info(self):
        return [self._h, self._h]

    def __call__(self, inputs, states):
        states = self._materialize(inputs, states)
        h = self._h
        gates = (sym.FullyConnected(inputs, self._var("i2h_weight"),
                                    self._var("i2h_bias"),
                                    num_hidden=4 * h, flatten=False)
                 + sym.FullyConnected(states[0], self._var("h2h_weight"),
                                      self._var("h2h_bias"),
                                      num_hidden=4 * h, flatten=False))
        i = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=0, end=h))
        f = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=h, end=2 * h))
        g = sym.tanh(sym.slice_axis(gates, axis=-1, begin=2 * h, end=3 * h))
        o = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=3 * h,
                                       end=4 * h))
        c = f * states[1] + i * g
        out = o * sym.tanh(c)
        return out, [out, c]


class GRUCell(BaseRNNCell):
    """cuDNN GRU variant (linear_before_reset): the recurrent candidate
    term keeps its own bias, matching ops/rnn.py's fused scan."""

    def __init__(self, num_hidden, prefix="gru_"):
        super().__init__(prefix)
        self._h = num_hidden

    @property
    def state_info(self):
        return [self._h]

    def __call__(self, inputs, states):
        states = self._materialize(inputs, states)
        h = self._h
        i2h = sym.FullyConnected(inputs, self._var("i2h_weight"),
                                 self._var("i2h_bias"),
                                 num_hidden=3 * h, flatten=False)
        h2h = sym.FullyConnected(states[0], self._var("h2h_weight"),
                                 self._var("h2h_bias"),
                                 num_hidden=3 * h, flatten=False)
        xr = sym.slice_axis(i2h, axis=-1, begin=0, end=h)
        xz = sym.slice_axis(i2h, axis=-1, begin=h, end=2 * h)
        xn = sym.slice_axis(i2h, axis=-1, begin=2 * h, end=3 * h)
        hr = sym.slice_axis(h2h, axis=-1, begin=0, end=h)
        hz = sym.slice_axis(h2h, axis=-1, begin=h, end=2 * h)
        hn = sym.slice_axis(h2h, axis=-1, begin=2 * h, end=3 * h)
        r = sym.sigmoid(xr + hr)
        z = sym.sigmoid(xz + hz)
        n = sym.tanh(xn + r * hn)
        out = (1.0 - z) * n + z * states[0]
        return out, [out]


class SequentialRNNCell(BaseRNNCell):
    def __init__(self):
        super().__init__("")
        self._cells: List[BaseRNNCell] = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return [i for c in self._cells for i in c.state_info]

    def __call__(self, inputs, states):
        next_states = []
        pos = 0
        out = inputs
        for c in self._cells:
            n = len(c.state_info)
            out, st = c(out, states[pos:pos + n])
            next_states.extend(st)
            pos += n
        return out, next_states


class DropoutCell(BaseRNNCell):
    def __init__(self, dropout, prefix="dropout_"):
        super().__init__(prefix)
        self._p = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        return sym.Dropout(inputs, p=self._p), states


class FusedRNNCell(BaseRNNCell):
    """The fused RNN op behind the cell API: one packed parameter vector
    (``{prefix}parameters``), the whole sequence in one op call (cuDNN on
    the card)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, prefix="fused_"):
        super().__init__(prefix)
        self._h = num_hidden
        self._layers = num_layers
        self._mode = mode
        self._bidir = bidirectional

    @property
    def state_info(self):
        dirs = 2 if self._bidir else 1
        n = self._layers * dirs
        return [n * self._h] * (2 if self._mode == "lstm" else 1)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        if isinstance(inputs, (list, tuple)):
            axis0 = sym.stack(*inputs, axis=0)  # (T, N, C)
        else:
            t_ax = layout.find("T")
            axis0 = inputs if t_ax == 0 else sym.transpose(
                inputs, axes=(1, 0, 2))
        dirs = 2 if self._bidir else 1
        n_states = self._layers * dirs
        params = self._var("parameters")

        def zero_state():
            z = sym.mean(sym.slice_axis(axis0, axis=0, begin=0, end=1),
                         axis=-1, keepdims=True) * 0.0   # (1, N, 1)
            return sym.tile(z, reps=(n_states, 1, self._h))

        states = begin_state if begin_state is not None else \
            [None] * len(self.state_info)
        states = [zero_state() if s is None else s for s in states]
        args = [axis0, params] + states
        res = sym.RNN(*args, state_size=self._h, num_layers=self._layers,
                      mode=self._mode, bidirectional=self._bidir,
                      state_outputs=True)
        n_out = 3 if self._mode == "lstm" else 2
        out = res[0]
        final_states = [res[i] for i in range(1, n_out)]
        if layout.find("T") == 1:
            out = sym.transpose(out, axes=(1, 0, 2))
        if merge_outputs is False:
            t_ax = layout.find("T")
            out = [sym.squeeze(sym.slice_axis(out, axis=t_ax, begin=t,
                                              end=t + 1), axis=t_ax)
                   for t in range(length)]
        return out, final_states


    def begin_state(self, func=None, batch_size=0, **kwargs):
        dirs = 2 if self._bidir else 1
        n = self._layers * dirs
        if func is not None and batch_size:
            return [func(shape=(n, batch_size, self._h))
                    for _ in self.state_info]
        return [None for _ in self.state_info]

    def pack_weights(self, args):
        """Per-cell arrays -> the packed vector (single direction only, as
        the reference's). ``args`` maps
        ``{prefix}l{i}_i2h_weight`` etc. to numpy arrays; returns the flat
        vector under ``{prefix}parameters``."""
        import numpy as np

        if self._bidir:
            raise NotImplementedError("pack_weights: bidirectional TBD")
        parts_w, parts_b = [], []
        for li in range(self._layers):
            parts_w.append(np.asarray(
                args[f"{self._prefix}l{li}_i2h_weight"]).reshape(-1))
            parts_w.append(np.asarray(
                args[f"{self._prefix}l{li}_h2h_weight"]).reshape(-1))
            parts_b.append(np.asarray(
                args[f"{self._prefix}l{li}_i2h_bias"]).reshape(-1))
            parts_b.append(np.asarray(
                args[f"{self._prefix}l{li}_h2h_bias"]).reshape(-1))
        out = dict(args)
        out[f"{self._prefix}parameters"] = np.concatenate(
            parts_w + parts_b).astype(np.float32)
        return out

    def unpack_weights(self, args, input_size):
        """Packed vector -> per-cell tensors (inverse of pack_weights).
        ``input_size`` fixes layer-0's input width."""
        import numpy as np

        from ..ops.rnn import _GATES

        if self._bidir:
            raise NotImplementedError("unpack_weights: bidirectional TBD")
        g = _GATES[self._mode]
        h = self._h
        vec = np.asarray(args[f"{self._prefix}parameters"]).reshape(-1)
        out = dict(args)
        off = 0
        for li in range(self._layers):
            isz = input_size if li == 0 else h
            out[f"{self._prefix}l{li}_i2h_weight"] = \
                vec[off:off + g * h * isz].reshape(g * h, isz)
            off += g * h * isz
            out[f"{self._prefix}l{li}_h2h_weight"] = \
                vec[off:off + g * h * h].reshape(g * h, h)
            off += g * h * h
        for li in range(self._layers):
            out[f"{self._prefix}l{li}_i2h_bias"] = vec[off:off + g * h]
            off += g * h
            out[f"{self._prefix}l{li}_h2h_bias"] = vec[off:off + g * h]
            off += g * h
        return out


class BidirectionalCell(BaseRNNCell):
    """Runs l_cell forward and r_cell backward over the sequence and
    concatenates the per-step outputs on the feature axis; unroll only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(output_prefix)
        self._l, self._r = l_cell, r_cell

    @property
    def state_info(self):
        return self._l.state_info + self._r.state_info

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "BidirectionalCell supports unroll() only (per-step calls "
            "cannot see the future half of the sequence)")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if not isinstance(inputs, (list, tuple)):
            axis = layout.find("T")
            inputs = [sym.squeeze(sym.slice_axis(inputs, axis=axis, begin=t,
                                                 end=t + 1), axis=axis)
                      for t in range(length)]
        n_l = len(self._l.state_info)
        bs_l = begin_state[:n_l] if begin_state is not None else None
        bs_r = begin_state[n_l:] if begin_state is not None else None
        l_out, l_states = self._l.unroll(length, list(inputs),
                                         begin_state=bs_l, layout=layout,
                                         merge_outputs=False)
        r_out, r_states = self._r.unroll(length, list(inputs)[::-1],
                                         begin_state=bs_r, layout=layout,
                                         merge_outputs=False)
        r_out = list(r_out)[::-1]
        outputs = [sym.concat(lo, ro, dim=-1)
                   for lo, ro in zip(l_out, r_out)]
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=layout.find("T"))
        return outputs, list(l_states) + list(r_states)


class ResidualCell(BaseRNNCell):
    """Adds the cell input to its output."""

    def __init__(self, base_cell):
        super().__init__("")
        self._base = base_cell

    @property
    def state_info(self):
        return self._base.state_info

    def begin_state(self, *a, **kw):
        return self._base.begin_state(*a, **kw)

    def __call__(self, inputs, states):
        out, states = self._base(inputs, states)
        return out + inputs, states


class ZoneoutCell(BaseRNNCell):
    """Zoneout in its expectation form, as the reference's: each state
    (and output) is ``p * previous + (1 - p) * new``, with the previous
    output zero at the first step."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__("")
        self._base = base_cell
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    @property
    def state_info(self):
        return self._base.state_info

    def begin_state(self, *a, **kw):
        return self._base.begin_state(*a, **kw)

    def reset(self):
        super().reset()
        self._base.reset()
        self._prev_output = None  # a new sequence starts from zero output

    def __call__(self, inputs, states):
        prev = self._base._materialize(inputs, states)
        out, new_states = self._base(inputs, prev)
        if self._zs:
            new_states = [p * self._zs + n * (1.0 - self._zs)
                          for p, n in zip(prev, new_states)]
        if self._zo:
            # the previous output is tracked across steps (zero at t=0)
            prev_out = (self._prev_output if self._prev_output is not None
                        else out * 0.0)
            out = prev_out * self._zo + out * (1.0 - self._zo)
            self._prev_output = out
        return out, new_states
