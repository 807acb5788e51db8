"""Recurrent cells and ``unroll``, the step-at-a-time API (counterpart of
``mxnet_tpu/gluon/rnn/rnn_cell.py``).

Cells are HybridBlocks computing one time step; ``unroll`` runs a Python
loop over a static length, with ``layout`` ``NTC``/``TNC``,
``merge_outputs`` and ``valid_length`` (the lengths reach the sequence
ops as an input; the reference passes them as a keyword that its
dispatch does not unwrap, so its ``valid_length`` raises). Gate orders
match the fused ``RNN`` op (LSTM ``[i, f, g, o]``, GRU ``[r, z, n]``,
linear before reset), so a cell and a one-layer fused layer with the
same weights compute the same thing. The fused layers (``rnn_layer.py``) are the fast
path for long sequences.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _format_sequence(length, inputs, layout, merge):
    """Split an (T,N,C)/(N,T,C) NDArray into a list of (N,C) steps, or
    merge a list of steps."""
    from ... import ndarray as F

    axis = layout.find("T")
    if isinstance(inputs, (list, tuple)):
        if merge:
            return F.stack(*inputs, axis=axis), axis
        return list(inputs), axis
    length = length or inputs.shape[axis]
    if merge is False:
        steps = F.split(inputs, num_outputs=length, axis=axis,
                        squeeze_axis=True)
        if length == 1:
            steps = [steps]
        return list(steps), axis
    return inputs, axis


class RecurrentCell(HybridBlock):
    """Base cell: one step of recurrence, and ``unroll``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._modified = False
        self._init_counter = -1

    def reset(self):
        self._init_counter = -1

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None,
                    dtype="float32", **kwargs):
        from ... import ndarray as nd

        func = func or nd.zeros
        return [func(shape=info["shape"], ctx=ctx, dtype=dtype, **kwargs)
                for info in self.state_info(batch_size)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F

        steps, axis = _format_sequence(length, inputs, layout, False)
        batch = steps[0].shape[0]
        states = begin_state if begin_state is not None else \
            self.begin_state(batch, ctx=steps[0].context,
                             dtype=steps[0].dtype)
        outputs = []
        for t in range(length):
            out, states = self(steps[t], states)
            outputs.append(out)
        if valid_length is not None:
            stacked = F.stack(*outputs, axis=0)  # (T, N, C)
            masked = F.SequenceMask(stacked, valid_length,
                                    use_sequence_length=True, axis=0)
            outputs = F.split(masked, num_outputs=length, axis=0,
                              squeeze_axis=True)
            outputs = [outputs] if length == 1 else list(outputs)
        if merge_outputs:
            outputs, _ = _format_sequence(length, outputs, layout, True)
        return outputs, states


class HybridRecurrentCell(RecurrentCell):
    pass


class RNNCell(HybridRecurrentCell):
    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._activation = activation
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(hidden_size,),
                                        init=i2h_bias_initializer)
        self.h2h_bias = self.params.get("h2h_bias", shape=(hidden_size,),
                                        init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape_inferred((self._hidden_size, x.shape[-1]))
        self.h2h_weight.shape_inferred((self._hidden_size,
                                        self._hidden_size))

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias,
                               num_hidden=self._hidden_size)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=self._hidden_size)
        out = F.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(HybridRecurrentCell):
    """One LSTM step; gate order [i, f, g, o], the fused op's."""

    def __init__(self, hidden_size, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(4 * hidden_size,),
                                        init=i2h_bias_initializer)
        self.h2h_bias = self.params.get("h2h_bias", shape=(4 * hidden_size,),
                                        init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape_inferred((4 * self._hidden_size, x.shape[-1]))
        self.h2h_weight.shape_inferred((4 * self._hidden_size,
                                        self._hidden_size))

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        nh = self._hidden_size
        gates = (F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=4 * nh)
                 + F.FullyConnected(states[0], h2h_weight, h2h_bias,
                                    num_hidden=4 * nh))
        i, f, g, o = F.split(gates, num_outputs=4, axis=-1)
        c = F.sigmoid(f) * states[1] + F.sigmoid(i) * F.tanh(g)
        h = F.sigmoid(o) * F.tanh(c)
        return h, [h, c]


class GRUCell(HybridRecurrentCell):
    """One GRU step; gate order [r, z, n], cuDNN's linear before reset."""

    def __init__(self, hidden_size, input_size=0, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get("i2h_bias", shape=(3 * hidden_size,),
                                        init=i2h_bias_initializer)
        self.h2h_bias = self.params.get("h2h_bias", shape=(3 * hidden_size,),
                                        init=h2h_bias_initializer)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def infer_shape(self, x, *args):
        self.i2h_weight.shape_inferred((3 * self._hidden_size, x.shape[-1]))
        self.h2h_weight.shape_inferred((3 * self._hidden_size,
                                        self._hidden_size))

    def hybrid_forward(self, F, x, states, i2h_weight, h2h_weight, i2h_bias,
                       h2h_bias):
        nh = self._hidden_size
        i2h = F.FullyConnected(x, i2h_weight, i2h_bias, num_hidden=3 * nh)
        h2h = F.FullyConnected(states[0], h2h_weight, h2h_bias,
                               num_hidden=3 * nh)
        ir, iz, inn = F.split(i2h, num_outputs=3, axis=-1)
        hr, hz, hn = F.split(h2h, num_outputs=3, axis=-1)
        r = F.sigmoid(ir + hr)
        z = F.sigmoid(iz + hz)
        n = F.tanh(inn + r * hn)
        h = (1.0 - z) * n + z * states[0]
        return h, [h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked vertically."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children.values(), batch_size)

    def __call__(self, x, states):
        return self.forward(x, states)

    def forward(self, x, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            x, cell_states = cell(x, states[p:p + n])
            next_states.extend(cell_states)
            p += n
        return x, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        first = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
        batch = first.shape[0 if layout[0] == "N" else 1]
        states = begin_state if begin_state is not None else \
            self.begin_state(batch, ctx=first.context)
        p = 0
        next_states = []
        cells = list(self._children.values())
        for i, cell in enumerate(cells):
            n = len(cell.state_info())
            inputs, cell_states = cell.unroll(
                length, inputs, states[p:p + n], layout,
                merge_outputs=None if i < len(cells) - 1 else merge_outputs,
                valid_length=valid_length)
            next_states.extend(cell_states)
            p += n
        return inputs, next_states

    def __getitem__(self, i):
        return list(self._children.values())[i]

    def __len__(self):
        return len(self._children)


class DropoutCell(HybridRecurrentCell):
    def __init__(self, rate, **kwargs):
        super().__init__(**kwargs)
        self._rate = rate

    def state_info(self, batch_size=0):
        return []

    def hybrid_forward(self, F, x, states):
        if self._rate:
            x = F.Dropout(x, p=self._rate)
        return x, states


class _ModifierCell(HybridRecurrentCell):
    def __init__(self, base_cell, **kwargs):
        super().__init__(**kwargs)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, **kwargs):
        return self.base_cell.begin_state(batch_size, **kwargs)


class ResidualCell(_ModifierCell):
    def hybrid_forward(self, F, x, states):
        out, states = self.base_cell(x, states)
        return out + x, states


class ZoneoutCell(_ModifierCell):
    """Zoneout: in training, each output and state keeps its previous
    value with probability ``zoneout_outputs``/``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 **kwargs):
        super().__init__(base_cell, **kwargs)
        self._zo = zoneout_outputs
        self._zs = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, x, states):
        from ... import autograd

        out, next_states = self.base_cell(x, states)
        if autograd.is_training():
            def mask(p, like):
                return F.Dropout(F.ones_like(like), p=p)

            if self._zo:
                prev = self._prev_output if self._prev_output is not None \
                    else F.zeros_like(out)
                out = F.where(mask(self._zo, out), out, prev)
            if self._zs:
                next_states = [F.where(mask(self._zs, ns), ns, s)
                               for ns, s in zip(next_states, states)]
        self._prev_output = out
        return out, next_states


class BidirectionalCell(HybridRecurrentCell):
    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return _cells_state_info([self.l_cell, self.r_cell], batch_size)

    def __call__(self, x, states):
        raise NotImplementedError("BidirectionalCell cannot be stepped; "
                                  "use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        from ... import ndarray as F

        steps, axis = _format_sequence(length, inputs, layout, False)
        batch = steps[0].shape[0]
        states = begin_state if begin_state is not None else \
            self.begin_state(batch, ctx=steps[0].context,
                             dtype=steps[0].dtype)

        def _seq_reverse(step_list):
            """The steps reversed in time; with ``valid_length`` only each
            sequence's valid prefix is (padding stays in place)."""
            if valid_length is None:
                return list(reversed(step_list))
            revd = F.SequenceReverse(F.stack(*step_list, axis=0),
                                     valid_length, use_sequence_length=True,
                                     axis=0)
            parts = F.split(revd, num_outputs=length, axis=0,
                            squeeze_axis=True)
            return [parts] if length == 1 else list(parts)

        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(
            length, steps, states[:nl], layout="NTC", merge_outputs=False,
            valid_length=valid_length)
        r_out, r_states = self.r_cell.unroll(
            length, _seq_reverse(steps), states[nl:], layout="NTC",
            merge_outputs=False, valid_length=valid_length)
        r_out = _seq_reverse(r_out)
        outputs = [F.concat(lo, ro, dim=-1) for lo, ro in zip(l_out, r_out)]
        if merge_outputs:
            outputs, _ = _format_sequence(length, outputs, layout, True)
        return outputs, l_states + r_states
