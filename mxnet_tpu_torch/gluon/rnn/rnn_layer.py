"""Fused recurrent layers: ``RNN``, ``LSTM`` and ``GRU`` (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``).

Parameters are held unfused, one ``{l|r}{layer}_{i2h|h2h}_{weight|bias}``
per layer and direction under the reference's names, so ``.params``
files load both ways; the forward concatenates them into the flat
vector the ``RNN`` op takes (every weight, then every bias) and calls
``F.RNN``, which runs cuDNN on the card (``ops/rnn.py``). ``layout`` is
``TNC`` or ``NTC``; with explicit begin states the layer returns
``(output, states)``, without them the output alone.
"""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers=1, layout="TNC",
                 dropout=0.0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), f"invalid layout {layout!r}"
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._dtype = dtype
        self._gates = _GATES[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in ["l", "r"][: self._dir]:
                self._register_param(f"{j}{i}_i2h_weight", (ng * nh, ni),
                                     i2h_weight_initializer, dtype)
                self._register_param(f"{j}{i}_h2h_weight", (ng * nh, nh),
                                     h2h_weight_initializer, dtype)
                self._register_param(f"{j}{i}_i2h_bias", (ng * nh,),
                                     i2h_bias_initializer, dtype)
                self._register_param(f"{j}{i}_h2h_bias", (ng * nh,),
                                     h2h_bias_initializer, dtype)
            ni = nh * self._dir

    def _register_param(self, name, shape, init, dtype):
        p = self.params.get(name, shape=shape, init=init, dtype=dtype,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def infer_shape(self, x, *args):
        ni = x.shape[-1]
        ng, nh = self._gates, self._hidden_size
        for i in range(self._num_layers):
            for j in ["l", "r"][: self._dir]:
                getattr(self, f"{j}{i}_i2h_weight").shape_inferred(
                    (ng * nh, ni))
            ni = nh * self._dir
        self._input_size = self._input_size or x.shape[-1]

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, ctx=None, dtype=None,
                    **kwargs):
        from ... import ndarray as nd

        func = func or nd.zeros
        return [func(shape=info["shape"], ctx=ctx,
                     dtype=dtype or self._dtype, **kwargs)
                for info in self.state_info(batch_size)]

    def _param_order_names(self):
        """Weights for every layer and direction first, then biases: the
        packed layout of ``ops.rnn.rnn_unpack_params``."""
        names = []
        for kind in ("weight", "bias"):
            for i in range(self._num_layers):
                for j in ["l", "r"][: self._dir]:
                    names.append(f"{j}{i}_i2h_{kind}")
                    names.append(f"{j}{i}_h2h_{kind}")
        return names

    def hybrid_forward(self, F, x, states=None, **params):
        if isinstance(states, (list, tuple)) and len(states) == 0:
            states = None
        if self._layout == "NTC":
            x = F.swapaxes(x, dim1=0, dim2=1)
        batch = x.shape[1]
        skip_states = states is None
        if skip_states:
            # zero states where x lives (the graph's device when tracing)
            where = {"ctx": x.context} if hasattr(x, "context") else {}
            states = [F.zeros(shape=info["shape"],
                              dtype=getattr(x, "dtype", "float32"), **where)
                      for info in self.state_info(batch)]
        if not isinstance(states, (list, tuple)):
            states = [states]
        flat = F.concat(*[params[n].reshape(-1)
                          for n in self._param_order_names()], dim=0)
        out = F.RNN(x, flat, *states, state_size=self._hidden_size,
                    num_layers=self._num_layers, mode=self._mode,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=True)
        outputs, rstates = out[0], list(out[1:])
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return outputs, rstates

    def __repr__(self):
        return (f"{self.__class__.__name__}({self._hidden_size}, "
                f"num_layers={self._num_layers}, layout='{self._layout}', "
                f"bidirectional={self._dir == 2})")


class RNN(_RNNLayer):
    """Elman RNN with tanh or relu."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__("rnn_" + activation, hidden_size, num_layers,
                         layout, dropout, bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM over the fused RNN op."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"},
                {"shape": shape, "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """Multi-layer GRU, cuDNN's gate convention."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__("gru", hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
