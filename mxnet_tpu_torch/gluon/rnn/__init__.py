"""Gluon recurrent layers and cells (counterpart of
``mxnet_tpu/gluon/rnn/``): the fused layers ``RNN``/``LSTM``/``GRU``
over the ``RNN`` op, and the step-at-a-time cells with ``unroll``."""
from .rnn_layer import RNN, LSTM, GRU  # noqa: F401
from .rnn_cell import (  # noqa: F401
    RecurrentCell, RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
    BidirectionalCell, DropoutCell, ResidualCell, ZoneoutCell,
    HybridRecurrentCell,
)
