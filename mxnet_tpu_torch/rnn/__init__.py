"""``mx.rnn``: the symbolic RNN cell API and the bucketing iterator
(counterpart of ``mxnet_tpu/rnn/``)."""
from .io import BucketSentenceIter  # noqa: F401
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,  # noqa: F401
                       FusedRNNCell, GRUCell, LSTMCell, ResidualCell,
                       RNNCell, SequentialRNNCell, ZoneoutCell)
