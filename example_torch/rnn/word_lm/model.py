"""LSTM language model (the port's copy of example/rnn/word_lm/model.py —
the fused RNN op workhorse, baseline config 2; cuDNN on the card)."""
from __future__ import annotations

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon import nn, rnn


class RNNModel(mx.gluon.Block):
    def __init__(self, mode, vocab_size, num_embed, num_hidden, num_layers,
                 dropout=0.5, tie_weights=False, **kwargs):
        super().__init__(**kwargs)
        self.drop = nn.Dropout(dropout)
        self.encoder = nn.Embedding(vocab_size, num_embed)
        if mode == "lstm":
            self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                                input_size=num_embed)
        elif mode == "gru":
            self.rnn = rnn.GRU(num_hidden, num_layers, dropout=dropout,
                               input_size=num_embed)
        else:
            self.rnn = rnn.RNN(num_hidden, num_layers, dropout=dropout,
                               input_size=num_embed,
                               activation="relu" if mode == "rnn_relu" else "tanh")
        self.decoder = nn.Dense(vocab_size, in_units=num_hidden, flatten=False)
        self.num_hidden = num_hidden

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        decoded = self.decoder(output)
        return decoded, hidden

    def begin_state(self, batch_size, ctx=None):
        return self.rnn.begin_state(batch_size=batch_size, ctx=ctx)
