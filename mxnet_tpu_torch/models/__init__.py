"""Model families of the port (counterpart of
``mxnet_tpu/models/``): the transformer family, BERT and the decoder-only
causal ``TransformerLM`` as Gluon blocks, with tensor-parallel rules and
the LM's decode interface (``transformer.py``), and the encoder-decoder
NMT transformer with label smoothing and beam search (``seq2seq.py``),
and the SSD detector with its multibox loss (``ssd.py``)."""
from .transformer import (MultiHeadAttention, PositionwiseFFN,  # noqa: F401
                          TransformerEncoderCell, BERTEncoder, BERTModel,
                          TransformerLM, bert_base, bert_large, bert_tiny,
                          transformer_lm, bert_sharding_rules)
from .seq2seq import (TransformerDecoderCell, Seq2SeqTransformer,  # noqa: F401
                      beam_search, label_smoothing_loss)
from .ssd import SSD, SSDMultiBoxLoss, ssd_300  # noqa: F401
