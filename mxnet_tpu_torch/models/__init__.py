"""Model families of the port (counterpart of
``mxnet_tpu/models/``): the transformer family, BERT and the decoder-only
causal ``TransformerLM`` as Gluon blocks, with tensor-parallel rules and
the LM's decode interface (``transformer.py``). The seq2seq and SSD
families are not ported yet."""
from .transformer import (MultiHeadAttention, PositionwiseFFN,  # noqa: F401
                          TransformerEncoderCell, BERTEncoder, BERTModel,
                          TransformerLM, bert_base, bert_large, bert_tiny,
                          transformer_lm, bert_sharding_rules)
