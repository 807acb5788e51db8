"""Model families of the port. This slice holds the decoder-only causal
``TransformerLM`` as a Gluon block, its ``torch.nn.Module`` form and its
decode interface (``transformer.py``)."""
from .transformer import (TransformerLM, TransformerLMModule,  # noqa: F401
                          transformer_lm)
