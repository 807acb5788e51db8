"""Optimizers of the port (sgd, adam, adamw) and their one-call
multi-tensor update (``fused.lower_update``)."""
from .fused import lower_update  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Optimizer, create, register  # noqa: F401
