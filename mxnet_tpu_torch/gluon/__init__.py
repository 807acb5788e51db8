"""Gluon pieces of the port. This slice holds the losses of the training
path (``loss.py``); ``Parameter``/``Block``/``HybridBlock`` belong to a
later slice (the port's models are ``torch.nn.Module``s)."""
from . import loss  # noqa: F401
