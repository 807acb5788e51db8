"""gluon.nn: neural-network layers (counterpart of
``mxnet_tpu/gluon/nn/``). The convolution and batch/instance/group norm
layers wait for their ops (queue item A9)."""
from .basic_layers import *  # noqa: F401,F403
from . import basic_layers

__all__ = basic_layers.__all__
