"""Gluon, the imperative high-level API (counterpart of
``mxnet_tpu/gluon/``): ``Parameter``/``ParameterDict``, ``Block``/
``HybridBlock``, the ``nn`` layers, the losses, ``Trainer`` and the
utilities."""
from .block import (Block, HybridBlock, SymbolBlock,  # noqa: F401
                    load_stablehlo)
from .parameter import Constant, Parameter, ParameterDict  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
