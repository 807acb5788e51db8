"""Gluon, the imperative high-level API (counterpart of
``mxnet_tpu/gluon/``): ``Parameter``/``ParameterDict``, ``Block``/
``HybridBlock``, the ``nn`` layers, the losses, ``Trainer``, the
utilities and (imported on first use) ``rnn``, ``data``, ``contrib``
and the vision ``model_zoo``."""
from .block import (Block, HybridBlock, SymbolBlock,  # noqa: F401
                    load_stablehlo)
from .parameter import Constant, Parameter, ParameterDict  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401


def __getattr__(name):
    # lazy, as the reference's
    if name in ("rnn", "data", "model_zoo", "contrib"):
        import importlib

        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'mxnet_tpu_torch.gluon' has no attribute "
                         f"{name!r}")
