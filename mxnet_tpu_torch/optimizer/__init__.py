"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer/``): the
16 optimizers, ``Updater``, the lr schedulers and the multi-tensor update
engine (``fused``)."""
from .optimizer import (DCASGD, FTML, LAMB, LARS, NAG, SGD, SGLD,  # noqa: F401
                        AdaDelta, AdaGrad, Adam, AdamW, AdaMax, Adamax, Ftrl,
                        Nadam, Optimizer, RMSProp, Signum, Updater, create,
                        get_updater, register)
from . import lr_scheduler  # noqa: F401
from . import fused  # noqa: F401
from .fused import (FusedUpdateEngine, fused_update_enabled,  # noqa: F401
                    lower_update)

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdamW", "LAMB", "RMSProp",
           "AdaGrad", "AdaDelta", "Ftrl", "FTML", "Signum", "AdaMax",
           "Adamax", "Nadam", "SGLD", "DCASGD", "LARS", "create", "register",
           "Updater", "get_updater", "lr_scheduler", "fused",
           "FusedUpdateEngine", "fused_update_enabled", "lower_update"]
