"""``mx.nd.contrib`` (counterpart of ``mxnet_tpu/ndarray/contrib.py``):
``nd.contrib.<name>`` resolves to the registered op ``_contrib_<name>``
(or ``<name>``), beside the control-flow functions ``foreach``,
``while_loop`` and ``cond``."""
from __future__ import annotations

from ..ops import has_op
from ..ops.control_flow import cond, foreach, while_loop  # noqa: F401


def __getattr__(name: str):
    from . import _make_dispatcher

    for cand in (f"_contrib_{name}", name):
        if has_op(cand):
            fn = _make_dispatcher(cand)
            globals()[name] = fn
            return fn
    raise AttributeError(f"no contrib operator {name!r}")
