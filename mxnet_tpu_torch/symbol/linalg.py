"""``mx.sym.linalg`` — linear-algebra ops in the symbolic frontend
(counterpart of ``mxnet_tpu/symbol/linalg.py``)."""
from __future__ import annotations

from ..ops import has_op
from .symbol import _make_symbol_op


def __getattr__(name: str):
    for cand in (f"_linalg_{name}", f"linalg_{name}", name):
        if has_op(cand):
            fn = _make_symbol_op(cand)
            globals()[name] = fn
            return fn
    raise AttributeError(f"no linalg symbol operator {name!r}")
