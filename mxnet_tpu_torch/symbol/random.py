"""``mx.sym.random`` — random ops in the symbolic frontend (counterpart of
``mxnet_tpu/symbol/random.py``, over the ``_random_*``/``_sample_*``
names)."""
from __future__ import annotations

from ..ops import has_op
from .symbol import _make_symbol_op


def __getattr__(name: str):
    for cand in (f"_random_{name}", f"_sample_{name}", name):
        if has_op(cand):
            fn = _make_symbol_op(cand)
            globals()[name] = fn
            return fn
    raise AttributeError(f"no random symbol operator {name!r}")
