"""``mx.sym.image`` — image ops in the symbolic frontend (counterpart of
``mxnet_tpu/symbol/image.py``, over the ``_image_*`` registry names)."""
from __future__ import annotations

from ..ops import has_op
from .symbol import _make_symbol_op


def __getattr__(name: str):
    cand = f"_image_{name}"
    if has_op(cand):
        fn = _make_symbol_op(cand)
        globals()[name] = fn
        return fn
    raise AttributeError(f"no image symbol operator {name!r}")
