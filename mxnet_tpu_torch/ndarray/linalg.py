"""``mx.nd.linalg``, the linear-algebra ops of the imperative API
(counterpart of ``mxnet_tpu/ndarray/linalg.py``): ``nd.linalg.gemm2``
resolves to the registered ``_linalg_gemm2`` (the flat ``nd.linalg_gemm2``
alias's op)."""
from __future__ import annotations

from ..ops import has_op
from . import _make_dispatcher


def __getattr__(name: str):
    for cand in (f"_linalg_{name}", f"linalg_{name}", name):
        if has_op(cand):
            fn = _make_dispatcher(cand)
            globals()[name] = fn
            return fn
    raise AttributeError(f"no linalg operator {name!r}")
