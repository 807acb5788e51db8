"""Static graph analysis (counterpart of ``mxnet_tpu/analysis/``). Only the
shape and dtype engine is ported (``shape_infer.py``); the linters and
the findings they report belong to the host planes (queue item A15)."""
from .shape_infer import InferResult, infer_graph  # noqa: F401
