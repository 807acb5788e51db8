"""Static graph analysis (counterpart of ``mxnet_tpu/analysis/``). Ported:
the shape and dtype engine (``shape_infer.py``) and the findings
datatypes (``findings.py``: ``Severity``, ``Finding``, ``Report``), which
the training-health plane's blame pass reports with; the linters are
queue item A15(e)."""
from .findings import Finding, Report, Severity  # noqa: F401
from .shape_infer import InferResult, infer_graph  # noqa: F401
