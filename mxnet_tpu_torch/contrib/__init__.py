"""``mx.contrib`` (counterpart of ``mxnet_tpu/contrib/``): ``amp``, int8
``quantization`` and ``onnx`` export and import."""
from .. import amp  # noqa: F401  (the reference's path: mx.contrib.amp)
from . import quantization  # noqa: F401
from . import onnx  # noqa: F401
