"""gluon.contrib, the experimental Gluon surface (counterpart of
``mxnet_tpu/gluon/contrib/``): the Estimator and ``nn``
(``SyncBatchNorm``, ``Identity``, ``HybridConcurrent``)."""
from . import estimator  # noqa: F401
from . import nn  # noqa: F401
