"""gluon.contrib, the experimental Gluon surface (counterpart of
``mxnet_tpu/gluon/contrib/``): the Estimator. Its ``nn``
(``SyncBatchNorm``) is queue item A12(b)."""
from . import estimator  # noqa: F401
