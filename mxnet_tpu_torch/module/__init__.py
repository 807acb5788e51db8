"""Module API (counterpart of ``mxnet_tpu/module/``)."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
