"""The Gluon data API (counterpart of ``mxnet_tpu/gluon/data/``)."""
from .dataset import Dataset, ArrayDataset, SimpleDataset, RecordFileDataset  # noqa: F401
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler,  # noqa: F401
                      FilterSampler)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
