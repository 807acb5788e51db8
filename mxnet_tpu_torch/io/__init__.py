"""``mx.io``: data iterators and RecordIO (counterpart of
``mxnet_tpu/io/``)."""
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter, CSVIter,  # noqa: F401
                 MNISTIter, ImageRecordIter, ResizeIter, PrefetchingIter)
from . import recordio  # noqa: F401
