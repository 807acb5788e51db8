"""``mx.io`` — data iterators (counterpart of ``mxnet_tpu/io/``). The
part ``Module`` needs is ported; the file and record iterators, the
prefetcher and recordio are queue item A11."""
from ..base import MXNetError
from .io import DataBatch, DataDesc, DataIter, NDArrayIter  # noqa: F401

_A11 = ("CSVIter", "MNISTIter", "ImageRecordIter", "ResizeIter",
        "PrefetchingIter", "recordio")


def __getattr__(name):
    if name in _A11:
        raise MXNetError(f"mx.io.{name}: the data plane (queue item A11) is "
                         "not ported yet")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
