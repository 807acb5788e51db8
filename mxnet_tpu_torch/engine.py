"""``mx.engine``: execution-engine controls (counterpart of
``mxnet_tpu/engine.py``).

PyTorch queues CUDA work asynchronously, so eager ops already pipeline.
The real bulking is ``hybridize()`` and the multi-tensor update
(``optimizer/fused.py``: every update of a ``Trainer.step`` in a few
``torch._foreach_*`` calls). ``bulk`` is the reference's compatibility
scope: it suspends the debug sync of ``MX_SYNC=1`` /
``MXNET_ENGINE_TYPE=NaiveEngine`` (``ndarray.ndarray._MX_SYNC``, a wait
for the device after every op) for its duration and restores it after.
``set_bulk_size`` is kept for script parity and changes nothing else.
"""
from __future__ import annotations

import contextlib

__all__ = ["bulk", "set_bulk_size"]

_bulk_size = 15


def set_bulk_size(size):
    """Returns the previous bulk size (reference contract)."""
    global _bulk_size
    prev, _bulk_size = _bulk_size, int(size)
    return prev


@contextlib.contextmanager
def bulk(size=None):
    """Scope under which eager ops dispatch without the per-op sync."""
    from .ndarray import ndarray as _nd

    prev = _nd._MX_SYNC
    _nd._MX_SYNC = False
    try:
        yield
    finally:
        _nd._MX_SYNC = prev
