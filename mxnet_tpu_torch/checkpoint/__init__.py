"""Crash-safe checkpointing (counterpart of ``mxnet_tpu/checkpoint/``).

Atomic on-disk format (temp + fsync + rename, per-array CRC32 manifest),
full training-state capture (params, aux, optimizer slots and counters,
loss-scaler, epoch/batch cursor, RNG streams, data-iterator position), an
async background writer so the step loop never blocks on disk, keep-last-N
GC, and corrupted/partial-checkpoint detection that falls back to the newest
valid checkpoint.

Lazily exported: ``ndarray.serialization`` imports ``checkpoint.atomic``
while the package is still initializing, so this ``__init__`` must not pull
in modules that import ``mxnet_tpu_torch.ndarray`` at import time.
"""
from __future__ import annotations

__all__ = ["CheckpointManager", "CheckpointError", "TrainingState",
           "capture_training_state"]

_LAZY = {
    "CheckpointManager": ("manager", "CheckpointManager"),
    "CheckpointError": ("manager", "CheckpointError"),
    "as_manager": ("manager", "as_manager"),
    "TrainingState": ("state", "TrainingState"),
    "capture_training_state": ("state", "capture_training_state"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod_name, attr = _LAZY[name]
        mod = importlib.import_module(f".{mod_name}", __name__)
        return getattr(mod, attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
