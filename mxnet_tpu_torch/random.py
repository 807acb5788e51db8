"""The framework's random stream: ``seed()``, the per-device
``torch.Generator`` that ``Dropout`` and the initializers draw from, and
the seeded host generator ``np_rng()`` (counterpart of the ``seed``/
``next_key``/``np_rng`` part of ``mxnet_tpu/random.py``; the sampling ops
are not ported yet). Torch's generators do not give ``jax.random``'s
bits: draws match the reference in distribution only.
``get_state_data``/``set_state_data`` capture and restore every device
generator's state for a checkpoint, where the reference keeps its JAX
key.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from .base import get_env

__all__ = ["seed", "generator", "np_rng", "get_state_data",
           "set_state_data"]


class _State:
    def __init__(self):
        self.seed = None
        self.generators = {}
        self.np_rng = None
        self.lock = threading.Lock()


_STATE = _State()


def seed(seed_state: int, ctx="all") -> None:
    """Seed the stream of every device (reference ``mx.random.seed``); the
    next draw on each device starts from this seed."""
    with _STATE.lock:
        _STATE.seed = int(seed_state)
        _STATE.generators.clear()
        _STATE.np_rng = np.random.default_rng(int(seed_state))


def generator(device) -> torch.Generator:
    """The stream's generator on ``device``: seeded from :func:`seed`, or
    nondeterministically when nothing was seeded."""
    device = torch.device(device)
    key = (device.type, device.index)
    with _STATE.lock:
        gen = _STATE.generators.get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            if _STATE.seed is None:
                gen.seed()
            else:
                gen.manual_seed(_STATE.seed)
            _STATE.generators[key] = gen
        return gen


def np_rng() -> np.random.Generator:
    """Host numpy generator tied to the framework seed (``MXNET_SEED`` or
    :func:`seed`), as the reference's."""
    if _STATE.np_rng is None:
        _STATE.np_rng = np.random.default_rng(get_env("MXNET_SEED", None,
                                                      int))
    return _STATE.np_rng


def get_state_data():
    """{"type:index": uint8 state array} of every device generator made so
    far, or None when none was: a resumed process then seeds its
    generators as a fresh one would."""
    with _STATE.lock:
        if not _STATE.generators:
            return None
        return {f"{t}:{-1 if i is None else i}": g.get_state().numpy().copy()
                for (t, i), g in _STATE.generators.items()}


def set_state_data(data) -> None:
    """Restore what :func:`get_state_data` captured: later draws on those
    devices repeat the captured run's bit for bit."""
    for key, state in data.items():
        typ, idx = key.split(":")
        dev = torch.device(typ) if idx == "-1" else torch.device(typ,
                                                                 int(idx))
        generator(dev).set_state(torch.from_numpy(
            np.asarray(state, np.uint8).copy()))
