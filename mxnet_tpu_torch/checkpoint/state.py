"""Full-training-state capture and restore (counterpart of
``mxnet_tpu/checkpoint/state.py``).

A :class:`TrainingState` is everything needed to make a resumed run bitwise
reproduce an uninterrupted one (the chaos suite's flagship assertion):

- parameters and aux states (``arg:NAME`` / ``aux:NAME`` arrays),
- optimizer slots — momentum, Adam moments, etc. (``opt:...`` arrays) plus
  the scalar bookkeeping the slots alone don't carry (``num_update`` and the
  per-index update counts that drive Adam/Nadam bias correction),
- loss-scaler state (scale + unskipped-step counter),
- the epoch/batch cursor and global step,
- RNG streams: the global numpy MT state (iterator shuffles draw from
  it), the seeded ``np_rng`` generator, and the state of every device's
  ``torch.Generator`` (``rng:torch:<device>`` arrays), which the port's
  initializers and Dropout draw from. The reference keeps its JAX key
  there instead (``rng:mx_key``); each package ignores the other's
  stream, a documented difference,
- the data iterator position (duck-typed via ``get_checkpoint_state``).

Arrays live in ``state.arrays`` (flat name → numpy, or a CPU
``torch.bfloat16`` tensor for bf16: ``ndarray/serialization.host_array``)
so the manager can CRC each one into the manifest; everything JSON-able
lives in ``state.meta``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from ..ndarray.serialization import host_array

__all__ = ["TrainingState", "capture_training_state", "restore_optimizer",
           "restore_rng", "capture_rng", "restore_iterator"]

FORMAT_VERSION = 1


class TrainingState:
    """A checkpointable snapshot: flat ``arrays`` + JSON-able ``meta``."""

    def __init__(self, arrays: Optional[Dict[str, np.ndarray]] = None,
                 meta: Optional[dict] = None):
        self.arrays: Dict[str, np.ndarray] = arrays or {}
        self.meta: dict = meta or {"format": FORMAT_VERSION}

    # -- convenience views ------------------------------------------------
    @property
    def epoch(self):
        return self.meta.get("epoch")

    @property
    def nbatch(self):
        return self.meta.get("nbatch")

    @property
    def global_step(self):
        return self.meta.get("global_step", 0)

    def arg_params(self) -> Dict[str, np.ndarray]:
        return {k[4:]: v for k, v in self.arrays.items()
                if k.startswith("arg:")}

    def aux_params(self) -> Dict[str, np.ndarray]:
        return {k[4:]: v for k, v in self.arrays.items()
                if k.startswith("aux:")}


# ---------------------------------------------------------------------------
# optimizer state (Updater slots + scalar counters)
# ---------------------------------------------------------------------------

def _flatten_opt_state(state, path: str, arrays: Dict[str, Any]):
    """Flatten a (possibly nested-tuple) Updater slot into ``arrays`` (host
    copies) and return a JSON descriptor mirroring the structure."""
    if state is None:
        return None
    if isinstance(state, tuple):
        return {"tuple": [_flatten_opt_state(s, f"{path}.{i}", arrays)
                          for i, s in enumerate(state)]}
    key = f"opt:{path}"
    arrays[key] = host_array(state)
    return {"array": key}


def _unflatten_opt_state(desc, arrays: Dict[str, Any], ctx):
    from ..ndarray import NDArray

    if desc is None:
        return None
    if "tuple" in desc:
        return tuple(_unflatten_opt_state(d, arrays, ctx)
                     for d in desc["tuple"])
    return NDArray(arrays[desc["array"]], ctx=ctx)


def capture_optimizer(updater, optimizer, arrays: Dict[str, np.ndarray]):
    """Snapshot Updater slots into ``arrays`` and return the JSON meta blob.
    Slot keys may be ints (Module/Trainer) or strings (PS server)."""
    meta: dict = {"state_tree": []}
    if updater is not None:
        for key, slot in updater.states.items():
            tag = "i" if isinstance(key, (int, np.integer)) else "s"
            meta["state_tree"].append(
                [tag, str(key), _flatten_opt_state(slot, str(key), arrays)])
    if optimizer is not None:
        meta["num_update"] = int(getattr(optimizer, "num_update", 0))
        meta["index_update_count"] = [
            [("i" if isinstance(k, (int, np.integer)) else "s"), str(k), int(v)]
            for k, v in getattr(optimizer, "_index_update_count", {}).items()]
        if hasattr(optimizer, "m_schedule"):  # Nadam's momentum schedule
            meta["m_schedule"] = float(optimizer.m_schedule)
    return meta


def restore_optimizer(updater, optimizer, state: TrainingState, ctx=None):
    """Put the slots back (as arrays on ``ctx``, default the current
    context) and the counters."""
    from ..context import current_context

    meta = state.meta.get("optimizer")
    if meta is None:
        return
    if updater is not None:
        ctx = ctx or current_context()
        updater.states = {
            (int(key) if tag == "i" else key):
                _unflatten_opt_state(desc, state.arrays, ctx)
            for tag, key, desc in meta.get("state_tree", [])}
    if optimizer is not None:
        if "num_update" in meta:
            optimizer.num_update = meta["num_update"]
        optimizer._index_update_count = {
            (int(k) if tag == "i" else k): v
            for tag, k, v in meta.get("index_update_count", [])}
        if "m_schedule" in meta and hasattr(optimizer, "m_schedule"):
            optimizer.m_schedule = meta["m_schedule"]


# ---------------------------------------------------------------------------
# RNG streams
# ---------------------------------------------------------------------------

def capture_rng(arrays: Dict[str, np.ndarray]) -> dict:
    from .. import random as mx_random

    meta: dict = {}
    # global numpy MT stream (NDArrayIter shuffles, initializer fallbacks)
    name, keys, pos, has_gauss, cached = np.random.get_state()
    arrays["rng:np_mt"] = np.asarray(keys, np.uint32)
    meta["np_mt"] = {"name": name, "pos": int(pos),
                     "has_gauss": int(has_gauss), "cached": float(cached)}
    # the device generators' streams (the reference's JAX key stands here)
    gen_states = mx_random.get_state_data()
    if gen_states is not None:
        for dev, st in gen_states.items():
            arrays[f"rng:torch:{dev}"] = st
        meta["torch_generators"] = sorted(gen_states)
    # the seeded default_rng initializers draw from (PCG64 state is JSON-able)
    try:
        meta["np_rng"] = mx_random.np_rng().bit_generator.state
    except Exception:
        pass
    return meta


def restore_rng(state: TrainingState) -> None:
    from .. import random as mx_random

    meta = state.meta.get("rng")
    if not meta:
        return
    mt = meta.get("np_mt")
    if mt and "rng:np_mt" in state.arrays:
        np.random.set_state((mt["name"],
                             np.asarray(state.arrays["rng:np_mt"], np.uint32),
                             mt["pos"], mt["has_gauss"], mt["cached"]))
    gens = {dev: state.arrays[f"rng:torch:{dev}"]
            for dev in meta.get("torch_generators", [])
            if f"rng:torch:{dev}" in state.arrays}
    if gens:
        mx_random.set_state_data(gens)
    if meta.get("np_rng"):
        try:
            mx_random.np_rng().bit_generator.state = meta["np_rng"]
        except Exception:
            pass


# ---------------------------------------------------------------------------
# data iterator position
# ---------------------------------------------------------------------------

def capture_iterator(train_data, arrays: Dict[str, np.ndarray]):
    getter = getattr(train_data, "get_checkpoint_state", None)
    if getter is None:
        return None
    it_state = getter()
    if it_state is None:
        return None
    meta = {}
    for k, v in it_state.items():
        if isinstance(v, np.ndarray):
            arrays[f"iter:{k}"] = np.ascontiguousarray(v)
            meta[k] = {"array": f"iter:{k}"}
        else:
            meta[k] = {"value": v}
    return meta


def restore_iterator(train_data, state: TrainingState) -> bool:
    meta = state.meta.get("iterator")
    setter = getattr(train_data, "set_checkpoint_state", None)
    if meta is None or setter is None:
        return False
    it_state = {}
    for k, d in meta.items():
        it_state[k] = state.arrays[d["array"]] if "array" in d else d["value"]
    try:
        setter(it_state)
    except NotImplementedError:
        # the DataIter base class stub: this iterator cannot be positioned
        # (e.g. the checkpoint was taken with a different iterator type) —
        # the caller falls back to epoch-boundary semantics
        return False
    return True


# ---------------------------------------------------------------------------
# the one-stop capture
# ---------------------------------------------------------------------------

def capture_training_state(arg_params=None, aux_params=None, updater=None,
                           optimizer=None, epoch=None, nbatch=None,
                           global_step=0, train_data=None, loss_scaler=None,
                           extra_meta=None) -> TrainingState:
    """Snapshot everything into a TrainingState. All array values are copied
    to host numpy at call time, so the caller may keep training while an
    async writer drains the snapshot to disk."""
    arrays: Dict[str, np.ndarray] = {}
    for name, v in (arg_params or {}).items():
        arrays[f"arg:{name}"] = host_array(v)
    for name, v in (aux_params or {}).items():
        arrays[f"aux:{name}"] = host_array(v)
    meta: Dict[str, Any] = {
        "format": FORMAT_VERSION,
        "epoch": epoch,
        "nbatch": nbatch,
        "global_step": int(global_step),
        "optimizer": capture_optimizer(updater, optimizer, arrays),
        "rng": capture_rng(arrays),
        "iterator": capture_iterator(train_data, arrays),
    }
    if loss_scaler is not None:
        meta["loss_scaler"] = {
            "loss_scale": float(loss_scaler.loss_scale),
            "unskipped": int(_scalar(getattr(loss_scaler, "_unskipped",
                                             0)))}
    if extra_meta:
        meta.update(extra_meta)
    return TrainingState(arrays, meta)


def restore_loss_scaler(loss_scaler, state: TrainingState) -> None:
    meta = state.meta.get("loss_scaler")
    if loss_scaler is None or not meta:
        return
    loss_scaler.loss_scale = meta["loss_scale"]
    loss_scaler._unskipped = meta["unskipped"]


def _scalar(x):
    """A counter the loss scaler may keep on the device, as a number."""
    return x.item() if hasattr(x, "item") else x
