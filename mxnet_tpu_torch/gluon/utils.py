"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm`` and
``check_sha1``. ``download`` raises, as the reference's does: nothing is
fetched over the network. ``set_params_from_numpy`` carries a block's
weights in from numpy arrays keyed as a ``.params`` file is (the file
format itself: ``ndarray/serialization.py``, through
``Block.save_parameters``/``load_parameters``)."""
from __future__ import annotations

import hashlib
import math
import warnings

from ..base import MXNetError
from ..ndarray import NDArray, array

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download", "set_params_from_numpy"]


def split_data(data: NDArray, num_slice: int, batch_axis=0, even_split=True):
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(f"batch size {size} not divisible by number of "
                         f"slices {num_slice}")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(axis=batch_axis, begin=begin, end=end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so that their global L2 norm is at most
    ``max_norm``; returns the norm before clipping (a float: one read of
    the device)."""
    total = 0.0
    for a in arrays:
        n = float(a.norm().asscalar())
        total += n * n
    total = math.sqrt(total)
    if check_isfinite and not math.isfinite(total):
        warnings.warn("nan or inf found in clip_global_norm")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a *= scale
    return total


def check_sha1(filename, sha1_hash):
    h = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    raise MXNetError("download: the port fetches nothing over the network; "
                     "place files locally")


def set_params_from_numpy(block, arrays) -> None:
    """Set every parameter of ``block`` from ``arrays``, a dict of numpy
    arrays (or tensors) keyed by the structural names of
    ``block._collect_params_with_prefix()`` (``features.0.weight``): the
    names the reference's ``save_parameters`` writes, and the keys of
    ``{k: p.data().asnumpy() for k, p in
    net._collect_params_with_prefix().items()}`` on the reference's side.
    ``Parameter.name`` is not used: its prefix counters depend on how many
    blocks a process built before. The block must be initialized; a
    parameter whose shape is still deferred takes the array's. Every
    parameter must be given, and nothing else."""
    from ..initializer import _fill

    own = block._collect_params_with_prefix()
    missing, extra = set(own) - set(arrays), set(arrays) - set(own)
    if missing or extra:
        raise ValueError(f"set_params_from_numpy: missing {sorted(missing)}"
                         f", unexpected {sorted(extra)}")
    for name, p in own.items():
        shape = tuple(arrays[name].shape)
        if p._data is None:
            p._finish_deferred_init(shape)
        elif tuple(p.shape) != shape:
            raise ValueError(f"set_params_from_numpy: {name} has shape "
                             f"{tuple(p.shape)}, the array {shape}")
        _fill(p._data, arrays[name])
