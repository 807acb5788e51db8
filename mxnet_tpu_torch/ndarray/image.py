"""``mx.nd.image``, the image ops of the imperative API (counterpart of
``mxnet_tpu/ndarray/image.py``): ``nd.image.to_tensor`` resolves to the
registered op ``_image_to_tensor``."""
from __future__ import annotations

from ..ops import has_op
from . import _make_dispatcher


def __getattr__(name: str):
    cand = f"_image_{name}"
    if has_op(cand):
        fn = _make_dispatcher(cand)
        globals()[name] = fn
        return fn
    raise AttributeError(f"no image operator {name!r}")
