"""Custom operator API, ``mx.operator`` (counterpart of
``mxnet_tpu/operator.py``).

A custom op is registered like any built-in: importing this module
registers the ``Custom`` op, and ``nd.Custom(x, op_type="name")`` runs the
registered :class:`CustomOpProp`'s operator. As in the reference, only
``forward`` runs: it computes with ``NDArray`` ops, gradients flow through
those ops on the autograd tape, and ``backward`` is never called.
``CustomOpProp`` keeps the reference's (``list_arguments`` /
``infer_shape`` / ``create_operator``) contract.

Outputs are allocated as the reference allocates them: float32 zeros on
the inputs' device, or, inside a symbolic or shape trace (meta tensors),
meta tensors of the input's dtype.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .ndarray import NDArray
from .ops.registry import register as _register_op

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]

_CUSTOM: Dict[str, type] = {}


class CustomOp:
    """User op: override forward/backward using ``self.assign``."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst: NDArray, req: str, src):
        """Write ``src`` into ``dst`` under ``req`` (``write``/``inplace``,
        ``add`` or ``null``), keeping ``src``'s graph node while
        recording."""
        if req in ("null",):
            return
        src_nd = src if isinstance(src, NDArray) else NDArray(src)
        if req == "add":
            src_nd = NDArray(dst._data + src_nd._data)
        dst._set_data(src_nd)


class CustomOpProp:
    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError


def register(reg_name: str):
    """Decorator: ``@mx.operator.register("myop")`` on a CustomOpProp
    class makes ``nd.Custom(..., op_type="myop")`` available."""

    def deco(prop_cls):
        _CUSTOM[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered_operators():
    return sorted(_CUSTOM)


def _run_custom(*datas, op_type=None, **kwargs):
    if op_type not in _CUSTOM:
        raise ValueError(f"custom op {op_type!r} is not registered "
                         f"({sorted(_CUSTOM)})")
    prop = _CUSTOM[op_type]()
    in_shapes = [tuple(d.shape) for d in datas]
    _, out_shapes, _ = prop.infer_shape(list(in_shapes))
    op = prop.create_operator(None, in_shapes, [d.dtype for d in datas])
    in_nd = [NDArray(d) for d in datas]
    dev = datas[0].device if datas else torch.device("cpu")
    tracing = dev.type == "meta"
    out_nd = [NDArray(torch.zeros(tuple(s), device=dev,
                                  dtype=datas[0].dtype if tracing
                                  else torch.float32))
              for s in out_shapes]
    from . import autograd

    op.forward(autograd.is_training(), ["write"] * len(out_nd), in_nd,
               out_nd, [])
    outs = tuple(o._data for o in out_nd)
    return outs[0] if len(outs) == 1 else outs


_register_op("Custom", num_outputs=lambda kw: 1)(_run_custom)
