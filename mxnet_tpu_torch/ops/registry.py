"""Central operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

An op is one pure function over ``torch.Tensor``s, registered once under
the reference's op name. The same definition serves eager dispatch
(``mx.nd.*`` through ``ndarray.invoke``) and autograd: ``torch.autograd``
records the function's own operations while ``autograd.record()`` is on,
so an op needs no hand-written gradient unless the reference gives it a
custom one (``SoftmaxOutput``) or a kernel computes it (flash attention,
a ``torch.autograd.Function``). Names that no slice of the port has
registered yet raise ``NotImplementedError`` naming the op.
"""
from __future__ import annotations

import ast
import inspect
import weakref
from typing import Any, Callable, Dict, List, Optional

__all__ = ["OpDef", "register", "get_op", "has_op", "list_ops", "alias",
           "coerce_value", "coerce_kwargs", "call_op"]


class OpDef:
    """One registered operator.

    Attributes:
        name: canonical op name (reference op names kept, e.g.
            ``broadcast_add``).
        fn: pure function ``fn(*tensors, **kwargs) -> tensor | tuple``.
        num_outputs: static int, or callable(kwargs) -> int.
        ndarray_inputs: names of positional tensor inputs, or ``"*"`` for
            variadic ops.
        differentiable: False keeps the op off the autograd tape (e.g.
            ``argmax``).
        param_types: the reference's parameter types (unused here, kept
            for the same slots).
        tags: semantic labels (``"reduction"``, ``"softmax"``, ``"exp"``,
            ``"log"``), as the reference's static analyzer reads them.
    """

    __slots__ = ("name", "fn", "num_outputs", "ndarray_inputs",
                 "differentiable", "param_types", "tags")

    def __init__(self, name, fn, num_outputs=1, ndarray_inputs=None,
                 differentiable=True, param_types=None, tags=()):
        self.name = name
        self.fn = fn
        self.num_outputs = num_outputs
        self.ndarray_inputs = ndarray_inputs
        self.differentiable = differentiable
        self.param_types = param_types or {}
        self.tags = tuple(tags)

    def n_out(self, kwargs) -> int:
        if callable(self.num_outputs):
            return self.num_outputs(kwargs)
        return self.num_outputs

    def __repr__(self):
        return f"<Op {self.name}>"


_REGISTRY: Dict[str, OpDef] = {}


def register(name: str, num_outputs=1, aliases: Optional[List[str]] = None,
             ndarray_inputs=None, differentiable=True, tags=()):
    """Decorator registering a pure torch op under a reference op name."""

    def deco(fn: Callable):
        op = OpDef(name, fn, num_outputs, ndarray_inputs, differentiable,
                   tags=tags)
        _REGISTRY[name] = op
        for a in aliases or ():
            _REGISTRY[a] = op
        return fn

    return deco


def alias(existing: str, *names: str) -> None:
    op = _REGISTRY[existing]
    for n in names:
        _REGISTRY[n] = op


def get_op(name: str) -> OpDef:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"operator {name!r} is not implemented in mxnet_tpu_torch "
            f"({len(set(id(v) for v in _REGISTRY.values()))} ops "
            "registered)") from None


def has_op(name: str) -> bool:
    return name in _REGISTRY


def list_ops() -> List[str]:
    return sorted(_REGISTRY)


# The reference's parameter layer parses op kwargs from strings (symbol
# JSON stores every attribute as a string): "(3, 3)" -> (3, 3),
# "True" -> True, "2" -> 2.

def coerce_value(v: Any) -> Any:
    if not isinstance(v, str):
        return v
    s = v.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return v


def coerce_kwargs(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: coerce_value(v) for k, v in kwargs.items()}


_TAKES_CTX: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def call_op(opdef: OpDef, inputs, kwargs: Dict[str, Any], device):
    """Run ``opdef`` on ``inputs`` as a graph node does: an op that creates
    its output (``_zeros``, ``_arange``; it takes ``ctx``) creates it on
    ``device`` unless the node names one, as its inputs' device is the
    graph's."""
    takes = _TAKES_CTX.get(opdef.fn)
    if takes is None:
        try:
            takes = "ctx" in inspect.signature(opdef.fn).parameters
        except (TypeError, ValueError):
            takes = False
        _TAKES_CTX[opdef.fn] = takes
    if takes and kwargs.get("ctx") is None:
        kwargs = {**kwargs, "ctx": device}
    return opdef.fn(*inputs, **kwargs)
