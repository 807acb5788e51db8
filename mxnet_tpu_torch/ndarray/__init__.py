"""``mx.nd``, the imperative array API (counterpart of
``mxnet_tpu/ndarray/__init__.py``).

Any registered op name resolves to an eager dispatcher through PEP 562's
module ``__getattr__``, so ``nd.relu``, ``nd.FullyConnected``,
``nd.broadcast_add`` ... exist without generated code; a name that no
slice of the port has registered raises ``AttributeError``.
``nd.contrib`` holds the contrib ops and the control-flow functions,
``nd.image`` the image ops, ``nd.linalg`` the linear-algebra ops and
``nd.random`` the sampling front-ends. A few
wrappers whose Python signatures differ from raw dispatch follow.
"""
from __future__ import annotations

from ..ops import get_op, has_op, list_ops
from .. import random
from .ndarray import (NDArray, arange, array, concat, empty, full, invoke,
                      invoke_fn, load, ones, save, stack, waitall, zeros)

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "save", "load", "concat", "stack", "waitall", "random",
           "invoke", "invoke_fn"]


def _make_dispatcher(name: str):
    opdef = get_op(name)

    def op_fn(*args, **kwargs):
        inputs = []
        rest = list(args)
        while rest and isinstance(rest[0], NDArray):
            inputs.append(rest.pop(0))
        if rest:
            raise TypeError(f"{name}: positional args after tensor inputs "
                            "must be kwargs")
        return invoke(opdef, inputs, kwargs)

    op_fn.__name__ = name
    op_fn.__doc__ = (opdef.fn.__doc__ or "") + f"\n\n(registered op {name!r})"
    return op_fn


def __getattr__(name: str):
    if name in ("contrib", "image", "linalg"):
        import importlib

        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    if has_op(name):
        fn = _make_dispatcher(name)
        globals()[name] = fn  # cache
        return fn
    raise AttributeError(f"module 'mxnet_tpu_torch.ndarray' has no "
                         f"attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list_ops()))


def split(data, num_outputs, axis=1, squeeze_axis=False):
    return invoke("SliceChannel", [data], {"num_outputs": num_outputs,
                                           "axis": axis,
                                           "squeeze_axis": squeeze_axis})


def dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    return invoke("dot", [lhs, rhs], {"transpose_a": transpose_a,
                                      "transpose_b": transpose_b})


def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    return invoke("batch_dot", [lhs, rhs], {"transpose_a": transpose_a,
                                            "transpose_b": transpose_b})


def where(condition, x, y):
    return invoke("where", [condition, x, y], {})


def zeros_like(data):
    return invoke("zeros_like", [data], {})


def ones_like(data):
    return invoke("ones_like", [data], {})


def cast(data, dtype):
    return invoke("Cast", [data], {"dtype": dtype})


def one_hot(indices, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    return invoke("one_hot", [indices], {"depth": depth,
                                         "on_value": on_value,
                                         "off_value": off_value,
                                         "dtype": dtype})
