"""``mx.sym`` — the symbolic (lazy graph) frontend (counterpart of
``mxnet_tpu/symbol/``): every registered op is a function here too."""
from .symbol import (Symbol, Variable, var, Group, load, load_json,  # noqa: F401
                     zeros, ones, invoke_fn)

from ..ops import get_op, has_op, list_ops
from .symbol import _make_symbol_op


def __getattr__(name):
    if name in ("contrib", "image", "random", "linalg"):
        import importlib

        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    if has_op(name):
        fn = _make_symbol_op(name)
        globals()[name] = fn
        return fn
    raise AttributeError(f"module 'mxnet_tpu_torch.symbol' has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + list_ops()))
