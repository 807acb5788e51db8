"""Graph passes and the subgraph-backend API (counterpart of
``mxnet_tpu/subgraph.py``).

Passes are registered by name and applied to Symbol graphs by
``optimize_symbol``; ``Symbol.optimize_for(backend, args, aux)`` routes
here. The reference's backend names ("MKLDNN", "TensorRT", "default") map
to its standard inference rewrite, ``fold_bn``: an algebraic rewrite that
changes the program (inference BatchNorm folded into the preceding
Convolution's weights), which neither cuDNN nor XLA would do on its own.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

__all__ = ["register_pass", "list_passes", "optimize_symbol", "fold_bn"]

_PASSES: Dict[str, Callable] = {}


def register_pass(name: str):
    def deco(fn):
        _PASSES[name] = fn
        return fn
    return deco


def list_passes():
    return sorted(_PASSES)


def optimize_symbol(symbol, backend, arg_params=None, aux_params=None):
    """Apply a registered pass: returns (new_symbol, new_args, new_aux).

    ``backend`` names a pass ("fold_bn") or the reference backend aliases
    ("MKLDNN"/"TensorRT"/"default"), which map to the standard inference
    rewrite set.
    """
    name = {"mkldnn": "fold_bn", "tensorrt": "fold_bn",
            "default": "fold_bn"}.get(str(backend).lower(), backend)
    if name not in _PASSES:
        raise ValueError(f"unknown subgraph backend/pass {backend!r}; "
                         f"registered: {list_passes()}")
    return _PASSES[name](symbol, dict(arg_params or {}), dict(aux_params or {}))


@register_pass("fold_bn")
def fold_bn(symbol, arg_params, aux_params):
    """Fold inference-mode BatchNorm into the preceding Convolution.

    BN(conv(x, W) + b) == conv(x, W') + b' with
        scale = gamma / sqrt(var + eps)
        W' = W * scale[:, None, None, None]
        b' = (b - mean) * scale + beta
    Only folds BN nodes whose data input is a Convolution with no other
    consumers (the reference partitioner's same constraint). Rebuilds the
    Symbol DAG directly (a proper graph pass, not a JSON round-trip). The
    folded weights are computed in numpy (float64, cast to float32), as
    the reference computes them, so they are bitwise the reference's.
    """
    from .symbol.symbol import Symbol, Variable

    nodes = symbol._topo()
    consumers: Dict[int, int] = {}
    for n in nodes:
        for i in n._inputs:
            b = i._base()
            consumers[id(b)] = consumers.get(id(b), 0) + 1

    new_args = dict(arg_params)
    new_aux = dict(aux_params)
    folded = []

    def _np(d):
        return d.asnumpy() if hasattr(d, "asnumpy") else np.asarray(d)

    memo: Dict[int, Symbol] = {}

    def rebuild(node):
        if node._index is not None:
            return rebuild(node._base())[node._index]
        if id(node) in memo:
            return memo[id(node)]
        new_ins = [rebuild(i) for i in node._inputs]
        result = None
        if node._op == "BatchNorm" and node._inputs:
            conv_orig = node._inputs[0]._base()
            if (conv_orig._op == "Convolution"
                    and consumers.get(id(conv_orig), 0) == 1
                    and len(node._inputs) >= 5):
                g_name = node._inputs[1]._base()._name
                b_name = node._inputs[2]._base()._name
                m_name = node._inputs[3]._base()._name
                v_name = node._inputs[4]._base()._name
                w_name = conv_orig._inputs[1]._base()._name
                attrs = dict(node._attrs)
                no_bias = str(conv_orig._attrs.get(
                    "no_bias", "False")).lower() in ("true", "1")
                if (w_name in new_args and g_name in new_args
                        and b_name in new_args and m_name in new_aux
                        and v_name in new_aux):
                    eps = float(attrs.get("eps", 1e-3))
                    fix_gamma = str(attrs.get("fix_gamma", "True")).lower() \
                        in ("true", "1")
                    gamma = _np(new_args[g_name]).astype(np.float64)
                    if fix_gamma:
                        gamma = np.ones_like(gamma)
                    beta = _np(new_args[b_name]).astype(np.float64)
                    mean = _np(new_aux[m_name]).astype(np.float64)
                    var = _np(new_aux[v_name]).astype(np.float64)
                    w = _np(new_args[w_name]).astype(np.float64)
                    scale = gamma / np.sqrt(var + eps)
                    if no_bias or len(conv_orig._inputs) < 3:
                        bias = np.zeros_like(mean)
                        bias_name = w_name.rsplit("_", 1)[0] + "_bias"
                    else:
                        bias_name = conv_orig._inputs[2]._base()._name
                        bias = _np(new_args[bias_name]).astype(np.float64)

                    from .ndarray import array as nd_array

                    # the folded weights stay where the weight was
                    ctx = getattr(new_args[w_name], "context", None)
                    new_args[w_name] = nd_array(
                        (w * scale.reshape(-1, 1, 1, 1)).astype(np.float32),
                        ctx=ctx)
                    new_args[bias_name] = nd_array(
                        ((bias - mean) * scale + beta).astype(np.float32),
                        ctx=ctx)
                    for nm in (g_name, b_name):
                        new_args.pop(nm, None)
                    for nm in (m_name, v_name):
                        new_aux.pop(nm, None)

                    conv_new_ins = rebuild(conv_orig)._inputs[:2] + \
                        [Variable(bias_name)]
                    conv_attrs = dict(conv_orig._attrs)
                    conv_attrs["no_bias"] = False
                    result = Symbol("Convolution", conv_orig._name,
                                    conv_new_ins, conv_attrs)
                    folded.append(node._name)
        if result is None:
            result = Symbol(node._op, node._name, new_ins, node._attrs)
        memo[id(node)] = result
        return result

    new_sym = rebuild(symbol)  # rebuild() dispatches on _index itself
    new_sym._folded_bn = folded
    return new_sym, new_args, new_aux
