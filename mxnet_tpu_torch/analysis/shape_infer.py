"""Shape and dtype inference of a symbol graph (counterpart of
``mxnet_tpu/analysis/shape_infer.py``), the NNVM ``InferShape``/
``InferType`` analog: a topo-order walk that evaluates every node's op
function on ``torch.device("meta")`` tensors, which carry shape and dtype
and compute nothing, where the reference evaluates them through
``jax.eval_shape``. Auto-created parameters take their shapes from the op
rules (``symbol.symbol._param_shape_rules``). A kernel wrapper meeting a
meta tensor computes its output's shape through its plain version; meta
is not a device that computes, so this is no fallback.

``Symbol.infer_shape``/``infer_type``, ``Symbol.shape`` (the shape hints
alone: ``b, s, u = x.shape`` inside a traced ``hybrid_forward``) and
``simple_bind`` share it, and so does the ``shape-preflight`` lint pass
(``graph_passes.py``). In raise mode the first failure raises a
node-attributed :class:`~mxnet_tpu_torch.base.GraphAnalysisError`; in
collect mode (the lint pass) failures become error ``Finding``s and the
walk goes on past them. Nodes are evaluated in predict mode (the output
shapes of Dropout and BatchNorm do not depend on it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

import numpy as np
import torch

from ..base import GraphAnalysisError, dtype_np, dtype_torch
from .findings import Finding, Severity

__all__ = ["InferResult", "infer_graph"]

_META = torch.device("meta")


@dataclass
class InferResult:
    shapes: Dict[str, tuple] = field(default_factory=dict)
    dtypes: Dict[str, Any] = field(default_factory=dict)
    out_shapes: List[Optional[tuple]] = field(default_factory=list)
    out_dtypes: List[Any] = field(default_factory=list)
    node_out: Dict[int, Any] = field(default_factory=dict)    # id(node) -> shape|[shapes]
    node_dtype: Dict[int, Any] = field(default_factory=dict)  # id(node) -> dtype|[dtypes]
    node_in: Dict[int, List[Optional[tuple]]] = field(default_factory=dict)
    findings: List[Finding] = field(default_factory=list)
    failed: Set[int] = field(default_factory=set)


def _np_dtype(d):
    """numpy dtype of a user-facing dtype; bfloat16 stays
    ``torch.bfloat16`` (numpy has none)."""
    return dtype_np(d if not isinstance(d, np.dtype) else d.name)


def _var_dtype(node, known_dtypes):
    if known_dtypes and node._name in known_dtypes:
        return _np_dtype(known_dtypes[node._name])
    d = node._attrs.get("__dtype__")
    if d is not None:
        return _np_dtype(str(d))
    return np.dtype(np.float32)


def infer_graph(sym, known_shapes: Dict[str, tuple],
                known_dtypes: Optional[Dict[str, Any]] = None,
                collect: bool = False,
                use_hint_cache: bool = False) -> InferResult:
    """Walk ``sym`` in topo order inferring every node's output shape and
    dtype.

    ``collect=False``: raise :class:`GraphAnalysisError` at the first
    failure, naming the node, its op and its input shapes.
    ``collect=True``: record failures as error findings and keep walking
    (nodes downstream of a failure are skipped, not reported again).

    ``use_hint_cache`` reuses and fills per-node ``_hint_shape`` memos.
    Valid only with no explicit known shapes or dtypes (the
    ``Symbol.shape`` path): cached values then derive from the fixed
    ``Variable(shape=...)`` hints alone, so per-layer ``x.shape`` reads
    while tracing a deep net skip every node already seen."""
    from .. import autograd
    from ..ops import get_op, has_op
    from ..ops.registry import call_op, coerce_kwargs
    from ..symbol.symbol import _param_shape_rules, op_input_names

    res = InferResult()
    res.shapes = {k: tuple(v) for k, v in known_shapes.items()}
    if known_dtypes:
        res.dtypes = {k: _np_dtype(v) for k, v in known_dtypes.items()}

    def fail(rule_id, msg, node_name, op, in_shapes=None, fix_hint=None):
        if not collect:
            raise GraphAnalysisError(msg, node=node_name, op=op,
                                     rule_id=rule_id, input_shapes=in_shapes)
        res.findings.append(Finding(rule_id, Severity.ERROR, msg,
                                    node=node_name, op=op, fix_hint=fix_hint,
                                    details={"input_shapes": in_shapes}))

    use_hint_cache = use_hint_cache and not known_shapes and not known_dtypes
    old_train = autograd.set_training(False)
    try:
        for node in sym._topo():
            if use_hint_cache and "_hint_shape" in node.__dict__:
                s, d = node._hint_shape, node._hint_dtype
                res.node_out[id(node)] = s
                res.node_dtype[id(node)] = d
                if node._op is None:
                    res.shapes[node._name] = s
                    res.dtypes[node._name] = d
                continue
            if node._op is None:
                if node._name not in res.shapes and \
                        "__shape__" in node._attrs:
                    res.shapes[node._name] = tuple(node._attrs["__shape__"])
                if node._name in res.shapes:
                    res.node_out[id(node)] = res.shapes[node._name]
                    dt = _var_dtype(node, known_dtypes)
                    res.dtypes[node._name] = dt
                    res.node_dtype[id(node)] = dt
                continue
            if node._op == "_group":
                continue
            inline_opdef = getattr(node, "_opdef", None)  # symbol.invoke_fn
            if inline_opdef is None and not has_op(node._op):
                fail("unknown-op",
                     f"operator {node._op!r} is not in the op registry",
                     node._name, node._op,
                     fix_hint="check the op name / load a graph exported "
                              "by this framework version")
                res.failed.add(id(node))
                continue
            opdef = inline_opdef or get_op(node._op)
            kwargs = coerce_kwargs({k: v for k, v in node._attrs.items()
                                    if not k.startswith("__")})
            input_names = op_input_names(opdef)
            # the primary input's shape drives the parameter shape rules
            primary = None
            for i in node._inputs:
                s = res.node_out.get(id(i._base()))
                if s is not None:
                    if i._index is not None and isinstance(s, list):
                        s = s[i._index]
                    primary = s
                    break
            in_shapes: List[tuple] = []
            in_dtypes: List[Any] = []
            skip = False
            for pos, i in enumerate(node._inputs):
                base = i._base()
                s = res.node_out.get(id(base))
                d = res.node_dtype.get(id(base))
                if s is not None and i._index is not None and \
                        isinstance(s, list):
                    s = s[i._index]
                    d = d[i._index] if isinstance(d, list) else d
                if s is None and base._op is None:
                    arg = input_names[pos] if pos < len(input_names) \
                        else None
                    s = _param_shape_rules(node._op, primary, kwargs, arg) \
                        if primary is not None and arg else None
                    if s is None:
                        fail("missing-shape",
                             f"cannot infer shape of {base._name!r} (input "
                             f"{arg!r} of {node._op}); provide it "
                             "explicitly", base._name, node._op,
                             fix_hint=f"pass {base._name}=<shape> to "
                                      "infer_shape/bind, or set shape= on "
                                      "the Variable")
                        skip = True
                    else:
                        res.shapes[base._name] = tuple(s)
                        res.node_out[id(base)] = tuple(s)
                        d = _var_dtype(base, known_dtypes)
                        res.dtypes[base._name] = d
                        res.node_dtype[id(base)] = d
                if s is None:
                    # an upstream failure, already reported: no cascade
                    skip = True
                    break
                in_shapes.append(tuple(s))
                in_dtypes.append(d if d is not None else
                                 np.dtype(np.float32))
            res.node_in[id(node)] = in_shapes
            if skip:
                res.failed.add(id(node))
                continue
            metas = [torch.empty(s, dtype=dtype_torch(d), device=_META)
                     for s, d in zip(in_shapes, in_dtypes)]
            try:
                with torch.no_grad():
                    out = call_op(opdef, metas, kwargs, _META)
            except Exception as e:
                shown = ", ".join(f"{n}:{s}" for n, s in
                                  zip([i._base()._name
                                       for i in node._inputs], in_shapes))
                fail("shape-mismatch",
                     f"shape inference failed at {node._op} ({node._name}): "
                     f"inputs [{shown}] attrs {kwargs or '{}'}: {e}",
                     node._name, node._op, in_shapes=in_shapes,
                     fix_hint="fix the input shapes or the op attrs shown "
                              "above")
                res.failed.add(id(node))
                continue
            if isinstance(out, (list, tuple)):
                res.node_out[id(node)] = [tuple(o.shape) for o in out]
                res.node_dtype[id(node)] = [_np_dtype(o.dtype) for o in out]
            else:
                res.node_out[id(node)] = tuple(out.shape)
                res.node_dtype[id(node)] = _np_dtype(out.dtype)
    finally:
        autograd.set_training(old_train)

    if use_hint_cache:
        for node in sym._topo():
            if id(node) in res.node_out and id(node) not in res.failed \
                    and "_hint_shape" not in node.__dict__:
                node._hint_shape = res.node_out[id(node)]
                node._hint_dtype = res.node_dtype.get(id(node))

    if sym._op == "_group":
        heads = [(s._base(), s._index) for s in sym._inputs]
    else:
        heads = [(sym._base(), sym._index)]
    for base, index in heads:
        s = res.node_out.get(id(base))
        d = res.node_dtype.get(id(base))
        if isinstance(s, list):
            if index is not None:
                res.out_shapes.append(s[index])
                res.out_dtypes.append(d[index] if isinstance(d, list) else d)
            else:
                res.out_shapes.extend(s)
                res.out_dtypes.extend(d if isinstance(d, list)
                                      else [d] * len(s))
        else:
            res.out_shapes.append(s)
            res.out_dtypes.append(d)
    return res
