"""Uniform graph view for the analyzers (counterpart of
``mxnet_tpu/analysis/graph.py``).

``GraphView`` adapts both an in-memory
:class:`~mxnet_tpu_torch.symbol.Symbol` DAG and a serialized
``tojson()`` graph (the CLI path) to one node-table
shape, so every pass is written once. JSON views keep *all* nodes from the
file — including ones unreachable from the heads — which is what the
dead-node pass inspects; ``Symbol._topo`` views are reachable-only by
construction.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["NodeInfo", "GraphView"]


@dataclass
class NodeInfo:
    idx: int
    op: Optional[str]               # None => variable ("null" in JSON)
    name: str
    attrs: Dict[str, Any] = field(default_factory=dict)
    inputs: List[Tuple[int, int]] = field(default_factory=list)
    sym: Any = None                 # backing Symbol node, when available

    @property
    def is_variable(self) -> bool:
        return self.op is None

    def kwargs(self) -> Dict[str, Any]:
        """Op kwargs: non-dunder attrs, string values coerced."""
        from ..ops.registry import coerce_kwargs

        return coerce_kwargs({k: v for k, v in self.attrs.items()
                              if not k.startswith("__")})


class GraphView:
    """Node table + consumer index over a Symbol or JSON graph."""

    def __init__(self, nodes: List[NodeInfo], heads: List[Tuple[int, int]],
                 symbol=None):
        self.nodes = nodes
        self.heads = heads
        self.symbol = symbol
        self.consumers: Dict[int, List[Tuple[int, int]]] = {n.idx: []
                                                            for n in nodes}
        for n in nodes:
            for pos, (src, _out) in enumerate(n.inputs):
                self.consumers[src].append((n.idx, pos))

    # ------------------------------------------------------------------
    @classmethod
    def from_symbol(cls, sym) -> "GraphView":
        topo = sym._topo()
        idx = {id(n): i for i, n in enumerate(topo)}
        nodes = []
        for i, n in enumerate(topo):
            ins = [(idx[id(s._base())], s._index or 0) for s in n._inputs]
            nodes.append(NodeInfo(i, n._op, n._name, dict(n._attrs), ins,
                                  sym=n))
        if sym._op == "_group":
            heads = [(idx[id(s._base())], s._index or 0) for s in sym._inputs]
        else:
            heads = [(idx[id(sym._base())], sym._index or 0)]
        return cls(nodes, heads, symbol=sym)

    @classmethod
    def from_json(cls, graph) -> "GraphView":
        if isinstance(graph, str):
            graph = json.loads(graph)
        nodes = []
        for i, nd in enumerate(graph["nodes"]):
            op = None if nd["op"] == "null" else nd["op"]
            ins = [(inp[0], inp[1] if len(inp) > 1 else 0)
                   for inp in nd.get("inputs", [])]
            attrs = dict(nd.get("attrs", nd.get("param", {})))
            nodes.append(NodeInfo(i, op, nd["name"], attrs, ins))
        heads = [(h[0], h[1] if len(h) > 1 else 0)
                 for h in graph.get("heads", [])]
        symbol = None
        try:  # reachable subgraph as a live Symbol (for shape passes)
            from ..symbol.symbol import load_json

            symbol = load_json(json.dumps(graph))
        except Exception:
            symbol = None  # e.g. unknown ops; the registry pass reports them
        return cls(nodes, heads, symbol=symbol)

    # ------------------------------------------------------------------
    def reachable(self) -> set:
        """Node indices reachable from the heads (the live graph)."""
        seen: set = set()
        stack = [h for h, _ in self.heads]
        while stack:
            i = stack.pop()
            if i in seen:
                continue
            seen.add(i)
            stack.extend(src for src, _ in self.nodes[i].inputs)
        return seen

    def variables(self) -> List[NodeInfo]:
        return [n for n in self.nodes if n.is_variable]

    def op_nodes(self) -> List[NodeInfo]:
        return [n for n in self.nodes if n.op is not None
                and n.op != "_group"]

    def head_indices(self) -> set:
        return {h for h, _ in self.heads}
