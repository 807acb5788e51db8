"""``mx.viz``: network visualization (counterpart of
``mxnet_tpu/visualization.py``).

``print_summary`` prints the layer table of a Symbol graph. Its shapes
come from the port's shape engine (``analysis/shape_infer.py``, the op
functions on ``meta`` tensors), the one ``Symbol.infer_shape`` uses.
``plot_network`` returns a graphviz ``Digraph`` when the optional
``graphviz`` package is installed, and raises ``ImportError`` with the
reference's guidance when it is not.
"""
from __future__ import annotations

import json

__all__ = ["print_summary", "plot_network"]


def _sym_nodes(symbol):
    conf = json.loads(symbol.tojson())
    return conf["nodes"], conf.get("heads", [])


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64, .74, 1.)):
    """Layer-table summary of a Symbol graph (reference
    ``mx.viz.print_summary``), with each op's output shape when ``shape``
    gives the inputs' shapes; returns the text it prints."""
    topo = symbol._topo()
    node_shapes = {}
    shapes = {}
    if shape is not None:
        from .analysis.shape_infer import infer_graph

        res = infer_graph(symbol, {k: tuple(v) for k, v in shape.items()})
        shapes = res.shapes
        node_shapes = {id(n): res.node_out.get(id(n)) for n in topo}
    positions = [int(line_length * p) for p in positions]
    header = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def line(fields):
        row = ""
        for f, p in zip(fields, positions):
            row = (row + str(f))[:p].ljust(p)
        return row

    out = ["_" * line_length, line(header), "=" * line_length]
    total = 0
    for n in topo:
        if n._op is None:
            name = n._name
            cnt = 0
            shp = shapes.get(name, "")
            if name in shapes:
                cnt = 1
                for s in shapes[name]:
                    cnt *= s
            if any(name.endswith(sfx) for sfx in
                   ("weight", "bias", "gamma", "beta", "mean", "var")):
                total += cnt
                out.append(line([f"{name} (Parameter)", shp, cnt, ""]))
            continue
        if n._op == "_group":
            continue
        out_shp = node_shapes.get(id(n), "")
        if isinstance(out_shp, list):
            out_shp = ", ".join(str(s) for s in out_shp)
        prevs = ",".join(i._base()._name for i in n._inputs[:2])
        out.append(line([f"{n._name} ({n._op})", out_shp or "", 0, prevs]))
    out.append("=" * line_length)
    out.append(f"Total params: {total}")
    out.append("_" * line_length)
    print("\n".join(out))
    return "\n".join(out)


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz digraph of the Symbol graph (reference plot_network)."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError(
            "plot_network needs the optional 'graphviz' package (not "
            "installed); use mx.viz.print_summary for a text summary") from e
    nodes, _ = _sym_nodes(symbol)
    dot = Digraph(name=title, format=save_format)
    for i, n in enumerate(nodes):
        if n["op"] == "null" and hide_weights and n["name"].rsplit("_", 1)[-1] in (
                "weight", "bias", "gamma", "beta", "mean", "var"):
            continue
        dot.node(str(i), f"{n['name']}\n{n['op']}" if n["op"] != "null"
                 else n["name"])
    for i, n in enumerate(nodes):
        for (src, _o, _v) in n.get("inputs", []):
            s = nodes[src]
            if s["op"] == "null" and hide_weights and \
                    s["name"].rsplit("_", 1)[-1] in (
                        "weight", "bias", "gamma", "beta", "mean", "var"):
                continue
            dot.edge(str(src), str(i))
    return dot
