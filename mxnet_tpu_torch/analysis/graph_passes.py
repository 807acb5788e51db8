"""GraphLinter — pass-based static analysis over Symbol graphs
(counterpart of ``mxnet_tpu/analysis/graph_passes.py``, same passes and
rule ids).

The NNVM-pass analog for this framework: each pass is a pure function
``(GraphView, LintContext) -> [Finding]`` registered under a name, and
:class:`GraphLinter` runs a configurable subset. Rules are documented in
the reference's ``docs/ANALYSIS.md``; every rule has a stable id used for
filtering and suppression. The op tags and ``differentiable`` come from
the port's ``OpDef`` (``ops/registry.py``); the shape pre-flight
evaluates nodes on ``meta`` tensors (``shape_infer.infer_graph``).

Rule ids shipped here:

- ``duplicate-name``       two distinct nodes share a name (error)
- ``dead-node``            node unreachable from any head (warning)
- ``unused-argument``      variable consumed by nothing (warning)
- ``unknown-op``           op missing from the registry (error)
- ``shape-mismatch``       shape pre-flight failed at a node (error)
- ``missing-shape``        variable shape not inferable (error)
- ``zero-size-reduction``  reduction over a zero-size axis -> NaN/-inf (error)
- ``nondiff-on-grad-path`` non-differentiable op between params and loss (warning)
- ``log-of-softmax``       log(softmax(x)) idiom, catastrophic underflow (warning)
- ``exp-on-raw-input``     exp applied to unnormalized graph input (info)
- ``high-fanout``          one value consumed by many ops; remat hazard (info)
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .findings import Finding, Report, Severity
from .graph import GraphView, NodeInfo

__all__ = ["GraphLinter", "graph_pass", "list_passes", "LintContext"]

PASS_REGISTRY: Dict[str, Callable] = {}
PASS_RULES: Dict[str, tuple] = {}

# op-name fallbacks so JSON graphs from the reference (whose ops carry no
# OpDef tags) still hit the numerics/reduction rules
_SOFTMAX_OPS = {"softmax", "Softmax", "SoftmaxActivation", "log_softmax"}
_LOG_OPS = {"log", "log2", "log10"}  # log1p is the stabilized idiom
_EXP_OPS = {"exp"}
# only reductions WITHOUT an identity on empty axes (mean -> NaN,
# max/min -> ±inf); sum/prod/norm are well-defined there (see ops/reduce.py)
_REDUCE_OPS = {"mean", "max", "min", "max_axis", "min_axis"}


def graph_pass(name: str, rules: tuple = ()):
    """Register a lint pass under ``name`` (see docs/ANALYSIS.md to add one)."""

    def deco(fn):
        PASS_REGISTRY[name] = fn
        PASS_RULES[name] = rules
        return fn

    return deco


def list_passes() -> Dict[str, tuple]:
    return dict(PASS_RULES)


class LintContext:
    """Per-run state shared by passes: input shapes, options, lazy infer."""

    def __init__(self, shapes: Optional[Dict[str, tuple]] = None,
                 dtypes: Optional[Dict[str, Any]] = None, **options):
        self.shapes = dict(shapes or {})
        self.dtypes = dict(dtypes or {})
        self.options = options
        self._infer = None

    def option(self, key, default=None):
        return self.options.get(key, default)

    def infer(self, view: GraphView):
        """Collect-mode shape pre-flight, run at most once per lint."""
        if self._infer is None and view.symbol is not None:
            from .shape_infer import infer_graph

            self._infer = infer_graph(view.symbol, self.shapes,
                                      self.dtypes or None, collect=True)
        return self._infer


def _op_tags(op: Optional[str]) -> tuple:
    from ..ops import has_op, get_op

    if op and has_op(op):
        return tuple(getattr(get_op(op), "tags", ()) or ())
    return ()


def _is(node: NodeInfo, tag: str, names: set) -> bool:
    return node.op in names or tag in _op_tags(node.op)


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------

@graph_pass("structure", rules=("duplicate-name", "dead-node",
                                "unused-argument"))
def _structure_pass(view: GraphView, ctx: LintContext) -> List[Finding]:
    out: List[Finding] = []
    seen: Dict[str, int] = {}
    for n in view.nodes:
        if n.name in seen:
            other = view.nodes[seen[n.name]]
            out.append(Finding(
                "duplicate-name", Severity.ERROR,
                f"nodes #{seen[n.name]} ({other.op or 'variable'}) and "
                f"#{n.idx} ({n.op or 'variable'}) both named {n.name!r}; "
                "bind/arg_dict are name-keyed, one will shadow the other",
                node=n.name, op=n.op,
                fix_hint="give each op/Variable a unique name= "))
        else:
            seen[n.name] = n.idx
    live = view.reachable()
    heads = view.head_indices()
    for n in view.nodes:
        if n.op == "_group":  # head grouping marker, not a real node
            continue
        if n.is_variable:
            # a variable only counts as used if something LIVE consumes it
            consumers = [c for c, _ in view.consumers[n.idx]
                         if not view.heads or c in live
                         or view.nodes[c].op == "_group"]
            if not consumers and n.idx not in heads:
                out.append(Finding(
                    "unused-argument", Severity.WARNING,
                    f"argument {n.name!r} is consumed by nothing in the "
                    "live graph and is not an output; it still occupies an "
                    "arg slot at bind time",
                    node=n.name,
                    fix_hint="remove the unused Variable"))
        elif n.idx not in live and view.heads:
            out.append(Finding(
                "dead-node", Severity.WARNING,
                f"node {n.name!r} ({n.op}) is unreachable from the graph "
                "heads; it will never execute",
                node=n.name, op=n.op,
                fix_hint="drop it from the graph json, or add it to heads"))
    return out


@graph_pass("registry", rules=("unknown-op",))
def _registry_pass(view: GraphView, ctx: LintContext) -> List[Finding]:
    from ..ops import has_op

    out = []
    for n in view.op_nodes():
        if getattr(n.sym, "_opdef", None) is not None:
            continue  # invoke_fn node: OpDef carried inline, not registered
        if not has_op(n.op):
            out.append(Finding(
                "unknown-op", Severity.ERROR,
                f"operator {n.op!r} (node {n.name!r}) is not in the op "
                "registry; bind would raise NotImplementedError",
                node=n.name, op=n.op,
                fix_hint="check the op name, or port the op into "
                         "mxnet_tpu_torch/ops/"))
    return out


@graph_pass("shape-preflight", rules=("shape-mismatch", "missing-shape",
                                      "zero-size-reduction", "unknown-op"))
def _shape_pass(view: GraphView, ctx: LintContext) -> List[Finding]:
    if view.symbol is None:
        return []
    has_hints = any("__shape__" in n.attrs for n in view.variables())
    if not ctx.shapes and not has_hints:
        return []  # nothing to anchor inference; bind-time lint supplies shapes
    res = ctx.infer(view)
    out = list(res.findings)
    # zero-size reductions: legal to trace, NaN/-inf at run time
    id_to_shape = res.node_out
    for n in view.op_nodes():
        if n.sym is None or not _is(n, "reduction", _REDUCE_OPS):
            continue
        in_shapes = res.node_in.get(id(n.sym)) or []
        if not in_shapes or in_shapes[0] is None:
            continue
        shape = in_shapes[0]
        kw = n.kwargs()
        axis = kw.get("axis", None)
        if axis is None:
            reduced = range(len(shape))
        else:
            axes = axis if isinstance(axis, (tuple, list)) else (axis,)
            try:
                reduced = [int(a) % max(len(shape), 1) for a in axes]
            except (TypeError, ValueError):
                continue
        if any(shape[a] == 0 for a in reduced if a < len(shape)):
            out.append(Finding(
                "zero-size-reduction", Severity.ERROR,
                f"{n.op} ({n.name!r}) reduces over a zero-size axis of "
                f"input shape {shape}; mean/max produce NaN/-inf at run time",
                node=n.name, op=n.op,
                fix_hint="guard the empty case or fix the upstream shape"))
    return out


@graph_pass("grad-path", rules=("nondiff-on-grad-path",))
def _grad_path_pass(view: GraphView, ctx: LintContext) -> List[Finding]:
    """Non-differentiable ops (OpDef.differentiable=False) that sit between
    trainable parameters and the graph outputs block/zero gradients."""
    from ..ops import get_op, has_op

    param_names = ctx.option("param_names")
    suffixes = ("weight", "bias", "gamma", "beta")

    def is_param(n: NodeInfo) -> bool:
        if not n.is_variable or n.attrs.get("__aux__"):
            return False
        if param_names is not None:
            return n.name in param_names
        return n.name.endswith(suffixes)

    depends_on_param = [False] * len(view.nodes)
    out: List[Finding] = []
    for n in view.nodes:  # topo order for Symbol views; JSON is topo too
        if n.is_variable:
            depends_on_param[n.idx] = is_param(n)
            continue
        dep = any(depends_on_param[src] for src, _ in n.inputs)
        depends_on_param[n.idx] = dep
        if dep and n.op != "_group" and has_op(n.op) \
                and not get_op(n.op).differentiable:
            out.append(Finding(
                "nondiff-on-grad-path", Severity.WARNING,
                f"{n.op} ({n.name!r}) is non-differentiable but depends on "
                "trainable parameters; backward will stop or zero gradients "
                "through it",
                node=n.name, op=n.op,
                fix_hint="move it off the loss path (metrics/postprocess) "
                         "or use a differentiable surrogate"))
    return out


@graph_pass("numerics", rules=("log-of-softmax", "exp-on-raw-input"))
def _numerics_pass(view: GraphView, ctx: LintContext) -> List[Finding]:
    out: List[Finding] = []
    for n in view.op_nodes():
        if _is(n, "log", _LOG_OPS):
            for src, _o in n.inputs:
                srcn = view.nodes[src]
                if srcn.op is not None and _is(srcn, "softmax", _SOFTMAX_OPS) \
                        and srcn.op != "log_softmax":
                    out.append(Finding(
                        "log-of-softmax", Severity.WARNING,
                        f"log ({n.name!r}) applied to {srcn.op} "
                        f"({srcn.name!r}): underflows to -inf for "
                        "confident predictions",
                        node=n.name, op=n.op,
                        fix_hint="use log_softmax (one fused, stabilized "
                                 "op) or SoftmaxCrossEntropy-style loss"))
        if _is(n, "exp", _EXP_OPS):
            for src, _o in n.inputs:
                srcn = view.nodes[src]
                if srcn.is_variable and not srcn.name.endswith(
                        ("weight", "bias", "gamma", "beta")):
                    out.append(Finding(
                        "exp-on-raw-input", Severity.INFO,
                        f"exp ({n.name!r}) applied directly to graph input "
                        f"{srcn.name!r}; unbounded inputs overflow to inf "
                        "in fp32 above ~88",
                        node=n.name, op=n.op,
                        fix_hint="subtract a running max / clip / normalize "
                                 "before exponentiating"))
    return out


@graph_pass("fanout", rules=("high-fanout",))
def _fanout_pass(view: GraphView, ctx: LintContext) -> List[Finding]:
    threshold = int(ctx.option("fanout_threshold", 8))
    out: List[Finding] = []
    for n in view.op_nodes():
        consumers = view.consumers[n.idx]
        if len(consumers) >= threshold:
            out.append(Finding(
                "high-fanout", Severity.INFO,
                f"{n.op} ({n.name!r}) output feeds {len(consumers)} "
                "consumers; its activation is live across all of them and "
                "backward recomputes/holds it for each",
                node=n.name, op=n.op,
                fix_hint="consider remat (ShardedTrainer(remat=True)) or "
                         "restructuring the fan-out"))
    return out


# ---------------------------------------------------------------------------


class GraphLinter:
    """Run a set of passes over a Symbol or a ``tojson()`` graph.

    ::

        report = GraphLinter().lint(sym, shapes={"data": (2, 3, 32, 32)})
        report.raise_if_errors()

    ``passes`` selects a subset by name; ``options`` are forwarded to the
    :class:`LintContext` (e.g. ``fanout_threshold=4``,
    ``param_names={...}``, ``disable={"high-fanout"}``).
    """

    def __init__(self, passes: Optional[List[str]] = None, **options):
        unknown = set(passes or ()) - set(PASS_REGISTRY)
        if unknown:
            raise ValueError(f"unknown lint passes {sorted(unknown)}; "
                             f"available: {sorted(PASS_REGISTRY)}")
        self.passes = list(passes) if passes is not None \
            else list(PASS_REGISTRY)
        self.options = options

    def lint(self, graph, shapes: Optional[Dict[str, tuple]] = None,
             dtypes: Optional[Dict[str, Any]] = None,
             **shape_kwargs) -> Report:
        all_shapes = dict(shapes or {})
        all_shapes.update({k: tuple(v) for k, v in shape_kwargs.items()})
        if isinstance(graph, (str, dict)):
            view = GraphView.from_json(graph)
        else:
            view = GraphView.from_symbol(graph)
        ctx = LintContext(shapes=all_shapes, dtypes=dtypes, **self.options)
        disable = set(self.options.get("disable") or ())
        report = Report()
        seen = set()
        for name in self.passes:
            for f in PASS_REGISTRY[name](view, ctx):
                if f.rule_id in disable:
                    continue
                key = (f.rule_id, f.node, f.message)
                if key in seen:  # e.g. unknown-op via registry + preflight
                    continue
                seen.add(key)
                report.add(f)
        return report
