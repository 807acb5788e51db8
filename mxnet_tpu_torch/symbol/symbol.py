"""Symbol — lazy computation graph (counterpart of
``mxnet_tpu/symbol/symbol.py``).

The graph is a plain Python DAG over the registered ops. Binding it
(``simple_bind``/``bind``, ``executor.py``) makes one function of the
graph's argument and auxiliary tensors that runs the same op functions
the imperative API runs, so a traced model reaches the same kernels;
shape inference evaluates them on ``meta`` tensors
(``analysis/shape_infer.py``).

Missing tensor inputs auto-create Variables named ``{name}_{arg}`` (the
reference's behavior that makes ``Module.init_params`` work); ``moving_*``
args become auxiliary states. ``tojson`` gives the reference's JSON for
graphs of registered ops; the ``_invoke_fn`` placeholder of
:func:`invoke_fn` cannot be loaded back, in either package.
``optimize_for`` applies a graph pass of ``subgraph.py``; ``lint`` runs
the graph linter (``analysis.GraphLinter``).
"""
from __future__ import annotations

import inspect
import json
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..base import GraphAnalysisError
from ..ops import get_op, has_op
from ..ops.registry import OpDef, coerce_kwargs

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json", "zeros",
           "ones", "invoke_fn"]

# argument names treated as tensor inputs when inferring op signatures
_TENSOR_ARGS = {
    "data", "weight", "bias", "gamma", "beta", "moving_mean", "moving_var",
    "running_mean", "running_var", "lhs", "rhs", "condition", "x", "y",
    "label", "grad", "indices", "index", "parameters", "state", "state_cell",
    "sequence_length", "mean", "var", "mom", "a", "b", "loss", "value",
    "mask", "anchors", "cls_pred", "loc_pred",
}
# inputs that are auxiliary (not trained, updated by forward)
_AUX_ARGS = {"moving_mean", "moving_var", "running_mean", "running_var"}


class _NameManager(threading.local):
    def __init__(self):
        self.counters: Dict[str, int] = {}

    def get(self, hint: str) -> str:
        n = self.counters.get(hint, 0)
        self.counters[hint] = n + 1
        return f"{hint}{n}"


_NAMES = _NameManager()


def op_input_names(opdef: OpDef) -> List[str]:
    """Tensor-input argument names of an op, in signature order.

    ``ndarray_inputs="*"`` marks a variadic op (``def op(*data, ...)``):
    positional symbols fill the slots, so the single placeholder name is
    only used when an input must be auto-created.
    """
    if opdef.ndarray_inputs == "*":
        return ["data"]
    if opdef.ndarray_inputs:
        return list(opdef.ndarray_inputs)
    names = []
    try:
        sig = inspect.signature(opdef.fn)
    except (ValueError, TypeError):
        return ["data"]
    for p in sig.parameters.values():
        if p.kind not in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY):
            break
        if p.default is inspect.Parameter.empty or p.name in _TENSOR_ARGS:
            names.append(p.name)
        else:
            break
    return names or ["data"]


class Symbol:
    """One graph node (possibly multi-output); ``_index`` selects an output."""

    def __init__(self, op: Optional[str], name: str, inputs: List["Symbol"],
                 attrs: Dict[str, Any], index: Optional[int] = None):
        self._op = op          # None => variable
        self._name = name
        self._inputs = inputs
        self._attrs = dict(attrs)
        self._index = index

    # ------------------------------------------------------------- naming
    @property
    def name(self):
        if self._index is not None:
            return f"{self._name}_output{self._index}"
        return self._name

    def attr(self, key):
        v = self._attrs.get(key)
        if v is None:  # AttrScope-injected attrs are dunder-keyed
            v = self._attrs.get(f"__{key}__")
        return v

    def list_attr(self):
        return {k: str(v) for k, v in self._attrs.items()}

    # ---------------------------------------------------------- traversal
    def _topo(self) -> List["Symbol"]:
        seen: Dict[int, Symbol] = {}
        order: List[Symbol] = []

        def visit(node: "Symbol"):
            base = node._base()
            if id(base) in seen:
                return
            seen[id(base)] = base
            for i in base._inputs:
                visit(i)
            order.append(base)

        visit(self)
        return order

    def _base(self) -> "Symbol":
        return self if self._index is None else self._inputs[0]

    def get_internals(self) -> "Symbol":
        return Group(self._topo())

    def list_arguments(self) -> List[str]:
        return [n._name for n in self._topo()
                if n._op is None and not n._attrs.get("__aux__")]

    def list_auxiliary_states(self) -> List[str]:
        return [n._name for n in self._topo()
                if n._op is None and n._attrs.get("__aux__")]

    def list_inputs(self) -> List[str]:
        return [n._name for n in self._topo() if n._op is None]

    def list_outputs(self) -> List[str]:
        if self._op == "_group":
            out = []
            for s in self._inputs:
                out.extend(s.list_outputs())
            return out
        if self._index is not None:
            return [self.name]
        n = self._n_outputs()
        if n == 1:
            return [f"{self._name}_output"]
        return [f"{self._name}_output{i}" for i in range(n)]

    def _n_outputs(self) -> int:
        if self._op is None:
            return 1
        if self._op == "_group":
            return len(self.list_outputs())
        if self._index is not None:
            return 1
        opdef = getattr(self, "_opdef", None) or get_op(self._op)
        try:
            return opdef.n_out(coerce_kwargs(dict(self._attrs))) or 1
        except Exception:
            return 1

    @property
    def num_outputs(self):
        return self._n_outputs()

    def __getitem__(self, idx):
        if isinstance(idx, str):
            names = self.list_outputs()
            idx = names.index(idx)
        if self._op == "_group":
            return self._inputs[idx]
        if self._n_outputs() == 1 and idx == 0:
            return self
        return Symbol(self._op, self._name, [self], {}, index=idx)

    def __iter__(self):
        return iter(self[i] for i in range(len(self.list_outputs())))

    def __len__(self):
        return len(self.list_outputs())

    @property
    def outputs(self):
        return [self[i] for i in range(len(self.list_outputs()))]

    # ---------------------------------------------------------- arithmetic
    def _binop(self, op, other, swap=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if swap else (self, other)
            return _apply_op(op, [a, b], {})
        scalar_ops = {"broadcast_add": "_plus_scalar", "broadcast_sub":
                      "_rminus_scalar" if swap else "_minus_scalar",
                      "broadcast_mul": "_mul_scalar",
                      "broadcast_div": "_rdiv_scalar" if swap else "_div_scalar",
                      "broadcast_power": "_rpower_scalar" if swap else "_power_scalar"}
        sop = scalar_ops.get(op)
        if sop and has_op(sop):
            return _apply_op(sop, [self], {"scalar": other})
        raise TypeError(f"unsupported operand for {op}: {type(other)}")

    def __add__(self, o):
        return self._binop("broadcast_add", o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop("broadcast_sub", o)

    def __rsub__(self, o):
        return self._binop("broadcast_sub", o, swap=True)

    def __mul__(self, o):
        return self._binop("broadcast_mul", o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop("broadcast_div", o)

    def __rtruediv__(self, o):
        return self._binop("broadcast_div", o, swap=True)

    def __pow__(self, o):
        return self._binop("broadcast_power", o)

    def __neg__(self):
        return self._binop("broadcast_mul", -1.0)

    # ---------------------------------------------------------- inference
    @property
    def shape(self) -> tuple:
        """Static output shape of this node, via the shared analysis engine.

        Works when every upstream Variable carries a shape hint
        (``Variable(name, shape=...)``) or is an auto-shaped parameter —
        which makes shape-inspecting ``hybrid_forward`` code (``b, s, u =
        x.shape``) traceable symbolically, like concrete shapes inside a
        trace. Raises a node-attributed
        :class:`~mxnet_tpu_torch.base.GraphAnalysisError` when
        under-hinted.
        """
        from ..analysis.shape_infer import infer_graph

        res = infer_graph(self, {}, use_hint_cache=True)
        base = self._base()
        s = res.node_out.get(id(base))
        if isinstance(s, list):
            s = s[self._index or 0]
        if s is None:
            raise GraphAnalysisError(
                f"shape of {self.name!r} is not statically known; give the "
                "input Variables shape hints (Variable(name, shape=...))",
                node=self.name, op=self._op, rule_id="missing-shape")
        return tuple(s)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    # ------------------------------------------------------ method aliases
    # (mirror NDArray's method surface so F-generic hybrid_forward code —
    # x.reshape(...), x.transpose(...) — traces symbolically too)
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _apply_op("reshape", [self], {"shape": shape, **kwargs})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _apply_op("transpose", [self], {"axes": axes or None})

    @property
    def T(self):
        return self.transpose()

    def astype(self, dtype):
        return _apply_op("cast", [self], {"dtype": str(np.dtype(dtype))})

    def flatten(self):
        return _apply_op("Flatten", [self], {})

    def expand_dims(self, axis):
        return _apply_op("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _apply_op("squeeze", [self], {"axis": axis})

    def slice_axis(self, axis, begin, end):
        return _apply_op("slice_axis", [self],
                         {"axis": axis, "begin": begin, "end": end})

    def sum(self, axis=None, keepdims=False, **kw):
        return _apply_op("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False, **kw):
        return _apply_op("mean", [self], {"axis": axis, "keepdims": keepdims})

    def infer_shape(self, **kwargs):
        """Returns (arg_shapes, out_shapes, aux_shapes) (reference API).
        Parameter shapes are derived from data shapes like the reference's
        InferShape pass."""
        shapes, out_shapes = infer_shapes(self, kwargs)
        args = self.list_arguments()
        auxs = self.list_auxiliary_states()
        return ([shapes[a] for a in args], out_shapes,
                [shapes[a] for a in auxs])

    def infer_type(self, **kwargs):
        """Returns (arg_types, out_types, aux_types). With enough shape
        hints (Variable(shape=...) or prior infer), dtypes come from the
        same engine as infer_shape; otherwise the reference default
        (everything float32) is reported. Failures raise a node-attributed
        :class:`~mxnet_tpu_torch.base.GraphAnalysisError`."""
        args = self.list_arguments()
        auxs = self.list_auxiliary_states()
        try:
            from ..analysis.shape_infer import infer_graph

            res = infer_graph(self, {}, known_dtypes=kwargs or None)
            if all(d is not None for d in res.out_dtypes) and \
                    all(a in res.dtypes for a in args):
                np_t = lambda d: getattr(d, "type", d)  # noqa: E731
                return ([np_t(res.dtypes[a]) for a in args],
                        [np_t(d) for d in res.out_dtypes],
                        [np_t(res.dtypes[a]) for a in auxs])
        except ValueError as e:
            # not enough shape hints -> reference default; a real graph
            # inconsistency (shape-mismatch) propagates with attribution
            if getattr(e, "rule_id", None) not in (None, "missing-shape"):
                raise
        return ([np.float32] * len(args),
                [np.float32] * len(self.list_outputs()),
                [np.float32] * len(auxs))

    # ----------------------------------------------------------- analysis
    def lint(self, shapes: Optional[Dict[str, tuple]] = None, passes=None,
             **shape_kwargs):
        """Run the static analyzer over this graph (nothing runs).

        Returns an :class:`mxnet_tpu_torch.analysis.Report`. Pass input
        shapes (``sym.lint(data=(2, 3, 32, 32))``) to enable the
        shape/dtype pre-flight; without them (and without ``shape=``
        hints on the Variables) only the structural passes run.
        ``passes`` selects a subset by name (see
        ``mxnet_tpu_torch.analysis.list_passes``).
        """
        from ..analysis import GraphLinter

        return GraphLinter(passes=passes).lint(self, shapes=shapes,
                                               **shape_kwargs)

    # ---------------------------------------------------------- execution
    def simple_bind(self, ctx=None, grad_req="write", lint=None, **shapes):
        """An :class:`~mxnet_tpu_torch.executor.Executor` with arrays of the
        inferred shapes on ``ctx`` (default: the current context, the
        card unless a ``with mx.cpu():`` scope is open). ``lint``
        (``"off"|"warn"|"error"``, default ``MXNET_GRAPH_LINT``) runs the
        graph linter over these shapes first."""
        from ..executor import Executor

        return Executor(self, ctx=ctx, grad_req=grad_req, shapes=shapes,
                        lint=lint)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, lint=None, **kwargs):
        from ..executor import Executor

        return Executor(self, ctx=ctx, grad_req=grad_req, args=args,
                        args_grad=args_grad, aux_states=aux_states,
                        lint=lint)

    def optimize_for(self, backend, args=None, aux=None, **kwargs):
        """Apply a registered graph pass (reference Symbol.optimize_for /
        subgraph backend API): returns the rewritten Symbol; updated params
        are available on ._optimized_args/._optimized_aux."""
        from ..subgraph import optimize_symbol

        new_sym, new_args, new_aux = optimize_symbol(self, backend, args, aux)
        new_sym._optimized_args = new_args
        new_sym._optimized_aux = new_aux
        return new_sym

    def eval(self, ctx=None, **kwargs):
        exe = self.simple_bind(ctx=ctx, grad_req="null",
                               **{k: v.shape for k, v in kwargs.items()})
        return exe.forward(is_train=False, **kwargs)

    # ------------------------------------------------------------- persist
    def tojson(self) -> str:
        nodes = self._topo()
        idx = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            out_nodes.append({
                "op": "null" if n._op is None else n._op,
                "name": n._name,
                "attrs": {k: str(v) for k, v in n._attrs.items()
                          if not k.startswith("__")},
                "inputs": [[idx[id(i._base())], i._index or 0, 0]
                           for i in n._inputs],
            })
        if self._op == "_group":
            heads = []
            for s in self._inputs:
                heads.append([idx[id(s._base())], s._index or 0, 0])
        else:
            heads = [[idx[id(self._base())], self._index or 0, 0]]
        arg_nodes = [i for i, n in enumerate(nodes) if n._op is None]
        return json.dumps({"nodes": out_nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10900]}}, indent=2)

    def save(self, fname: str):
        from ..checkpoint.atomic import atomic_write_bytes

        # atomic: checkpoints pair this JSON with .params — a crash must
        # not leave a truncated graph next to valid weights
        atomic_write_bytes(fname, self.tojson().encode("utf-8"))

    def __repr__(self):
        if self._op is None:
            return f"<Symbol {self._name}>"
        return f"<Symbol {self._op}:{self.name}>"


# ---------------------------------------------------------------------------


def _scoped_name(name: Optional[str], hint: str) -> str:
    """Resolve a node name through mx.name scopes (NameManager/Prefix),
    falling back to the module-global counter."""
    if name:
        return name
    from .. import name as name_mod

    mgr = name_mod._STATE.current
    if mgr is not None:
        return mgr.get(None, hint)
    return _NAMES.get(hint)


def _scope_attrs(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Merge mx.attribute.AttrScope attrs in, dunder-keyed so the executor
    never passes them as op kwargs (read back via Symbol.attr)."""
    from .. import attribute

    cur = attribute.current()
    if not cur:
        return attrs
    merged = {f"__{k}__": v for k, v in cur.items()}
    merged.update(attrs)
    return merged


def _apply_op(op_name: str, sym_inputs: List[Symbol], attrs: Dict[str, Any],
              name: Optional[str] = None) -> Symbol:
    node = Symbol(op_name, _scoped_name(name, op_name.lower().lstrip("_")),
                  sym_inputs, _scope_attrs(attrs))
    return node


def _make_symbol_op(op_name: str):
    opdef = get_op(op_name)

    def sym_op(*args, name=None, attr=None, **kwargs):
        input_names = op_input_names(opdef)
        inputs: List[Optional[Symbol]] = []
        rest = list(args)
        # positional symbols fill input slots in order
        while rest and isinstance(rest[0], Symbol):
            inputs.append(rest.pop(0))
        if rest:
            raise TypeError(f"{op_name}: unexpected positional args {rest}")
        # keyword symbols fill by name
        by_name = {}
        for k in list(kwargs):
            if isinstance(kwargs[k], Symbol):
                by_name[k] = kwargs.pop(k)
        node_name = _scoped_name(name, op_name.lower().lstrip("_"))
        full_inputs: List[Symbol] = list(inputs)
        no_bias = str(kwargs.get("no_bias", False)).lower() == "true"
        if len(inputs) < len(input_names) and (inputs or by_name):
            for i, in_name in enumerate(input_names):
                if i < len(inputs):
                    continue
                if in_name in by_name:
                    full_inputs.append(by_name.pop(in_name))
                else:
                    if in_name == "bias" and no_bias:
                        continue
                    aux = in_name in _AUX_ARGS
                    full_inputs.append(Variable(f"{node_name}_{in_name}",
                                                __aux__=aux))
        if by_name:
            raise TypeError(f"{op_name}: unknown symbol kwargs {list(by_name)}")
        return _apply_op(op_name, full_inputs, kwargs, name=node_name)

    sym_op.__name__ = op_name
    sym_op.__doc__ = (opdef.fn.__doc__ or "") + f"\n\n(symbolic op {op_name!r})"
    return sym_op


def invoke_fn(fn, inputs: Sequence[Symbol], kwargs=None,
              num_outputs=1, name=None) -> Symbol:
    """Symbolic counterpart of ``ndarray.invoke_fn``: splice an ad-hoc pure
    function into the graph as one node.

    The node carries its :class:`OpDef` inline (``_opdef``) instead of a
    registry name, so the executor and the shape pre-flight evaluate it
    like any other op. Such graphs are in-memory only: ``tojson()`` emits
    the ``_invoke_fn`` placeholder, which cannot be loaded back.
    """
    node = _apply_op("_invoke_fn", list(inputs), dict(kwargs or {}),
                     name=name)
    node._opdef = OpDef("_invoke_fn", fn, num_outputs=num_outputs,
                        ndarray_inputs="*")
    return node


def Variable(name: str, shape=None, dtype=None, init=None, **attrs) -> Symbol:
    a = dict(attrs)
    if shape is not None:
        a["__shape__"] = tuple(shape)
    if dtype is not None:
        a["__dtype__"] = str(dtype)
    if init is not None:
        a["__init__"] = init
    return Symbol(None, name, [], _scope_attrs(a))


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    return Symbol("_group", "group", list(symbols), {})


def zeros(shape, dtype="float32", name=None):
    return _apply_op("_zeros", [], {"shape": tuple(shape), "dtype": dtype},
                     name=name)


def ones(shape, dtype="float32", name=None):
    return _apply_op("_ones", [], {"shape": tuple(shape), "dtype": dtype},
                     name=name)


def load_json(s: str) -> Symbol:
    d = json.loads(s)
    nodes: List[Symbol] = []
    for nd_ in d["nodes"]:
        if nd_["op"] == "null":
            attrs = coerce_kwargs(nd_.get("attrs", nd_.get("param", {})))
            sym = Symbol(None, nd_["name"], [], attrs)
        else:
            ins = []
            for (nid, out_idx, _v) in nd_["inputs"]:
                src = nodes[nid]
                ins.append(src if out_idx == 0 else src[out_idx])
            attrs = coerce_kwargs(nd_.get("attrs", nd_.get("param", {})))
            sym = Symbol(nd_["op"], nd_["name"], ins, attrs)
            # Auxness is DERIVED, not serialized (tojson drops internal
            # "__" attrs, and the reference json carries none either —
            # graph.cc re-derives aux states from the op registry's
            # mutable inputs): a variable feeding an op slot named in
            # _AUX_ARGS (moving_mean/moving_var/...) is an aux state.
            # Without this, a BatchNorm checkpoint reloads its moving
            # stats as plain (zero-initialized) arguments — a silent
            # eval-accuracy bug.
            try:
                slots = op_input_names(get_op(nd_["op"]))
            except Exception:  # unknown/variadic op: nothing to derive
                slots = []
            for inp, slot in zip(ins, slots):
                base = inp._base()
                if base._op is None and slot in _AUX_ARGS:
                    base._attrs["__aux__"] = True
        nodes.append(sym)
    heads = [nodes[h[0]] if h[1] == 0 else nodes[h[0]][h[1]]
             for h in d["heads"]]
    if len(heads) == 1:
        return heads[0]
    return Group(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


# ---------------------------------------------------------------------------
# shape inference
# ---------------------------------------------------------------------------

def _param_shape_rules(op: str, in_shape: tuple, kwargs: Dict[str, Any],
                       arg: str) -> Optional[tuple]:
    """Shape of an auto-created parameter from the primary input's shape —
    mirrors each op's InferShape."""
    k = kwargs
    if op == "FullyConnected":
        nh = int(k["num_hidden"])
        flatten = k.get("flatten", True)
        in_units = int(np.prod(in_shape[1:])) if flatten else in_shape[-1]
        return {"weight": (nh, in_units), "bias": (nh,)}.get(arg)
    if op in ("Convolution", "Deconvolution"):
        nf = int(k["num_filter"])
        kern = tuple(k.get("kernel", ()))
        ng = int(k.get("num_group", 1))
        c = in_shape[1]
        if op == "Convolution":
            w = (nf, c // ng) + kern
        else:
            w = (c, nf // ng) + kern
        return {"weight": w, "bias": (nf,)}.get(arg)
    if op in ("BatchNorm", "InstanceNorm"):
        axis = int(k.get("axis", 1))
        return (in_shape[axis],)
    if op in ("_contrib_quantized_conv", "_contrib_quantized_fully_connected"):
        # the int8 weights and their ranges, for a graph that
        # contrib.quantization.quantize_model rewrote
        if arg in ("min_weight", "max_weight"):
            return (1,)
        if arg != "weight":
            return None
        if op == "_contrib_quantized_conv":
            return (int(k["num_filter"]),
                    in_shape[1] // int(k.get("num_group", 1))) + \
                tuple(int(x) for x in k.get("kernel", (1, 1)))
        flatten = str(k.get("flatten", True)).lower() not in ("0", "false")
        in_units = int(np.prod(in_shape[1:])) if flatten else in_shape[-1]
        return (int(k["num_hidden"]), in_units)
    if op == "LayerNorm":
        axis = int(k.get("axis", -1)) % len(in_shape)
        return (in_shape[axis],)
    if op == "GroupNorm":
        return (in_shape[1],)
    if op == "Embedding":
        return (int(k["input_dim"]), int(k["output_dim"]))
    if op == "LeakyReLU" and arg == "gamma":
        return (in_shape[1] if len(in_shape) > 1 else in_shape[0],)
    if op in ("SoftmaxOutput", "Softmax", "SVMOutput") and arg == "label":
        multi = str(k.get("multi_output", False)).lower() == "true" or \
            k.get("multi_output") is True
        if multi:
            return (in_shape[0],) + tuple(in_shape[2:])
        return (in_shape[0],)
    if op.endswith("RegressionOutput") and arg == "label":
        return tuple(in_shape)
    if op == "RNN":
        from ..ops.rnn import rnn_param_size

        h = int(k["state_size"])
        L = int(k["num_layers"])
        bi = str(k.get("bidirectional", False)).lower() == "true" or \
            k.get("bidirectional") is True
        dirs = 2 if bi else 1
        if arg == "parameters":
            return (rnn_param_size(k["mode"], in_shape[2], h, L, bi),)
        if arg in ("state", "state_cell"):
            return (L * dirs, in_shape[1], h)
    return None


def infer_shapes(sym: Symbol, known: Dict[str, tuple]):
    """Topo-order forward shape inference. Returns (all_input_shapes,
    out_shapes). Auto-created params get shapes from op rules; other node
    outputs from the same op functions evaluated on meta tensors."""
    shapes, out_shapes, _ = _infer_shapes_full(sym, known)
    return shapes, out_shapes


def infer_node_shapes(sym: Symbol, known: Dict[str, tuple]):
    """Per-node output shapes keyed by id(node) (used by export helpers
    that need intermediate ranks, e.g. the ONNX Softmax axis guard)."""
    return _infer_shapes_full(sym, known)[2]


def _infer_shapes_full(sym: Symbol, known: Dict[str, tuple]):
    """Delegates to the shared engine (analysis/shape_infer.py). Failures
    raise a node-attributed GraphAnalysisError (a ValueError)."""
    from ..analysis.shape_infer import infer_graph

    res = infer_graph(sym, known)
    return res.shapes, res.out_shapes, res.node_out
