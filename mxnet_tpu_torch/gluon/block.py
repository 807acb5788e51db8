"""Gluon ``Block``, ``HybridBlock`` and ``CachedOp`` (counterpart of
``mxnet_tpu/gluon/block.py``).

A block names its parameters as the reference does: a prefix from a
per-class counter (``dense0_``, ``layernorm3_``; ``_BlockScope``) unless
the caller gives one, so ``collect_params()`` holds the same names in both
packages for the same sequence of constructions.

A non-hybridized ``HybridBlock`` runs ``hybrid_forward`` op by op through
``nd``. ``hybridize()`` swaps in a :class:`CachedOp`, keyed like the
reference's on (train mode, parameter shapes and dtypes, input shapes and
dtypes). The reference purifies the forward and compiles one XLA program
per key; here a cache entry is one function of (parameter tensors,
inputs) that runs the block's eager forward, dispatched through
``ndarray.invoke`` as one op, so that under ``autograd.record()`` torch
records the same graph the plain forward records: hybridized and plain
calls give bitwise-equal outputs and gradients. Hybridized children run
inline inside their parent's cached op, as nested jits inline into the
reference's program. Parameters that the forward rebinds (aux state) are
written back after the call. A first call with deferred shapes runs
eagerly, and ``hybridize()`` drops the cache.

Called on Symbols, a block traces itself (``hybrid_forward`` with
``F = symbol``): its parameters become Variables named as they are, with
their shapes as hints, and parameters that take no gradient (BatchNorm's
running statistics) become auxiliary states that a bound ``Executor``
folds in training, as the eager layer does (the reference's trace leaves
them plain arguments). ``export`` writes the ``.params`` file and the
traced graph; ``SymbolBlock``/``imports`` run a graph as a block.
``export(format="onnx")`` writes an ONNX file too (``contrib/onnx.py``);
``lint`` scans the forward's source and lints the traced graph
(``analysis``); ``optimize_for`` hybridizes,
as the reference's does; ``load_stablehlo`` raises by design.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

import numpy as np

from .. import autograd
from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.ndarray import invoke
from ..ops.registry import OpDef
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp",
           "load_stablehlo"]

class _BlockScope(threading.local):
    def __init__(self):
        self.counters = {}

    def alloc_prefix(self, hint):
        n = self.counters.get(hint, 0)
        self.counters[hint] = n + 1
        return f"{hint}{n}_"


_SCOPE = _BlockScope()


class _InCachedOp(threading.local):
    """Set while a cached op runs its block's forward: hybridized children
    then run inline, as the reference's nested jits inline into their
    parent's program."""
    active = False


_IN_CACHED_OP = _InCachedOp()


def _flatten_nds(args):
    flat, fmt = [], []
    for a in args:
        if isinstance(a, NDArray):
            flat.append(a)
            fmt.append(None)
        elif isinstance(a, (list, tuple)):
            f, m = _flatten_nds(a)
            flat.extend(f)
            fmt.append((type(a), m))
        else:
            fmt.append(("const", a))
    return flat, fmt


def _unflatten_nds(flat_iter, fmt):
    out = []
    for f in fmt:
        if f is None:
            out.append(next(flat_iter))
        elif isinstance(f, tuple) and f[0] == "const":
            out.append(f[1])
        else:
            typ, m = f
            out.append(typ(_unflatten_nds(flat_iter, m)))
    return out


class Block:
    """Base class for all layers and models."""

    def __init__(self, prefix=None, params=None):
        cls = self.__class__.__name__.lower()
        self._prefix = prefix if prefix is not None else \
            _SCOPE.alloc_prefix(cls)
        self._params = ParameterDict(self._prefix, shared=params)
        self._children = OrderedDict()
        self._reg_params = OrderedDict()  # attr name -> Parameter
        self._forward_hooks = []
        self._forward_pre_hooks = []

    # -- registering children and params ---------------------------------
    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get("_children")
            if existing is not None:
                existing[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
                self._params._params[value.name] = value
        super().__setattr__(name, value)

    # -- naming ----------------------------------------------------------
    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._prefix.rstrip("_")

    def name_scope(self):
        class _NS:
            def __enter__(s):
                return s

            def __exit__(s, *a):
                pass

        return _NS()

    # -- params ----------------------------------------------------------
    @property
    def params(self) -> ParameterDict:
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        ret = ParameterDict(self._params.prefix)
        pattern = re.compile(select) if select else None
        for p in self._iter_params():
            if pattern is None or pattern.match(p.name):
                ret._params[p.name] = p
        return ret

    def _iter_params(self):
        seen = set()
        for p in self._params.values():
            if id(p) not in seen:
                seen.add(id(p))
                yield p
        for c in self._children.values():
            for p in c._iter_params():
                if id(p) not in seen:
                    seen.add(id(p))
                    yield p

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init=init, ctx=ctx,
                                         force_reinit=force_reinit)

    def cast(self, dtype):
        for p in self._iter_params():
            p.cast(dtype)
        self._cast_hook(dtype)

    def _cast_hook(self, dtype):
        for c in self._children.values():
            c._cast_hook(dtype)

    # -- persistence ------------------------------------------------------
    def _collect_params_with_prefix(self, prefix=""):
        """Structural (attribute-path) parameter names, e.g.
        ``features.0.weight``: the names ``save_parameters`` writes."""
        if prefix:
            prefix += "."
        ret = {prefix + attr: p for attr, p in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def save_parameters(self, filename, deduplicate=False):
        """Write the initialized parameters to ``filename`` in the
        reference's ``.params`` container, keyed by structural name.
        ``deduplicate`` writes a parameter shared by several names once,
        under its first name."""
        from ..ndarray import save as nd_save

        params = self._collect_params_with_prefix()
        out, seen = {}, set()
        for k, p in params.items():
            if p._data is None or (deduplicate and id(p) in seen):
                continue
            seen.add(id(p))
            out[k] = p.data()
        nd_save(filename, out)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load ``filename`` (structural names; a file keyed by parameter
        names, the older format, is matched by those). A parameter shared
        by several names needs only one of them in the file. Missing
        parameters raise ``KeyError`` unless ``allow_missing``, extra
        ones unless ``ignore_extra``. Values are cast to each parameter's
        dtype, or, with ``cast_dtype`` and ``dtype_source="saved"``, the
        parameter takes the saved dtype. Uninitialized parameters land on
        ``ctx`` (default: the current context)."""
        from ..ndarray import load as nd_load

        loaded = nd_load(filename, ctx=ctx)
        mine = self._collect_params_with_prefix()
        if loaded and mine and not any(k in mine for k in loaded):
            mine = {p.name: p for p in self._iter_params()}
        names_of = {}
        for name, p in mine.items():
            names_of.setdefault(id(p), []).append(name)
        for name, param in mine.items():
            src = next((n for n in names_of[id(param)] if n in loaded),
                       None)
            if src is not None:
                param._load_init(loaded[src], ctx, cast_dtype=cast_dtype,
                                 dtype_source=dtype_source)
            elif not allow_missing:
                raise KeyError(f"Parameter {name} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(mine)
            if extra:
                raise KeyError(f"{filename} contains extra parameters "
                               f"{sorted(extra)}")

    # -- call ------------------------------------------------------------
    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def __call__(self, *args, **kwargs):
        for h in self._forward_pre_hooks:
            h(self, args)
        out = self.forward(*args, **kwargs)
        for h in self._forward_hooks:
            h(self, args, out)
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active=True, **kwargs):
        for c in self._children.values():
            c.hybridize(active, **kwargs)

    def summary(self, *inputs):
        out = self(*inputs)
        lines = [f"{'Layer':<40}{'Params':>12}"]
        total = 0
        for p in self._iter_params():
            n = int(np.prod(p.shape)) if p.shape else 0
            total += n
            lines.append(f"{p.name:<40}{n:>12}")
        lines.append(f"{'TOTAL':<40}{total:>12}")
        print("\n".join(lines))
        return out

    def __repr__(self):
        kids = "\n".join(f"  ({k}): {v.__class__.__name__}"
                         for k, v in self._children.items())
        return f"{self.__class__.__name__}(\n{kids}\n)"

    def apply(self, fn):
        for c in self._children.values():
            c.apply(fn)
        fn(self)
        return self


class HybridBlock(Block):
    """A Block whose forward can be cached per input signature."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        self._active = active
        self._flags = dict(static_alloc=static_alloc,
                           static_shape=static_shape, **kwargs)
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def infer_shape(self, *args):
        """Resolve deferred parameter shapes from input shapes. Built-in
        layers override; composite blocks resolve through their children
        during the forward."""

    def _direct_param_kwargs(self):
        return {attr: p.data() for attr, p in self._reg_params.items()}

    def forward(self, x, *args, **kwargs):
        from ..symbol.symbol import Symbol

        if isinstance(x, Symbol):
            return self._forward_symbolic(x, *args, **kwargs)
        self._ensure_init(x, *args)
        if self._active and not _IN_CACHED_OP.active:
            if any(p._data is None and p._deferred_init is not None
                   for p in self._iter_params()):
                # deferred shapes resolve on a first, eager call
                return self._forward_eager(x, *args, **kwargs)
            if self._cached_op is None:
                self._cached_op = CachedOp(self)
            return self._cached_op(x, *args)
        return self._forward_eager(x, *args, **kwargs)

    def _forward_symbolic(self, x, *args, **kwargs):
        from .. import symbol as sym_mod

        def as_var(p):
            # a fully known shape anchors the shape engine, so that
            # shape-reading forwards (b, s, u = x.shape) trace
            attrs = {"__aux__": True} if p.grad_req == "null" else {}
            shape = getattr(p, "shape", None)
            if shape and all(int(d) > 0 for d in shape):
                return sym_mod.Variable(p.name, shape=tuple(shape), **attrs)
            return sym_mod.Variable(p.name, **attrs)

        params = {attr: as_var(p) for attr, p in self._reg_params.items()}
        return self.hybrid_forward(sym_mod, x, *args, **params, **kwargs)

    def _forward_eager(self, x, *args, **kwargs):
        from .. import ndarray as nd_mod

        try:
            params = self._direct_param_kwargs()
        except DeferredInitializationError:
            self.infer_shape(x, *args)
            params = self._direct_param_kwargs()
        return self.hybrid_forward(nd_mod, x, *args, **params, **kwargs)

    def _ensure_init(self, *args):
        """Resolve this block's deferred parameter shapes from the
        inputs."""
        for p in self._reg_params.values():
            if p._data is None and p._deferred_init is not None:
                self.infer_shape(*args)
                break

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def lint(self, shapes=None, passes=None, **shape_kwargs):
        """Static-analyze this block before it runs.

        Runs the :class:`~mxnet_tpu_torch.analysis.TraceLinter` source
        checks (host syncs in forward bodies) and — when the block traces
        symbolically — the full :class:`~mxnet_tpu_torch.analysis.
        GraphLinter` over its graph with the given input shapes::

            report = net.lint(data=(2, 3, 32, 32))
            report.raise_if_errors()

        ``shapes`` maps input Variable names to shapes (one per positional
        forward input, in order). Blocks whose forward is not F-generic
        get an info-level ``not-symbolically-traceable`` finding and only
        the source checks.
        """
        from .. import symbol as sym_mod
        from ..analysis import (Finding, GraphLinter, Report, Severity,
                                TraceLinter)

        all_shapes = dict(shapes or {})
        all_shapes.update({k: tuple(v) for k, v in shape_kwargs.items()})
        report = Report(TraceLinter().scan_source(self))
        ins = [sym_mod.Variable(n, shape=s) for n, s in all_shapes.items()]
        try:
            out = self(*ins) if ins else self(sym_mod.Variable("data"))
            if isinstance(out, (list, tuple)):
                out = sym_mod.Group(list(out))
        except Exception as e:
            report.add(Finding(
                "not-symbolically-traceable", Severity.INFO,
                f"block does not trace symbolically ({type(e).__name__}: "
                f"{str(e)[:200]}); graph passes skipped",
                node=getattr(self, "name", None),
                fix_hint="make hybrid_forward F-generic (ops via F, "
                         "F.split over tensor indexing) to enable graph "
                         "lint"))
            return report
        param_names = {p.name for p in self._iter_params()}
        report.extend(GraphLinter(passes=passes, param_names=param_names)
                      .lint(out, shapes=all_shapes))
        return report

    def export(self, path, epoch=0, format="json", example_inputs=None):
        """Save for deployment: ``{path}-{epoch:04d}.params`` and
        ``{path}-symbol.json``, the reference's descriptor (format, class,
        the traced graph's JSON and the saved-name to variable-name map;
        a block that does not trace symbolically exports its parameters
        alone). ``format="onnx"`` also traces the block and writes
        ``{path}-{epoch:04d}.onnx`` through ``contrib.onnx.export_model``
        (``example_inputs`` fixes the input shapes; the graph must be in
        the exporter's op surface); ``"stablehlo"`` is the reference's JAX
        artifact and raises by design."""
        import json

        if format not in ("json", "onnx"):
            raise MXNetError(f"HybridBlock.export: format {format!r} is "
                             "not the port's (json, onnx)")
        if example_inputs is not None and \
                not isinstance(example_inputs, (list, tuple)):
            example_inputs = (example_inputs,)
        # validate before any file is written
        if format == "onnx":
            if example_inputs is None:
                raise ValueError("onnx export needs example_inputs")
            deferred = [p.name for p in self._iter_params()
                        if p._data is None]
            if deferred:
                raise ValueError(
                    f"cannot export: parameters {deferred} have deferred "
                    "shapes; run a forward pass before export")
        self.save_parameters(f"{path}-{epoch:04d}.params")
        meta = {"format": "mxnet_tpu-hybrid",
                "class": self.__class__.__name__}
        try:
            from .. import symbol as sym_mod

            n_inputs = len(example_inputs) if example_inputs is not None \
                else 1
            data_syms = [sym_mod.Variable(f"data{i}" if i else "data")
                         for i in range(n_inputs)]
            traced = self(*data_syms)
            if isinstance(traced, (list, tuple)):
                traced = sym_mod.Group(list(traced))
            meta["symbol"] = traced.tojson()
            meta["param_map"] = {
                saved: p.name for saved, p in
                self._collect_params_with_prefix().items()}
        except Exception:  # noqa: BLE001 — a non-F-generic forward
            pass
        if format == "onnx":
            from .. import symbol as sym_mod
            from ..contrib.onnx import export_model

            data_syms = [sym_mod.Variable(f"data{i}" if i else "data")
                         for i in range(len(example_inputs))]
            sym = self(*data_syms)
            if isinstance(sym, (list, tuple)):
                raise ValueError(
                    f"onnx export supports single-output blocks; this one "
                    f"returns {len(sym)} outputs — export a wrapper that "
                    "selects one")
            params = {p.name: p.data() for p in self._iter_params()}
            onnx_path = f"{path}-{epoch:04d}.onnx"
            export_model(sym, params,
                         [tuple(x.shape) for x in example_inputs],
                         onnx_file_path=onnx_path)
            meta["onnx"] = onnx_path
            meta["input_shapes"] = [list(x.shape) for x in example_inputs]
        from ..checkpoint.atomic import atomic_write_bytes

        atomic_write_bytes(f"{path}-symbol.json",
                           json.dumps(meta).encode("utf-8"))

    def optimize_for(self, *args, **kwargs):
        """As the reference's: hybridize. The graph passes apply to a
        Symbol (``Symbol.optimize_for``, ``subgraph.py``)."""
        self.hybridize(True)


class CachedOp:
    """The hybridized forward of a HybridBlock.

    Cache key: (train mode, parameter shapes and dtypes, input shapes and
    dtypes). Each entry holds an ``OpDef`` whose function takes
    (*parameter tensors, *input tensors), binds the tensors to the
    parameters, runs the block's eager forward and returns
    (*outputs, *aux updates): the parameters the forward rebound.

    Each call counts one program call for ``profiler.count_dispatches``;
    while the device plane captures, an entry's first call is counted by
    ``obs.device.capture`` (site ``cachedop``) into ``compile_log``.
    """

    def __init__(self, block: HybridBlock):
        self.block = block
        self._cache = {}
        self.compile_log: list = []

    def __call__(self, *inputs):
        flat_in, fmt = _flatten_nds(inputs)
        params = [p for p in self.block._iter_params()
                  if p._data is not None]
        train = autograd.is_training()
        key = (train,
               tuple((p.data().shape, str(p.data()._data.dtype))
                     for p in params),
               tuple((x.shape, str(x._data.dtype)) for x in flat_in))
        entry = self._cache.get(key)
        if entry is None:
            entry = self._build(params, fmt)
            self._cache[key] = entry
        from .. import obs, profiler

        if profiler.counting_dispatches():
            profiler.count_dispatch("compiled")
        args = [p.data() for p in params] + list(flat_in)
        if not entry["logged"] and obs.device.active():
            entry["logged"] = True
            result, cost = obs.device.capture(
                invoke, (entry["opdef"], args, {}), site="cachedop",
                label=self.block.name,
                arg_tensors=[a._data for a in args])
            self.compile_log.append({"block": self.block.name,
                                     "train": train, "avals": key[1:],
                                     **cost})
        else:
            result = invoke(entry["opdef"], args, {})
        if not isinstance(result, tuple):
            result = (result,)
        n_out = entry["n_flat"][0]
        outs, aux = result[:n_out], result[n_out:]
        for p_idx, a in zip(entry["aux_param_idx"], aux):
            with autograd.pause():
                params[p_idx].data()._set_data(a._data)
        restored = _unflatten_nds(iter(outs), entry["out_fmt"])
        return restored[0] if len(restored) == 1 else tuple(restored)

    def _build(self, params, in_fmt):
        block = self.block
        n_params = len(params)
        aux_param_idx: list = []
        out_fmt: list = []
        n_flat = [0]  # outputs flattened out of nested lists

        def fn(*vals):
            pvals, ivals = vals[:n_params], vals[n_params:]

            def forward():
                in_nds = _unflatten_nds(iter([NDArray(v) for v in ivals]),
                                        in_fmt)
                _IN_CACHED_OP.active = True
                try:
                    return block._forward_eager(*in_nds)
                finally:
                    _IN_CACHED_OP.active = False

            out, aux = run_bound(params, pvals, forward)
            outs = list(out) if isinstance(out, tuple) else [out]
            flat_out, fmt = _flatten_nds(outs)
            out_fmt[:] = fmt
            n_flat[0] = len(flat_out)
            aux_param_idx[:] = list(aux)
            return tuple([o._data for o in flat_out] + list(aux.values()))

        opdef = OpDef(f"CachedOp_{block.name}", fn,
                      num_outputs=lambda kw: n_flat[0] + len(aux_param_idx))
        return {"opdef": opdef, "aux_param_idx": aux_param_idx,
                "out_fmt": out_fmt, "n_flat": n_flat, "logged": False}


def run_bound(params, values, forward):
    """Run ``forward()`` with the tensors ``values`` bound to the arrays of
    ``params`` (a list of initialized ``Parameter``s), then restore the
    arrays' own tensors. Returns (``forward()``'s result, {index in
    ``params``: tensor} for each parameter the forward rebound: its aux
    state, such as BatchNorm's running statistics). A hybridized block's
    cached op and ``parallel.functionalize`` both run a block over given
    parameter values this way."""
    nds = [p.data() for p in params]
    saved = [a._data for a in nds]
    try:
        for a, v in zip(nds, values):
            a._data = v
        out = forward()
        aux = {i: a._data for i, (a, v) in enumerate(zip(nds, values))
               if a._data is not v}
        return out, aux
    finally:
        for a, old in zip(nds, saved):
            a._data = old


class SymbolBlock(HybridBlock):
    """Run a Symbol graph as a Gluon block (reference SymbolBlock): free
    graph variables that are not inputs become Parameters, so a
    ``symbol.json`` + ``.params`` pair reloads as a trainable,
    hybridizable block."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        if isinstance(outputs, (list, tuple)):
            if len(outputs) == 1:
                outputs = outputs[0]
            else:
                from ..symbol import Group

                outputs = Group(outputs)
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._outputs_sym = outputs
        self._input_names = [i.name if hasattr(i, "name") else str(i)
                             for i in inputs]
        self._arg_names = [n for n in outputs.list_arguments()
                           if n not in self._input_names]
        self._aux_names = outputs.list_auxiliary_states()
        for n in self._arg_names:
            self._reg_params[n] = self.params.get(
                n, shape=(0,), allow_deferred_init=True)
        for n in self._aux_names:
            self._reg_params[n] = self.params.get(
                n, shape=(0,), allow_deferred_init=True, grad_req="null")
        self._graph_fns = {}  # train flag -> _build_graph_fn's tuple

    def _direct_param_kwargs(self):
        return {}  # graph params are resolved by name in hybrid_forward

    def hybrid_forward(self, F, *args, **kwargs):
        from ..executor import _build_graph_fn
        from ..ndarray.ndarray import invoke_fn

        train = autograd.is_training()
        entry = self._graph_fns.get(train)
        if entry is None:
            entry = self._graph_fns[train] = _build_graph_fn(
                self._outputs_sym, train=train)
        arg_names, aux_names, fn, _has_aux = entry
        by_name = dict(zip(self._input_names, args))
        ins = []
        for n in arg_names:
            v = by_name[n] if n in by_name else self.params.get(n).data()
            ins.append(v if isinstance(v, NDArray) else NDArray(v))
        aux_nds = [self.params.get(n).data() for n in aux_names]
        n_args = len(ins)

        # through invoke_fn, so eager calls land on the autograd tape
        # (fine-tuning an imported checkpoint with record()/backward)
        def pure(*vals):
            outs, new_aux = fn(list(vals[:n_args]), list(vals[n_args:]))
            return tuple(outs) + tuple(new_aux)

        result = invoke_fn(pure, ins + aux_nds)
        result = result if isinstance(result, tuple) else (result,)
        n_out = len(result) - len(aux_names)
        outs, aux_new = result[:n_out], result[n_out:]
        with autograd.pause():
            for nd_, new in zip(aux_nds, aux_new):
                nd_._set_data(new._data)
        return outs[0] if len(outs) == 1 else tuple(outs)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """Load a ``-symbol.json`` (+ ``.params``) into a block; the
        parameters land on ``ctx`` (default: the current context)."""
        from ..symbol import Variable, load as sym_load

        sym = sym_load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        inputs = [Variable(n) for n in input_names]
        blk = SymbolBlock(sym, inputs)
        if param_file:
            from ..ndarray import load as nd_load

            loaded = nd_load(param_file, ctx=ctx)
            flat = {}
            for k, v in loaded.items():  # arg:/aux: checkpoint keys too
                flat[k.split(":", 1)[1] if ":" in k else k] = v
            for n, p in blk._reg_params.items():
                if n not in flat:
                    raise KeyError(f"parameter {n} missing in {param_file}")
                p._load_init(flat[n], ctx)
        return blk


def load_stablehlo(path):
    raise MXNetError("load_stablehlo: the reference's StableHLO artifact is "
                     "a JAX export format, which the port does not run; "
                     "export with format='json' and load with "
                     "SymbolBlock.imports")
