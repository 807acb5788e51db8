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

The symbolic side waits for the symbolic API (queue item A10):
``SymbolBlock``, ``export``, ``optimize_for`` and ``load_stablehlo``
raise, and so does calling a block on anything but arrays; ``lint``
waits for the analysis plane (A15).
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

_SYMBOLIC = ("the symbolic API (Symbol, SymbolBlock, export; queue item "
             "A10) is not ported yet")


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
        raise MXNetError("Block.save_parameters: the reference's .params "
                         "file format (queue item A10) is not ported yet")

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        raise MXNetError("Block.load_parameters: the reference's .params "
                         "file format (queue item A10) is not ported yet")

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
        if not isinstance(x, NDArray):
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
        raise MXNetError(f"HybridBlock._forward_symbolic: {_SYMBOLIC}")

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
        raise MXNetError("HybridBlock.lint: the analysis plane (queue item "
                         "A15) is not ported yet")

    def export(self, path, epoch=0, format="json", example_inputs=None):
        raise MXNetError(f"HybridBlock.export: {_SYMBOLIC}")

    def optimize_for(self, *args, **kwargs):
        raise MXNetError(f"HybridBlock.optimize_for: {_SYMBOLIC}")


class CachedOp:
    """The hybridized forward of a HybridBlock.

    Cache key: (train mode, parameter shapes and dtypes, input shapes and
    dtypes). Each entry holds an ``OpDef`` whose function takes
    (*parameter tensors, *input tensors), binds the tensors to the
    parameters, runs the block's eager forward and returns
    (*outputs, *aux updates): the parameters the forward rebound.
    """

    def __init__(self, block: HybridBlock):
        self.block = block
        self._cache = {}

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
        result = invoke(entry["opdef"], [p.data() for p in params]
                        + list(flat_in), {})
        if not isinstance(result, tuple):
            result = (result,)
        n_out = len(entry["out_fmt"])
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
            aux_param_idx[:] = list(aux)
            return tuple([o._data for o in flat_out] + list(aux.values()))

        opdef = OpDef(f"CachedOp_{block.name}", fn,
                      num_outputs=lambda kw: len(out_fmt)
                      + len(aux_param_idx))
        return {"opdef": opdef, "aux_param_idx": aux_param_idx,
                "out_fmt": out_fmt}


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
    """Runs a Symbol graph as a block: waits for the symbolic API."""

    def __init__(self, outputs=None, inputs=None, params=None):
        raise MXNetError(f"SymbolBlock: {_SYMBOLIC}")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        raise MXNetError(f"SymbolBlock.imports: {_SYMBOLIC}")


def load_stablehlo(path):
    raise MXNetError("load_stablehlo: the reference's StableHLO artifact is "
                     "a JAX export format; the port's deployment format "
                     f"waits for {_SYMBOLIC}")
