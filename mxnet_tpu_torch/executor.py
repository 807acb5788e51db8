"""Executor — a bound symbolic graph (counterpart of
``mxnet_tpu/executor.py``).

The whole graph evaluates as one function of (argument tensors, auxiliary
tensors) -> (outputs, new auxiliary tensors) that runs each node's
registered op function (``_build_graph_fn``), so a traced model reaches
the same kernels the imperative API reaches: an ``invoke_fn`` attention
node at the flash lengths launches the flash forward kernel, and its
gradient the flash backward kernel. BatchNorm's moving statistics thread
through as explicit auxiliary outputs, folded as the reference folds them
(momentum * moving + (1 - momentum) * batch statistic).

``forward(is_train=True)`` records the function on the ``torch.autograd``
tape (over its floating-point arguments, unless ``grad_req`` is ``null``)
and keeps the tape until the next forward: ``backward`` runs ``torch.autograd.grad``
on it, so a second ``backward`` after one forward gives the same
gradients, as the reference's recomputing backward does, and
``grad_req="add"`` accumulates them. Arrays live on the executor's
context, the card unless the caller names the CPU.

The host planes' hooks are the reference's: ``MXNET_CHAOS_NAN``
(``chaos/nan.py``) poisons a named argument of this forward only, before
the training forward's inputs are kept as ``_last_inputs`` for the
training-health plane's blame pass (``obs.health.blame_nonfinite``); the
first run of each signature of the forward and of the backward is
counted by ``obs.device.capture`` (site ``executor``) into
``compile_log``, and later runs carry the analytic MFU on their
``device.forward``/``device.backward`` spans; each counts one program
call for ``profiler.count_dispatches``. ``lint="warn"|"error"`` (default
``MXNET_GRAPH_LINT``, else off) runs the graph linter over the bound
shapes before anything is allocated: "error" rejects a bad graph with node
attribution, "warn" warns and goes on; the report is ``lint_report``.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import obs
from .base import MXNetError
from .context import Context, as_device, current_context
from .ndarray import NDArray
from .ndarray.ndarray import _x32
from .ops import get_op
from .ops.registry import call_op, coerce_kwargs

__all__ = ["Executor"]


def _build_graph_fn(sym, train: bool, device=None):
    """The DAG as ``fn(arg_vals, aux_vals) -> (outputs, new_aux)`` over
    tensors. Returns (arg_names, aux_names, fn, has_aux). Ops that create
    their output do so on ``device`` (default: the first argument's)."""
    nodes = sym._topo()
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    if sym._op == "_group":
        heads = [(s._base(), s._index) for s in sym._inputs]
    else:
        heads = [(sym._base(), sym._index)]

    def fn(arg_vals: List, aux_vals: List):
        env: Dict[int, object] = {}
        args = dict(zip(arg_names, arg_vals))
        auxs = dict(zip(aux_names, aux_vals))
        new_aux = dict(auxs)
        dev = device
        if dev is None and (arg_vals or aux_vals):
            dev = (list(arg_vals) + list(aux_vals))[0].device
        from . import autograd

        old_train = autograd.set_training(train)
        try:
            for node in nodes:
                if node._op is None:
                    env[id(node)] = args[node._name] if node._name in args \
                        else auxs[node._name]
                    continue
                if node._op == "_group":
                    continue
                # invoke_fn nodes carry their OpDef inline (symbol.invoke_fn)
                opdef = getattr(node, "_opdef", None) or get_op(node._op)
                kwargs = coerce_kwargs({k: v for k, v in node._attrs.items()
                                        if not k.startswith("__")})
                in_vals = []
                for i in node._inputs:
                    v = env[id(i._base())]
                    if i._index is not None and isinstance(v, tuple):
                        v = v[i._index]
                    in_vals.append(v)
                if node._op in _BN_OPS and train and \
                        not kwargs.get("use_global_stats", False):
                    kwargs["output_mean_var"] = True
                    out, bmean, bvar = call_op(opdef, in_vals, kwargs, dev)
                    mom = float(kwargs.get("momentum", 0.9))
                    # inputs 3, 4 are the moving_mean/moving_var variables
                    for slot, batch_stat in ((3, bmean), (4, bvar)):
                        vn = node._inputs[slot]._base()._name
                        if vn in new_aux:
                            new_aux[vn] = (mom * new_aux[vn] + (1 - mom)
                                           * batch_stat.detach())
                    env[id(node)] = out
                else:
                    out = call_op(opdef, in_vals, kwargs, dev)
                    env[id(node)] = tuple(out) if isinstance(out, list) \
                        else out
        finally:
            autograd.set_training(old_train)

        outs = []
        for base, index in heads:
            v = env[id(base)]
            if isinstance(v, tuple):
                if index is not None:
                    outs.append(v[index])
                else:
                    outs.extend(v)
            else:
                outs.append(v)
        return tuple(outs), tuple(new_aux[n] for n in aux_names)

    return arg_names, aux_names, fn, bool(aux_names)


def _tensor(v, device) -> torch.Tensor:
    """An NDArray, tensor or array-like as a tensor on ``device`` (64-bit
    types as 32-bit, as NDArray keeps them)."""
    if isinstance(v, NDArray):
        v = v._data
    if not isinstance(v, torch.Tensor):
        v = _x32(torch.from_numpy(np.array(np.asarray(v), copy=True)))
    return v.detach().to(device)


_BN_OPS = ("BatchNorm", "SyncBatchNorm", "_contrib_SyncBatchNorm",
           "sync_batch_norm")


class Executor:
    """Bound graph with argument, gradient and auxiliary arrays (reference
    Executor). ``grad_req`` is ``write``, ``add`` or ``null``."""

    def __init__(self, symbol, ctx=None, grad_req="write", shapes=None,
                 args=None, args_grad=None, aux_states=None, lint=None):
        self._symbol = symbol
        self._ctx = Context(ctx) if ctx is not None else current_context()
        self._device = as_device(self._ctx)
        self.outputs_nd: List[NDArray] = []
        self.lint_report = None

        # the pre-flight runs before any inference or allocation: "error"
        # rejects a bad graph with node attribution instead of a failure
        # deep inside a forward; "warn" reports and goes on
        if lint is None:
            import os

            lint = os.environ.get("MXNET_GRAPH_LINT", "off")
        if lint not in ("off", "warn", "error"):
            raise ValueError(f"lint must be 'off'|'warn'|'error', got "
                             f"{lint!r}")
        if lint != "off":
            known = {k: tuple(v) for k, v in (shapes or {}).items()}
            if not known and args is not None:
                named = args.items() if isinstance(args, dict) \
                    else zip(symbol.list_arguments(), args)
                known = {k: tuple(v.shape) if hasattr(v, "shape")
                         else np.shape(v) for k, v in named}
            from .analysis import GraphLinter

            self.lint_report = GraphLinter().lint(symbol, shapes=known)
            if lint == "error":
                self.lint_report.raise_if_errors()
            elif self.lint_report:
                import warnings

                warnings.warn("graph lint: " + self.lint_report.format(),
                              stacklevel=2)

        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        self._arg_names = arg_names
        self._aux_names = aux_names
        if grad_req not in ("write", "add", "null"):
            raise ValueError(f"grad_req {grad_req!r}: expected write, add "
                             "or null")
        self._grad_req = grad_req

        inferred: Dict[str, tuple] = {}
        if shapes:
            from .symbol.symbol import infer_shapes

            inferred, _outs = infer_shapes(symbol, {k: tuple(v) for k, v
                                                    in shapes.items()})
        self.arg_dict: Dict[str, NDArray] = {}
        if args is not None:
            named = args.items() if isinstance(args, dict) \
                else zip(arg_names, args)
            self.arg_dict = {k: v if isinstance(v, NDArray)
                             else NDArray(_tensor(v, self._device),
                                          ctx=self._ctx)
                             for k, v in named}
        elif shapes:
            for n in arg_names:
                if n not in inferred:
                    raise MXNetError(f"simple_bind: missing shape for arg "
                                     f"{n!r}")
                self.arg_dict[n] = self._zeros(inferred[n])
        self.aux_dict: Dict[str, NDArray] = {}
        if aux_states is not None:
            named = aux_states.items() if isinstance(aux_states, dict) \
                else zip(aux_names, aux_states)
            self.aux_dict = {k: v if isinstance(v, NDArray)
                             else NDArray(_tensor(v, self._device),
                                          ctx=self._ctx)
                             for k, v in named}
        else:
            for n in aux_names:
                shape = inferred.get(n)
                if shape is None and n in self.arg_dict:
                    shape = self.arg_dict[n].shape
                arr = self._zeros(shape or ())
                if n.endswith("var"):
                    arr._set_data(torch.ones_like(arr._data))
                self.aux_dict[n] = arr

        if isinstance(args_grad, dict):
            self.grad_dict = dict(args_grad)
        elif isinstance(args_grad, (list, tuple)):
            self.grad_dict = {n: g for n, g in zip(arg_names, args_grad)}
        else:
            self.grad_dict = {n: self._zeros(self.arg_dict[n].shape)
                              for n in arg_names
                              if n in self.arg_dict
                              and grad_req != "null"}
        self._fns: Dict[bool, tuple] = {}
        self._tape = None  # (argument names, leaves, outputs) of forward
        # the training forward's (argument, auxiliary tensors, train): the
        # blame pass replays them (obs.health.blame_nonfinite)
        self._last_inputs = None
        self.compile_log: List[dict] = []
        self._seen_sigs: set = set()
        self._sig_cost: Dict[tuple, dict] = {}

    def _zeros(self, shape) -> NDArray:
        return NDArray(torch.zeros(tuple(shape), dtype=torch.float32,
                                   device=self._device), ctx=self._ctx)

    # ------------------------------------------------------------------
    @property
    def outputs(self):
        return self.outputs_nd

    def copy_params_from(self, arg_params, aux_params=None):
        """Copy values in (the executor's arrays never alias the
        caller's)."""
        for k, v in (arg_params or {}).items():
            if k in self.arg_dict:
                self.arg_dict[k]._set_data(_tensor(v, self._device).clone())
        for k, v in (aux_params or {}).items():
            if k in self.aux_dict:
                self.aux_dict[k]._set_data(_tensor(v, self._device).clone())

    def _get_fn(self, train: bool):
        if train not in self._fns:
            self._fns[train] = _build_graph_fn(self._symbol, train,
                                               self._device)
        return self._fns[train]

    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k in self.arg_dict:
                self.arg_dict[k]._set_data(_tensor(v, self._device))
            elif k in self.aux_dict:
                self.aux_dict[k]._set_data(_tensor(v, self._device))
        self._tape = None  # frees the previous forward's graph
        self._last_inputs = None
        arg_names, aux_names, fn, _ = self._get_fn(bool(is_train))
        arg_vals = [self.arg_dict[n]._data.detach() for n in arg_names]
        aux_vals = [self.aux_dict[n]._data.detach() for n in aux_names]
        from .chaos import nan as _nan_chaos

        if _nan_chaos.enabled():
            # deterministic NaN injection (MXNET_CHAOS_NAN) before the
            # last-inputs capture, so the blame pass replays the poisoned
            # inputs exactly as this forward saw them
            arg_vals = _nan_chaos.poison(arg_names, arg_vals)
        train = bool(is_train) and self._grad_req != "null"
        if train:
            names = [n for n, v in zip(arg_names, arg_vals)
                     if n in self.grad_dict and v.is_floating_point()]
            leaf_of = {n: arg_vals[arg_names.index(n)].requires_grad_(True)
                       for n in names}
            arg_vals = [leaf_of.get(n, v) for n, v in zip(arg_names,
                                                         arg_vals)]

        def run():
            with torch.set_grad_enabled(train):
                return fn(arg_vals, aux_vals)

        outs, new_aux = self._run_counted("forward", bool(is_train), run,
                                          (arg_vals, aux_vals))
        if train:
            self._tape = (names, [leaf_of[n] for n in names], outs)
            self._last_inputs = (arg_vals, aux_vals, bool(is_train))
        for n, v in zip(aux_names, new_aux):
            self.aux_dict[n]._set_data(v.detach())
        self.outputs_nd = [NDArray(o.detach(), ctx=self._ctx) for o in outs]
        return self.outputs_nd

    def backward(self, out_grads=None):
        """Gradients of the last training forward's outputs (weighted by
        ``out_grads``, default ones) into ``grad_dict``: written, or added
        where ``grad_req`` is ``add``."""
        if self._tape is None:
            raise MXNetError("backward() requires forward(is_train=True) "
                             "and grad_req != 'null'")
        names, leaves, outs = self._tape
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            cots = [_tensor(g, self._device).to(o.dtype)
                    for g, o in zip(out_grads, outs)]
        live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        grads = [None] * len(leaves)
        if live and leaves:
            grads = self._run_counted(
                "backward", True,
                lambda: torch.autograd.grad([o for o, _ in live], leaves,
                                            [c for _, c in live],
                                            retain_graph=True,
                                            allow_unused=True),
                (leaves, cots))
        for n, leaf, g in zip(names, leaves, grads):
            if g is None:
                g = torch.zeros_like(leaf)
            if self._grad_req == "add":
                self.grad_dict[n]._set_data(self.grad_dict[n]._data + g)
            else:
                self.grad_dict[n]._set_data(g)
        return [self.grad_dict.get(n) for n in self._arg_names]

    def _run_counted(self, site, train, run, tensors):
        """``run()`` as one program call of ``site`` ("forward" or
        "backward"): counted for ``profiler.count_dispatches``, under a
        ``device.<site>`` span, and, while the device plane captures, its
        signature's first run counted into ``compile_log`` (the tensors it
        reads: ``tensors``); later runs get the analytic MFU."""
        from . import profiler

        if profiler.counting_dispatches():
            profiler.count_dispatch("compiled")
        rec = obs.enabled()
        t0 = time.monotonic() if rec else 0.0
        sig = None
        if obs.device.active():
            sig = (site, train, tuple((tuple(t.shape), str(t.dtype))
                                      for t in _flat(tensors)))
        first = sig is not None and sig not in self._seen_sigs
        with obs.trace.span(f"device.{site}", train=train,
                            compile=first) as sp:
            if first:
                self._seen_sigs.add(sig)
                out, cost = obs.device.capture(
                    run, (), site="executor", label=site,
                    device=self._device, arg_tensors=tensors)
                self._sig_cost[sig] = cost
                self.compile_log.append({"site": site, "train": train,
                                         "avals": sig[2], **cost})
            else:
                out = run()
            cost = self._sig_cost.get(sig) if rec and not first else None
            if cost:
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                obs.device.annotate_span(sp, site, time.monotonic() - t0,
                                         cost)
        return out

    def __repr__(self):
        return f"<Executor {self._symbol!r} args={len(self.arg_dict)}>"


def _flat(tree):
    out = []
    for x in tree:
        if isinstance(x, (list, tuple)):
            out.extend(_flat(x))
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out
