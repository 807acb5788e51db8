"""Bucketed batch inference — the device half of ``mxnet_tpu_torch.serve``
(counterpart of ``mxnet_tpu/serve/engine.py``).

:class:`InferenceEngine` serves a trained symbolic graph. It evaluates the
graph through the ``Executor``'s own function (``executor._build_graph_fn``
with ``train=False``), so a traced model reaches the same registered ops
and kernels as ``Module.predict`` (a full-width TransformerLM's attention
launches the flash forward kernel):

- **Shape bucketing**: a request of ``n`` rows is padded with
  ``pad_value`` up to the smallest configured bucket >= n and the outputs
  are sliced back to ``n``. Rows are independent in inference mode, so the
  valid rows of a bucket-B result are bitwise what ``Module.predict``
  computes at batch B: the same ops on the same shapes pick the same
  cuBLAS and cuDNN algorithms (with ``cudnn.benchmark`` off, the default).
  A request larger than the top bucket is chunked through it.
- **Program accounting**: PyTorch runs eagerly, so a "program" is one
  ``(signature, bucket)``. ``compile_log`` records each the first time it
  runs, as ``serve/decode.py``'s engine does; ``warmup`` records every
  bucket and no traffic adds another, so ``num_programs <= len(buckets)``
  per feature signature.
- **Program cache** (``progcache``; ``progcache_dir=``, an artifact's
  shipped ``programs/``, or the process-global cache): a signature's
  ``progcache.program_key`` (site ``serve``, label ``bucket<B>``; statics
  the graph's JSON, the argument layout, the parameter avals, the pad
  value, the device type and, on a mesh, its axes, the parameters'
  specs and ``data_spec``) is looked up at its first run. A hit marks the
  entry and the span ``cache_hit``, adopts the stored cost record instead
  of a capture run and loads the kernels the program launched from their
  entries (no ``nvcc``); a miss runs as before and writes the program's
  record and its kernels' entries. The outputs are the same either way:
  the cache changes no op that runs. The peers of a sharded engine look
  the same keys up at their first run of a bucket, so they load their
  kernels from the cache the leader hits.
- **Hot reload**: ``reload`` (or ``prepare_reload`` + ``commit_reload``)
  validates the new parameter set against the serving shapes and dtypes,
  places it on the device, and swaps the whole set under a lock. A batch in
  flight keeps the :class:`_ParamSet` it started with, so a reply is
  computed entirely with the old parameters or entirely with the new.

- **Sharded serving** (``mesh=``, ``rules=``, ``data_spec=``): on a mesh
  of several ranks (``parallel/mesh.py``: one process each) the engine
  runs on every rank. The parameters are ``DTensor``s placed by the
  ``rules`` table (specs that do not fit the mesh prune to replicated),
  the batch is replicated or sharded over ``dp`` by ``data_spec``, and
  each bucket runs under ``mesh_scope(mesh)``, so model code finds the
  mesh; the collectives follow from the placements. Rank 0 of the mesh
  leads: the caller's engine. The other ranks follow it
  (``serve/group.py``): their constructor does not return, and every
  operation that touches the mesh is announced by the leader first. A
  bucket whose parameters and batch are all replicated touches no mesh:
  the leader computes it alone, as one process would. A reload keeps the
  placements. On a mesh of one rank the engine is the unsharded one.

The model-load pre-flight is the reference's: ``lint="warn"`` (the
default) runs ``Symbol.lint`` over the graph and warns on findings,
``"error"`` raises a node-attributed ``GraphAnalysisError`` on an error
finding, ``"off"`` runs nothing; the report is ``lint_report`` and its
wall seconds ``lint_seconds``.

Differences from the reference: ``warmup`` runs its
buckets one after the other on the calling thread. ``ctx=`` places an
engine without a mesh (default: the current context, the card unless a
``with mx.cpu():`` scope is open); a mesh places it on its rank's device.

Telemetry (``obs``): each batch runs in a ``serve.execute`` span and feeds
the ``serve.*`` counters and histograms; reloads are ``serve.reload``
events. A signature's first run is its program's "compile": with the
device plane active (``obs.device.active()``) that run is counted by
``obs.device.capture`` (operations, bytes, peak memory; the flash kernels
by their formulas) into its ``compile_log`` entry and the ``("serve",
"bucket<B>")`` cost record. The span closes after the outputs' host copy,
the batch's one wait on the device, and later runs of a signature carry
its MFU and roofline class over that wall time (host copy included: no
sync is added to time the device alone). On a mesh of several ranks the
record counts the leader's own ops, its shard of the work.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import copytrack, obs, tsan
from .. import progcache as _progcache
from ..base import MXNetError, dtype_name
from ..ndarray.serialization import host_array
from ..parallel.sharding import is_replicated
from .group import OP_ABORT, OP_COMMIT, OP_PREPARE, OP_RELOAD

__all__ = ["InferenceEngine", "ServeError", "RequestRejected",
           "DeadlineExceeded", "Draining", "default_buckets"]


class ServeError(MXNetError):
    """Base error of the serving subsystem."""


class RequestRejected(ServeError):
    """Load shed: the request was refused before execution (HTTP-429
    analog) — queue over watermark, or the server is not accepting."""


class DeadlineExceeded(ServeError):
    """The request's deadline expired before (or while) it could run; it
    was shed, not executed."""


class Draining(ServeError):
    """The endpoint is draining for shutdown and refuses new work."""


def _to_device(v, device) -> torch.Tensor:
    """An NDArray, tensor or array-like as a tensor of the engine's own on
    ``device`` (load-time and reload-time placement share this helper; the
    engine never aliases the caller's arrays)."""
    from ..executor import _tensor

    src = getattr(v, "_data", v)
    t = _tensor(v, device)
    if isinstance(src, torch.Tensor) and t.data_ptr() == src.data_ptr():
        t = t.clone()
    return t


def _sig_of(arrays) -> tuple:
    """The program signature of a (padded) batch — ``infer``'s accounting
    key and ``warmup``'s already-seen filter both derive through this one
    function."""
    return tuple((tuple(a.shape), str(a.dtype)) for a in arrays)


def _aval(t: torch.Tensor) -> tuple:
    return tuple(t.shape), dtype_name(t.dtype)


def _shape_of(v) -> tuple:
    s = getattr(v, "shape", None)
    if s is None:
        s = np.asarray(v).shape
    return tuple(int(d) for d in s)


def default_buckets(max_batch_size: int) -> List[int]:
    """Power-of-two batch buckets up to ``max_batch_size`` (which is always
    included, power of two or not): 32 → [1, 2, 4, 8, 16, 32]."""
    max_batch_size = int(max_batch_size)
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return out


class _ParamSet:
    """One immutable generation of device-resident parameters. Executions
    snapshot the reference once, so a concurrent reload can never hand a
    batch half-old half-new tensors."""

    __slots__ = ("version", "arg_vals", "aux_vals")

    def __init__(self, version: int, arg_vals: tuple, aux_vals: tuple):
        self.version = version
        self.arg_vals = arg_vals
        self.aux_vals = aux_vals


class InferenceEngine:
    """Serve a trained symbolic graph as bucketed batch inference.

    Parameters
    ----------
    symbol : Symbol
        The inference graph (a trained Module's symbol, a Gluon export's
        embedded trace, or a ``quantize_model`` int8 rewrite).
    arg_params / aux_params : dict[str, array]
        Trained parameters (NDArray, tensor or numpy). Graph arguments
        that are neither data nor parameters and whose names contain
        ``label`` (a training head's labels) are bound to float32 zeros per
        bucket; any other missing argument is refused.
    data_names : sequence of str
        Which graph arguments are request inputs, in request order.
    max_batch_size : int
        Largest bucket; requests bigger than this are chunked.
    buckets : sequence of int, optional
        Explicit batch buckets (sorted, deduped). Default:
        ``default_buckets(max_batch_size)``.
    lint : "off" | "warn" | "error"
        The model-load pre-flight ``Symbol.lint`` (its report is
        ``lint_report``): "error" raises on an error finding, "warn"
        warns on any finding, "off" runs nothing.
    pad_value : float
        Fill of the padding rows.
    mesh : parallel.Mesh, optional
        Shard the engine over a mesh (one replica group's slice,
        ``parallel.mesh_slices``): a mesh of several ranks spans its whole
        job, every rank builds the engine, and only rank 0 of the mesh
        returns from the constructor (see the module's docstring). Rank
        0's parameter values are the ones served.
    rules : parallel.ShardingRules, optional
        Parameter name -> PartitionSpec table (default: everything
        replicated); specs naming axes the mesh lacks, or not dividing a
        dimension, prune to replicated.
    data_spec : PartitionSpec, optional
        Spec of the request batches (default ``P("dp")``, pruned per
        bucket shape: a pure-``tp`` slice replicates the batch).
    progcache_dir : str, optional
        Directory of a persistent program cache for THIS engine
        (``progcache``), e.g. an artifact's shipped ``programs/``. Default:
        the process-global cache (``MXNET_PROGCACHE_DIR`` /
        ``MXNET_PROGCACHE=1``), or none.
    ctx : Context or device, optional
        Where the parameters live and the batches run, without a mesh.
    """

    def __init__(self, symbol, arg_params, aux_params=None, *,
                 data_names: Sequence[str] = ("data",),
                 max_batch_size: int = 32,
                 buckets: Optional[Sequence[int]] = None,
                 lint: str = "warn",
                 pad_value: float = 0.0,
                 mesh=None, rules=None, data_spec=None,
                 progcache_dir: Optional[str] = None,
                 ctx=None):
        from ..context import as_device, current_context
        from ..executor import _build_graph_fn

        if lint not in ("off", "warn", "error"):
            raise ValueError(f"lint must be 'off'|'warn'|'error', got {lint!r}")

        self.symbol = symbol
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.local_device
        else:
            self.device = (as_device(ctx) if ctx is not None
                           else current_context().torch_device())
        self._data_names = list(data_names)
        if buckets is None:
            buckets = default_buckets(max_batch_size)
        self.buckets: List[int] = sorted(set(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"invalid buckets {buckets!r}")
        self.max_batch_size = self.buckets[-1]
        self._pad_value = float(pad_value)

        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        missing_data = [n for n in self._data_names if n not in arg_names]
        if missing_data:
            raise ServeError(
                f"data_names {missing_data} are not arguments of the graph "
                f"(arguments: {arg_names})")
        self._param_names = [n for n in arg_names
                             if n not in self._data_names and n in arg_params]
        # only label-like training-head leftovers are zero-filled: a
        # missing weight would serve wrong predictions silently
        self._free_names = [n for n in arg_names
                            if n not in self._data_names
                            and n not in arg_params]
        not_label = [n for n in self._free_names if "label" not in n]
        if not_label:
            raise ServeError(
                f"graph arguments {not_label} are neither inputs nor in "
                "arg_params — a zero-filled weight would serve wrong "
                "predictions silently; fix the checkpoint/param_map, or "
                "list them in data_names if they are real inputs")
        self._aux_names = list(aux_names)
        missing_aux = [n for n in aux_names if n not in aux_params]
        if missing_aux:
            raise ServeError(
                f"aux states {missing_aux} missing from aux_params — an "
                "untrained BatchNorm served with default stats is a silent "
                "accuracy bug; export the full checkpoint")

        # pre-flight static analysis at model load, not at the first
        # request: "error" refuses a graph with an error finding
        self.lint_report = None
        self.lint_seconds = 0.0
        if lint != "off":
            t0 = time.perf_counter()
            self.lint_report = symbol.lint()
            self.lint_seconds = time.perf_counter() - t0
            if lint == "error":
                self.lint_report.raise_if_errors()
            elif self.lint_report:
                warnings.warn("serve model-load lint: "
                              + self.lint_report.format(), stacklevel=2)

        # the placement is resolved here, once: a reload lands with the
        # same shardings, and a bucket's batch placement is cached by shape
        self._data_spec = data_spec
        self._param_sh: Dict[str, object] = {}
        self._data_pl: Dict[tuple, tuple] = {}
        self._channel = None
        if mesh is not None:
            from ..parallel.sharding import ShardingRules

            rules = rules or ShardingRules()
            self._rules = rules
            for n in self._param_names:
                self._param_sh[n] = rules.sharding_for(
                    n, mesh, _shape_of(arg_params[n]))
            if mesh.distributed:
                from .group import Channel

                self._channel = Channel(mesh, self.device)
        self._replicated = all(is_replicated(sh.placements)
                               for sh in self._param_sh.values())

        self._lock = tsan.lock("serve.engine")
        self._staged: Optional[_ParamSet] = None  # prepared, not serving
        args = [_to_device(arg_params[n], self.device)
                for n in self._param_names]
        auxs = [_to_device(aux_params[n], self.device)
                for n in self._aux_names]
        if self._channel is not None:
            self._channel.share(args + auxs)  # rank 0's values everywhere
        self._param_avals = tuple(_aval(v) for v in args)
        self._aux_avals = tuple(_aval(v) for v in auxs)
        self._specs = [(tuple(v.shape), v.dtype) for v in args + auxs]
        self._params = self._param_set(0, args, auxs)

        # the Executor's own graph function: Module.predict at batch B and
        # this engine's bucket B run the same ops on the same shapes
        arg_order = {n: i for i, n in enumerate(arg_names)}
        _, _, self._fn, _ = _build_graph_fn(symbol, train=False,
                                            device=self.device)
        self._param_slots = [arg_order[n] for n in self._param_names]
        self._free_slots = [arg_order[n] for n in self._free_names]
        self._data_slots = [arg_order[n] for n in self._data_names]
        self._n_args = len(arg_names)

        self._programs: Dict[tuple, int] = {}   # sig -> execution count
        self._stat_lock = tsan.lock("serve.engine.stats")
        self.compile_log: List[dict] = []
        self._sig_cost: Dict[tuple, dict] = {}  # device-plane records
        self._free_cache: Dict[tuple, tuple] = {}
        self.exec_count = 0
        self.cache_hits = 0
        # the persistent program cache: an explicit dir (an artifact's
        # programs/) beats the process-global one
        self._progcache = (_progcache.ProgramCache(progcache_dir)
                           if progcache_dir else _progcache.cache())
        self._sig_key: Dict[tuple, object] = {}   # sig -> ProgramKey
        self._launched: Dict[tuple, set] = {}     # sig -> its kernels
        # computed once, here: the graph's JSON stays off the request path
        self._key_statics = self._compute_key_statics()
        if self._channel is not None and not self._channel.is_leader:
            from .group import PeerExit

            self._channel.follow(self)
            raise PeerExit(self)

    # ------------------------------------------------------------------
    # properties / stats
    # ------------------------------------------------------------------
    @property
    def version(self) -> int:
        """Monotonic parameter generation (bumped by :meth:`reload`)."""
        return self._params.version

    @property
    def num_programs(self) -> int:
        """Distinct (signature, bucket) programs run so far."""
        return len(self._programs)

    @property
    def data_names(self) -> List[str]:
        return list(self._data_names)

    def _compute_key_statics(self):
        """The serve programs' statics for ``progcache.program_key``: the
        graph's JSON, the argument layout, the parameter avals, the pad
        value, the device type and, on a mesh, its axes, each parameter's
        spec and the batch spec (a program of one placement never serves
        another)."""
        mesh_desc = None
        if self.mesh is not None:
            mesh_desc = (tuple(sorted(self.mesh.shape.items())),
                         self.mesh.size,
                         tuple((n, repr(self._param_sh[n].spec))
                               for n in self._param_names),
                         repr(self._data_spec))
        return (self.symbol.tojson().encode("utf-8"),
                tuple(self._data_names), tuple(self._param_names),
                tuple(self._aux_names), tuple(self._free_names),
                self._param_avals, self._aux_avals, self._pad_value,
                self.device.type, mesh_desc)

    def _program_key(self, sig, bucket: int):
        """One ``progcache.ProgramKey`` per signature: the derivation the
        cost registry and the cache's file names share."""
        pk = self._sig_key.get(sig)
        if pk is None:
            pk = _progcache.program_key("serve", f"bucket{bucket}",
                                        (self._key_statics, sig))
            self._sig_key[sig] = pk
        return pk

    def _cached_program(self, sig, bucket: int):
        """Look ``sig``'s program up in the engine's cache (a hit loads its
        kernels). Returns (key, Program or None); (None, None) without a
        cache."""
        if self._progcache is None:
            return None, None
        pk = self._program_key(sig, bucket)
        return pk, _progcache.load_program(self._progcache, pk, self.device)

    def stats(self) -> dict:
        staged = self._staged
        with self._stat_lock:
            out = {
                "version": self.version,
                "staged_version": (staged.version if staged is not None
                                   else None),
                "buckets": list(self.buckets),
                "num_programs": self.num_programs,
                "executions": self.exec_count,
                "programs": {repr(k): v for k, v in self._programs.items()},
                "compiles": len(self.compile_log),
                "cache_hits": self.cache_hits,
                "device": str(self.device),
            }
        if self._progcache is not None:
            out["progcache"] = dict(self._progcache.stats,
                                    dir=self._progcache.root)
        if self.mesh is not None:
            out["mesh"] = self.mesh.shape
            out["mesh_devices"] = self.mesh.size
            out["sharded_params"] = sum(
                1 for sh in self._param_sh.values()
                if any(ax is not None for ax in sh.spec))
        return out

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def _param_set(self, version: int, args, auxs) -> _ParamSet:
        """A generation from whole tensors on the device: on a mesh of
        several ranks each parameter that its rule shards becomes this
        rank's ``DTensor`` piece; replicated ones and aux states stay
        plain (replicated where they meet a ``DTensor``)."""
        if self._channel is not None:
            from ..parallel.sharding import shard_local

            args = [v if is_replicated(sh.placements)
                    else shard_local(v, self.mesh, sh.placements)
                    for v, sh in zip(args, (self._param_sh[n]
                                            for n in self._param_names))]
        return _ParamSet(version, tuple(args), tuple(auxs))

    def _data_placements(self, shape: tuple) -> tuple:
        """A batch array's placements: ``data_spec`` pruned against the
        mesh and this bucket's shape."""
        pl = self._data_pl.get(shape)
        if pl is None:
            from ..parallel.sharding import P, batch_sharding

            spec = self._data_spec if self._data_spec is not None \
                else P("dp")
            pl = self._data_pl[shape] = batch_sharding(
                self.mesh, spec, shape).placements
        return pl

    def _on_mesh(self, shapes) -> bool:
        """Whether a bucket of these batch shapes touches the mesh: some
        parameter or the batch is sharded. A replicated bucket is one
        process's computation, which the leader runs alone."""
        return self._channel is not None and not (
            self._replicated and all(is_replicated(self._data_placements(s))
                                     for s in shapes))

    def _lead(self, op: int, ints=(), arrays=()):
        """On a mesh of several ranks: announce ``op`` to the peers and
        hold the group for the block (``serve/group.py``)."""
        if self._channel is None:
            return contextlib.nullcontext()
        return self._channel.lead(op, ints, arrays)

    def _scope(self, on_mesh: bool):
        """The mesh scope of a bucket; on the mesh, plain tensors beside
        ``DTensor``s count as replicated."""
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            from ..parallel.mesh import mesh_scope

            stack.enter_context(mesh_scope(self.mesh))
        if on_mesh:
            from torch.distributed.tensor.experimental import \
                implicit_replication

            stack.enter_context(implicit_replication())
        return stack

    # ------------------------------------------------------------------
    # bucketing
    # ------------------------------------------------------------------
    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest bucket >= n, or None when n exceeds the largest (the
        caller chunks)."""
        for b in self.buckets:
            if b >= n:
                return b
        return None

    def _free_vals(self, batch: int, data_shapes) -> tuple:
        """Zero tensors for non-data, non-param graph arguments (labels),
        shaped by shape inference at this bucket. Cached per signature."""
        key = (batch, tuple(data_shapes))
        vals = self._free_cache.get(key)
        if vals is None:
            if self._free_names:
                from ..symbol.symbol import infer_shapes

                shapes = dict(zip(self._data_names, data_shapes))
                inferred, _ = infer_shapes(self.symbol, shapes)
                missing = [n for n in self._free_names if n not in inferred]
                if missing:
                    raise ServeError(
                        f"cannot infer shapes for unbound arguments "
                        f"{missing}; pass them as arg_params or data_names")
                vals = tuple(torch.zeros(inferred[n], dtype=torch.float32,
                                         device=self.device)
                             for n in self._free_names)
            else:
                vals = ()
            self._free_cache[key] = vals
        return vals

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _forward(self, tensors, snapshot: _ParamSet, bucket: int,
                 on_mesh: bool) -> list:
        """One bucket's outputs, whole, from its padded batch (tensors on
        the device, every rank's whole batch when ``on_mesh``)."""
        shapes = [tuple(t.shape) for t in tensors]
        arg_vals: List = [None] * self._n_args
        for slot, v in zip(self._param_slots, snapshot.arg_vals):
            arg_vals[slot] = v
        for slot, v in zip(self._free_slots, self._free_vals(bucket, shapes)):
            arg_vals[slot] = v
        if on_mesh:
            from ..parallel.sharding import shard_local

            tensors = [shard_local(t, self.mesh, self._data_placements(s))
                       for t, s in zip(tensors, shapes)]
        for slot, t in zip(self._data_slots, tensors):
            arg_vals[slot] = t
        with torch.no_grad(), self._scope(on_mesh):
            outs, _new_aux = self._fn(arg_vals, list(snapshot.aux_vals))
            if on_mesh:  # every rank takes part in the gather
                outs = [o.full_tensor() if hasattr(o, "full_tensor") else o
                        for o in outs]
        return list(outs)

    def infer(self, inputs, n_valid: Optional[int] = None
              ) -> Tuple[list, int]:
        """Run one (possibly padded) batch. ``inputs``: one array per data
        name, equal leading dim. Returns ``(outputs, param_version)`` with
        outputs on the host, sliced back to ``n_valid`` rows.

        Batches larger than the top bucket are chunked (each chunk runs a
        bucket); the version is the first chunk's — the chunks of one
        oversized request may straddle a reload.
        """
        from ..executor import _tensor
        from .group import OP_FORWARD

        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        if len(inputs) != len(self._data_names):
            raise ServeError(
                f"expected {len(self._data_names)} input(s) "
                f"({self._data_names}), got {len(inputs)}")
        arrays = [np.ascontiguousarray(np.asarray(x)) for x in inputs]
        n = int(arrays[0].shape[0]) if arrays[0].ndim else 1
        for a in arrays[1:]:
            if int(a.shape[0]) != n:
                raise ServeError("inputs disagree on batch dimension: "
                                 f"{[x.shape for x in arrays]}")
        if n == 0:
            raise ServeError("empty request (0 rows)")
        if n_valid is None:
            n_valid = n
        bucket = self.bucket_for(n)
        if bucket is None:
            top = self.max_batch_size
            pieces: List[list] = []
            version = None
            for lo in range(0, n, top):
                outs, v = self.infer([a[lo:lo + top] for a in arrays])
                version = v if version is None else version
                pieces.append(outs)
            merged = [np.concatenate([p[i] for p in pieces], axis=0)
                      for i in range(len(pieces[0]))]
            return [m[:n_valid] for m in merged], version

        pad = bucket - n
        if pad:
            arrays = [np.concatenate(
                [a, np.full((pad,) + a.shape[1:], self._pad_value, a.dtype)],
                axis=0) for a in arrays]
        sig = _sig_of(arrays)
        rec = obs.enabled()
        t0 = time.monotonic() if rec else 0.0
        tensors = [_tensor(a, self.device) for a in arrays]
        on_mesh = self._on_mesh([tuple(a.shape) for a in arrays])
        # the span's attrs are read before the announcement; the
        # compile_log entry is decided under the lock inside it
        # the span's attrs are set before the announcement; a first run's
        # cache_hit is added once the lookup has answered
        with obs.trace.span("serve.execute", bucket=bucket, rows=n_valid,
                            compile=sig not in self._programs,
                            cache_hit=False,
                            version=self._params.version) as sp:
            with (self._lead(OP_FORWARD, [bucket], tensors) if on_mesh
                  else contextlib.nullcontext()):
                # taken inside the announcement: the peers serve the same
                snapshot = self._params  # atomic: old or new, never mixed
                entry = None
                with self._stat_lock:
                    if sig not in self._programs:
                        self._programs[sig] = 0
                        entry = {"sig": sig, "bucket": bucket,
                                 "param_avals": self._param_avals,
                                 "version_at_compile": snapshot.version,
                                 "cache_hit": False}
                        self.compile_log.append(entry)
                if entry is not None:
                    outs = self._first_run(entry, sp, sig, bucket, tensors,
                                           snapshot, on_mesh)
                else:
                    outs = self._forward(tensors, snapshot, bucket, on_mesh)
            # on the host (numpy, or CPU bfloat16): the batch's one wait,
            # the accounted device-to-host hop of a card batch
            if any(isinstance(o, torch.Tensor) and o.is_cuda for o in outs):
                copytrack.TRACKER.host_sync("serve.engine.host_array")
            host = [host_array(o) for o in outs]  # lint: disable=host-sync-on-hot-path
            cost = self._sig_cost.get(sig) if rec and entry is None \
                else None
            if cost:  # after the wait: the span's wall covers the work
                obs.device.annotate_span(sp, "serve.execute",
                                         time.monotonic() - t0, cost)
        if rec:
            dt = time.monotonic() - t0
            if entry is not None and not entry["cache_hit"]:
                obs.inc("serve.compile")
                obs.observe("serve.compile_seconds", dt)
            elif entry is not None:
                # a cache hit is no fresh first run: counted apart, and
                # its time (the record's read included) stays out of the
                # steady-state execute histogram
                obs.inc("serve.cache_hit")
                obs.observe("serve.deserialize_seconds", dt)
            else:
                obs.observe("serve.execute_seconds", dt)
            obs.inc("serve.rows_executed", n_valid)
            obs.inc("serve.rows_padding", bucket - n_valid)
            obs.device.sample()  # the live-memory counter lane, per batch
        with self._stat_lock:
            self._programs[sig] += 1
            self.exec_count += 1
        return ([o[:n_valid] if o.ndim else o for o in host],
                snapshot.version)

    def _first_run(self, entry, sp, sig, bucket, tensors, snapshot,
                   on_mesh) -> list:
        """A signature's first run: a cache hit adopts the stored cost and
        runs; otherwise the run is counted (device plane active) and, with
        a cache, recorded with the kernels it launched and written."""
        from ..ops import _kernels

        pk, hit = self._cached_program(sig, bucket)
        if pk is not None:
            entry["program_key"] = pk.digest
        if hit is not None:
            self._launched[sig] = set(hit.kernels)
            entry["cache_hit"] = True
            if isinstance(sp, obs.trace._Span):
                sp.attrs["cache_hit"] = True
            cost = obs.device.adopt_cached_cost(pk, hit.cost)
            if cost:
                entry.update(cost)
                self._sig_cost[sig] = cost
            with self._stat_lock:
                self.cache_hits += 1
            return self._forward(tensors, snapshot, bucket, on_mesh)
        cost = None
        with _kernels.recording() as launched:
            if obs.device.active():
                # the signature's first run, counted: its cost record
                # goes into the compile_log entry
                outs, cost = obs.device.capture(
                    self._forward, (tensors, snapshot, bucket, on_mesh),
                    site="serve", label=f"bucket{bucket}",
                    device=self.device, key=pk,
                    arg_tensors=(tensors, snapshot.arg_vals,
                                 snapshot.aux_vals))
                entry.update(cost)
                self._sig_cost[sig] = cost
            else:
                outs = self._forward(tensors, snapshot, bucket, on_mesh)
        self._launched[sig] = launched
        if pk is not None:
            _progcache.store_program(self._progcache, pk, cost, launched,
                                     self.device, meta={"bucket": bucket})
        return outs

    def predict(self, *inputs):
        """Single-call inference: arrays in, host arrays out (one, or a
        list when the graph has several outputs)."""
        outs, _version = self.infer(list(inputs))
        return outs[0] if len(outs) == 1 else outs

    def warmup(self, *feature_shapes, dtype=np.float32,
               concurrency: Optional[int] = None) -> int:
        """Run every bucket once for the given per-row feature shape(s)
        (one tuple per data input), one bucket after the other; servers
        call this before flipping readiness. Returns the number of programs
        run for the first time. ``concurrency`` is accepted for the
        reference's signature: eager buckets gain nothing from a pool."""
        shapes = list(feature_shapes) or [()]
        if len(shapes) != len(self._data_names):
            raise ServeError(
                f"warmup needs one feature shape per data input "
                f"({len(self._data_names)}), got {len(shapes)}")
        before = self.num_programs
        for b in self.buckets:
            batch = [np.zeros((b,) + tuple(s), dtype) for s in shapes]
            if _sig_of(batch) not in self._programs:
                self.infer(batch)
        return self.num_programs - before

    def save_programs(self, directory: str, keep: Optional[int] = None,
                      durable: bool = True) -> int:
        """Export every program this engine has run into ``directory`` as
        a program-cache payload (the artifact ``programs/`` convention
        ``serve.load`` discovers; ``serve.ship_programs`` wraps this), with
        the entries of the kernels they launched: from the engine's cache,
        or, where they were built with no cache armed, packed from the
        build directory. Returns the number of program entries written."""
        pc = _progcache.ProgramCache(directory, keep=keep or 0,
                                     durable=durable)
        written = 0
        for e in list(self.compile_log):
            sig, bucket = e["sig"], e["bucket"]
            written += _progcache.store_program(
                pc, self._program_key(sig, bucket), self._sig_cost.get(sig),
                self._launched.get(sig, ()), self.device,
                meta={"bucket": bucket})
        return written

    def close(self) -> None:
        """Stop the peers of a sharded engine (the leader's call; their
        constructors raise ``PeerExit``). Idempotent; no-op elsewhere."""
        from . import group

        ch = self._channel
        if ch is None or not ch.is_leader or ch.broken:
            return
        group.stopping()
        with ch.lead(group.OP_STOP):
            ch.broken = "stopped"

    # ------------------------------------------------------------------
    # a peer's side of the announced operations
    # ------------------------------------------------------------------
    def _follow_op(self, op: int, ints, arrays) -> None:
        from . import group

        if op == group.OP_FORWARD:
            # the leader's first run of a bucket looked its program up:
            # look up the same key, so a hit loads the same kernels here
            sig = tuple((tuple(t.shape), dtype_name(t.dtype))
                        for t in arrays)
            if sig not in self._programs:
                self._programs[sig] = 0
                self._cached_program(sig, ints[0])
            self._forward(arrays, self._params, ints[0], True)
        elif op in (group.OP_PREPARE, group.OP_RELOAD):
            vals = [torch.empty(s, dtype=d, device=self.device)
                    for s, d in self._specs]
            self._channel.share(vals)
            k = len(self._param_names)
            new = self._param_set(ints[0], vals[:k], vals[k:])
            with self._lock:
                if op == group.OP_PREPARE:
                    self._staged = new
                else:
                    self._params = new
        elif op == group.OP_COMMIT:
            self._commit()
        elif op == group.OP_ABORT:
            with self._lock:
                self._staged = None
        else:
            raise ServeError(f"unknown group operation {op}")

    # ------------------------------------------------------------------
    # hot reload
    # ------------------------------------------------------------------
    def _validated_param_set(self, arg_params, aux_params):
        """Names, shapes and dtypes must match the serving set. Returns the
        whole ``(new_args, new_aux)`` tensors on the device, built before
        any swap."""
        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})
        missing = [n for n in self._param_names if n not in arg_params]
        missing += [n for n in self._aux_names if n not in aux_params]
        if missing:
            raise ServeError(f"reload missing parameters: {missing}")
        new_args = [_to_device(arg_params[n], self.device)
                    for n in self._param_names]
        new_aux = [_to_device(aux_params[n], self.device)
                   for n in self._aux_names]
        for names, vals, avals in (
                (self._param_names, new_args, self._param_avals),
                (self._aux_names, new_aux, self._aux_avals)):
            for name, v, want in zip(names, vals, avals):
                got = _aval(v)
                if got != want:
                    raise ServeError(
                        f"reload aval mismatch for {name!r}: serving "
                        f"{want}, new checkpoint {got} — this would change "
                        "every bucket's shapes; deploy a new engine for a "
                        "changed architecture")
        return new_args, new_aux

    def _install(self, op: int, arg_params, aux_params, version) -> int:
        """Validate, announce, share and place a new generation; stage it
        (OP_PREPARE) or serve it (OP_RELOAD). Returns its version."""
        new_args, new_aux = self._validated_param_set(arg_params, aux_params)
        with self._lock:
            v = int(version) if version is not None \
                else self._params.version + 1
        with self._lead(op, [v]):
            if self._channel is not None:
                self._channel.share(new_args + new_aux)
            new = self._param_set(v, new_args, new_aux)
            with self._lock:
                if op == OP_PREPARE:
                    self._staged = new
                else:
                    self._params = new
        return v

    def prepare_reload(self, arg_params, aux_params=None, *,
                       version: Optional[int] = None) -> int:
        """Phase one of a two-phase reload: validate and place the new
        generation now, and stage it without flipping; :meth:`commit_reload`
        is then a pointer swap. ``version`` pins the staged generation
        number (default current + 1). Returns the staged version."""
        v = self._install(OP_PREPARE, arg_params, aux_params, version)
        obs.event("serve.reload_prepared", version=v)
        return v

    def _commit(self) -> int:
        with self._lock:
            if self._staged is None:
                raise ServeError("no prepared reload to commit")
            self._params, self._staged = self._staged, None
            return self._params.version

    def commit_reload(self) -> int:
        """Phase two: flip the staged generation live. Raises when nothing
        is staged. Returns the now-serving version."""
        if self._staged is None:
            raise ServeError("no prepared reload to commit")
        with self._lead(OP_COMMIT):
            version = self._commit()
        obs.inc("serve.reloads")
        obs.event("serve.reload", version=version)
        return version

    def abort_reload(self) -> None:
        """Discard a staged generation (idempotent)."""
        with self._lead(OP_ABORT):
            with self._lock:
                self._staged = None

    def reload(self, arg_params, aux_params=None, *,
               version: Optional[int] = None) -> int:
        """Swap in a new parameter generation without dropping in-flight
        work (single-replica path); the staged slot is untouched. Returns
        the new version."""
        v = self._install(OP_RELOAD, arg_params, aux_params, version)
        obs.inc("serve.reloads")
        obs.event("serve.reload", version=v)
        return v
