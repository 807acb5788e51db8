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
  runs (``cache_hit: False``, as ``serve/decode.py``'s engine does);
  ``warmup`` records every bucket and no traffic adds another, so
  ``num_programs <= len(buckets)`` per feature signature.
- **Hot reload**: ``reload`` (or ``prepare_reload`` + ``commit_reload``)
  validates the new parameter set against the serving shapes and dtypes,
  places it on the device, and swaps the whole set under a lock. A batch in
  flight keeps the :class:`_ParamSet` it started with, so a reply is
  computed entirely with the old parameters or entirely with the new.

Differences from the reference, each raising :class:`MXNetError` where it
applies: ``mesh=``, ``rules=`` and ``data_spec=`` (sharded serving) belong
to queue item A14; ``progcache_dir=`` and ``save_programs`` (persisted
programs), and the ``lint="error"`` pre-flight (``Symbol.lint``) to A15.
The default ``lint="warn"`` warns once that the pre-flight did not run
(``lint_report`` stays None). ``warmup`` runs its buckets one after the
other on the calling thread. The reference's obs spans and counters wait
for A15. ``ctx=`` places the engine (default: the current context, the
card unless a ``with mx.cpu():`` scope is open).
"""
from __future__ import annotations

import threading
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, dtype_name
from ..ndarray.serialization import host_array

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
        The pre-flight ``Symbol.lint`` is queue item A15: "error" raises,
        "warn" warns that it did not run, "off" runs nothing.
    pad_value : float
        Fill of the padding rows.
    ctx : Context or device, optional
        Where the parameters live and the batches run.
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

        for name, val in (("mesh", mesh), ("rules", rules),
                          ("data_spec", data_spec)):
            if val is not None:
                raise MXNetError(
                    f"InferenceEngine({name}=): sharded serving over a "
                    "device mesh is queue item A14 of the port")
        if progcache_dir is not None:
            raise MXNetError("InferenceEngine(progcache_dir=): persisted "
                             "programs are queue item A15 of the port")
        if lint not in ("off", "warn", "error"):
            raise ValueError(f"lint must be 'off'|'warn'|'error', got {lint!r}")
        self.lint_report = None
        if lint == "error":
            raise MXNetError("InferenceEngine(lint='error'): the Symbol.lint "
                             "pre-flight is queue item A15 of the port")
        if lint == "warn":
            warnings.warn("serve model-load lint did not run: Symbol.lint "
                          "is queue item A15 of the port", stacklevel=2)

        self.symbol = symbol
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

        self._lock = threading.Lock()
        self._staged: Optional[_ParamSet] = None  # prepared, not serving
        self._params = _ParamSet(
            0,
            tuple(_to_device(arg_params[n], self.device)
                  for n in self._param_names),
            tuple(_to_device(aux_params[n], self.device)
                  for n in self._aux_names))
        self._param_avals = tuple(_aval(v) for v in self._params.arg_vals)
        self._aux_avals = tuple(_aval(v) for v in self._params.aux_vals)

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
        self._stat_lock = threading.Lock()
        self.compile_log: List[dict] = []
        self._free_cache: Dict[tuple, tuple] = {}
        self.exec_count = 0
        self.cache_hits = 0

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

    def stats(self) -> dict:
        staged = self._staged
        with self._stat_lock:
            return {
                "version": self.version,
                "staged_version": (staged.version if staged is not None
                                   else None),
                "buckets": list(self.buckets),
                "num_programs": self.num_programs,
                "executions": self.exec_count,
                "programs": {repr(k): v for k, v in self._programs.items()},
                "compiles": len(self.compile_log),
                "cache_hits": self.cache_hits,
            }

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
        free_vals = self._free_vals(bucket, [tuple(a.shape) for a in arrays])
        snapshot = self._params  # atomic: old or new, never mixed

        arg_vals: List = [None] * self._n_args
        for slot, v in zip(self._param_slots, snapshot.arg_vals):
            arg_vals[slot] = v
        for slot, v in zip(self._free_slots, free_vals):
            arg_vals[slot] = v
        for slot, a in zip(self._data_slots, arrays):
            arg_vals[slot] = _tensor(a, self.device)
        with self._stat_lock:
            if sig not in self._programs:
                self._programs[sig] = 0
                self.compile_log.append({
                    "sig": sig, "bucket": bucket,
                    "param_avals": self._param_avals,
                    "version_at_compile": snapshot.version,
                    "cache_hit": False})
        with torch.no_grad():
            outs, _new_aux = self._fn(arg_vals, list(snapshot.aux_vals))
        # on the host (numpy, or CPU bfloat16): the batch's one wait
        host = [host_array(o) for o in outs]
        with self._stat_lock:
            self._programs[sig] += 1
            self.exec_count += 1
        return ([o[:n_valid] if o.ndim else o for o in host],
                snapshot.version)

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
        raise MXNetError("InferenceEngine.save_programs: persisted programs "
                         "are queue item A15 of the port")

    # ------------------------------------------------------------------
    # hot reload
    # ------------------------------------------------------------------
    def _validated_param_set(self, arg_params, aux_params):
        """Names, shapes and dtypes must match the serving set. Returns the
        device-resident ``(new_args, new_aux)``, built before any swap."""
        arg_params = dict(arg_params or {})
        aux_params = dict(aux_params or {})
        missing = [n for n in self._param_names if n not in arg_params]
        missing += [n for n in self._aux_names if n not in aux_params]
        if missing:
            raise ServeError(f"reload missing parameters: {missing}")
        new_args = tuple(_to_device(arg_params[n], self.device)
                         for n in self._param_names)
        new_aux = tuple(_to_device(aux_params[n], self.device)
                        for n in self._aux_names)
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

    def prepare_reload(self, arg_params, aux_params=None, *,
                       version: Optional[int] = None) -> int:
        """Phase one of a two-phase reload: validate and place the new
        generation now, and stage it without flipping; :meth:`commit_reload`
        is then a pointer swap. ``version`` pins the staged generation
        number (default current + 1). Returns the staged version."""
        new_args, new_aux = self._validated_param_set(arg_params, aux_params)
        with self._lock:
            v = int(version) if version is not None \
                else self._params.version + 1
            self._staged = _ParamSet(v, new_args, new_aux)
        return v

    def commit_reload(self) -> int:
        """Phase two: flip the staged generation live. Raises when nothing
        is staged. Returns the now-serving version."""
        with self._lock:
            if self._staged is None:
                raise ServeError("no prepared reload to commit")
            self._params, self._staged = self._staged, None
            return self._params.version

    def abort_reload(self) -> None:
        """Discard a staged generation (idempotent)."""
        with self._lock:
            self._staged = None

    def reload(self, arg_params, aux_params=None, *,
               version: Optional[int] = None) -> int:
        """Swap in a new parameter generation without dropping in-flight
        work (single-replica path); the staged slot is untouched. Returns
        the new version."""
        new_args, new_aux = self._validated_param_set(arg_params, aux_params)
        with self._lock:
            v = int(version) if version is not None \
                else self._params.version + 1
            self._params = _ParamSet(v, new_args, new_aux)
        return v
