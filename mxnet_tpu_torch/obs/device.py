"""Device-plane observability — cost and memory accounting of the card,
MFU/roofline attribution and live device-memory telemetry (counterpart of
``mxnet_tpu/obs/device.py``).

The reference reads each compiled program's cost from XLA
(``compiled.cost_analysis()``/``memory_analysis()``). PyTorch runs eagerly:
there is no compiled program to ask. The port counts the program instead,
on the first run of each signature (the engines' ``compile_log`` sites):

- **Cost accounting** (:func:`capture`): the call runs once under a
  ``TorchDispatchMode`` that counts

  - operations with the formulas of ``torch.utils.flop_counter``
    (``FlopCounterMode``'s registry: matmuls, convolutions, attention);
    with ``pointwise=True`` (the update engine's site, whose work is all
    element-wise) also one operation per element each other arithmetic
    op produces;
  - bytes as each dispatched op's input and output bytes: the *eager*
    program's traffic, op by op, not a fused program's. Views move
    nothing and count nothing; an indexed read or write (``index``,
    ``index_put_``, ``embedding``, ...) counts the elements it moves, not
    the whole tensor it indexes;
  - the peak memory: ``torch.cuda.max_memory_allocated`` around the call
    on the card; on the CPU the largest sum of the bytes of the
    intermediates alive at once, as the mode sees them allocated and
    freed.

  The port's own kernels launch through CPython entry points
  (``csrc/pyentry.cuh``) that dispatch never sees. Each wrapper in
  ``ops/flash_attention.py`` therefore reports its call into the active
  capture (:func:`capturing`, :meth:`Capture.add_kernel`) by its
  analytic formula, the one ``chip_smoke.py``'s bounds use, whichever
  implementation ran, and hides the ops of its body and of the formula's
  own reads (:meth:`Capture.hidden`) from the counting.
  A cost record is so the same on the CPU and on the card (but for
  ``temp_bytes``/``peak_hbm_bytes``, which are each allocator's own). Its
  ``kernels`` entry gives each kernel's share: calls, flops and bytes.
- **Records** keep the reference's field order (:data:`COST_FIELDS`) and
  schema: the (site, label) registry (:func:`record`, :func:`cost_of`,
  :func:`costs`), the ``device.*`` metrics and the ``device.compile``
  instant event. After the reference's fields come ``device`` (cpu or
  cuda), ``dtype`` (the dtype that carried most of the operations) and
  ``kernels``.
- **MFU/roofline attribution** (:func:`attribute`, :func:`roofline_class`,
  :func:`annotate_span`): as the reference's. :func:`get_peak` returns the
  data-sheet peaks of the card that ``torch.cuda.get_device_name`` names
  (the H100 SXM: 989 TFLOP/s dense bf16/f16, 67 TFLOP/s f32 outside the
  tensor cores, which is what an f32 program gets with TF32 off, and
  3.35 TB/s of HBM3); the f32 figure applies to a record whose ``dtype``
  is float32. ``set_peak`` and the env overrides win, as in the
  reference.
- **Live memory** (:func:`sample`, :func:`live_bytes`): the
  ``device.live_bytes`` gauge and counter lane are
  ``torch.cuda.memory_allocated`` summed over the cards; a process with
  no card has no device memory and reports 0. :class:`LeakDetector` as
  the reference's.

Activation as the reference's: capture runs while telemetry is enabled or
``MXNET_DEVICE_COST=1`` forces it; ``MXNET_DEVICE_COST=0`` vetoes it.
Program identity is the program cache's (``progcache.program_key``): a
capture given ``key=`` files under the key's (site, label) and its record
carries the key's digest as ``program_key``, and on a cache hit
:func:`adopt_cached_cost` files the stored record instead of a capture
run. The reference's ``analyze_compiled`` (XLA's analyses of a compiled
executable) has no counterpart: there is no compiled executable to ask.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Dict, Optional, Tuple

from . import metrics as _metrics
from . import trace as _trace

__all__ = ["active", "capture", "capturing", "Capture", "record", "cost_of",
           "costs", "adopt_cached_cost", "attribute", "annotate_span",
           "roofline_class",
           "set_peak", "get_peak", "card_peaks", "live_bytes", "sample",
           "LeakDetector", "monitor", "reset", "COST_FIELDS"]

# ---------------------------------------------------------------------------
# activation
# ---------------------------------------------------------------------------


def active() -> bool:
    """Should first-run sites capture device cost? ``MXNET_DEVICE_COST``
    forces (1) or vetoes (0); default follows the one obs flag."""
    env = os.environ.get("MXNET_DEVICE_COST", "").lower()
    if env in ("1", "true", "yes", "on"):
        return True
    if env in ("0", "false", "no", "off"):
        return False
    return _trace._ENABLED


# ---------------------------------------------------------------------------
# peaks (the MFU denominator and the roofline ceiling)
# ---------------------------------------------------------------------------

# data-sheet peaks by card name: (name fragment, dense bf16/f16 TFLOP/s,
# f32 TFLOP/s outside the tensor cores, memory GB/s); first match wins
_CARD_PEAKS = (
    ("H100 80GB HBM3", 989.0, 67.0, 3350.0),   # the H100 SXM5's name
    ("H100 SXM", 989.0, 67.0, 3350.0),
)
# placeholders for backends the table cannot name (the reference's): the
# attribution stays internally consistent, not absolute
_DEFAULT_PEAKS = {"gpu": (312.0, 1555.0), "cpu": (0.2, 20.0)}
_peak_override: list = [None, None]        # [tflops, gbps]

_F32 = ("float32", "torch.float32")


def set_peak(tflops: Optional[float] = None, gbps: Optional[float] = None):
    """Pin the peak compute rate (TFLOP/s) and/or memory bandwidth (GB/s)
    used by MFU/roofline math."""
    if tflops is not None:
        _peak_override[0] = float(tflops)
    if gbps is not None:
        _peak_override[1] = float(gbps)


def card_peaks(name: str) -> Optional[Tuple[float, float, float]]:
    """``(bf16 TFLOP/s, f32 TFLOP/s, GB/s)`` of the card called ``name``
    (``torch.cuda.get_device_name``), or None when the table lacks it."""
    for frag, tc, f32, gbps in _CARD_PEAKS:
        if frag in name:
            return tc, f32, gbps
    return None


def _backend(device) -> str:
    if device is not None:
        return "cuda" if str(device).startswith("cuda") else "cpu"
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def get_peak(dtype: Optional[str] = None,
             device: Optional[str] = None) -> Tuple[float, float]:
    """(peak_tflops, peak_gbps): explicit ``set_peak`` wins, then the
    ``MXNET_DEVICE_PEAK_TFLOPS``/``_GBPS`` env, then the data sheet of the
    card (``device``: "cuda"/"cpu", default the card when there is one;
    ``dtype`` "float32" takes the f32 rate, anything else the dense
    bf16/f16 one), then a per-backend placeholder."""
    tflops, gbps = _peak_override
    if tflops is None:
        env = os.environ.get("MXNET_DEVICE_PEAK_TFLOPS")
        tflops = float(env) if env else None
    if gbps is None:
        env = os.environ.get("MXNET_DEVICE_PEAK_GBPS")
        gbps = float(env) if env else None
    if tflops is None or gbps is None:
        backend = _backend(device)
        dt, db = _DEFAULT_PEAKS["gpu" if backend == "cuda" else "cpu"]
        if backend == "cuda":
            try:
                import torch

                peaks = card_peaks(torch.cuda.get_device_name(
                    torch.cuda.current_device()))
            except Exception:  # peaks must never take down a caller
                peaks = None
            if peaks is not None:
                dt = peaks[1] if str(dtype) in _F32 else peaks[0]
                db = peaks[2]
        tflops = dt if tflops is None else tflops
        gbps = db if gbps is None else gbps
    return tflops, gbps


# ---------------------------------------------------------------------------
# cost capture
# ---------------------------------------------------------------------------

# (site, label) → cost record. Sites: "serve" (InferenceEngine buckets),
# "decode" (DecodeEngine prefills and the step), "update" (the fused
# update engine), "executor" (forward and backward), "cachedop" and
# "train_step" (ShardedTrainer)
_COSTS: Dict[Tuple[str, str], dict] = {}
_lock = threading.Lock()
_tls = threading.local()
_open = [0]  # captures running in the process (capturing()'s fast path)

# cost-record field order is the compile_log/report schema; keep stable
COST_FIELDS = ("flops", "bytes_accessed", "argument_bytes", "output_bytes",
               "temp_bytes", "generated_code_bytes", "alias_bytes",
               "peak_hbm_bytes")


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tree) -> int:
    """Bytes of the distinct storages behind the tensors of ``tree``."""
    seen, total = set(), 0
    for t in _tensors(tree):
        try:
            st = t.untyped_storage()
            key = (st.data_ptr(), str(t.device))
            n = st.nbytes()
        except Exception:  # a tensor without storage (meta, wrappers)
            key, n = id(t), _nbytes(t)
        if key not in seen:
            seen.add(key)
            total += n
    return total


# ops that read only the elements they gather (count indices + output
# read + output written) and ops that write only the elements they
# scatter (count every input but the indexed one, and the written values)
_GATHERS = ("index", "index_select", "embedding", "gather", "take")
_SCATTERS = ("index_put", "index_put_", "_index_put_impl_", "index_copy",
             "index_copy_", "index_add", "index_add_", "scatter",
             "scatter_", "scatter_add", "scatter_add_")
# metadata, allocation and no-data ops
_FREE = ("detach", "alias", "lift_fresh", "_to_copy_meta", "empty",
         "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_local_scalar_dense", "set_", "resize_", "sym_size", "sym_stride",
         "is_same_size")
# ops that move or fill values and compute none (no pointwise operations)
_MOVES = ("copy_", "_to_copy", "clone", "_foreach_copy_", "fill_", "zero_",
          "zeros_like", "ones_like", "full_like", "stack", "cat", "where",
          "_foreach_zero_", "contiguous")


class Capture:
    """The counts of one captured call. A thread-local, single-use
    ``TorchDispatchMode`` does the counting (:func:`capture` makes one)."""

    def __init__(self, pointwise: bool = False):
        self.pointwise = pointwise
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, dict] = {}
        self._by_dtype: Dict[str, int] = {}
        self._hidden = 0
        self._live = 0
        self.peak_live = 0

    # -- the port's kernels ----------------------------------------------
    def hidden(self):
        """``with cap.hidden(): ...`` — the ops inside count nothing: a
        kernel wrapper's body (its plain version on the CPU, its
        allocations on the card) and its formula's reads."""
        return _Hidden(self)

    def add_kernel(self, name: str, flops: int, nbytes: int,
                   dtype: Optional[str] = None) -> None:
        """Count one call of a port kernel by its formula."""
        flops, nbytes = int(flops), int(nbytes)
        k = self.kernels.setdefault(
            name, {"calls": 0, "flops": 0, "bytes_accessed": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes_accessed"] += nbytes
        self.flops += flops
        self.bytes += nbytes
        if dtype is not None:
            self._by_dtype[dtype] = self._by_dtype.get(dtype, 0) + flops

    # -- dispatch ----------------------------------------------------------
    def _count(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        f = flop_registry.get(packet)
        if f is not None:
            n = int(f(*args, **kwargs, out_val=out))
            self.flops += n
            ins = _tensors(args)
            if ins:
                dt = str(ins[0].dtype).replace("torch.", "")
                self._by_dtype[dt] = self._by_dtype.get(dt, 0) + n
        name = packet.__name__
        if func.is_view or name in _FREE:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if f is None and self.pointwise and name not in _MOVES \
                and name not in _GATHERS and name not in _SCATTERS:
            n = sum(t.numel() for t in (outs or ins[:1]))
            self.flops += n
            if outs or ins:
                dt = str((outs or ins)[0].dtype).replace("torch.", "")
                self._by_dtype[dt] = self._by_dtype.get(dt, 0) + n
        if name in _GATHERS:
            idx = [t for t in ins[1:] if not t.is_floating_point()]
            moved = sum(_nbytes(t) for t in outs)
            self.bytes += sum(_nbytes(t) for t in idx) + 2 * moved
        elif name in _SCATTERS:
            rest = ins[1:]
            vals = [t for t in rest if t.is_floating_point()]
            self.bytes += (sum(_nbytes(t) for t in rest)
                           + sum(_nbytes(t) for t in vals))
        else:
            self.bytes += (sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        # intermediates alive at once: the CPU's peak memory
        in_ptrs = set()
        for t in ins:
            try:
                in_ptrs.add(t.untyped_storage().data_ptr())
            except Exception:
                pass
        for t in outs:
            try:
                ptr = t.untyped_storage().data_ptr()
                n = t.untyped_storage().nbytes()
            except Exception:
                continue
            if ptr in in_ptrs or n == 0:
                continue  # in place, or a view of an input
            self._live += n
            self.peak_live = max(self.peak_live, self._live)
            weakref.finalize(t, self._freed, n)

    def _freed(self, n):
        self._live -= n

    def dtype(self) -> Optional[str]:
        if not self._by_dtype:
            return None
        return max(self._by_dtype.items(), key=lambda kv: kv[1])[0]


class _Hidden:
    __slots__ = ("cap",)

    def __init__(self, cap):
        self.cap = cap

    def __enter__(self):
        self.cap._hidden += 1
        return self.cap

    def __exit__(self, *exc):
        self.cap._hidden -= 1
        return False


def capturing() -> Optional[Capture]:
    """The capture active on this thread (None outside :func:`capture`):
    the kernel wrappers' cheap check before computing a formula. On a
    thread the capture did not start on (the autograd engine's, which
    runs a CUDA backward and inherits the capture's dispatch mode), the
    capture is found through that mode."""
    cap = getattr(_tls, "capture", None)
    if cap is None and _open[0]:
        try:
            from torch.utils._python_dispatch import \
                _get_current_dispatch_mode_stack

            for mode in _get_current_dispatch_mode_stack():
                cap = getattr(mode, "_mxt_capture", None) or cap
        except Exception:  # no mode stack to read: nothing is captured
            return None
    return cap


def _mode(cap: Capture):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _CountingMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not cap._hidden:
                try:
                    cap._count(func, args, kwargs, out)
                except Exception:  # counting must never break the call
                    pass
            return out

    mode = _CountingMode()
    mode._mxt_capture = cap  # capturing() finds it on other threads
    return mode


def capture(fn, args: tuple = (), site: str = None, label: str = None,
            kwargs=None, device=None, arg_tensors=None,
            pointwise: bool = False, key=None):
    """Run ``fn(*args, **kwargs)`` once, counted; return ``(result,
    cost)``. ``device`` (the call's device; default the first tensor
    argument's) picks the peak-memory source; ``arg_tensors`` (a pytree:
    the parameters and inputs the program reads, default the tensors of
    ``args``/``kwargs``) gives ``argument_bytes``. The caller keeps the
    result: one run serves both the accounting and the request. The
    record is filed under ``(site, label)`` (:func:`record`).
    ``pointwise`` also counts one operation per element of each
    element-wise op's output (the update engine's site). ``key`` (a
    ``progcache.ProgramKey``) gives the site and label and adds its digest
    to the record as ``program_key``."""
    import torch

    if key is not None:
        site, label = key.site, key.label

    if device is None:
        ts = _tensors((args, kwargs or {}))
        device = ts[0].device if ts else torch.device("cpu")
    device = torch.device(device)
    cuda = device.type == "cuda"
    cap = Capture(pointwise)
    arg_bytes = _storage_bytes((args, kwargs or {}) if arg_tensors is None
                               else arg_tensors)
    if cuda:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    prev = getattr(_tls, "capture", None)
    _tls.capture = cap
    with _lock:
        _open[0] += 1
    try:
        with _mode(cap):
            out = fn(*args, **(kwargs or {}))
    finally:
        _tls.capture = prev
        with _lock:
            _open[0] -= 1
    temp = (torch.cuda.max_memory_allocated(device) - base if cuda
            else cap.peak_live)
    cost = {"flops": int(cap.flops), "bytes_accessed": int(cap.bytes),
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(_storage_bytes(out)),
            "temp_bytes": int(max(temp, 0)), "generated_code_bytes": 0,
            "alias_bytes": 0,
            "peak_hbm_bytes": int(arg_bytes + max(temp, 0)),
            "device": device.type, "dtype": cap.dtype(),
            "kernels": {k: dict(v) for k, v in sorted(cap.kernels.items())}}
    if key is not None:
        cost["program_key"] = key.digest
    record(site, label, cost)
    return out, cost


# the fields of a record that a cache entry carries back (the reference's
# COST_FIELDS, then the port's own)
_ADOPTED = ("device", "dtype", "kernels")


def adopt_cached_cost(key, meta: Optional[dict]) -> dict:
    """Cost salvage for a program-cache hit (``progcache``): the record the
    writer's capture took rides the entry, so the registry and the MFU
    attribution work on hits without a capture run. Filters ``meta`` to
    :data:`COST_FIELDS` and the port's ``device``/``dtype``/``kernels``
    and, when the device plane records, files it under the key's (site,
    label) with ``program_key``. Returns the cost dict, ``{}`` when the
    writer captured none (callers skip an all-zero record)."""
    meta = meta or {}
    cost = {k: meta[k] for k in COST_FIELDS if k in meta}
    if not any(cost.values()):
        return {}
    cost.update({k: meta[k] for k in _ADOPTED if k in meta})
    cost["program_key"] = key.digest
    if active():
        record(key.site, key.label, cost)
    return cost


def record(site: str, label: str, cost: dict) -> None:
    """File a program's cost record: the (site,label) registry, the
    ``device.*`` metrics mirror, and a ``device.compile`` instant event
    (the trace-side row ``tools/trace_report.py`` tabulates)."""
    with _lock:
        _COSTS[(site, str(label))] = cost
    if _trace._ENABLED:
        reg = _metrics.registry
        reg.counter("device.compile.count").inc()
        reg.counter("device.compile.flops_total").inc(cost.get("flops", 0))
        reg.counter("device.compile.bytes_total").inc(
            cost.get("bytes_accessed", 0))
        reg.gauge(f"device.{site}.flops").set(cost.get("flops", 0))
        reg.gauge(f"device.{site}.peak_hbm_bytes").set(
            cost.get("peak_hbm_bytes", 0))
        peak = reg.gauge("device.peak_hbm_bytes")
        if cost.get("peak_hbm_bytes", 0) > peak.value:
            peak.set(cost["peak_hbm_bytes"])
        _trace.tracer.event("device.compile", site=site, label=str(label),
                            **{k: cost.get(k, 0)
                               for k in ("flops", "bytes_accessed",
                                         "peak_hbm_bytes")})


def cost_of(site: str, label: str) -> Optional[dict]:
    return _COSTS.get((site, str(label)))


def costs() -> Dict[Tuple[str, str], dict]:
    """Snapshot of every recorded program cost (tests, reports)."""
    with _lock:
        return dict(_COSTS)


# ---------------------------------------------------------------------------
# MFU + roofline attribution
# ---------------------------------------------------------------------------

def _peaks_for(cost, peak_tflops, peak_gbps):
    pt, pb = get_peak(dtype=(cost or {}).get("dtype"),
                      device=(cost or {}).get("device"))
    if peak_tflops is not None:
        pt = peak_tflops
    if peak_gbps is not None:
        pb = peak_gbps
    return pt, pb


def roofline_class(cost: Optional[dict], peak_tflops: Optional[float] = None,
                   peak_gbps: Optional[float] = None) -> Optional[dict]:
    """Classify a program against the roofline: its operational intensity
    (FLOP per byte of memory traffic) vs the machine balance point
    (peak FLOPs / peak bandwidth). Returns None when the record can't
    support the math (zero flops or bytes)."""
    if not cost:
        return None
    flops = cost.get("flops") or 0
    byt = cost.get("bytes_accessed") or 0
    if flops <= 0 or byt <= 0:
        return None
    pt, pb = _peaks_for(cost, peak_tflops, peak_gbps)
    intensity = flops / byt
    balance = (pt * 1e12) / (pb * 1e9)
    return {"intensity_flop_per_byte": round(intensity, 3),
            "machine_balance_flop_per_byte": round(balance, 3),
            "bound": "compute" if intensity >= balance else "bandwidth"}


def attribute(phase: str, seconds: float, cost: Optional[dict],
              peak_tflops: Optional[float] = None,
              peak_gbps: Optional[float] = None) -> dict:
    """Fold one program execution (wall ``seconds``) with its cost record:
    returns span attrs ``{analytic_mfu, achieved_tflops, roofline}`` and
    feeds the ``device.mfu.<phase>`` histogram. Empty dict when there's
    nothing to attribute — callers splat it into span attrs. ``seconds``
    must end after the device finished the work (a host read of its
    result): a wall time taken before the sync would overstate MFU."""
    if not cost or seconds <= 0:
        return {}
    flops = cost.get("flops") or 0
    if flops <= 0:
        return {}
    pt, pb = _peaks_for(cost, peak_tflops, peak_gbps)
    achieved = flops / seconds / 1e12
    mfu = achieved / pt if pt > 0 else 0.0
    rl = roofline_class(cost, pt, pb)
    attrs = {"analytic_mfu": round(mfu, 6),
             "achieved_tflops": round(achieved, 6)}
    if rl:
        attrs["roofline"] = rl["bound"]
    if _trace._ENABLED:
        # MFU is a ratio — fine-grained low buckets, not the latency ladder
        _metrics.registry.histogram(
            f"device.mfu.{phase}",
            buckets=(0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7,
                     0.8, 0.9, 1.0)).observe(mfu)
        _metrics.registry.gauge(f"device.{phase}.analytic_mfu").set(
            round(mfu, 6))
    return attrs


def annotate_span(span, phase: str, seconds: float,
                  cost: Optional[dict]) -> dict:
    """``attribute`` + fold the attrs into a live span (before its
    ``__exit__`` records it). No-op on the shared no-op span."""
    attrs = attribute(phase, seconds, cost)
    if attrs and isinstance(span, _trace._Span):
        span.attrs = dict(span.attrs or {}, **attrs)
    return attrs


# ---------------------------------------------------------------------------
# live device memory + leak detection
# ---------------------------------------------------------------------------

def live_bytes() -> int:
    """Bytes allocated on the cards (``torch.cuda.memory_allocated``,
    summed over the cards this process has touched); 0 in a process with
    no card, whose tensors all live in host memory."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return 0
    return int(sum(torch.cuda.memory_allocated(i)
                   for i in range(torch.cuda.device_count())))


class LeakDetector:
    """Steady-state leak detector over sampled live-bytes.

    A serving or training loop's device footprint is a step function: big
    at the first run (temporary buffers), then FLAT. Monotonic growth
    across steady-state steps means something retains tensors per step.
    The detector drops ``warmup`` samples, then fits a least-squares slope
    over a sliding ``window``; it fires when the slope exceeds
    ``threshold_bytes_per_step`` AND the window actually rose end-to-end
    (slope alone can be a single spike's artifact). After firing it
    re-arms only after a full fresh window.
    """

    def __init__(self, window: int = 10, warmup: int = 3,
                 threshold_bytes_per_step: float = 1 << 20):
        self.window = int(window)
        self.warmup = int(warmup)
        self.threshold = float(threshold_bytes_per_step)
        self._samples: list = []
        self._seen = 0
        self._cooldown = 0
        self.findings: list = []

    def observe(self, nbytes: int) -> Optional[dict]:
        """Feed one sample; returns a finding dict when a leak is flagged
        (and records it in ``findings``), else None."""
        self._seen += 1
        if self._seen <= self.warmup:
            return None
        self._samples.append(float(nbytes))
        if len(self._samples) > self.window:
            self._samples.pop(0)
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        n = len(self._samples)
        if n < self.window:
            return None
        # least-squares slope over x = 0..n-1
        xs = range(n)
        mean_x = (n - 1) / 2.0
        mean_y = sum(self._samples) / n
        sxx = sum((x - mean_x) ** 2 for x in xs)
        sxy = sum((x - mean_x) * (y - mean_y)
                  for x, y in zip(xs, self._samples))
        slope = sxy / sxx if sxx else 0.0
        grew = self._samples[-1] - self._samples[0]
        if slope > self.threshold and grew > self.threshold * (n - 1) / 2:
            finding = {"slope_bytes_per_step": round(slope, 1),
                       "window": n,
                       "grew_bytes": round(grew, 1),
                       "live_bytes": int(self._samples[-1])}
            self.findings.append(finding)
            self._cooldown = self.window
            return finding
        return None

    def reset(self) -> None:
        self._samples.clear()
        self._seen = 0
        self._cooldown = 0
        self.findings.clear()


# the process-global monitor fed by sample()
monitor = LeakDetector(
    window=int(os.environ.get("MXNET_DEVICE_LEAK_WINDOW", "10")),
    threshold_bytes_per_step=float(
        os.environ.get("MXNET_DEVICE_LEAK_BYTES_PER_STEP", str(1 << 20))))


def sample(**attrs) -> Optional[int]:
    """Sample live device bytes into the ``device.live_bytes`` gauge, the
    chrome-trace counter track, and the leak detector (the serve engines
    call it once per batch). One flag check when telemetry is off;
    ``MXNET_OBS_MEMORY=0`` disables sampling with telemetry on."""
    if not _trace._ENABLED:
        return None
    if os.environ.get("MXNET_OBS_MEMORY", "").lower() in ("0", "false",
                                                          "no", "off"):
        return None
    n = live_bytes()
    _metrics.registry.gauge("device.live_bytes").set(n)
    _trace.tracer.counter("device.live_bytes", n)
    finding = monitor.observe(n)
    if finding is not None:
        _metrics.registry.counter("device.leak_suspected").inc()
        _trace.tracer.event("device.leak_suspected", **dict(finding, **attrs))
    return n


def reset() -> None:
    """Drop recorded program costs, peaks, and the leak monitor's state
    (tests; a fresh run starts empty)."""
    with _lock:
        _COSTS.clear()
    _peak_override[0] = _peak_override[1] = None
    monitor.reset()
