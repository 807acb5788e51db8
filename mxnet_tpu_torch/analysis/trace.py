"""TraceLinter — hybridize hygiene checks for HybridBlocks (counterpart
of ``mxnet_tpu/analysis/trace.py``, same rule ids).

Three classes of silent perf/correctness bugs a forward can't flag itself:

- ``retrace-churn``: every distinct (shapes, dtypes, train-mode) signature
  is a new ``CachedOp`` entry (``gluon/block.py``) with its own first run;
  a loop feeding ragged shapes keeps adding them.
- ``concretization-leak``: ``float()``/``bool()``/``.asnumpy()`` on a
  forward's value is a device-to-host sync on every call, and it breaks
  CUDA-graph capture of the forward.
- ``weak-dtype-promotion``: mixed param/input float dtypes promote inside
  the forward, upcasting the whole model (bf16 params + fp32 inputs run
  fp32).

The engine checks prove the program bounds of the fused update
(``optimizer/fused.py``), the serve engine (``serve/engine.py``) and the
decode engine (``serve/decode.py``) from their ``compile_log``.

Usage::

    report = TraceLinter().lint(net, example_x)      # static + cache checks
    with TraceLinter().watch(net) as tl:             # observe a train loop
        for batch in loader: net(batch)
    report = tl.report()
"""
from __future__ import annotations

import ast
import contextlib
import inspect
import textwrap
from typing import List

from .findings import Finding, Report, Severity

__all__ = ["TraceLinter"]

# host-sync call forms flagged inside hybrid_forward/forward bodies
_HOST_BUILTINS = {"float", "bool"}
_HOST_NP_FUNCS = {"asarray", "array"}
_HOST_METHODS = {"asnumpy", "item", "tolist"}
_NP_MODULES = {"np", "numpy", "_np", "onp"}


def _dtype_name(d) -> str:
    """Name of a numpy or torch dtype (``float32``, ``bfloat16``)."""
    import numpy as np

    if hasattr(d, "is_floating_point"):  # torch.dtype
        return str(d).replace("torch.", "")
    return np.dtype(d).name


def _is_float(name: str) -> bool:
    return name.startswith(("float", "bfloat"))


def _is_constant(node) -> bool:
    return isinstance(node, ast.Constant) or \
        (isinstance(node, ast.UnaryOp) and _is_constant(node.operand))


class _HostCallScanner(ast.NodeVisitor):
    def __init__(self, filename: str, lineno_base: int):
        self.filename = filename
        self.lineno_base = lineno_base
        self.findings: List[Finding] = []

    def _flag(self, node, what):
        line = self.lineno_base + node.lineno - 1
        self.findings.append(Finding(
            "concretization-leak", Severity.WARNING,
            f"{what} inside a forward: a device->host sync on every call, "
            "and it breaks CUDA-graph capture of the forward",
            location=f"{self.filename}:{line}",
            fix_hint="keep the math on the device (use ops / F.where), or "
                     "compute it outside forward"))

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _HOST_BUILTINS \
                and node.args and not _is_constant(node.args[0]):
            self._flag(node, f"{fn.id}(...)")
        elif isinstance(fn, ast.Attribute):
            if fn.attr in _HOST_METHODS and not node.args:
                self._flag(node, f".{fn.attr}()")
            elif fn.attr in _HOST_NP_FUNCS \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id in _NP_MODULES \
                    and node.args and not _is_constant(node.args[0]):
                self._flag(node, f"{fn.value.id}.{fn.attr}(...)")
        self.generic_visit(node)


class TraceLinter:
    """Static + cache-observing lint for HybridBlock tracing hygiene."""

    def __init__(self, retrace_threshold: int = 3, **options):
        self.retrace_threshold = int(retrace_threshold)
        self.options = options
        self._watch_baseline = None
        self._watched = None

    # ------------------------------------------------------------- static
    def scan_source(self, block) -> List[Finding]:
        """AST scan of every distinct forward/hybrid_forward in the tree."""
        findings: List[Finding] = []
        seen_fns = set()
        for blk in self._walk_blocks(block):
            for meth_name in ("hybrid_forward", "forward"):
                meth = getattr(type(blk), meth_name, None)
                if meth is None or meth in seen_fns:
                    continue
                seen_fns.add(meth)
                if getattr(meth, "__module__", "").startswith(
                        "mxnet_tpu_torch.gluon.block"):
                    continue  # framework dispatch glue, not user math
                try:
                    src = textwrap.dedent(inspect.getsource(meth))
                    fname = inspect.getsourcefile(meth) or "<unknown>"
                    base = inspect.getsourcelines(meth)[1]
                except (OSError, TypeError):
                    continue
                try:
                    tree = ast.parse(src)
                except SyntaxError:
                    continue
                scanner = _HostCallScanner(fname, base)
                scanner.visit(tree)
                findings.extend(scanner.findings)
        return findings

    @staticmethod
    def _walk_blocks(block):
        yield block
        for c in getattr(block, "_children", {}).values():
            yield from TraceLinter._walk_blocks(c)

    # ------------------------------------------------------------- dtypes
    def check_dtypes(self, block, *example_inputs) -> List[Finding]:
        import numpy as np

        findings: List[Finding] = []
        param_dts = set()
        for p in getattr(block, "_iter_params", lambda: ())():
            if p._data is not None:
                param_dts.add(_dtype_name(p.data().dtype))
        float_params = {d for d in param_dts if _is_float(d)}
        for i, x in enumerate(example_inputs):
            dt = _dtype_name(getattr(x, "dtype", np.float32))
            if _is_float(dt) and float_params and dt not in float_params:
                pd = ", ".join(sorted(float_params))
                findings.append(Finding(
                    "weak-dtype-promotion", Severity.WARNING,
                    f"input #{i} is {dt} but parameters are {pd}; "
                    "promotion inside the forward silently runs the model "
                    "at the wider dtype (and caches a program per input "
                    "dtype)",
                    node=f"input#{i}",
                    fix_hint="cast inputs to the parameter dtype (or use "
                             "amp/cast policy) before the traced call"))
        return findings

    # -------------------------------------------------------------- cache
    @staticmethod
    def _cache_keys(block):
        keys = []
        for blk in TraceLinter._walk_blocks(block):
            op = getattr(blk, "_cached_op", None)
            if op is not None:
                keys.extend(op._cache.keys())
        return keys

    def check_cache(self, block, baseline: int = 0) -> List[Finding]:
        keys = self._cache_keys(block)
        n_new = len(keys) - baseline
        findings: List[Finding] = []
        if n_new <= self.retrace_threshold:
            return findings
        # diagnose which signature component varies
        by_train = {}
        for train, pav, iav in keys:
            by_train.setdefault(train, []).append((pav, iav))
        shapes = {tuple(s for s, _ in iav) for _t, _p, iav in keys}
        dtypes = {tuple(d for _, d in iav) for _t, _p, iav in keys}
        varying = []
        if len(shapes) > 1:
            varying.append(f"input shapes ({len(shapes)} distinct)")
        if len(dtypes) > 1:
            varying.append(f"input dtypes ({len(dtypes)} distinct)")
        if len(by_train) > 1:
            varying.append("train/eval mode (expected, costs one retrace)")
        sample = ", ".join(str(s) for s in list(shapes)[:3])
        findings.append(Finding(
            "retrace-churn", Severity.WARNING,
            f"{n_new} distinct signatures cached (threshold "
            f"{self.retrace_threshold}); varying: "
            f"{'; '.join(varying) or 'unknown'}; e.g. shapes {sample}",
            node=getattr(block, "name", None),
            fix_hint="bucket/pad inputs to a fixed set of shapes and cast "
                     "to one dtype so cached programs are reused"))
        return findings

    # ------------------------------------------------- fused update engine
    @staticmethod
    def _engines_of(obj):
        """Yield FusedUpdateEngine instances reachable from a Trainer,
        Updater, Module, or a bare engine."""
        if hasattr(obj, "compile_log") and hasattr(obj, "apply"):
            yield obj  # already an engine
            return
        updaters = []
        if hasattr(obj, "_updaters"):  # gluon Trainer
            updaters.extend(obj._updaters)
        if hasattr(obj, "_updater") and obj._updater is not None:  # Module
            updaters.append(obj._updater)
        if hasattr(obj, "states") and hasattr(obj, "optimizer"):  # Updater
            updaters.append(obj)
        for u in updaters:
            eng = getattr(u, "_engine", None)
            if eng is not None:
                yield eng

    def check_update_engine(self, obj, baseline: int = 0) -> List[Finding]:
        """Flag a training loop that keeps recompiling the fused update
        program.  Per-step scalars (lr after scheduler, wd, loss scale,
        update counts) are traced arguments by design — churn means a
        *static* component varies per step: a mutated hyperparameter
        (e.g. ``optimizer.momentum`` rewritten from a python float each
        iteration), ragged parameter shapes, or a flapping scaler/clip
        toggle. Reads the engine's ``compile_log`` fields ``static``,
        ``avals``, ``state_structure``, ``flags`` and ``optimizer``."""
        findings: List[Finding] = []
        for eng in self._engines_of(obj):
            log = eng.compile_log[baseline:]
            if len(log) <= self.retrace_threshold:
                continue
            varying = []
            for field, label in (("static", "static hyperparameters"),
                                 ("avals", "parameter shapes/dtypes"),
                                 ("state_structure", "optimizer state structure"),
                                 ("flags", "loss-scaler/clip toggles"),
                                 ("optimizer", "optimizer class")):
                distinct = {repr(e.get(field)) for e in log}
                if len(distinct) > 1:
                    varying.append(f"{label} ({len(distinct)} distinct)")
            findings.append(Finding(
                "update-retrace-churn", Severity.WARNING,
                f"the fused update program recompiled {len(log)} times "
                f"(threshold {self.retrace_threshold}); varying: "
                f"{'; '.join(varying) or 'unknown'}. Each new signature "
                "takes the step's first-run path (kernel-launch "
                "recording, device-plane capture, a program-cache write)",
                node=type(eng.optimizer).__name__,
                fix_hint="don't rebind static optimizer hyperparameters per "
                         "step — per-step values (lr/wd/scale) are already "
                         "traced arguments; use set_learning_rate or an "
                         "lr_scheduler instead of mutating e.g. momentum, "
                         "and keep parameter shapes fixed"))
        return findings

    # ---------------------------------------------------- serving engine
    def check_serve_engine(self, engine, baseline: int = 0) -> List[Finding]:
        """Prove the serving engine's compiled-program bound
        (``serve/engine.py``): every ``compile_log`` entry must carry a
        distinct input signature (a repeated key means the engine took a
        first run for a program it believed cached), and the distinct-signature
        count must not exceed buckets × feature signatures — more means
        bucketing is leaking ragged shapes past the engine.
        An empty finding list IS the proof tests assert on."""
        findings: List[Finding] = []
        log = engine.compile_log[baseline:]
        if not log:
            return findings
        sigs = [e["sig"] for e in log]
        dupes = {repr(s) for s in sigs if sigs.count(s) > 1}
        if dupes:
            findings.append(Finding(
                "serve-retrace-churn", Severity.ERROR,
                f"{len(dupes)} input signature(s) compiled more than once "
                f"(e.g. {sorted(dupes)[0][:120]}); the per-signature "
                "program cache is being bypassed",
                node=type(engine).__name__,
                fix_hint="keep parameter avals stable across reload() and "
                         "don't mutate engine buckets after warmup"))
        n_feat = len({tuple((shape[1:], dt) for shape, dt in s)
                      for s in sigs})
        bound = len(engine.buckets) * max(n_feat, 1)
        if len(set(map(repr, sigs))) > bound:
            findings.append(Finding(
                "serve-retrace-churn", Severity.WARNING,
                f"{len(set(map(repr, sigs)))} compiled programs exceed the "
                f"bucket bound ({len(engine.buckets)} buckets × {n_feat} "
                "feature signatures); ragged batch sizes are escaping "
                "bucketing",
                node=type(engine).__name__,
                fix_hint="route all traffic through engine.infer (it pads "
                         "to buckets); check for direct _forward calls"))
        return findings

    def check_decode_engine(self, engine, baseline: int = 0
                            ) -> List[Finding]:
        """Prove the decode engine's two-program bound
        (``serve/decode.py``): across ANY traffic mix the engine may
        compile at most one prefill program per prompt bucket plus ONE
        shared decode-step program. A repeated signature means a retrace
        behind the engine's back; more prefill programs than buckets (or
        a second step program) means a dynamic shape is leaking into a
        program — every extra one is a first run (and a program-cache
        write) in a latency-bound token loop. An empty finding list IS the proof
        tests assert on."""
        findings: List[Finding] = []
        log = engine.compile_log[baseline:]
        if not log:
            return findings
        sigs = [e["sig"] for e in log]
        dupes = {repr(s) for s in sigs if sigs.count(s) > 1}
        if dupes:
            findings.append(Finding(
                "decode-retrace-churn", Severity.ERROR,
                f"{len(dupes)} decode signature(s) compiled more than once "
                f"(e.g. {sorted(dupes)[0][:120]}); the per-signature "
                "program cache is being bypassed",
                node=type(engine).__name__,
                fix_hint="keep parameter avals stable and never resize the "
                         "page pool or slot count after construction"))
        n_prefill = len({repr(e["sig"]) for e in log
                         if e["kind"] == "prefill"})
        n_step = len({repr(e["sig"]) for e in log if e["kind"] == "step"})
        if n_prefill > len(engine.buckets):
            findings.append(Finding(
                "decode-retrace-churn", Severity.ERROR,
                f"{n_prefill} prefill programs exceed the bucket bound "
                f"({len(engine.buckets)} buckets); ragged prompt lengths "
                "are escaping bucketing",
                node=type(engine).__name__,
                fix_hint="route all prompts through engine.prefill (it "
                         "pads to prompt_buckets); check for direct "
                         "_execute calls"))
        if n_step > 1:
            findings.append(Finding(
                "decode-retrace-churn", Severity.ERROR,
                f"{n_step} decode-step programs compiled; the step must "
                "be ONE fixed-shape program regardless of which slots "
                "are live",
                node=type(engine).__name__,
                fix_hint="keep the step batch at the fixed slot count and "
                         "park inactive slots on the scratch page instead "
                         "of reshaping the batch"))
        return findings

    # ------------------------------------------------------------- public
    def lint(self, block, *example_inputs) -> Report:
        report = Report(self.scan_source(block))
        if example_inputs:
            report.extend(self.check_dtypes(block, *example_inputs))
        report.extend(self.check_cache(block))
        report.extend(self.check_update_engine(block))
        return report

    @contextlib.contextmanager
    def watch(self, block):
        """Observe a training/eval loop; ``report()`` afterwards. Accepts a
        Block, a gluon Trainer, or a Module (the latter two are watched for
        fused-update retrace churn: the block keeps the update engines'
        signature accounting on, ``optimizer.fused.track_signatures``)."""
        from ..optimizer.fused import track_signatures

        self._watched = block
        self._watch_baseline = len(self._cache_keys(block))
        self._watch_engine_baseline = sum(
            len(e.compile_log) for e in self._engines_of(block))
        with track_signatures():
            yield self

    def report(self) -> Report:
        if self._watched is None:
            raise RuntimeError("report() requires a completed watch() block")
        rep = Report(self.scan_source(self._watched))
        rep.extend(self.check_cache(self._watched,
                                    baseline=self._watch_baseline))
        rep.extend(self.check_update_engine(
            self._watched, baseline=getattr(self, "_watch_engine_baseline", 0)))
        return rep
