"""DataplaneLinter — static copy/sync/allocation lint for the hot paths
(counterpart of ``mxnet_tpu/analysis/dataplane.py``, same rule ids and
hot roots).

A machine-checked definition of "zero-copy" and "non-blocking hot path":
the data-plane bug classes that get fixed by hand again and again —
blocking host syncs on request paths, per-frame buffer copies, unbounded
server-side caches, and leaked sockets/threads on exception paths —
turned into contracts, the way ``concurrency.py`` does for locks. (Its
runtime twin, ``copytrack.py``, *measures* the copies and syncs this
pass can only prove reachable.)

Rules (docs/ANALYSIS.md "Data-plane lint" has the catalog):

- ``pickle-on-wire`` (error) — ``pickle``/``marshal``/``.tojson()`` on a
  hot-reachable or wire-framing function: array payloads must transit
  the ``_pack_arrays``/memoryview framing, never an object serializer.
- ``redundant-buffer-copy`` (warning) — ``bytes``-accumulating ``+=``,
  per-frame ``b"".join`` inside a loop, ``.tobytes()`` of an array, or
  slicing received ``bytes`` where a ``memoryview`` suffices, on a
  send/recv or hot-reachable function — the scatter-gather
  preconditions for item 4.
- ``host-sync-on-hot-path`` (warning) — ``asnumpy``/``device_get``/
  ``block_until_ready``/``copy_to_host_async`` and the port's own
  device-to-host points — ``synchronize`` (``torch.cuda.synchronize``,
  ``Event.synchronize``), ``.item()``, ``.tolist()`` and the
  ``host_array`` helper (``ndarray/serialization.py``) — reachable from a
  declared hot root (same-class interprocedural propagation, the
  concurrency lint's blocking-call idiom). ``float(t)``/``np.asarray(t)``
  coercions are type-ambiguous statically. Waived syncs stay inventoried
  at info severity.
- ``unbounded-collection-growth`` (warning) — a dict/list/set attribute
  initialized in ``__init__`` and mutated inside a handler method or
  loop body, with no eviction/cap/rebind anywhere in the class (the
  released-round-cache / hot-key-table bug class).
- ``resource-lifetime`` (warning) — a locally acquired socket/file/
  thread that is never closed/joined and never handed off (returned,
  stored, passed on): the exception path leaks it.
- ``env-registry-drift`` (warning) — every ``MXNET_*`` environ read must
  have a ``runtime._ENV_REGISTRY`` row and every ``MXNET_*`` registry
  row must have a read (bidirectional; catches doc rot mechanically).

Hot roots (class, method) — the request/step paths everything above is
computed relative to::

    InferenceEngine.infer        serve/engine.py   (bucketed execute)
    DynamicBatcher._loop/_assemble/_execute   serve/batcher.py
    ServeServer._handle_loop/_handle_one      serve/server.py
    FleetServer._handle_one                   serve/fleet.py
    PSServer._handle_loop/_handle_one         kvstore/ps_server.py
    Router.infer                 serve/fleet.py    (failover route)
    DecodeScheduler.step         serve/decode.py   (one decode step)
    BaseModule.fit               module/base_module.py (step body)

Waive a deliberate site with ``# lint: disable=<rule-id>`` on the
offending line (justify nearby); waived findings are reported at info
severity with ``details={"waived": True}`` but never fail the lint.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import Finding, Report, Severity
from .repo_lint import _suppressed

__all__ = ["RULES", "HOT_ROOTS", "lint_source", "lint_paths",
           "check_env_registry", "collect_env_reads", "unwaived", "main"]

RULES = {
    "pickle-on-wire":
        "object serializer (pickle/marshal/tojson) on a wire or "
        "hot-reachable path — array bytes must use the array framing",
    "redundant-buffer-copy":
        "avoidable buffer copy on a send/recv path (bytes +=, per-frame "
        "join, .tobytes(), slicing received bytes)",
    "host-sync-on-hot-path":
        "device->host sync (asnumpy/device_get/block_until_ready/"
        "synchronize/item/tolist/host_array) reachable from a declared "
        "hot root",
    "unbounded-collection-growth":
        "collection attribute grows in a handler/loop body with no "
        "eviction or cap in the class",
    "resource-lifetime":
        "socket/file/thread acquired but never closed/joined on any "
        "path and never handed off",
    "env-registry-drift":
        "MXNET_* environ read without a runtime._ENV_REGISTRY row, or "
        "a registry row no code reads",
}

# (class name, method name) pairs the reachability analysis seeds from.
HOT_ROOTS: Set[Tuple[str, str]] = {
    ("InferenceEngine", "infer"),
    ("DynamicBatcher", "_loop"),
    ("DynamicBatcher", "_assemble"),
    ("DynamicBatcher", "_execute"),
    ("ServeServer", "_handle_loop"),
    ("ServeServer", "_handle_one"),
    ("FleetServer", "_handle_one"),
    ("PSServer", "_handle_loop"),
    ("PSServer", "_handle_one"),
    ("Router", "infer"),
    ("DecodeScheduler", "step"),
    ("BaseModule", "fit"),
}

# device->host materialization points (rule 3): the reference's, and the
# port's (a device wait, a scalar or list read of a tensor)
_SYNC_ATTRS = {"asnumpy", "device_get", "block_until_ready",
               "copy_to_host_async", "synchronize", "item", "tolist"}
# ... and by function name (the port's array-to-host helper)
_SYNC_FUNCS = {"host_array"}
# object serializers (rule 1)
_PICKLE_MODULES = {"pickle", "cPickle", "marshal"}
_PICKLE_FUNCS = {"dumps", "loads", "dump", "load"}
# eviction evidence on a collection attribute (rule 4)
_EVICT_ATTRS = {"pop", "popitem", "popleft", "clear", "remove", "evict",
                "discard"}
# resource constructors (rule 5): qualified-name suffix -> release verbs
_RESOURCE_CTORS = {
    "socket.socket": ("close", "shutdown", "detach"),
    "socket.create_connection": ("close", "shutdown", "detach"),
    "open": ("close",),
    "threading.Thread": ("join",),
    "Thread": ("join",),
}
# env-read callees (rule 6)
_ENV_READ_FUNCS = {"get_env", "getenv", "env_float", "env_int",
                   "env_str", "env_bool"}
_ENV_NAME_RE = re.compile(r"^MXNET_[A-Z0-9][A-Z0-9_]*$")


def _dotted(expr: ast.AST) -> str:
    """Dotted best-effort name of an attribute chain ('os.environ')."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return ".".join(reversed(parts))


def _call_name(node: ast.Call) -> str:
    """Dotted best-effort name of a call target ('socket.socket',
    'self._pack', 'open')."""
    return _dotted(node.func)


def _is_self_call(node: ast.Call) -> Optional[str]:
    f = node.func
    if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
            and f.value.id == "self"):
        return f.attr
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ModuleLinter:
    def __init__(self, src: str, filename: str = "<string>"):
        self.src = src
        self.filename = filename
        self.lines = src.splitlines()
        self.findings: List[Finding] = []
        self.env_reads: List[Tuple[str, int]] = []  # (var name, line)
        try:
            self.tree: Optional[ast.AST] = ast.parse(src)
        except SyntaxError as e:
            self.tree = None
            self.findings.append(Finding(
                "syntax-error", Severity.ERROR, str(e),
                location=f"{filename}:{e.lineno or 0}"))

    # -- emit helpers ---------------------------------------------------
    def emit(self, rule: str, severity: str, msg: str, line: int,
             fix: str, end_line: Optional[int] = None, **details) -> None:
        for ln in range(line, (end_line or line) + 1):
            if _suppressed(self.lines, ln, rule):
                self.emit_waived(rule, line)
                return
        self.findings.append(Finding(
            rule, severity, msg, fix_hint=fix,
            location=f"{self.filename}:{line}", details=details or {}))

    def emit_waived(self, rule: str, line: int) -> None:
        self.findings.append(Finding(
            rule, Severity.INFO, "waived in source (lint: disable)",
            location=f"{self.filename}:{line}", details={"waived": True}))

    # -- analysis -------------------------------------------------------
    def run(self) -> None:
        if self.tree is None:
            return
        self._collect_env_reads(self.tree)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self._lint_class(node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._lint_resources(node)
        # module-level wire helpers (the framing functions live outside
        # classes): buffer + serializer rules apply there too
        for node in (self.tree.body if isinstance(self.tree, ast.Module)
                     else []):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and self._is_wire_fn(node):
                self._lint_buffers(node, f"{node.name}()")
                self._lint_serializers(node, f"{node.name}()")

    # -- hot-root reachability ------------------------------------------
    def _lint_class(self, cls: ast.ClassDef) -> None:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        # seed + same-class fixpoint: a method called (transitively) from
        # a hot root is hot; remember which root it derives from
        hot: Dict[str, str] = {
            name: f"{cls.name}.{name}" for name in methods
            if (cls.name, name) in HOT_ROOTS}
        changed = True
        while changed:
            changed = False
            for name, fn in methods.items():
                if name not in hot:
                    continue
                for call in ast.walk(fn):
                    if not isinstance(call, ast.Call):
                        continue
                    callee = _is_self_call(call)
                    if callee and callee in methods and callee not in hot:
                        hot[callee] = hot[name]
                        changed = True
        for name, fn in methods.items():
            ctx = f"{cls.name}.{name}"
            if name in hot:
                self._lint_syncs(fn, ctx, root=hot[name])
                self._lint_buffers(fn, ctx)
                self._lint_serializers(fn, ctx)
            elif self._is_wire_fn(fn):
                self._lint_buffers(fn, ctx)
                self._lint_serializers(fn, ctx)
        self._lint_growth(cls, methods, set(hot))

    def _is_wire_fn(self, fn: ast.AST) -> bool:
        """A function is on the wire path if it is a framing helper by
        name or touches a socket send/recv itself."""
        if fn.name.startswith(("_pack", "_unpack", "_send", "_recv",
                               "_reply")):
            return True
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute) and node.func.attr in (
                    "sendall", "sendmsg", "recv", "recv_into"):
                return True
        return False

    # -- rule 3: host syncs ---------------------------------------------
    def _lint_syncs(self, fn: ast.AST, ctx: str, root: str) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in _SYNC_ATTRS:
                what, sync = f".{f.attr}()", f.attr
            elif isinstance(f, ast.Attribute) and f.attr in _SYNC_FUNCS:
                what, sync = f"{f.attr}()", f.attr
            elif isinstance(f, ast.Name) and f.id in _SYNC_FUNCS:
                what, sync = f"{f.id}()", f.id
            else:
                continue
            self.emit(
                "host-sync-on-hot-path", Severity.WARNING,
                f"{ctx}: {what} is a device->host sync "
                f"reachable from hot root {root}",
                node.lineno,
                "keep results device-resident (or waive: intentional "
                "syncs stay inventoried at info severity)",
                end_line=getattr(node, "end_lineno", None),
                root=root, sync=sync)

    # -- rule 1: object serializers on wire paths -----------------------
    def _lint_serializers(self, fn: ast.AST, ctx: str) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            mod, _, leaf = name.rpartition(".")
            hit = None
            if mod.split(".")[-1] in _PICKLE_MODULES \
                    and leaf in _PICKLE_FUNCS:
                hit = name
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "tojson":
                hit = ".tojson()"
            if hit:
                self.emit(
                    "pickle-on-wire", Severity.ERROR,
                    f"{ctx}: {hit} on a wire/hot path — array payloads "
                    "must use the _pack_arrays/memoryview framing",
                    node.lineno,
                    "frame arrays with _pack_arrays; reserve object "
                    "serializers for small non-array metadata (waive with "
                    "a justification if so)",
                    end_line=getattr(node, "end_lineno", None),
                    call=hit)

    # -- rule 2: redundant buffer copies --------------------------------
    def _lint_buffers(self, fn: ast.AST, ctx: str) -> None:
        bytes_locals: Set[str] = set()
        recv_locals: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
                v = node.value
                if isinstance(v, ast.Constant) and isinstance(v.value, bytes):
                    bytes_locals.add(tgt)
                elif isinstance(v, ast.Call):
                    vname = _call_name(v)
                    leaf = vname.rpartition(".")[2]
                    if "recv" in leaf:
                        recv_locals.add(tgt)
                    elif leaf == "memoryview":
                        recv_locals.discard(tgt)

        def visit(node: ast.AST, in_loop: bool) -> None:
            if isinstance(node, ast.AugAssign) \
                    and isinstance(node.op, ast.Add) \
                    and isinstance(node.target, ast.Name) \
                    and node.target.id in bytes_locals:
                self.emit(
                    "redundant-buffer-copy", Severity.WARNING,
                    f"{ctx}: '{node.target.id} +=' reallocates and copies "
                    "the whole accumulated buffer every iteration",
                    node.lineno,
                    "append chunks to a list and b''.join once after the "
                    "loop (or write into a preallocated bytearray)",
                    end_line=getattr(node, "end_lineno", None),
                    kind="bytes-augassign")
            elif isinstance(node, ast.Call):
                f = node.func
                if in_loop and isinstance(f, ast.Attribute) \
                        and f.attr == "join" \
                        and isinstance(f.value, ast.Constant) \
                        and isinstance(f.value.value, bytes):
                    self.emit(
                        "redundant-buffer-copy", Severity.WARNING,
                        f"{ctx}: per-frame b''.join inside a loop copies "
                        "every frame's bytes again",
                        node.lineno,
                        "collect pieces across the loop and join once "
                        "(or hand the piece list to sendmsg)",
                        end_line=getattr(node, "end_lineno", None),
                        kind="join-in-loop")
                if isinstance(f, ast.Attribute) \
                        and f.attr in ("sendall", "send") and node.args \
                        and isinstance(node.args[0], ast.BinOp) \
                        and isinstance(node.args[0].op, ast.Add):
                    self.emit(
                        "redundant-buffer-copy", Severity.WARNING,
                        f"{ctx}: concatenating buffers in the "
                        f"{f.attr}() argument copies the whole message "
                        "first",
                        node.lineno,
                        "hand the parts to sendmsg() (scatter-gather) "
                        "instead of header + body",
                        end_line=getattr(node, "end_lineno", None),
                        kind="concat-before-send")
                if isinstance(f, ast.Attribute) and f.attr == "tobytes":
                    self.emit(
                        "redundant-buffer-copy", Severity.WARNING,
                        f"{ctx}: .tobytes() copies the whole array into a "
                        "fresh bytes object",
                        node.lineno,
                        "pass memoryview(arr) / arr.data to the send path "
                        "(scatter-gather)",
                        end_line=getattr(node, "end_lineno", None),
                        kind="tobytes")
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id in recv_locals \
                    and isinstance(node.slice, ast.Slice):
                # memoryview-wrapped receives are exempt (slicing a
                # memoryview is free); prescan dropped those names
                self.emit(
                    "redundant-buffer-copy", Severity.WARNING,
                    f"{ctx}: slicing received bytes "
                    f"'{node.value.id}[...]' copies the slice",
                    node.lineno,
                    "wrap the receive in memoryview() before slicing",
                    end_line=getattr(node, "end_lineno", None),
                    kind="bytes-slice")
            if isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
                # only the loop BODY repeats; the iterable/test is
                # evaluated outside the per-iteration cost
                for field, sub in ast.iter_fields(node):
                    kids = sub if isinstance(sub, list) else [sub]
                    per_iter = in_loop or field in ("body", "orelse")
                    for c in kids:
                        if isinstance(c, ast.AST):
                            visit(c, per_iter)
            else:
                for c in ast.iter_child_nodes(node):
                    visit(c, in_loop)

        for stmt in fn.body:
            visit(stmt, False)

    # -- rule 4: unbounded collection growth ----------------------------
    def _lint_growth(self, cls: ast.ClassDef, methods, hot: Set[str]
                     ) -> None:
        init = methods.get("__init__")
        if init is None:
            return
        grown: Dict[str, int] = {}  # attr -> init line
        for node in ast.walk(init):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            attr = _self_attr(node.targets[0])
            if attr is None:
                continue
            v = node.value
            unbounded = False
            if isinstance(v, (ast.Dict, ast.List, ast.Set)) \
                    and not getattr(v, "keys", None) \
                    and not getattr(v, "elts", None):
                unbounded = True
            elif isinstance(v, ast.Call):
                ctor = _call_name(v).rpartition(".")[2]
                if ctor in ("dict", "list", "set", "OrderedDict",
                            "defaultdict") and not v.args:
                    unbounded = True
                elif ctor == "deque" and not any(
                        kw.arg == "maxlen" for kw in v.keywords):
                    unbounded = True
            if unbounded:
                grown[attr] = node.lineno
        if not grown:
            return
        capped: Set[str] = set()
        for name, fn in methods.items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    f = node.func
                    if isinstance(f, ast.Attribute) \
                            and f.attr in _EVICT_ATTRS:
                        a = _self_attr(f.value)
                        if a:
                            capped.add(a)
                    # a length check against the attr is cap awareness
                    if isinstance(f, ast.Name) and f.id == "len" \
                            and node.args:
                        a = _self_attr(node.args[0])
                        if a:
                            capped.add(a)
                if isinstance(node, ast.Delete):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript):
                            a = _self_attr(t.value)
                            if a:
                                capped.add(a)
                if name != "__init__" and isinstance(node, ast.Assign):
                    for t in node.targets:
                        a = _self_attr(t)
                        if a:
                            capped.add(a)  # rebind = reset
        handlerish = hot | {n for n in methods
                            if n.startswith(("_handle", "_loop"))
                            or n in ("serve_forever", "run", "_run")}
        for name, fn in methods.items():
            if name == "__init__":
                continue  # construction-time growth is bounded by config
            for node in ast.walk(fn):
                mut_attr = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Subscript):
                    mut_attr = _self_attr(node.targets[0].value)
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("append", "add",
                                               "setdefault", "extend",
                                               "appendleft", "update"):
                    mut_attr = _self_attr(node.func.value)
                if mut_attr is None or mut_attr not in grown \
                        or mut_attr in capped:
                    continue
                if name in handlerish or self._in_loop(fn, node):
                    self.emit(
                        "unbounded-collection-growth", Severity.WARNING,
                        f"{cls.name}.{mut_attr} grows in "
                        f"{cls.name}.{name} with no eviction/cap "
                        "anywhere in the class",
                        node.lineno,
                        "cap it (LRU popitem / deque(maxlen=) / periodic "
                        "prune) or rebind it per round",
                        end_line=getattr(node, "end_lineno", None),
                        attr=mut_attr, method=name)
                    capped.add(mut_attr)  # one finding per attribute

    @staticmethod
    def _in_loop(fn: ast.AST, target: ast.AST) -> bool:
        """True if ``target`` sits inside a For/While within ``fn``."""
        found = [False]

        def visit(node, in_loop):
            if node is target:
                found[0] = found[0] or in_loop
                return
            child_loop = in_loop or isinstance(
                node, (ast.For, ast.While, ast.AsyncFor))
            for c in ast.iter_child_nodes(node):
                visit(c, child_loop)

        visit(fn, False)
        return found[0]

    # -- rule 5: resource lifetime --------------------------------------
    def _lint_resources(self, fn: ast.AST) -> None:
        acquired: Dict[str, Tuple[int, str, Tuple[str, ...]]] = {}
        for stmt in ast.walk(fn):
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                    or not isinstance(stmt.targets[0], ast.Name) \
                    or not isinstance(stmt.value, ast.Call):
                continue
            name = _call_name(stmt.value)
            for ctor, verbs in _RESOURCE_CTORS.items():
                if name == ctor or name.endswith("." + ctor):
                    if ctor in ("threading.Thread", "Thread") and any(
                            kw.arg == "daemon" for kw in
                            stmt.value.keywords):
                        break  # daemon thread: supervised by lifetime
                    acquired[stmt.targets[0].id] = (
                        stmt.lineno, ctor, verbs)
                    break
        if not acquired:
            return
        released: Set[str] = set()
        escaped: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id in acquired:
                    var = f.value.id
                    if f.attr in acquired[var][2]:
                        released.add(var)
                # passed as an argument -> ownership handed off
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Name) \
                                and sub.id in acquired:
                            escaped.add(sub.id)
            elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
                val = getattr(node, "value", None)
                if val is not None:
                    for sub in ast.walk(val):
                        if isinstance(sub, ast.Name) \
                                and sub.id in acquired:
                            escaped.add(sub.id)
            elif isinstance(node, ast.Assign):
                # stored on self/a collection -> tracked elsewhere;
                # `t.daemon = True` -> supervised
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name) and sub.id in acquired:
                        escaped.add(sub.id)
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in acquired \
                            and t.attr == "daemon":
                        released.add(t.value.id)
        for var, (line, ctor, verbs) in acquired.items():
            if var in released or var in escaped:
                continue
            self.emit(
                "resource-lifetime", Severity.WARNING,
                f"{fn.name}(): '{var}' ({ctor}) is acquired but never "
                f"{'/'.join(verbs)}ed and never handed off — the "
                "exception path leaks it",
                line,
                "use a with-statement or try/finally "
                f"{var}.{verbs[0]}() (or store it on a supervisor that "
                "owns shutdown)",
                var=var, ctor=ctor)

    # -- rule 6 support: env reads --------------------------------------
    def _collect_env_reads(self, tree: ast.AST) -> None:
        for node in ast.walk(tree):
            names: List[Tuple[str, int]] = []
            if isinstance(node, ast.Call):
                callee = _call_name(node)
                leaf = callee.rpartition(".")[2].lstrip("_")
                env_call = (leaf in _ENV_READ_FUNCS
                            or ("environ" in callee
                                and leaf in ("get", "setdefault", "pop")))
                if env_call:
                    for arg in node.args[:1]:
                        if isinstance(arg, ast.Constant) \
                                and isinstance(arg.value, str):
                            val = arg.value
                            if leaf == "get_env" \
                                    and not val.startswith("MXNET_") \
                                    and re.match(r"^[A-Z0-9_]+$", val):
                                # base.get_env auto-prefixes short names
                                val = "MXNET_" + val
                            names.append((val, node.lineno))
            elif isinstance(node, ast.Subscript):
                base = _dotted(node.value)
                if "environ" in base and isinstance(node.slice,
                                                    ast.Constant) \
                        and isinstance(node.slice.value, str):
                    names.append((node.slice.value, node.lineno))
            elif isinstance(node, ast.Compare) \
                    and isinstance(node.left, ast.Constant) \
                    and isinstance(node.left.value, str) \
                    and any(isinstance(op, (ast.In, ast.NotIn))
                            for op in node.ops):
                names.append((node.left.value, node.lineno))
            for name, line in names:
                if _ENV_NAME_RE.match(name):
                    self.env_reads.append((name, line))


# ---------------------------------------------------------------------------
# rule 6: bidirectional env-registry drift (repo-level)
# ---------------------------------------------------------------------------

def collect_env_reads(sources: Dict[str, str]
                      ) -> Dict[str, List[Tuple[str, int]]]:
    """``MXNET_*`` env reads per name: ``{name: [(file, line), ...]}``."""
    reads: Dict[str, List[Tuple[str, int]]] = {}
    for fname, src in sources.items():
        m = _ModuleLinter(src, fname)
        if m.tree is None:
            continue
        m._collect_env_reads(m.tree)
        for name, line in m.env_reads:
            reads.setdefault(name, []).append((fname, line))
    return reads


def check_env_registry(sources: Dict[str, str],
                       registry: Optional[Iterable[str]] = None
                       ) -> List[Finding]:
    """Bidirectional drift between ``MXNET_*`` reads in ``sources`` and
    the env registry (``runtime._ENV_REGISTRY`` keys by default; pass an
    explicit iterable in tests). Only runs the dead-row direction when a
    scanned file defines ``_ENV_REGISTRY`` (so single-file lints don't
    declare the whole registry dead)."""
    if registry is None:
        from .. import runtime

        registry = runtime._ENV_REGISTRY.keys()
    full = set(registry)
    reg = {k for k in full if k.startswith("MXNET_")}
    reads = collect_env_reads(sources)
    out: List[Finding] = []
    for name in sorted(set(reads) - reg):
        # base.get_env("DMLC_X") falls back to MXNET_DMLC_X, so a row for
        # the unprefixed name documents the prefixed alias too.
        if name[len("MXNET_"):] in full:
            continue
        for fname, line in reads[name]:
            lines = sources[fname].splitlines()
            if _suppressed(lines, line, "env-registry-drift"):
                out.append(Finding(
                    "env-registry-drift", Severity.INFO,
                    "waived in source (lint: disable)",
                    location=f"{fname}:{line}",
                    details={"waived": True}))
                continue
            out.append(Finding(
                "env-registry-drift", Severity.WARNING,
                f"{name} is read here but has no runtime._ENV_REGISTRY "
                "row (undocumented knob)",
                location=f"{fname}:{line}",
                fix_hint="add a registry row with the default and a "
                         "one-line description (env_list() is the docs "
                         "table)",
                details={"name": name, "direction": "undocumented"}))
    registry_files = [f for f, s in sources.items()
                      if "_ENV_REGISTRY" in s and "runtime" in
                      os.path.basename(f)]
    if registry_files:
        regfile = registry_files[0]
        reglines = sources[regfile].splitlines()
        for name in sorted(reg - set(reads)):
            line = next((i + 1 for i, ln in enumerate(reglines)
                         if f'"{name}"' in ln), 1)
            if _suppressed(reglines, line, "env-registry-drift"):
                out.append(Finding(
                    "env-registry-drift", Severity.INFO,
                    "waived in source (lint: disable)",
                    location=f"{regfile}:{line}",
                    details={"waived": True}))
                continue
            out.append(Finding(
                "env-registry-drift", Severity.WARNING,
                f"registry row {name} has no read anywhere in the "
                "scanned tree (dead knob)",
                location=f"{regfile}:{line}",
                fix_hint="prune the row, or wire the knob back up",
                details={"name": name, "direction": "dead-row"}))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def unwaived(report) -> List[Finding]:
    return [f for f in report if not f.details.get("waived")]


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    """Single-file lint (rule unit tests): rules 1-5. The registry-drift
    rule needs the whole tree — see :func:`lint_paths` /
    :func:`check_env_registry`."""
    m = _ModuleLinter(src, filename)
    m.run()
    return m.findings


def lint_paths(paths: Iterable[str], exclude: Iterable[str] = ()
               ) -> Report:
    """Repo lint: rules 1-5 per file plus the bidirectional env-registry
    drift check over everything scanned."""
    report = Report()
    exclude = tuple(exclude)
    sources: Dict[str, str] = {}
    files: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            files.append(path)
        else:
            for root, _dirs, names in os.walk(path):
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
    for f in sorted(files):
        if any(x in f for x in exclude):
            continue
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        sources[f] = src
        m = _ModuleLinter(src, f)
        m.run()
        report.extend(m.findings)
    report.extend(check_env_registry(sources))
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis dataplane",
        description="Data-plane lint: hot-path copy/sync/allocation "
                    "rules, resource lifetime, env-registry drift.")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories (default: "
                         "mxnet_tpu_torch)")
    ap.add_argument("--exclude", action="append", default=[],
                    help="path substring to skip")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog")
    ap.add_argument("--no-waived", action="store_true",
                    help="hide waived findings from the report")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}: {desc}")
        return 0

    report = lint_paths(args.paths or ["mxnet_tpu_torch"],
                        exclude=args.exclude)
    shown = Report(unwaived(report)) if args.no_waived else report
    print(shown.to_json() if args.json else shown.format())
    bad = unwaived(report)
    if bad:
        print(f"\n{len(bad)} unwaived finding(s) "
              f"({len(report) - len(bad)} waived)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
