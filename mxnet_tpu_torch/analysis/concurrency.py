"""ConcurrencyLinter — static lock/protocol lint for the threaded planes
(counterpart of ``mxnet_tpu/analysis/concurrency.py``, same rule ids).

The reference's worst production bugs were concurrency bugs, not math
bugs (ps-lite's whole design is surviving flaky peers); our serve and PS
planes now hold dozens of locks, condition variables, and daemon threads
with a request/reply wire between them. This pass is the ``analysis/``
family member that watches that code the way GraphLinter watches graphs:
an AST pass over the repo (the ``repo_lint.py`` driving machinery) that
understands ``with self._lock:`` nesting, condition-variable discipline,
thread lifecycle, and the wire-protocol opcode registries.

Rules (see docs/ANALYSIS.md "Concurrency lint" for the catalog):

- ``lock-order-cycle`` (error) — the per-module lock-acquisition graph
  (nesting + same-class interprocedural propagation) contains a cycle:
  some interleaving deadlocks. (Its runtime twin is ``tsan.py``: the
  serve and PS planes' locks record their order live under
  ``MXNET_TSAN=1``.)
- ``blocking-call-under-lock`` (warning) — socket ``recv``/``sendall``/
  ``accept``/``connect``, ``subprocess`` waits, ``time.sleep``,
  ``os.fsync``, device waits (``torch.cuda.synchronize``,
  ``Event.synchronize``; the reference's ``block_until_ready``), wire
  framing helpers
  (``_send_msg``/``_recv_msg``), or a ``Condition``/``Event`` wait while
  holding a (different) lock — one slow peer wedges every thread queued
  on that lock. Propagates one class deep: calling a same-class method
  that blocks counts as blocking.
- ``cv-wait-no-recheck`` (warning) — ``Condition.wait`` outside a
  ``while``-predicate loop: wakeups are spurious and racy by contract.
- ``join-timeout-unchecked`` (warning) — ``t.join(timeout=...)`` whose
  outcome is never checked (``join`` returns ``None``; only
  ``is_alive()`` reveals a leak) in a function that never consults
  ``is_alive``.
- ``thread-fire-and-forget`` (warning) — the chained
  ``threading.Thread(...).start()`` form: the handle is discarded, so
  the thread can never be joined, supervised, or even named in a stack
  dump.
- ``unbounded-wait`` (warning) — argument-less ``Condition.wait()`` /
  ``Event.wait()`` / ``Thread.join()``: no timeout means a lost wakeup
  is a permanent hang instead of a bounded stall.

Protocol rules (driven by the declarative ``mxnet_tpu_torch.wire`` registries,
shared by the serve and PS planes):

- ``opcode-missing-handler`` (error) — a registered request opcode with
  no dispatch branch in its plane's handler.
- ``opcode-unknown-handler`` (error) — a dispatch branch for a constant
  the registry doesn't know (stale/renumbered op).
- ``opcode-duplicate-handler`` (error) — two branches test the same op.
- ``mutating-op-no-dedup`` (error) — a mutating op whose spec declares
  no exactly-once discipline (``seq``/``token``/``idempotent``/``legacy``).
- ``dedup-machinery-missing`` (error) — the spec declares seq-dedup /
  commit-token / WAL coverage but the handler branch (plus the same-class
  methods it calls) never touches that machinery.
- ``trace-propagation-missing`` (error) — the plane's framed receive
  loop never extracts wire trace context (the tracing plane's
  contract).

Waive a deliberate finding with ``# lint: disable=<rule-id>`` on the
offending line (justify nearby); waived findings are still *reported* at
info severity with ``details={"waived": True}`` but never fail the lint.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import Finding, Report, Severity
from .repo_lint import _suppressed

__all__ = ["RULES", "lint_source", "lint_paths", "lint_protocol",
           "check_registry", "unwaived", "main"]

RULES = {
    "lock-order-cycle":
        "lock-acquisition graph has a cycle (deadlockable interleaving)",
    "blocking-call-under-lock":
        "blocking operation (socket/sleep/fsync/device-sync/wait) while "
        "holding a lock",
    "cv-wait-no-recheck":
        "Condition.wait not inside a while-predicate re-check loop",
    "join-timeout-unchecked":
        "join(timeout=...) outcome never checked via is_alive()",
    "thread-fire-and-forget":
        "threading.Thread(...).start() with the handle discarded",
    "unbounded-wait":
        "wait()/join() with no timeout: a lost wakeup hangs forever",
    "opcode-missing-handler":
        "registered opcode has no handler branch",
    "opcode-unknown-handler":
        "handler branch for an unregistered opcode constant",
    "opcode-duplicate-handler":
        "two handler branches test the same opcode",
    "mutating-op-no-dedup":
        "mutating wire op declares no exactly-once discipline",
    "dedup-machinery-missing":
        "declared dedup/WAL machinery absent from the handler branch",
    "trace-propagation-missing":
        "wire receive loop never extracts trace context",
}

# constructor-name -> primitive kind
_LOCK_CTORS = {
    "Lock": "lock", "lock": "lock", "SanLock": "lock",
    "allocate_lock": "lock", "_raw_lock": "lock",
    "RLock": "rlock", "rlock": "rlock", "SanRLock": "rlock",
    "Condition": "condition", "condition": "condition",
    "SanCondition": "condition",
    "Event": "event", "event": "event",
}
_LOCKISH = ("lock", "rlock", "condition")
# attribute names that look like a lock when we cannot resolve the object
# (e.g. ``with self._pool._lock:`` reaching into another class)
_LOCKY_ATTRS = {"_lock", "lock", "_cv", "cv", "_mu", "_cond", "_mutex",
                "_global_lock", "_seq_lock", "_reload_lock"}

# direct blocking operations by attribute name …
# (``synchronize``: the port's device waits, torch.cuda.synchronize and
# Event.synchronize, the counterpart of the reference's block_until_ready)
_BLOCKING_ATTRS = {"recv", "recv_into", "recvfrom", "sendall", "accept",
                   "connect", "communicate", "fsync", "block_until_ready",
                   "synchronize", "sleep", "select"}
# … and by bare/module function name (the wire framing helpers block on
# the socket; create_connection dials)
_BLOCKING_FUNCS = {"sleep", "fsync", "select", "create_connection",
                   "_send_msg", "_recv_msg", "_recv_exact"}


def _ctor_kind(node) -> Optional[str]:
    """Primitive kind if ``node`` is a Lock/RLock/Condition/Event/tsan
    factory call, else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    name = None
    if isinstance(fn, ast.Name):
        name = fn.id
    elif isinstance(fn, ast.Attribute):
        name = fn.attr
    return _LOCK_CTORS.get(name) if name else None


def _is_thread_ctor(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    fn = node.func
    return (isinstance(fn, ast.Name) and fn.id == "Thread") or \
        (isinstance(fn, ast.Attribute) and fn.attr == "Thread")


class _Scope:
    """Lock/thread identity tables for one class (or the module level)."""

    def __init__(self, name: str):
        self.name = name                       # class name or module base
        self.lock_attrs: Dict[str, str] = {}   # attr -> kind
        self.lockdict_attrs: Set[str] = set()  # attrs holding {key: lock}
        self.thread_attrs: Set[str] = set()


class _FuncInfo:
    """Per-function facts feeding the class-level fixpoint."""

    def __init__(self, qualname: str):
        self.qualname = qualname
        self.acquires: Set[str] = set()            # lock idents acquired
        self.blocks: List[Tuple[str, int]] = []    # (description, line)
        # (callee simple name, held idents at call, line, end_line)
        self.calls: List[Tuple[str, Tuple[str, ...], int, int]] = []
        self.has_is_alive = False


class _FuncWalker:
    """Walks one function body tracking the held-lock stack."""

    def __init__(self, module: "_ModuleLinter", scope: _Scope,
                 func: ast.AST, qualname: str):
        self.m = module
        self.scope = scope
        self.func = func
        self.info = _FuncInfo(qualname)
        self.held: List[Tuple[str, str]] = []   # (ident, kind)
        # per-held-cv: how many While loops opened since it was acquired
        self.loops_since: List[int] = []
        self.locals: Dict[str, Tuple[str, str]] = {}  # var -> (ident, kind)
        self.thread_locals: Set[str] = set()
        self.threadlist_locals: Set[str] = set()

    # -- identity resolution -------------------------------------------
    def _resolve(self, node) -> Optional[Tuple[str, str]]:
        """``(ident, kind)`` for an expression that may denote a lock."""
        if isinstance(node, ast.Name):
            if node.id in self.locals:
                return self.locals[node.id]
            mod = self.m.module_scope
            if node.id in mod.lock_attrs:
                return (f"{mod.name}.{node.id}", mod.lock_attrs[node.id])
            return None
        if isinstance(node, ast.Attribute):
            base = node.value
            if isinstance(base, ast.Name) and base.id == "self":
                if node.attr in self.scope.lock_attrs:
                    return (f"{self.scope.name}.{node.attr}",
                            self.scope.lock_attrs[node.attr])
                return None
            # opaque chain (self._pool._lock, el.cv, ...): only treat as a
            # lock when the final attribute *looks* like one
            if node.attr in _LOCKY_ATTRS:
                try:
                    text = ast.unparse(node)
                except Exception:  # noqa: BLE001 — best-effort label
                    text = node.attr
                kind = "condition" if "cv" in node.attr or "cond" in node.attr \
                    else "lock"
                return (f"{self.scope.name}::{text}", kind)
            return None
        if isinstance(node, ast.Subscript):
            base = node.value
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self" \
                    and base.attr in self.scope.lockdict_attrs:
                return (f"{self.scope.name}.{base.attr}[]", "lock")
            return None
        if isinstance(node, ast.Call):
            # self._locks.get(key, default) -> the dict's shared identity
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "get":
                inner = self._resolve_dictish(fn.value)
                if inner is not None:
                    return inner
            return None
        if isinstance(node, ast.IfExp):
            return self._resolve(node.body) or self._resolve(node.orelse)
        return None

    def _resolve_dictish(self, node) -> Optional[Tuple[str, str]]:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" \
                and node.attr in self.scope.lockdict_attrs:
            return (f"{self.scope.name}.{node.attr}[]", "lock")
        return None

    def _is_threadish(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.thread_locals
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr in self.scope.thread_attrs
        return False

    # -- findings -------------------------------------------------------
    def _finding(self, rule: str, severity: str, msg: str, line: int,
                 fix: str, end_line: Optional[int] = None,
                 **details) -> None:
        self.m.emit(rule, severity, msg, line, fix, end_line=end_line,
                    **details)

    def _edge(self, dst: str, line: int) -> None:
        for src, _kind in self.held:
            if src != dst:
                self.m.add_edge(src, dst, line)

    def _block_op(self, desc: str, line: int, exempt_cv: Optional[str] = None,
                  end_line: Optional[int] = None) -> None:
        """A blocking operation happened here: record it for callers and
        flag it if any lock is held (``exempt_cv``: the CV being waited
        on — waiting releases *that* lock, not the others)."""
        self.info.blocks.append((desc, line))
        held = [h for h, _k in self.held if h != exempt_cv]
        if held:
            self._finding(
                "blocking-call-under-lock", Severity.WARNING,
                f"{desc} while holding {held[-1]!r}: every thread queued "
                "on that lock stalls behind this call", line,
                "move the blocking call outside the critical section, or "
                "waive with '# lint: disable=blocking-call-under-lock' "
                "and a justification",
                end_line=end_line, held=list(held))

    # -- traversal ------------------------------------------------------
    def run(self) -> _FuncInfo:
        for stmt in self.func.body:
            self._visit(stmt, loop_depth=0)
        return self.info

    def _visit(self, node, loop_depth: int) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested defs are analyzed as their own functions
        if isinstance(node, ast.With):
            self._visit_with(node, loop_depth)
            return
        if isinstance(node, (ast.While, ast.For)):
            # a While re-evaluates a predicate; count it for the CV rule
            bump = 1 if isinstance(node, ast.While) else 0
            for i in range(len(self.loops_since)):
                self.loops_since[i] += bump
            for child in ast.iter_child_nodes(node):
                self._visit(child, loop_depth + 1)
            if bump:
                for i in range(len(self.loops_since)):
                    self.loops_since[i] -= bump
            return
        if isinstance(node, ast.Assign):
            self._visit_assign(node)
        if isinstance(node, ast.Call):
            self._visit_call(node, loop_depth)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            self._visit(child, loop_depth)

    def _visit_with(self, node: ast.With, loop_depth: int) -> None:
        pushed = 0
        for item in node.items:
            got = self._resolve(item.context_expr)
            if got is not None and got[1] in _LOCKISH:
                ident, kind = got
                self._edge(ident, node.lineno)
                self.info.acquires.add(ident)
                self.held.append((ident, kind))
                self.loops_since.append(0)
                pushed += 1
            elif isinstance(item.context_expr, ast.Call):
                # `with self._conn(m) as cli:` — still a call under the
                # current held set
                self._visit_call(item.context_expr, loop_depth)
        try:
            for stmt in node.body:
                self._visit(stmt, loop_depth)
        finally:
            for _ in range(pushed):
                self.held.pop()
                self.loops_since.pop()

    def _visit_assign(self, node: ast.Assign) -> None:
        kind = _ctor_kind(node.value)
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                if kind is not None:
                    self.locals[tgt.id] = (
                        f"{self.info.qualname}.{tgt.id}", kind)
                elif _is_thread_ctor(node.value):
                    self.thread_locals.add(tgt.id)
                elif isinstance(node.value, ast.ListComp) \
                        and _is_thread_ctor(node.value.elt):
                    self.threadlist_locals.add(tgt.id)
                else:
                    resolved = self._resolve(node.value)
                    if resolved is not None:
                        self.locals[tgt.id] = resolved

    def _visit_call(self, node: ast.Call, loop_depth: int) -> None:
        fn = node.func
        line = node.lineno
        has_timeout = bool(node.args) or any(
            kw.arg == "timeout" for kw in node.keywords)

        if isinstance(fn, ast.Name):
            if fn.id in _BLOCKING_FUNCS:
                self._block_op(f"{fn.id}()", line)
            if fn.id == "is_alive":
                self.info.has_is_alive = True
            # bare call to a module-level function in this file
            if fn.id in self.m.module_funcs:
                self.info.calls.append(
                    (fn.id, tuple(h for h, _k in self.held), line,
                     getattr(node, "end_lineno", line) or line))
            return

        if not isinstance(fn, ast.Attribute):
            return
        attr = fn.attr
        if attr == "is_alive":
            self.info.has_is_alive = True
            return
        if attr == "wait":
            self._visit_wait(node, fn, has_timeout, loop_depth)
            return
        if attr == "join":
            self._visit_join(node, fn, has_timeout)
            return
        if attr == "start" and _is_thread_ctor(fn.value):
            self._finding(
                "thread-fire-and-forget", Severity.WARNING,
                "Thread(...).start() discards the handle: the thread "
                "can never be joined, supervised, or attributed in a "
                "stack dump", line,
                "keep the handle (join it on shutdown), or waive with "
                "'# lint: disable=thread-fire-and-forget' stating who "
                "supervises it",
                end_line=getattr(node, "end_lineno", None))
            return
        if attr in _BLOCKING_ATTRS:
            self._block_op(f".{attr}()", line)
            return
        # same-class method call: feeds interprocedural propagation
        if isinstance(fn.value, ast.Name) and fn.value.id == "self":
            self.info.calls.append(
                (attr, tuple(h for h, _k in self.held), line,
                 getattr(node, "end_lineno", line) or line))

    def _visit_wait(self, node: ast.Call, fn: ast.Attribute,
                    has_timeout: bool, loop_depth: int) -> None:
        line = node.lineno
        target = self._resolve(fn.value)
        if target is not None and target[1] == "condition":
            ident = target[0]
            held_idents = [h for h, _k in self.held]
            if ident in held_idents:
                # waiting on the CV we hold: releases it. Check the
                # predicate-loop discipline …
                idx = held_idents.index(ident)
                if self.loops_since[idx] == 0:
                    if not _suppressed(self.m.lines, line,
                                       "cv-wait-no-recheck"):
                        self._finding(
                            "cv-wait-no-recheck", Severity.WARNING,
                            f"Condition.wait on {ident!r} outside a while-"
                            "predicate loop: wakeups are spurious and racy "
                            "by contract", line,
                            "wrap the wait in 'while not <predicate>:'")
                    else:
                        self.m.emit_waived("cv-wait-no-recheck", line)
                # … and whether any OTHER lock stays held across the wait
                self._block_op(f"Condition.wait on {ident}", line,
                               exempt_cv=ident)
            else:
                self._block_op(f"Condition.wait on {ident}", line)
            if not has_timeout:
                self._unbounded(f"Condition.wait() on {ident!r}", line)
        elif target is not None and target[1] == "event":
            self._block_op(f"Event.wait on {target[0]}", line)
            if not has_timeout:
                self._unbounded(f"Event.wait() on {target[0]!r}", line)
        else:
            # unknown receiver (subprocess handle, queue, foreign object):
            # only the under-lock hazard is knowable
            if self.held:
                self._block_op(".wait()", line)

    def _visit_join(self, node: ast.Call, fn: ast.Attribute,
                    has_timeout: bool) -> None:
        line = node.lineno
        # only receivers provably threads count — `"".join`, `os.path.join`
        # and queue.join must not trip thread rules
        threadish = self._is_threadish(fn.value) or (
            isinstance(fn.value, ast.Name)
            and (fn.value.id in self.threadlist_locals
                 or fn.value.id in self.m.loopvar_threads.get(
                     self.info.qualname, set())))
        if not threadish:
            return
        timeout_kw = any(kw.arg == "timeout" for kw in node.keywords) \
            or bool(node.args)
        self._block_op("Thread.join()", line)
        if not timeout_kw:
            self._unbounded("Thread.join() with no timeout", line)
        else:
            if not _suppressed(self.m.lines, line, "join-timeout-unchecked"):
                self.m.pending_joins.append(
                    (self.info.qualname, line, self))
            else:
                self.m.emit_waived("join-timeout-unchecked", line)

    def _unbounded(self, what: str, line: int) -> None:
        if not _suppressed(self.m.lines, line, "unbounded-wait"):
            self._finding(
                "unbounded-wait", Severity.WARNING,
                f"{what}: a lost wakeup or dead peer hangs this thread "
                "forever", line,
                "pass a timeout and handle expiry (re-check / give up / "
                "escalate)")
        else:
            self.m.emit_waived("unbounded-wait", line)


class _ModuleLinter:
    """One file: identity collection, per-function walks, class-level
    interprocedural fixpoint."""

    def __init__(self, src: str, filename: str):
        self.filename = filename
        self.lines = src.splitlines()
        self.findings: List[Finding] = []
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.tree: Optional[ast.AST] = None
        self.module_scope = _Scope(
            os.path.splitext(os.path.basename(filename))[0])
        self.module_funcs: Set[str] = set()
        self.pending_joins: List[Tuple[str, int, _FuncWalker]] = []
        # qualname -> loop vars known to iterate thread lists
        self.loopvar_threads: Dict[str, Set[str]] = {}
        try:
            self.tree = ast.parse(src, filename=filename)
        except SyntaxError as e:
            self.findings.append(Finding(
                "syntax-error", Severity.ERROR, str(e),
                location=f"{filename}:{e.lineno or 0}"))

    # -- emit helpers ---------------------------------------------------
    def emit(self, rule: str, severity: str, msg: str, line: int,
             fix: str, end_line: Optional[int] = None, **details) -> None:
        # a multi-line statement's waiver may sit on any of its lines
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

    def add_edge(self, src: str, dst: str, line: int) -> None:
        if _suppressed(self.lines, line, "lock-order-cycle"):
            return
        self.edges.setdefault((src, dst), (self.filename, line))

    # -- analysis -------------------------------------------------------
    def run(self) -> None:
        if self.tree is None:
            return
        classes: List[Tuple[_Scope, List[ast.AST]]] = []
        module_fns: List[ast.AST] = []
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                scope = _Scope(node.name)
                methods = [n for n in node.body
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))]
                self._collect_attrs(scope, methods)
                classes.append((scope, methods))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                module_fns.append(node)
                self.module_funcs.add(node.name)
            elif isinstance(node, ast.Assign):
                kind = _ctor_kind(node.value)
                if kind is not None:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            self.module_scope.lock_attrs[tgt.id] = kind

        # module-level functions share a pseudo-scope for self-free lint
        groups: List[Tuple[_Scope, List[ast.AST]]] = list(classes)
        if module_fns:
            groups.append((self.module_scope, module_fns))

        for scope, fns in groups:
            infos: Dict[str, _FuncInfo] = {}
            for fn in fns:
                for sub, qual in self._with_nested(fn, scope.name):
                    self._prescan_thread_loops(sub, qual)
                    infos[qual.split(".")[-1]] = _FuncWalker(
                        self, scope, sub, qual).run()
            self._propagate(scope, infos)

        # join-timeout-unchecked resolves after the walk (needs the whole
        # function's is_alive verdict)
        for qual, line, walker in self.pending_joins:
            if walker.info.has_is_alive:
                continue
            self.emit(
                "join-timeout-unchecked", Severity.WARNING,
                "join(timeout=...) returns None either way; without an "
                "is_alive() check a leaked thread goes unnoticed", line,
                "check t.is_alive() after the join (log/count the leak), "
                "or waive with '# lint: disable=join-timeout-unchecked'")

    def _with_nested(self, fn, prefix: str):
        qual = f"{prefix}.{fn.name}"
        yield fn, qual
        for node in ast.walk(fn):
            if node is not fn and isinstance(node, (ast.FunctionDef,
                                                    ast.AsyncFunctionDef)):
                yield node, f"{qual}.{node.name}"

    def _prescan_thread_loops(self, fn, qual: str) -> None:
        """``for t in threads: t.join(...)`` — learn which loop vars range
        over lists of Thread objects, built either as a listcomp of Thread
        ctors or by appending Thread locals."""
        thread_locals: Set[str] = set()
        thread_lists: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if not isinstance(tgt, ast.Name):
                        continue
                    if _is_thread_ctor(node.value):
                        thread_locals.add(tgt.id)
                    elif isinstance(node.value, ast.ListComp) \
                            and _is_thread_ctor(node.value.elt):
                        thread_lists.add(tgt.id)
        # appends of thread locals into a list also make it a thread list
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "append" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.args and (
                        _is_thread_ctor(node.args[0])
                        or (isinstance(node.args[0], ast.Name)
                            and node.args[0].id in thread_locals)):
                thread_lists.add(node.func.value.id)
        loopvars: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.For) and isinstance(node.iter, ast.Name) \
                    and isinstance(node.target, ast.Name) \
                    and node.iter.id in thread_lists:
                loopvars.add(node.target.id)
        self.loopvar_threads[qual] = loopvars

    def _collect_attrs(self, scope: _Scope, methods) -> None:
        for m in methods:
            for node in ast.walk(m):
                if not isinstance(node, ast.Assign):
                    continue
                kind = _ctor_kind(node.value)
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        if kind is not None:
                            scope.lock_attrs[tgt.attr] = kind
                        elif _is_thread_ctor(node.value):
                            scope.thread_attrs.add(tgt.attr)
                    elif isinstance(tgt, ast.Subscript) and kind is not None:
                        base = tgt.value
                        if isinstance(base, ast.Attribute) \
                                and isinstance(base.value, ast.Name) \
                                and base.value.id == "self":
                            scope.lockdict_attrs.add(base.attr)

    def _propagate(self, scope: _Scope, infos: Dict[str, _FuncInfo]) -> None:
        """Fixpoint: a method's may-acquire/may-block includes its
        same-class callees'. Then call sites under held locks contribute
        edges and blocking findings."""
        may_acquire = {n: set(i.acquires) for n, i in infos.items()}
        may_block = {n: list(i.blocks) for n, i in infos.items()}
        changed = True
        while changed:
            changed = False
            for n, info in infos.items():
                for callee, _held, _line, _end in info.calls:
                    if callee not in infos:
                        continue
                    before = len(may_acquire[n])
                    may_acquire[n] |= may_acquire[callee]
                    if len(may_acquire[n]) != before:
                        changed = True
                    if may_block[callee] and not may_block[n]:
                        may_block[n] = [
                            (f"{callee}() → {may_block[callee][0][0]}",
                             _line)]
                        changed = True
        for n, info in infos.items():
            for callee, held, line, end in info.calls:
                if callee not in infos or not held:
                    continue
                for ident in may_acquire[callee]:
                    if ident in held:
                        continue
                    for h in held:
                        if h != ident:
                            self.add_edge(h, ident, line)
                if may_block[callee]:
                    desc, _bl = may_block[callee][0]
                    self.emit(
                        "blocking-call-under-lock", Severity.WARNING,
                        f"self.{callee}() blocks ({desc}) and is called "
                        f"while holding {held[-1]!r}", line,
                        "restructure so the blocking work happens outside "
                        "the lock, or waive with a justification",
                        end_line=end, held=list(held), via=callee)


# ---------------------------------------------------------------------------
# cycle detection over the merged acquisition graph
# ---------------------------------------------------------------------------

def _cycle_findings(edges: Dict[Tuple[str, str], Tuple[str, int]]
                    ) -> List[Finding]:
    graph: Dict[str, Set[str]] = {}
    for (src, dst) in edges:
        graph.setdefault(src, set()).add(dst)
        graph.setdefault(dst, set())

    # Tarjan SCC, iterative
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(root: str) -> None:
        work = [(root, iter(sorted(graph[root])))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

    for node in sorted(graph):
        if node not in index:
            strongconnect(node)

    out = []
    for comp in sccs:
        comp_set = set(comp)
        cyc_edges = sorted(
            (s, d) for (s, d) in edges
            if s in comp_set and d in comp_set)
        locs = {f"{s}->{d}": f"{edges[(s, d)][0]}:{edges[(s, d)][1]}"
                for s, d in cyc_edges}
        first = edges[cyc_edges[0]]
        out.append(Finding(
            "lock-order-cycle", Severity.ERROR,
            "lock-acquisition cycle over {" + ", ".join(comp) + "}: some "
            "thread interleaving deadlocks",
            location=f"{first[0]}:{first[1]}",
            fix_hint="pick one global order for these locks and acquire "
                     "them in it everywhere (or collapse them into one)",
            details={"locks": comp, "edges": locs}))
    return out


# ---------------------------------------------------------------------------
# protocol pass (reads mxnet_tpu_torch.wire, cross-checks handler ASTs)
# ---------------------------------------------------------------------------

_DEDUP_EVIDENCE = {
    "seq": {"_applied_seq", "_record_seq"},
    "token": {"_committed_tokens", "_telemetry_tokens"},
}
_WAL_EVIDENCE = {"_wal"}


def check_registry(reg) -> List[Finding]:
    """Data-level invariants of one
    :class:`~mxnet_tpu_torch.wire.WireRegistry`."""
    from .. import wire

    out = []
    for op in reg:
        if op.mutating and op.dedup not in wire.DEDUP_KINDS:
            out.append(Finding(
                "mutating-op-no-dedup", Severity.ERROR,
                f"{reg.plane}:{op.name} (code {op.code}) mutates state but "
                f"declares no exactly-once discipline (dedup={op.dedup!r})",
                node=f"{reg.plane}:{op.name}",
                fix_hint="declare dedup='seq'|'token'|'idempotent' (or "
                         "'legacy' for a documented at-least-once op)"))
    return out


def _branch_table(dispatch_fn: ast.AST):
    """``[(const_name, test_line, body)]`` from ``opcode == OP_X``
    dispatch branches."""
    out = []
    for node in ast.walk(dispatch_fn):
        if not isinstance(node, ast.If):
            continue
        t = node.test
        if isinstance(t, ast.Compare) and len(t.ops) == 1 \
                and isinstance(t.ops[0], ast.Eq) \
                and isinstance(t.left, ast.Name) and t.left.id == "opcode" \
                and isinstance(t.comparators[0], ast.Name):
            out.append((t.comparators[0].id, t.lineno, node.body))
    return out


def _find_func(tree: ast.AST, name: str):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def _names_in(nodes) -> Set[str]:
    seen: Set[str] = set()
    for n in nodes:
        for sub in ast.walk(n):
            if isinstance(sub, ast.Attribute):
                seen.add(sub.attr)
            elif isinstance(sub, ast.Name):
                seen.add(sub.id)
    return seen


def check_handlers(reg, src: str, filename: str) -> List[Finding]:
    """Cross-check one registry against its handler module's source."""
    out = list(check_registry(reg))
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError:
        return out  # the per-file lint already reported it
    loop_fn = _find_func(tree, reg.loop_fn)
    # the tracing contract is loop-level (context is stripped before
    # dispatch); it is required iff any op in the registry declares it
    if loop_fn is not None and any(op.traced for op in reg):
        calls = {n.func.attr if isinstance(n.func, ast.Attribute)
                 else getattr(n.func, "id", None)
                 for n in ast.walk(loop_fn) if isinstance(n, ast.Call)}
        if "extract_key" not in calls:
            out.append(Finding(
                "trace-propagation-missing", Severity.ERROR,
                f"{reg.plane} receive loop {reg.loop_fn!r} never extracts "
                "wire trace context: this plane's spans fall out of the "
                "merged timeline",
                location=f"{filename}:{loop_fn.lineno}",
                fix_hint="strip context first: key, wctx = "
                         "obs_context.extract_key(key)"))
    dispatch = _find_func(tree, reg.dispatch_fn)
    if dispatch is None:
        out.append(Finding(
            "opcode-missing-handler", Severity.ERROR,
            f"{reg.plane}: dispatch function {reg.dispatch_fn!r} not found "
            f"in {filename}",
            location=f"{filename}:1",
            fix_hint="keep the registry's handler metadata in sync"))
        return out
    const_map = reg.by_const()
    seen: Dict[str, int] = {}
    bodies: Dict[str, list] = {}
    for const, line, body in _branch_table(dispatch):
        if const not in const_map:
            out.append(Finding(
                "opcode-unknown-handler", Severity.ERROR,
                f"{reg.plane}: handler branch tests {const}, which is not "
                "a registered opcode",
                location=f"{filename}:{line}",
                fix_hint="register the op in mxnet_tpu_torch/wire.py or "
                         "delete the stale branch"))
            continue
        if const in seen:
            out.append(Finding(
                "opcode-duplicate-handler", Severity.ERROR,
                f"{reg.plane}: second handler branch for {const} (first at "
                f"line {seen[const]}): one of them is dead",
                location=f"{filename}:{line}",
                fix_hint="exactly one dispatch branch per opcode"))
            continue
        seen[const] = line
        bodies[const] = body
    # same-class one-level call follow for machinery evidence
    class_methods: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    class_methods.setdefault(m.name, m)
    for op in reg:
        const = op.const_name
        if op.direction != "request":
            continue
        if const not in seen:
            out.append(Finding(
                "opcode-missing-handler", Severity.ERROR,
                f"{reg.plane}:{op.name} (code {op.code}) has no "
                f"'opcode == {const}' branch in {reg.dispatch_fn}",
                location=f"{filename}:{dispatch.lineno}",
                fix_hint="add the dispatch branch (or retire the op from "
                         "the registry)"))
            continue
        needed: Set[str] = set()
        if op.dedup in _DEDUP_EVIDENCE:
            needed |= _DEDUP_EVIDENCE[op.dedup]
        if op.wal:
            needed |= _WAL_EVIDENCE
        if not needed:
            continue
        scan_nodes = list(bodies[const])
        for n in bodies[const]:
            for sub in ast.walk(n):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == "self" \
                        and sub.func.attr in class_methods:
                    scan_nodes.append(class_methods[sub.func.attr])
        present = _names_in(scan_nodes)
        # seq/token evidence: ANY name of the kind's set suffices; wal
        # evidence is its own set
        missing: Set[str] = set()
        if op.dedup in _DEDUP_EVIDENCE \
                and not (present & _DEDUP_EVIDENCE[op.dedup]):
            missing |= _DEDUP_EVIDENCE[op.dedup]
        if op.wal and not (present & _WAL_EVIDENCE):
            missing |= _WAL_EVIDENCE
        if missing:
            out.append(Finding(
                "dedup-machinery-missing", Severity.ERROR,
                f"{reg.plane}:{op.name} declares "
                f"dedup={op.dedup!r}/wal={op.wal} but its handler branch "
                f"never touches {sorted(missing)}",
                location=f"{filename}:{seen[const]}",
                fix_hint="apply the declared exactly-once machinery in "
                         "the branch, or correct the OpSpec"))
    return out


def lint_protocol(files: Dict[str, str]) -> List[Finding]:
    """Run the protocol pass for every registry whose handler module is in
    ``files`` (``{path: source}``)."""
    from .. import wire

    out: List[Finding] = []
    for reg in (wire.PS_WIRE, wire.SERVE_WIRE):
        suffix = reg.handler_path.replace("/", os.sep)
        match = next((p for p in files
                      if os.path.normpath(p).endswith(suffix)), None)
        if match is None:
            continue
        out.extend(check_handlers(reg, files[match], match))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def unwaived(report: Report) -> List[Finding]:
    return [f for f in report if not f.details.get("waived")]


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    """Single-file lint (rule unit tests): per-file rules + a per-file
    cycle detection. Protocol checks need the real tree — see
    :func:`lint_paths`."""
    m = _ModuleLinter(src, filename)
    m.run()
    return m.findings + _cycle_findings(m.edges)


def lint_paths(paths: Iterable[str], exclude: Iterable[str] = ()) -> Report:
    """Repo lint: per-file rules, a GLOBAL lock-order graph (cycles may
    span modules when identities are shared), and the wire-protocol pass
    when a plane's handler module is in scope."""
    report = Report()
    exclude = tuple(exclude)
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
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
        for k, v in m.edges.items():
            edges.setdefault(k, v)
    report.extend(_cycle_findings(edges))
    report.extend(lint_protocol(sources))
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis concurrency",
        description="Concurrency-correctness lint: lock-order cycles, "
                    "blocking-under-lock, CV/thread discipline, and the "
                    "wire-protocol registry checks.")
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
