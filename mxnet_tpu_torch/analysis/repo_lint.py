"""AST-based repo self-lint: framework invariants for ``mxnet_tpu_torch/``
(counterpart of ``mxnet_tpu/analysis/repo_lint.py``, same rules).

The op registry's whole design rests on every registered op being a pure
tensor function (the executor, ``CachedOp`` and the shape pre-flight on
``meta`` tensors all call it). These checks keep that true as the
codebase grows:

- ``op-missing-ndarray-inputs`` (error): every ``@register(...)`` op must
  declare ``ndarray_inputs`` (list of tensor-arg names, or ``"*"`` for
  variadic ops) so symbol binding never guesses from signatures.
- ``host-call-in-op`` (error): no ``np.*``/``float()``/``bool()``/``int()``
  /``.asnumpy()``/``.item()`` applied to a tensor input inside a registered
  op body — each is a silent device->host sync (and fails on a ``meta``
  tensor in the shape pre-flight).
- ``bare-except`` (error): no ``except:`` — it swallows KeyboardInterrupt
  and every real error alike.

Suppress a deliberate violation with ``# lint: disable=<rule-id>`` on the
offending line (document why in a nearby comment).
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional, Set

from .findings import Finding, Report, Severity

__all__ = ["lint_source", "lint_paths", "main"]

# mirror of symbol.symbol._TENSOR_ARGS: kwargs that are tensors by convention
_TENSOR_ARG_NAMES = {
    "data", "weight", "bias", "gamma", "beta", "moving_mean", "moving_var",
    "running_mean", "running_var", "lhs", "rhs", "condition", "x", "y",
    "label", "grad", "indices", "index", "parameters", "state", "state_cell",
    "sequence_length", "mean", "var", "mom", "a", "b", "loss", "value",
    "mask", "anchors", "cls_pred", "loc_pred",
}
_NP_MODULES = {"np", "numpy", "_np", "onp"}
_HOST_BUILTINS = {"float", "bool", "int"}
_HOST_METHODS = {"asnumpy", "item", "tolist"}


def _suppressed(lines: List[str], lineno: int, rule_id: str) -> bool:
    if 1 <= lineno <= len(lines):
        line = lines[lineno - 1]
        if "lint: disable" in line:
            _, _, rest = line.partition("lint: disable")
            rest = rest.strip()
            if not rest.startswith("="):
                return True
            names = rest[1:].split()[0] if rest[1:].split() else ""
            return rule_id in {r.strip() for r in names.split(",")}
    return False


def _register_call(dec) -> Optional[ast.Call]:
    """The ast.Call if a decorator is ``register(...)`` / ``x.register(...)``."""
    if isinstance(dec, ast.Call):
        fn = dec.func
        if isinstance(fn, ast.Name) and fn.id == "register":
            return dec
        if isinstance(fn, ast.Attribute) and fn.attr == "register":
            return dec
    return None


def _tensor_names(fndef: ast.FunctionDef, reg_call: ast.Call) -> Set[str]:
    """Tensor-input names of a registered op, from its declaration."""
    names: Set[str] = set()
    declared = None
    for kw in reg_call.keywords:
        if kw.arg == "ndarray_inputs":
            declared = kw.value
    if isinstance(declared, (ast.List, ast.Tuple)):
        for elt in declared.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                names.add(elt.value)
    elif isinstance(declared, ast.Constant) and declared.value == "*" \
            and fndef.args.vararg is not None:
        names.add(fndef.args.vararg.arg)
    else:  # undeclared: leading positional args without defaults
        args = fndef.args.args
        n_default = len(fndef.args.defaults)
        required = args[:len(args) - n_default] if n_default else args
        names.update(a.arg for a in required)
        if fndef.args.vararg is not None:
            names.add(fndef.args.vararg.arg)
    # tensor-by-convention kwargs (optional tensor inputs like label=None)
    names.update(a.arg for a in fndef.args.args
                 if a.arg in _TENSOR_ARG_NAMES)
    return names


class _OpBodyScanner(ast.NodeVisitor):
    """Flags host calls on tensor inputs inside one registered op body."""

    def __init__(self, tensor_names: Set[str], filename: str,
                 lines: List[str], findings: List[Finding]):
        self.tensor_names = tensor_names
        self.filename = filename
        self.lines = lines
        self.findings = findings

    def _flag(self, node, what):
        if _suppressed(self.lines, node.lineno, "host-call-in-op"):
            return
        self.findings.append(Finding(
            "host-call-in-op", Severity.ERROR,
            f"{what} on a tensor input inside a registered op body: forces "
            "a device->host sync (and fails on a meta tensor)",
            location=f"{self.filename}:{node.lineno}",
            fix_hint="use torch ops on the tensor, or mark the line "
                     "'# lint: disable=host-call-in-op' with justification"))

    def _tensor_arg(self, node) -> bool:
        return isinstance(node, ast.Name) and node.id in self.tensor_names

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _HOST_BUILTINS \
                and node.args and self._tensor_arg(node.args[0]):
            self._flag(node, f"{fn.id}({node.args[0].id})")
        elif isinstance(fn, ast.Attribute):
            if fn.attr in _HOST_METHODS and self._tensor_arg(fn.value):
                self._flag(node, f"{fn.value.id}.{fn.attr}()")
            elif isinstance(fn.value, ast.Name) \
                    and fn.value.id in _NP_MODULES:
                for a in node.args:
                    if self._tensor_arg(a):
                        self._flag(node,
                                   f"{fn.value.id}.{fn.attr}({a.id})")
                        break
        self.generic_visit(node)


def lint_source(src: str, filename: str = "<string>") -> List[Finding]:
    findings: List[Finding] = []
    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        findings.append(Finding(
            "syntax-error", Severity.ERROR, str(e),
            location=f"{filename}:{e.lineno or 0}"))
        return findings

    # does this module use the OP registry's register()? (`.registry`
    # relative inside ops/, or absolute ops.registry — NOT the generic
    # mxnet_tpu_torch.registry used for metrics/initializers)
    uses_op_registry = any(
        isinstance(n, ast.ImportFrom) and n.module
        and (n.module.endswith("ops.registry")
             or (n.module == "registry" and n.level == 1))
        and any(a.name == "register" for a in n.names)
        for n in ast.walk(tree))

    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            if not _suppressed(lines, node.lineno, "bare-except"):
                findings.append(Finding(
                    "bare-except", Severity.ERROR,
                    "bare 'except:' swallows KeyboardInterrupt/SystemExit "
                    "and every real error",
                    location=f"{filename}:{node.lineno}",
                    fix_hint="catch Exception (or the specific error)"))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                reg = _register_call(dec)
                if reg is None or not uses_op_registry:
                    continue
                if not any(kw.arg == "ndarray_inputs"
                           for kw in reg.keywords):
                    if not _suppressed(lines, dec.lineno,
                                       "op-missing-ndarray-inputs"):
                        findings.append(Finding(
                            "op-missing-ndarray-inputs", Severity.ERROR,
                            f"registered op {node.name!r} does not declare "
                            "ndarray_inputs; symbol binding would fall back "
                            "to signature guessing",
                            location=f"{filename}:{dec.lineno}",
                            fix_hint='declare ndarray_inputs=["data", ...] '
                                     '(or "*" for variadic ops)'))
                scanner = _OpBodyScanner(_tensor_names(node, reg),
                                         filename, lines, findings)
                for stmt in node.body:
                    scanner.visit(stmt)
    return findings


def lint_paths(paths: Iterable[str],
               exclude: Iterable[str] = ()) -> Report:
    report = Report()
    exclude = tuple(exclude)
    for path in paths:
        if os.path.isfile(path):
            files = [path]
        else:
            files = []
            for root, _dirs, names in os.walk(path):
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
        for f in sorted(files):
            if any(x in f for x in exclude):
                continue
            with open(f, encoding="utf-8") as fh:
                report.extend(lint_source(fh.read(), filename=f))
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="mxnet_tpu_torch repo self-lint (framework invariants)")
    ap.add_argument("paths", nargs="*", default=["mxnet_tpu_torch"],
                    help="files or directories to lint (default: "
                         "mxnet_tpu_torch)")
    ap.add_argument("--exclude", action="append", default=[],
                    help="path substring to skip")
    ap.add_argument("--json", action="store_true", help="JSON output")
    args = ap.parse_args(argv)
    report = lint_paths(args.paths or ["mxnet_tpu_torch"],
                        exclude=args.exclude)
    print(report.to_json() if args.json else report.format())
    return 1 if report.findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
