"""The port's concurrency linter (``mxnet_tpu_torch.analysis.concurrency``)
against the reference's on the CPU.

Every rule case of ``tests/test_concurrency_lint.py`` runs again with its
``lint_source``/``check_handlers``/``check_registry`` calls answered by
both packages' linters, whose findings must be equal (rule, severity,
location, details). The port's additions (its device waits under a lock)
have fixtures of their own; the port's wire registries and handlers, and
its whole tree, lint clean.
"""
import importlib.util
import os
import subprocess
import sys

import pytest

from mxnet_tpu.analysis import concurrency as jconc

from mxnet_tpu_torch import wire
from mxnet_tpu_torch.analysis import concurrency as tconc

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _load_reference_tests(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(findings):
    return sorted((f.rule_id, f.severity, f.location, f.node,
                   repr(sorted(f.details.items()))) for f in findings)


_REF = _load_reference_tests("test_concurrency_lint")
_WRAPPED = ("lint_source", "check_handlers", "check_registry")
# the reference's rule cases: its tests that call a wrapped linter entry
_CASES = sorted(
    name for name, fn in vars(_REF).items()
    if name.startswith("test_") and callable(fn)
    and fn.__code__.co_argcount == 0
    and set(_WRAPPED) & set(fn.__code__.co_names)
    and "REPO" not in fn.__code__.co_names)


def _both(name):
    ref_fn, port_fn = getattr(jconc, name), getattr(tconc, name)

    def call(*args, **kwargs):
        ref = ref_fn(*args, **kwargs)
        port = port_fn(*args, **kwargs)
        assert _key(port) == _key(ref), (
            [f.format() for f in port], [f.format() for f in ref])
        return ref

    return call


def test_reference_cases_found():
    assert len(_CASES) >= 20, _CASES


@pytest.mark.parametrize("case", _CASES)
def test_reference_rule_case_matches(case, monkeypatch):
    for name in _WRAPPED:
        monkeypatch.setattr(_REF, name, _both(name))
    getattr(_REF, case)()


def test_rule_catalog_is_the_reference():
    assert tconc.RULES.keys() == jconc.RULES.keys()


# ---------------------------------------------------------------------------
# the port's additions: device waits count as blocking
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["torch.cuda.synchronize()",
                                  "self._ev.synchronize()"])
def test_device_wait_under_lock_is_blocking(call):
    src = ("import threading, torch\n"
           "class S:\n"
           "    def __init__(self):\n"
           "        self.lk = threading.Lock()\n"
           "        self._ev = torch.cuda.Event()\n"
           "    def f(self):\n"
           "        with self.lk:\n"
           f"            {call}\n")
    found = [f for f in tconc.lint_source(src)
             if f.rule_id == "blocking-call-under-lock"]
    assert len(found) == 1 and ".synchronize()" in found[0].message
    assert "blocking-call-under-lock" not in {
        f.rule_id for f in jconc.lint_source(src)}
    outside = src.replace(f"        with self.lk:\n            {call}\n",
                          f"        {call}\n")
    assert not tconc.lint_source(outside)


def test_device_wait_propagates_through_same_class_call():
    src = ("import threading, torch\n"
           "class S:\n"
           "    def __init__(self):\n"
           "        self.lk = threading.Lock()\n"
           "    def _wait(self):\n"
           "        torch.cuda.synchronize()\n"
           "    def f(self):\n"
           "        with self.lk:\n"
           "            self._wait()\n")
    found = [f for f in tconc.lint_source(src)
             if f.rule_id == "blocking-call-under-lock"]
    assert len(found) == 1 and found[0].details["via"] == "_wait"


# ---------------------------------------------------------------------------
# the port's own registries, handlers and tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reg", [wire.PS_WIRE, wire.SERVE_WIRE],
                         ids=["kvstore", "serve"])
def test_port_registries_and_handlers_clean(reg):
    path = os.path.join(REPO, reg.handler_path)
    with open(path, encoding="utf-8") as fh:
        findings = tconc.check_handlers(reg, fh.read(), path)
    assert not tconc.unwaived(findings), [f.format() for f in findings]


def test_port_tree_lints_clean():
    report = tconc.lint_paths([os.path.join(REPO, "mxnet_tpu_torch")])
    bad = tconc.unwaived(report)
    assert not bad, "\n".join(f.format() for f in bad)
    # the justified waivers stay inventoried (reported, not hidden)
    waived = [f for f in report if f.details.get("waived")]
    assert waived and all(f.severity == "info" for f in waived)


def test_cli_subcommand_over_the_port():
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.analysis", "concurrency",
         "mxnet_tpu_torch", "--no-waived"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
