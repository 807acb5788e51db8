"""The port's repo self-lint (``mxnet_tpu_torch.analysis.repo_lint``) and
``python -m mxnet_tpu_torch.tools.lint_repo`` on the CPU.

Every rule case of ``tests/test_repo_lint.py`` runs again with its
``lint_source`` calls answered by both packages' linters, whose findings
must be equal. The port's tree has no unwaived finding of any of the
three source linters, and the merged command exits 0 over it.
"""
import importlib.util
import os
import subprocess
import sys

import pytest

from mxnet_tpu.analysis import repo_lint as jrl

from mxnet_tpu_torch.analysis import concurrency
from mxnet_tpu_torch.analysis import repo_lint as trl
from mxnet_tpu_torch.tools import lint_repo

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "mxnet_tpu_torch")


def _load_reference_tests(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(findings):
    return sorted((f.rule_id, f.severity, f.location) for f in findings)


_REF = _load_reference_tests("test_repo_lint")
_CASES = sorted(
    name for name, fn in vars(_REF).items()
    if name.startswith("test_") and callable(fn)
    and fn.__code__.co_argcount == 0
    and "lint_source" in fn.__code__.co_names
    and "REPO" not in fn.__code__.co_names)


def _both(src, filename="<string>"):
    ref = jrl.lint_source(src, filename)
    port = trl.lint_source(src, filename)
    assert _key(port) == _key(ref)
    return ref


def test_reference_cases_found():
    assert len(_CASES) >= 5, _CASES


@pytest.mark.parametrize("case", _CASES)
def test_reference_rule_case_matches(case, monkeypatch):
    monkeypatch.setattr(_REF, "lint_source", _both)
    getattr(_REF, case)()


def test_crop_waiver_is_the_reference():
    """The port's ``_crop`` carries the reference's waiver: its x/y are
    host ints by contract, declared as ``ndarray_inputs`` as the
    reference declares them."""
    src = open(os.path.join(PKG, "ops", "image_ops.py")).read()
    assert not trl.lint_source(src)
    stripped = src.replace("  # lint: disable=host-call-in-op", "")
    assert {f.rule_id for f in trl.lint_source(stripped)} == {
        "host-call-in-op"}


def test_port_source_is_clean():
    report = trl.lint_paths([PKG])
    assert not report.findings, report.format()


def test_merged_lint_has_no_unwaived_finding():
    report = lint_repo.lint([PKG])
    bad = concurrency.unwaived(report)
    assert not bad, "\n".join(f.format() for f in bad)
    # the concurrency and data-plane waivers stay inventoried at info
    waived = [f for f in report if f.details.get("waived")]
    assert {f.rule_id for f in waived} >= {
        "blocking-call-under-lock", "thread-fire-and-forget",
        "host-sync-on-hot-path"}


def test_lint_repo_cli_entry(tmp_path, monkeypatch, capsys):
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.lint_repo"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "0 unwaived finding(s)" in proc.stdout
    from mxnet_tpu_torch.analysis.cli import main

    monkeypatch.chdir(REPO)
    assert main(["--self-lint"]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text("try:\n    pass\nexcept:\n    pass\n")
    capsys.readouterr()
    assert lint_repo.main([str(bad)]) == 1
    assert "bare-except" in capsys.readouterr().out
