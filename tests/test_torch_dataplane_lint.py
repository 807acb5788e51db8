"""The port's data-plane linter (``mxnet_tpu_torch.analysis.dataplane``)
against the reference's on the CPU.

Every rule case of ``tests/test_dataplane_lint.py`` runs again with its
``lint_source``/``check_env_registry``/``collect_env_reads`` calls
answered by both packages' linters, whose results must be equal. The
port's additional device-to-host points (``synchronize``, ``.item()``,
``.tolist()``, ``host_array``) have fixtures of their own; every hot root
resolves to a method of the port's tree; the env-registry drift rule runs
both ways against the port's ``runtime._ENV_REGISTRY``; the port's tree
lints clean.
"""
import ast
import importlib.util
import os
import subprocess
import sys

import pytest

from mxnet_tpu.analysis import dataplane as jdp

from mxnet_tpu_torch import runtime
from mxnet_tpu_torch.analysis import dataplane as tdp

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PKG = os.path.join(REPO, "mxnet_tpu_torch")


def _load_reference_tests(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _key(result):
    if isinstance(result, dict):  # collect_env_reads
        return result
    return sorted((f.rule_id, f.severity, f.location,
                   repr(sorted(f.details.items()))) for f in result)


_REF = _load_reference_tests("test_dataplane_lint")
_WRAPPED = ("lint_source", "check_env_registry", "collect_env_reads")
_CASES = sorted(
    name for name, fn in vars(_REF).items()
    if name.startswith("test_") and callable(fn)
    and fn.__code__.co_argcount == 0
    and set(_WRAPPED) & set(fn.__code__.co_names)
    and "REPO" not in fn.__code__.co_names)


def _both(name):
    ref_fn, port_fn = getattr(jdp, name), getattr(tdp, name)

    def call(*args, **kwargs):
        ref = ref_fn(*args, **kwargs)
        port = port_fn(*args, **kwargs)
        assert _key(port) == _key(ref)
        return ref

    return call


def test_reference_cases_found():
    assert len(_CASES) >= 20, _CASES


@pytest.mark.parametrize("case", _CASES)
def test_reference_rule_case_matches(case, monkeypatch):
    for name in _WRAPPED:
        monkeypatch.setattr(_REF, name, _both(name))
    getattr(_REF, case)()


def test_rules_and_hot_roots_are_the_reference():
    assert tdp.RULES.keys() == jdp.RULES.keys()
    assert tdp.HOT_ROOTS == jdp.HOT_ROOTS


# ---------------------------------------------------------------------------
# the port's additional device-to-host points
# ---------------------------------------------------------------------------

_HOT = ("class InferenceEngine:\n"
        "    def infer(self, x):\n"
        "        return self._run(x)\n"
        "    def _run(self, x):\n"
        "        {stmt}\n")


@pytest.mark.parametrize("stmt,sync", [
    ("torch.cuda.synchronize()", "synchronize"),
    ("return x.sum().item()", "item"),
    ("return x.tolist()", "tolist"),
    ("return host_array(x)", "host_array"),
    ("return serialization.host_array(x)", "host_array"),
])
def test_port_sync_points_on_hot_path(stmt, sync):
    src = _HOT.format(stmt=stmt)
    found = [f for f in tdp.lint_source(src)
             if f.rule_id == "host-sync-on-hot-path"]
    assert [f.details["sync"] for f in found] == [sync]
    assert found[0].details["root"] == "InferenceEngine.infer"
    assert not [f for f in jdp.lint_source(src)
                if f.rule_id == "host-sync-on-hot-path"]
    # off the hot path it is no finding
    cold = src.replace("InferenceEngine", "Helper")
    assert not tdp.lint_source(cold)
    # a justified waiver keeps it inventoried at info severity
    waived = tdp.lint_source(src.rstrip("\n")
                             + "  # lint: disable=host-sync-on-hot-path\n")
    assert [(f.severity, f.details.get("waived")) for f in waived] == [
        ("info", True)]


# ---------------------------------------------------------------------------
# the port's tree: hot roots resolve, registry both ways, clean
# ---------------------------------------------------------------------------

def _port_sources():
    out = {}
    for root, _dirs, names in os.walk(PKG):
        for n in names:
            if n.endswith(".py"):
                p = os.path.join(root, n)
                with open(p, encoding="utf-8") as fh:
                    out[p] = fh.read()
    return out


def test_every_hot_root_resolves_in_the_port():
    """Each (class, method) is defined by the class or a base of it (the
    fleet front's ``_handle_one`` is its ServeServer base's, as in the
    reference)."""
    methods, bases = {}, {}
    for src in _port_sources().values():
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.ClassDef):
                methods.setdefault(node.name, set()).update(
                    m.name for m in node.body
                    if isinstance(m, ast.FunctionDef))
                bases.setdefault(node.name, []).extend(
                    b.id if isinstance(b, ast.Name) else b.attr
                    for b in node.bases
                    if isinstance(b, (ast.Name, ast.Attribute)))

    def defines(cls, meth):
        return meth in methods.get(cls, ()) or any(
            defines(b, meth) for b in bases.get(cls, ()))

    missing = {r for r in tdp.HOT_ROOTS if not defines(*r)}
    assert not missing, missing


def test_env_registry_matches_the_port_reads_both_ways():
    sources = _port_sources()
    reads = tdp.collect_env_reads(sources)
    rows = {k for k in runtime._ENV_REGISTRY if k.startswith("MXNET_")}
    undocumented = {n for n in reads if n not in rows
                    and n[len("MXNET_"):] not in runtime._ENV_REGISTRY}
    assert not undocumented, sorted(undocumented)
    assert not rows - set(reads), sorted(rows - set(reads))
    assert {"MXNET_MESH_LM", "MXNET_GRAPH_LINT"} <= rows
    assert not tdp.unwaived(tdp.check_env_registry(sources))
    # both directions fire against the port's registry
    extra = dict(sources)
    extra["x/new.py"] = "import os\nv = os.environ.get('MXNET_NEW_KNOB')\n"
    got = {(f.details.get("direction"), f.details.get("name"))
           for f in tdp.check_env_registry(extra)}
    assert got == {("undocumented", "MXNET_NEW_KNOB")}
    dropped = {p: s for p, s in sources.items()
               if not p.endswith(os.path.join("tools", "mesh_worker.py"))}
    got = {(f.details.get("direction"), f.details.get("name"))
           for f in tdp.check_env_registry(dropped)}
    assert got == {("dead-row", "MXNET_MESH_LM")}


def test_port_tree_lints_clean():
    report = tdp.lint_paths([PKG])
    bad = tdp.unwaived(report)
    assert not bad, "\n".join(f.format() for f in bad)
    assert any(f.details.get("waived") for f in report)


def test_cli_subcommand_over_the_port():
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.analysis", "dataplane",
         "mxnet_tpu_torch", "--no-waived"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
