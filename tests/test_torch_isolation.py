"""The PyTorch/CUDA port stands alone: ``mxnet_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of the JAX package."""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mxnet_tpu_torch")

_IMPORT_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_REF_PKG = re.compile(r"\bmxnet_tpu(?!_torch)\b")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return sorted(out)


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.serve, "
            "mxnet_tpu_torch.models, mxnet_tpu_torch.ops, "
            "mxnet_tpu_torch.parallel, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.gluon, "
            "mxnet_tpu_torch.tools.launch_cost_probe\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.'))\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "clean"


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_or_reference(path):
    with open(path) as f:
        text = f.read()
    assert not _IMPORT_JAX.search(text), path
    code = "\n".join(line for line in text.splitlines()
                     if re.match(r"\s*(import|from)\s", line))
    assert not _REF_PKG.search(code), path
