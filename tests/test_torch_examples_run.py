"""The port's copies of the reference's examples (``example_torch/``) trained
for real on the CPU: the six cases of ``tests/test_examples_run.py`` with
the same arguments and log regexes plus ``--device cpu``, each script's own
main path in a subprocess, a finite loss read from its own output. BERT on
``dp=2,sp=2,tp=2`` starts its own 8 gloo ranks, and its printed step
losses equal a ``dp=1`` run's at the mesh tests' rtol 1e-4."""
import math
import os
import re
import subprocess
import sys

import pytest
import torch

from test_examples_run import CASES as REF_CASES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 560
LOSS_RE = r"step \d+ loss ([\d.eE+-]+|nan|inf)"

CASES = [(name, script.replace("example/", "example_torch/", 1),
          args + ["--device", "cpu"], loss_re)
         for name, script, args, loss_re in REF_CASES]


def _run(script, args):
    env = dict(os.environ)
    for var in ("DMLC_NUM_WORKER", "DMLC_WORKER_ID", "MXNET_COORDINATOR"):
        env.pop(var, None)
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, script)] + args,
        capture_output=True, text=True, timeout=TIMEOUT, env=env, cwd="/")


def _losses(r, script, loss_re):
    assert r.returncode == 0, f"{script} rc={r.returncode}:\n{r.stderr[-2000:]}"
    text = r.stdout + r.stderr
    matches = re.findall(loss_re, text)
    assert matches, (f"{script}: no loss line matching {loss_re!r} in "
                     f"output:\n{text[-2000:]}")
    return [float(m) for m in matches]


_MEMO = {}


def _run_once(name, script, args):
    """The bert_mesh8 job serves two cases: run it once per session."""
    if name not in _MEMO:
        _MEMO[name] = _run(script, args)
    return _MEMO[name]


def test_cases_are_the_reference_cases():
    assert [c[0] for c in CASES] == [c[0] for c in REF_CASES] == [
        "bert", "bert_mesh8", "word_lm", "transformer", "ssd",
        "imagenet_module"]
    for (_n, script, args, _re), (_rn, rscript, rargs, _rre) in zip(
            CASES, REF_CASES):
        assert os.path.isfile(os.path.join(ROOT, script))
        assert args[:-2] == rargs and script[len("example_torch"):] == \
            rscript[len("example"):]


@pytest.mark.parametrize("name,script,args,loss_re",
                         CASES, ids=[c[0] for c in CASES])
def test_example_trains_a_step(name, script, args, loss_re):
    r = _run_once(name, script, args)
    val = _losses(r, script, loss_re)[-1]
    assert math.isfinite(val), f"{script}: non-finite loss {val}"


def test_bert_mesh8_step_losses_equal_dp1():
    name, script, args, loss_re = CASES[1]
    assert "dp=2,sp=2,tp=2" in args and args[args.index("--batch-size")
                                              + 1] == "8"
    mesh = _losses(_run_once(name, script, args), script, loss_re)
    one = list(args)
    one[one.index("--mesh") + 1] = "dp=1"
    dp1 = _losses(_run(script, one), script, loss_re)
    assert len(mesh) == len(dp1) == 2
    for a, b in zip(mesh, dp1):
        assert math.isclose(a, b, rel_tol=1e-4), (mesh, dp1)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    _name, script, args, _re = CASES[3]
    r = _run(script, args[:-2])
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not re.findall(LOSS_RE, r.stdout)
