"""The op consistency sweep (``mxnet_tpu_torch/tools/check_consistency.py``)
against the reference's (``tools/check_tpu_consistency.py``): the same 278
cases by (group, name), the same inputs and tolerances, ``--self-check``
passing, and every forward and gradient case giving the same CPU result in
both packages at that case's own tolerance (one test per case)."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu
import mxnet_tpu_torch
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import test_utils as ttu
from mxnet_tpu_torch.tools import check_consistency as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "check_tpu_consistency",
        os.path.join(ROOT, "tools", "check_tpu_consistency.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference_tool()


def _tables(mod):
    """A module's forward and gradient cases, drawn as its ``main`` draws
    them: one ``RandomState(0)``, forward cases first."""
    rng = np.random.RandomState(0)
    return mod._cases(rng), mod._grad_cases(rng)


REF_FWD, REF_GRAD = _tables(ref)
PORT_FWD, PORT_GRAD = _tables(port)
CASES = ([("forward", i) for i in range(len(PORT_FWD))]
         + [("grad", i) for i in range(len(PORT_GRAD))])


def _ids():
    return [f"{kind}-{PORT_FWD[i][0] if kind == 'forward' else PORT_GRAD[i][0]}"
            f"-{PORT_FWD[i][1] if kind == 'forward' else PORT_GRAD[i][1]}"
            for kind, i in CASES]


def _names(fwd, grad, random_cases, flash_name):
    return ([(g, n) for g, n, *_ in fwd] + [(g, n) for g, n, *_ in grad]
            + [("grad_flash", flash_name)]
            + [(g, n) for g, n, _d in random_cases])


def test_case_list_equals_the_reference():
    want = _names(REF_FWD, REF_GRAD, ref._random_cases(),
                  "pallas_bwd_vs_plain_cpu")
    got = _names(PORT_FWD, PORT_GRAD, port._random_cases(),
                 "pallas_bwd_vs_plain_cpu")
    assert got == want
    assert len(got) == 278
    assert (len(PORT_FWD), len(PORT_GRAD)) == (189, 84)


def _sweep(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.check_consistency",
         *args], capture_output=True, text=True, timeout=300, env=env,
        cwd="/")


def test_self_check_passes_every_case(tmp_path):
    out = str(tmp_path / "sweep.json")
    r = _sweep("--self-check", "--json", out)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    doc = json.load(open(out))
    assert doc["n_cases"] == doc["n_ok"] == 278
    assert {"grad_flash", "random", "nn", "grad_bf16"} <= \
        set(doc["worst_by_group"])
    assert "278/278 ops consistent" in r.stdout


def test_empty_selection_exits_2():
    r = _sweep("--self-check", "--ops", "no_such_group")
    assert r.returncode == 2
    assert "no cases matched" in r.stdout


def test_without_a_card_exits_naming_the_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists")
    r = _sweep("--ops", "nn")
    assert r.returncode != 0
    err = json.loads(r.stdout.strip().splitlines()[-1])
    assert err["error"] == "platform_init_failed"
    assert err["what"] == "cuda.devices"
    assert "OK " not in r.stdout


def test_moments_bound_is_six_standard_errors():
    x = np.random.RandomState(0).standard_normal(100_000)
    mean_b, var_b = port._moments_bound(x)
    np.testing.assert_allclose(mean_b, 6 * np.sqrt(2 / 1e5), rtol=1e-2)
    # a normal sample's fourth central moment is 3 var^2
    np.testing.assert_allclose(var_b, 6 * np.sqrt(2 * 2 / 1e5), rtol=3e-2)


def _forward(pkg, tu, fn, inputs, dt):
    ctx = pkg.cpu()
    with ctx:
        args = [pkg.nd.array(tu._np(x), ctx=ctx, dtype=dt) for x in inputs]
        return tu._np(fn(pkg.nd, *args)).astype(np.float32)


def _grad(pkg, tu, fn, inputs, dtype, wrt):
    """Forward and input gradients under the sweep's fixed cotangent, as
    ``check_grad_consistency`` computes them on one context."""
    ctx = pkg.cpu()
    with ctx:
        args = [pkg.nd.array(tu._np(x), ctx=ctx, dtype=dtype)
                for x in inputs]
        idx = list(wrt) if wrt is not None else list(range(len(args)))
        for i in idx:
            args[i].attach_grad()
        with pkg.autograd.record():
            out = fn(pkg.nd, *args)
            if isinstance(out, (list, tuple)):
                out = out[0]
            cot = np.linspace(0.5, 1.5, int(np.prod(out.shape or (1,)))) \
                .reshape(out.shape).astype(np.float32)
            loss = (out.astype("float32") * pkg.nd.array(cot, ctx=ctx)).sum()
        loss.backward()
        return [tu._np(out)] + [
            None if args[i].grad is None else tu._np(args[i].grad)
            for i in idx]


@pytest.mark.parametrize("kind,i", CASES, ids=_ids())
def test_case_matches_the_reference_on_the_cpu(kind, i):
    rg, rn, rfn, rinputs, rkw = (REF_FWD if kind == "forward"
                                 else REF_GRAD)[i]
    g, n, fn, inputs, kw = (PORT_FWD if kind == "forward" else PORT_GRAD)[i]
    assert (g, n, kw) == (rg, rn, rkw)
    assert len(inputs) == len(rinputs)
    for a, b in zip(inputs, rinputs):
        np.testing.assert_array_equal(a, b)
    if kind == "forward":
        for dt in kw.get("dtypes", ("float32",)):
            low = dt in ("float16", "bfloat16")
            rt = kw.get("rtol", 1e-2 if low else 1e-4)
            at = kw.get("atol", 1e-2 if low else 1e-5)
            want = _forward(mxnet_tpu, jtu, rfn, rinputs, dt)
            got = _forward(mxnet_tpu_torch, ttu, fn, inputs, dt)
            np.testing.assert_allclose(got, want, rtol=rt, atol=at)
        return
    dtype = kw.get("dtype", "float32")
    low = dtype in ("float16", "bfloat16")
    rt = kw.get("rtol", 1e-2 if low else 1e-3)
    at = kw.get("atol", 1e-2 if low else 1e-4)
    want = _grad(mxnet_tpu, jtu, rfn, rinputs, dtype, kw.get("wrt"))
    got = _grad(mxnet_tpu_torch, ttu, fn, inputs, dtype, kw.get("wrt"))
    for j, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), j
        if a is not None:
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32), rtol=rt,
                                       atol=at, err_msg=f"output {j}")
