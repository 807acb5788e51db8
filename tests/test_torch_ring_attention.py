"""Ring attention of the port (``mxnet_tpu_torch/parallel/ring_attention.py``)
against the JAX package's, on the CPU.

One job of 8 ranks (``tools/launch.py -n 8`` running
``tools/mesh_worker.py``, one process a mesh device, gloo) runs every
mesh case; this process computes the reference's
``sequence_sharded_attention`` on its 8-device CPU mesh from the same
numpy inputs meanwhile. Cases and tolerances are the reference's
(``tests/test_parallel.py:49, 63``, ``tests/test_flash_attention.py:117,
133``) tightened to 2e-5 (outputs) and 1e-4 (gradients): ``sp8``,
``dp2 x sp2 x tp2``, the flash blocks on and off over ``sp4`` (on the CPU
they run the flash kernels' plain versions at the ring's causal
offsets), and the gradients through the lse combine over ``sp2``.

Then, without processes, the flash kernels' plain versions at the ring's
offsets (``+S``: every key visible; ``-S``: every row dead, out 0 and lse
-1e30, gradients 0) with a live lse cotangent, against the reference's
``flash_attention_with_lse`` and its gradient (Pallas in interpret mode
and its blocked backward, as the reference's tests run them).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import parallel as jpar
from mxnet_tpu.ops import flash_attention as jfa
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.tools import mesh_worker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_TOL, GRAD_TOL = 2e-5, 1e-4
JOB_TIMEOUT = 240


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


# (shape, seed) of q, k, v per case; the meshes are mesh_worker.RING_CASES
RING_INPUTS = {"ring_sp8": ((2, 2, 16, 8), 0),
               "ring_dp2sp2tp2": ((2, 2, 8, 4), 1),
               "ring_flash_sp4": ((2, 2, 64, 16), 2),
               "ring_grad_sp2": ((4, 2, 32, 16), 3)}


def run_job(n, scenarios, workdir, inputs, references, env=None):
    """Start ``n`` CPU ranks of ``mesh_worker`` on ``inputs``, compute
    ``references()`` here meanwhile; (the ranks' results, the
    references)."""
    out = os.path.join(workdir, "out")
    proc = mesh_worker.start_job(n, scenarios, out, device="cpu",
                                 inputs=inputs,
                                 env={"JAX_PLATFORMS": "cpu", **(env or {})})
    try:
        refs = references()
    finally:
        results, _log = mesh_worker.job_results(proc, n, scenarios, out,
                                                JOB_TIMEOUT)
    return results, refs


@pytest.fixture(scope="module")
def ring_job(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ring"))
    inputs = {}
    for name, (shape, seed) in RING_INPUTS.items():
        for t, a in zip("qkv", _qkv(shape, seed)):
            inputs[f"{name}/{t}"] = a
    inputs["ring_grad_sp2/cot"] = np.random.RandomState(9).randn(
        *RING_INPUTS["ring_grad_sp2"][0]).astype(np.float32)
    return run_job(8, list(RING_INPUTS), work, inputs,
                   lambda: _references(inputs))


def _references(inputs):
    """The reference's outputs (and gradients) on its 8-device mesh."""
    refs = {}
    devs = jax.devices()
    for name, (axes, causals, flashes) in mesh_worker.RING_CASES.items():
        n = int(np.prod(list(axes.values())))
        mesh = jpar.make_mesh(axes, devices=devs[:n])
        q, k, v = (jnp.asarray(inputs[f"{name}/{t}"]) for t in "qkv")
        for causal in causals:
            for flash in flashes:
                # jitted: the eager shard_map dispatches op by op (~30 s)
                fn = jax.jit(lambda q, k, v, m=mesh, c=causal, f=flash:
                             jpar.sequence_sharded_attention(
                                 q, k, v, m, causal=c, use_flash=f))
                refs[f"{name}/{int(causal)}/{flash}"] = np.asarray(
                    fn(q, k, v))
    mesh = jpar.make_mesh({"dp": 4, "sp": 2}, devices=devs)
    q, k, v = (jnp.asarray(inputs[f"ring_grad_sp2/{t}"]) for t in "qkv")
    cot = jnp.asarray(inputs["ring_grad_sp2/cot"])

    def loss(q, k, v):
        o = jpar.sequence_sharded_attention(q, k, v, mesh, causal=True,
                                            use_flash=True)
        return (o * cot).sum()

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    for t, g in zip("qkv", grads):
        refs[f"ring_grad_sp2/grad/{t}"] = np.asarray(g)
    return refs


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


CASES = [(name, causal, flash)
         for name, (_a, causals, flashes) in mesh_worker.RING_CASES.items()
         for causal in causals for flash in flashes]


@pytest.mark.parametrize("name,causal,flash", CASES,
                         ids=[f"{n}-causal{int(c)}-flash{f}"
                              for n, c, f in CASES])
def test_ring_matches_reference(ring_job, name, causal, flash):
    results, refs = ring_job
    key = f"{int(causal)}/{flash}"
    want = refs[f"{name}/{key}"]
    for r, res in enumerate(results[name]):
        _close(res[f"out/{key}"], want, OUT_TOL)
        # every rank gathers the same global output
        np.testing.assert_array_equal(res[f"out/{key}"],
                                      results[name][0][f"out/{key}"])


@pytest.mark.parametrize("t", ["q", "k", "v"])
def test_ring_flash_grads_match_reference(ring_job, t):
    results, refs = ring_job
    for res in results["ring_grad_sp2"]:
        g = res[f"grad/{t}"]
        assert np.isfinite(g).all()
        _close(g, refs[f"ring_grad_sp2/grad/{t}"], GRAD_TOL)


# ---------------------------------------------------------------------------
# the flash kernels' plain versions at the ring's offsets
# ---------------------------------------------------------------------------

S_RING = 32  # a rank's block of the sequence


@pytest.mark.parametrize("bwd", ["blocked", "pallas"])
@pytest.mark.parametrize("offset", [S_RING, -S_RING, 0],
                         ids=["past_block", "future_block", "diagonal"])
def test_plain_flash_at_ring_offsets_with_lse_cotangent(offset, bwd,
                                                        monkeypatch):
    """out, lse and the gradients of sum(out * w_o) + sum(lse * w_l)
    with a random nonzero lse cotangent, as the ring's combine sends it,
    against the reference's."""
    monkeypatch.setenv("MXNET_FLASH_BWD", bwd)
    shape = (1, 2, S_RING, 16)
    arrs = _qkv(shape, seed=11)
    rng = np.random.RandomState(12)
    w_o = rng.randn(*shape).astype(np.float32)
    w_l = rng.randn(*shape[:3]).astype(np.float32)

    def fl(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, causal=True,
                                            offset=offset, block_q=16,
                                            block_k=16)

    out, lse = fl(*map(jnp.asarray, arrs))
    want = jax.grad(lambda *a: (fl(*a)[0] * w_o).sum()
                    + (fl(*a)[1] * w_l).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    monkeypatch.setenv("MXNET_FLASH_BWD", "auto")
    q, k, v = [torch.from_numpy(a.copy()).requires_grad_() for a in arrs]
    got_o, got_l = tfa.flash_attention_with_lse(q, k, v, causal=True,
                                                offset=offset, block_q=16,
                                                block_k=16)
    _close(got_o.detach().numpy(), out, OUT_TOL)
    dead = np.asarray(lse) <= -1e29
    np.testing.assert_array_equal(got_l.detach().numpy() <= -1e29, dead)
    _close(got_l.detach().numpy()[~dead], np.asarray(lse)[~dead], OUT_TOL)
    if offset < 0:  # a block wholly in the future: every row dead
        assert dead.all()
        assert not got_o.detach().numpy().any()
    ((got_o * torch.from_numpy(w_o)).sum()
     + (got_l * torch.from_numpy(w_l)).sum()).backward()
    for t, w in zip((q, k, v), want):
        g = t.grad.numpy()
        assert np.isfinite(g).all()
        _close(g, w, 5e-4)
        if offset < 0:
            assert not g.any()
