"""The reference's TransformerLM model code (``tools/nd_lm.py``, its
``hybrid_forward`` bodies written once against an ``F`` namespace)
trained one imperative step through both packages: the same seeded
weights and tokens, ``with autograd.record(): loss = ...;
loss.backward()``, at 2 layers, 32 units, 4 heads, S 16. With
``MXNET_ATTENTION_IMPL=flash`` the reference runs its Pallas kernels as
tests/test_flash_attention.py runs them on the CPU (interpret mode;
``MXNET_FLASH_BWD=pallas`` for the backward too) and the port its plain
flash versions. Loss to rtol 1e-5; every gradient to 1e-4 of its
parameter's largest reference gradient (f32 sums taken in other orders,
the flash tiles' among them)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray.ndarray import invoke_fn as jinvoke_fn
from mxnet_tpu.ops.attention import fused_attention as jattention
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.ndarray.ndarray import invoke_fn as tinvoke_fn
from mxnet_tpu_torch.ops.attention import fused_attention as tattention
from mxnet_tpu_torch.tools import nd_lm

torch.set_num_threads(1)

CFG = {"vocab": 97, "units": 32, "heads": 4, "head_dim": 8, "layers": 2,
       "max_length": 16}
HIDDEN, BATCH, SEQ = 64, 2, 16


def _params(seed):
    rng = np.random.RandomState(seed)
    u, v = CFG["units"], CFG["vocab"]

    def w(*shape):
        return rng.uniform(-0.3, 0.3, shape).astype(np.float32)

    layer = dict(qkv_w=(3 * u, u), qkv_b=(3 * u,), proj_w=(u, u),
                 proj_b=(u,), ln1_g=(u,), ln1_b=(u,), ffn1_w=(HIDDEN, u),
                 ffn1_b=(HIDDEN,), ffn2_w=(u, HIDDEN), ffn2_b=(u,),
                 ln2_g=(u,), ln2_b=(u,))
    return {"embed": w(v, u), "pos": w(CFG["max_length"], u),
            "final_g": 1 + w(u), "final_b": w(u), "dec_w": w(v, u),
            "dec_b": w(v),
            "layers": [{k: w(*s) for k, s in layer.items()}
                       for _ in range(CFG["layers"])]}


def _step(nd, autograd, invoke_fn, attention, params, tokens):
    """One recorded loss and backward; (loss, {name: grad})."""
    arrays = {k: nd.array(v) for k, v in params.items() if k != "layers"}
    arrays["layers"] = [{k: nd.array(v) for k, v in lp.items()}
                        for lp in params["layers"]]
    flat = nd_lm.flat_params(arrays)
    for _, a in flat:
        a.attach_grad()
    x = nd.array(tokens, dtype="int32")
    with autograd.record():
        loss = nd_lm.lm_loss(nd, invoke_fn, attention, arrays, x, x,
                             heads=CFG["heads"])
    loss.backward()
    return float(loss.asscalar()), {n: a.grad.asnumpy() for n, a in flat}


def _ref_step(params, tokens, monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_BWD", "pallas")
    with jmx.cpu():
        out = _step(jnd, jag, jinvoke_fn, jattention, params, tokens)
    monkeypatch.delenv("MXNET_FLASH_BWD")
    return out


def _port_step(params, tokens):
    with tmx.cpu():
        return _step(tnd, tag, tinvoke_fn, tattention, params, tokens)


def _tokens(seed):
    return np.random.RandomState(seed).randint(0, CFG["vocab"],
                                               (BATCH, SEQ))


@pytest.mark.parametrize("impl", ["flash", "plain"])
def test_nd_lm_step_matches_reference(impl, monkeypatch):
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", impl)
    params, tokens = _params(0), _tokens(1)
    want_loss, want = _ref_step(params, tokens, monkeypatch)
    got_loss, got = _port_step(params, tokens)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert set(got) == set(want) and len(got) == 6 + 12 * CFG["layers"]
    for name, g in got.items():
        r = want[name]
        bound = 1e-4 * np.abs(r).max() + 1e-7
        assert np.abs(g - r).max() <= bound, (name, np.abs(g - r).max(),
                                              bound)


def test_nd_lm_matches_the_module_path(monkeypatch):
    """The imperative path and the plain-tensor oracle (``lm_prefill``,
    the training forward with dense attention, plus torch.autograd on
    leaf tensors) agree on the same weights: the check chip_smoke.py's
    nd_path phase makes at full width on the card."""
    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    params, tokens = _params(2), _tokens(3)
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in params.items() if k != "layers"}
    leaves["layers"] = [{k: torch.from_numpy(v).requires_grad_()
                         for k, v in lp.items()} for lp in params["layers"]]
    x = torch.from_numpy(tokens)
    logits, _k, _v = tt.lm_prefill(CFG, leaves, x)
    ref = -torch.log_softmax(logits, -1).gather(-1, x[..., None]).mean()
    ref.backward()
    got_loss, got = _port_step(params, tokens)
    np.testing.assert_allclose(got_loss, ref.item(), rtol=1e-6)
    mine = dict(nd_lm.flat_params(leaves))
    assert set(got) == set(mine)
    for name, g in got.items():
        r = mine[name].grad.numpy()
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max() + 1e-8, name


def test_sgd_loop_lowers_the_loss():
    """The classic imperative loop: record, backward, then
    nd.sgd_update(w, g, out=w) per parameter; the loss falls and the
    update rebinds each array (a new tensor, still an attached leaf)."""
    params, tokens = _params(4), _tokens(5)
    with tmx.cpu():
        arrays = {k: tnd.array(v) for k, v in params.items()
                  if k != "layers"}
        arrays["layers"] = [{k: tnd.array(v) for k, v in lp.items()}
                            for lp in params["layers"]]
        flat = nd_lm.flat_params(arrays)
        for _, a in flat:
            a.attach_grad()
        x = tnd.array(tokens, dtype="int32")
        losses = []
        for _ in range(3):
            with tag.record():
                loss = nd_lm.lm_loss(tnd, tinvoke_fn, tattention, arrays, x,
                                     x, heads=CFG["heads"])
            loss.backward()
            losses.append(float(loss.asscalar()))
            before = flat[0][1].astorch()
            for _, a in flat:
                tnd.sgd_update(a, a.grad, out=a, lr=0.5)
            assert flat[0][1].astorch() is not before
            assert flat[0][1].astorch().requires_grad
    assert losses[2] < losses[1] < losses[0], losses
