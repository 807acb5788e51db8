"""The port's optimizers (mxnet_tpu_torch.optimizer: the 16 optimizers,
Updater, the multi-tensor engine, the lr schedulers) and update ops
against the JAX package, on the CPU; the mirror of
tests/test_fused_update.py:98-233.

Both packages get the same numpy weights and gradients. The port runs
its multi-tensor engine and its per-parameter eager oracle
(``MXNET_FUSED_UPDATE=0``); each is held against the reference's
``Updater`` at the reference's own differential tolerances (f32: rtol
5e-6 on weights; 5e-5 on states; bf16 weights with f32 master copies:
the master copies at the f32 tolerances, the weights bitwise).
SGLD adds noise from each package's own stream: the port's two paths
draw the same numbers and agree; against the reference the noise is
held by distribution.
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.amp import LossScaler as JLossScaler
from mxnet_tpu.ndarray import NDArray as JND
from mxnet_tpu.optimizer import lr_scheduler as jsched
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.amp import LossScaler as TLossScaler
from mxnet_tpu_torch.ndarray import NDArray as TND
from mxnet_tpu_torch.optimizer import lr_scheduler as tsched

torch.set_num_threads(1)

SHAPES = [(5, 4), (3,), (2, 3, 2)]
NAMES = sorted(topt.optimizer._REGISTRY)

# non-default knobs so that the stateful and bounded branches run
SPECIAL_KWARGS = {
    "sgd": {"momentum": 0.9, "wd": 0.01},
    "nag": {"momentum": 0.9},
    "signum": {"momentum": 0.9, "wd_lh": 0.001},
    "adamw": {"wd": 0.01},
    "lamb": {"lower_bound": 0.01, "upper_bound": 10.0},
    "rmsprop": {"centered": True},
    "dcasgd": {"momentum": 0.5},
    "lars": {"wd": 0.001},
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _env(fused):
    prev = os.environ.get("MXNET_FUSED_UPDATE")
    os.environ["MXNET_FUSED_UPDATE"] = "1" if fused else "0"
    return prev


def _restore(prev):
    if prev is None:
        os.environ.pop("MXNET_FUSED_UPDATE", None)
    else:
        os.environ["MXNET_FUSED_UPDATE"] = prev


def _run(pkg, name, kwargs, fused=True, steps=3, dtype="float32",
         multi_precision=False, lr_mult=None, scheduler=False):
    """The reference's _run_updater, through ``pkg`` (``jmx`` or
    ``tmx``): (weights, flat states, updater)."""
    prev = _env(fused)
    try:
        pkg.random.seed(11)
        kw = dict(kwargs)
        if scheduler:
            kw["lr_scheduler"] = pkg.optimizer.lr_scheduler.FactorScheduler(
                step=1, factor=0.9)
        opt = pkg.optimizer.create(name, rescale_grad=1.0 / 8,
                                   multi_precision=multi_precision, **kw)
        if lr_mult:
            opt.set_lr_mult(lr_mult)
        up = pkg.optimizer.Updater(opt)
        rng = np.random.RandomState(42)
        cls = JND if pkg is jmx else TND
        ws = [cls(rng.randn(*s).astype(np.float32), dtype=dtype)
              for s in SHAPES]
        idx = list(range(len(ws)))
        for _ in range(steps):
            gs = [cls(rng.randn(*s).astype(np.float32), dtype=dtype)
                  for s in SHAPES]
            up.update_batch(idx, gs, ws)
        flat = []
        for i in idx:
            _flat(up.states[i], flat)
        return ([w.asnumpy().astype(np.float32) for w in ws], flat, up)
    finally:
        _restore(prev)


def _flat(s, out):
    if s is None:
        return
    if isinstance(s, tuple):
        for x in s:
            _flat(x, out)
    else:
        out.append(s.asnumpy().astype(np.float32))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_reference(name, fused):
    """Every optimizer, three steps through Updater.update_batch, against
    the reference's Updater: weights, states and counters."""
    kw = SPECIAL_KWARGS.get(name, {})
    want_w, want_s, want_up = _run(jmx, name, kw)
    got_w, got_s, got_up = _run(tmx, name, kw, fused=fused)
    eng = got_up._engine
    if fused:
        assert eng is not None and eng.exec_count == 3, name
    else:
        assert eng is None
    if name == "sgld":
        # same stream in both port paths; against the reference, 3 draws
        # of N(0, lr = 0.01) per element and package: std sqrt(0.06)
        other_w, _, _ = _run(tmx, name, kw, fused=not fused)
        for a, b in zip(got_w, other_w):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        diff = np.concatenate([(a - b).ravel()
                               for a, b in zip(got_w, want_w)])
        assert 0.12 < diff.std() < 0.40 and abs(diff.mean()) < 0.15
    else:
        for a, b in zip(got_w, want_w):
            np.testing.assert_allclose(a, b, rtol=5e-6, atol=5e-6,
                                       err_msg=name)
        assert len(got_s) == len(want_s)
        for a, b in zip(got_s, want_s):
            np.testing.assert_allclose(a, b, rtol=5e-6, atol=5e-5,
                                       err_msg=name)
    assert got_up.optimizer.num_update == want_up.optimizer.num_update
    assert got_up.optimizer._index_update_count == \
        want_up.optimizer._index_update_count


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_scheduler_and_mults_match_reference(name, fused):
    """An lr scheduler and per-index lr multipliers; the engine applies
    every step."""
    kw = SPECIAL_KWARGS.get(name, {})
    mults = {0: 0.5, 2: 2.0}
    want, _, _ = _run(jmx, name, kw, lr_mult=mults, scheduler=True)
    got, _, up = _run(tmx, name, kw, fused=fused, lr_mult=mults,
                      scheduler=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6)
    if fused:
        assert up._engine.exec_count == 3


def test_wd_mult_by_name_and_param_dict():
    opt = topt.create("sgd", learning_rate=1.0, wd=0.5,
                      param_idx2name={0: "a_weight", 1: "b_bias"})
    opt.set_wd_mult({"b_bias": 0.0})
    opt.set_lr_mult({0: 3.0})
    assert opt._get_wd(0) == 0.5 and opt._get_wd(1) == 0.0
    assert opt._get_lr(0) == 3.0 and opt._get_lr(1) == 1.0
    p = tmx.gluon.Parameter("p", shape=(1,), lr_mult=0.25, wd_mult=2.0)
    opt2 = topt.create("sgd", learning_rate=1.0, wd=0.5, param_dict={7: p})
    assert opt2._get_lr(7) == 0.25 and opt2._get_wd(7) == 1.0
    opt3 = topt.create("adam", begin_num_update=10)
    opt3._update_count(0)
    assert opt3._index_update_count[0] == 11 and opt3.num_update == 11


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_bf16_multi_precision_matches_reference(name, fused):
    """bf16 weights with an f32 master copy in the state. The master copy
    and the f32 slots are updated in f32 from the same bf16 start, so they
    are held at the f32 tolerances; the bf16 weights are the reference's
    updated master copy rounded to bf16, and they moved."""
    kw = dict(SPECIAL_KWARGS.get(name, {}))
    want_w, want_s, want_up = _run(jmx, name, kw, dtype="bfloat16",
                                   multi_precision=True)
    got_w, got_s, up = _run(tmx, name, kw, fused=fused, dtype="bfloat16",
                            multi_precision=True)
    rng = np.random.RandomState(42)
    start = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             .bfloat16().float().numpy() for s in SHAPES]
    for i in range(len(SHAPES)):
        assert up.states[i][-1]._data.dtype == torch.float32
    assert len(got_s) == len(want_s)
    for a, b in zip(got_s, want_s):
        np.testing.assert_allclose(a, b, rtol=5e-6, atol=5e-5)
    for i, (a, s0) in enumerate(zip(got_w, start)):
        master = want_up.states[i][-1]._data.astype("bfloat16")
        np.testing.assert_array_equal(a, np.asarray(master, np.float32))
        assert not np.array_equal(a, s0), i
    for a, b in zip(got_w, want_w):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# loss scaler and global-norm clipping
# ---------------------------------------------------------------------------

def _scaler_run(pkg, fused, inject_inf_at=1, steps=3):
    prev = _env(fused)
    try:
        opt = pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
        up = pkg.optimizer.Updater(opt)
        scaler = (JLossScaler if pkg is jmx else TLossScaler)()
        scaler.loss_scale = 1024.0
        cls = JND if pkg is jmx else TND
        rng = np.random.RandomState(3)
        ws = [cls(rng.randn(*s).astype(np.float32)) for s in SHAPES]
        idx = list(range(len(ws)))
        scales = []
        for step in range(steps):
            gs = [rng.randn(*s).astype(np.float32) * 1024.0 for s in SHAPES]
            if step == inject_inf_at:
                gs[1].reshape(-1)[0] = np.inf
            up.update_batch(idx, [cls(g) for g in gs], ws,
                            loss_scaler=scaler)
            scales.append(float(scaler.loss_scale))
        return [w.asnumpy() for w in ws], scales, scaler, opt
    finally:
        _restore(prev)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_loss_scale_skip_step_matches_reference(fused):
    want_w, want_sc, _, jo = _scaler_run(jmx, True)
    got_w, got_sc, scaler, to = _scaler_run(tmx, fused)
    for a, b in zip(got_w, want_w):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6)
    assert got_sc == want_sc and got_sc[1] == pytest.approx(512.0)
    assert bool(scaler.last_overflow) is False
    assert int(scaler.skip_streak) == 0
    # the skipped step's counters advanced
    assert to._index_update_count == jo._index_update_count == \
        {0: 3, 1: 3, 2: 3}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_loss_scale_skip_leaves_weights_unchanged(fused):
    prev = _env(fused)
    try:
        opt = topt.create("adam", learning_rate=0.1)
        up = topt.Updater(opt)
        scaler = TLossScaler()
        w = TND(np.ones((4,), np.float32))
        g = TND(np.full((4,), np.nan, np.float32))
        up.update_batch([0], [g], [w], loss_scaler=scaler)
        np.testing.assert_array_equal(w.asnumpy(), np.ones(4))
        for s in up.states[0]:
            np.testing.assert_array_equal(s.asnumpy(), np.zeros(4))
        assert bool(scaler.last_overflow) is True
        assert int(scaler.skip_streak) == 1
        assert opt._index_update_count == {0: 1} and opt.num_update == 1
        assert float(scaler.loss_scale) == 0.5
    finally:
        _restore(prev)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
def test_clip_global_norm_expected(fused):
    prev = _env(fused)
    try:
        opt = topt.create("sgd", learning_rate=1.0)
        up = topt.Updater(opt)
        ws = [TND(np.zeros((2,), np.float32)), TND(np.zeros((3,), np.float32))]
        gs = [TND(np.array([3.0, 0.0], np.float32)),
              TND(np.array([0.0, 4.0, 0.0], np.float32))]
        up.update_batch([0, 1], gs, ws, clip_global_norm=1.0)
    finally:
        _restore(prev)
    # ||g|| = 5: grads scaled by 1/5; sgd lr 1: w = -g / 5
    np.testing.assert_allclose(ws[0].asnumpy(), [-0.6, 0.0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(ws[1].asnumpy(), [0.0, -0.8, 0.0], rtol=1e-4,
                               atol=1e-5)


def test_updater_states_roundtrip_and_per_index_call():
    opt = topt.create("adam", learning_rate=0.1)
    up = topt.Updater(opt)
    w = TND(np.ones((3,), np.float32))
    up(0, TND(np.full((3,), 0.5, np.float32)), w)
    blob = up.get_states()
    up2 = topt.get_updater(topt.create("adam"))
    up2.set_states(blob, ctx=tmx.cpu())
    for a, b in zip(up.states[0], up2.states[0]):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert up2.states[0][0].context == tmx.cpu()


def test_lower_update_covers_every_optimizer():
    """The in-place list form (ShardedTrainer's) equals the engine's
    result for every optimizer with a deterministic step."""
    rng = np.random.RandomState(5)
    w0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    g0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    for name in NAMES:
        if name in ("sgld", "nadam"):
            continue
        kw = SPECIAL_KWARGS.get(name, {})
        a = topt.create(name, **kw)
        ws = [torch.from_numpy(w.copy()) for w in w0]
        sts = [a.create_state(i, w) for i, w in enumerate(ws)]
        topt.lower_update(a, ws, [torch.from_numpy(g) for g in g0], sts,
                          lr=a.lr, wd=a.wd, t=1)
        b = topt.create(name, **kw)
        up = topt.Updater(b)
        nds = [TND(w.copy()) for w in w0]
        up.update_batch(list(range(3)), [TND(g) for g in g0], nds)
        for x, y in zip(ws, nds):
            np.testing.assert_allclose(x.numpy(), y.asnumpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# lr schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = [
    ("FactorScheduler", {"step": 5, "factor": 0.7, "base_lr": 0.1,
                         "warmup_steps": 3}),
    ("MultiFactorScheduler", {"step": [4, 9, 20], "factor": 0.5,
                              "base_lr": 0.2}),
    ("PolyScheduler", {"max_update": 40, "base_lr": 0.1, "pwr": 2,
                       "final_lr": 0.001, "warmup_steps": 5}),
    ("CosineScheduler", {"max_update": 40, "base_lr": 0.1,
                         "final_lr": 0.01, "warmup_steps": 5,
                         "warmup_begin_lr": 0.02}),
    ("LRScheduler", {"base_lr": 0.3, "warmup_steps": 10,
                     "warmup_begin_lr": 0.05}),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS,
                         ids=[n for n, _ in SCHEDULERS])
def test_lr_scheduler_matches_reference(name, kw):
    want_s = getattr(jsched, name)(**kw)
    got_s = getattr(tsched, name)(**kw)
    if name == "LRScheduler":  # the base class: its warmup alone
        want = [want_s.get_warmup_lr(i) for i in range(10)]
        got = [got_s.get_warmup_lr(i) for i in range(10)]
    else:
        want = [want_s(i) for i in range(50)]
        got = [got_s(i) for i in range(50)]
    assert got == want


def test_optimizer_with_scheduler_rejects_set_learning_rate():
    sched = tsched.FactorScheduler(step=1, factor=0.5)
    opt = topt.create("sgd", learning_rate=0.4, lr_scheduler=sched)
    assert opt.learning_rate == 0.4
    with pytest.raises(RuntimeError, match="lr_scheduler"):
        opt.set_learning_rate(0.1)


# ---------------------------------------------------------------------------
# the update ops
# ---------------------------------------------------------------------------

def _u(seed, shape=(3, 4)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pos(seed, shape=(3, 4)):
    return np.abs(_u(seed, shape)) + 0.1


_W, _G, _M, _V = _u(1), _u(2), _u(3), _pos(4)
_COMMON = {"rescale_grad": 0.5, "clip_gradient": 1.0, "wd": 0.01}
OPS = {
    "nag_mom_update": ([_W, _G, _M], dict(_COMMON, lr=0.1, momentum=0.9)),
    "mp_sgd_update": ([_W, _G, _W], dict(_COMMON, lr=0.1)),
    "mp_sgd_mom_update": ([_W, _G, _M, _W],
                          dict(_COMMON, lr=0.1, momentum=0.9)),
    "rmsprop_update": ([_W, _G, _V], dict(_COMMON, lr=0.01,
                                          clip_weights=0.5)),
    "rmspropalex_update": ([_W, _G, _V + 1.0, _M * 0.1, _M],
                           dict(_COMMON, lr=0.01)),
    "ftrl_update": ([_W, _G, _M, _V], dict(_COMMON, lr=0.1, lamda1=0.3)),
    "signsgd_update": ([_W, _G], dict(_COMMON, lr=0.1)),
    "signum_update": ([_W, _G, _M], dict(_COMMON, lr=0.1, momentum=0.9,
                                         wd_lh=0.01)),
    "lamb_update_phase1": ([_W, _G, _M, _V], dict(_COMMON, t=3)),
    "lamb_update_phase2": ([_W, _G, np.float32([2.0]), np.float32([0.5])],
                           {"lr": 0.1, "lower_bound": 0.1,
                            "upper_bound": 1.5}),
    "adagrad_update": ([_W, _G, _V], dict(_COMMON, lr=0.1)),
    "adadelta_update": ([_W, _G, _V, _pos(5)], dict(_COMMON, rho=0.8)),
    "ftml_update": ([_W, _G, _pos(5), _V, _M],
                    {"lr": 0.01, "t": 2, "wd": 0.01, "rescale_grad": 0.5,
                     "clip_grad": 1.0}),
    "adamax_update": ([_W, _G, _M, _V], dict(_COMMON, lr=0.01, t=2)),
    "nadam_update": ([_W, _G, _M, _V], dict(_COMMON, lr=0.01, t=2,
                                            m_schedule=0.8)),
    "lars_update": ([_W, _G, _M], dict(_COMMON, lr=0.1, momentum=0.9,
                                       eta=0.01)),
    "dcasgd_update": ([_W, _G, _M, _u(6)], dict(_COMMON, lr=0.1,
                                                momentum=0.5, lamda=0.1)),
    "multi_sgd_update": ([_W, _G, _u(7), _u(8)],
                         {"lrs": [0.1, 0.2], "wds": [0.0, 0.1],
                          "num_weights": 2}),
    "multi_sgd_mom_update": ([_W, _G, _M, _u(7), _u(8), _u(9)],
                             {"lrs": [0.1, 0.2], "wds": [0.0, 0.1],
                              "momentum": 0.9, "num_weights": 2}),
    "multi_mp_sgd_update": ([_W, _G, _W, _u(7), _u(8), _u(7)],
                            {"lrs": [0.1, 0.2], "wds": [0.0, 0.1],
                             "num_weights": 2}),
    "multi_mp_sgd_mom_update": ([_W, _G, _M, _W, _u(7), _u(8), _u(9),
                                 _u(7)],
                                {"lrs": [0.1, 0.2], "wds": [0.0, 0.1],
                                 "momentum": 0.9, "num_weights": 2}),
    "preloaded_multi_sgd_update": ([_W, _G, _u(7), _u(8),
                                    np.float32([0.1, 0.2]),
                                    np.float32([0.0, 0.1])],
                                   {"num_weights": 2}),
    "preloaded_multi_sgd_mom_update": ([_W, _G, _M, _u(7), _u(8), _u(9),
                                        np.float32([0.1, 0.2]),
                                        np.float32([0.0, 0.1])],
                                       {"momentum": 0.9,
                                        "num_weights": 2}),
    "preloaded_multi_mp_sgd_update": ([_W, _G, _W, _u(7), _u(8), _u(7),
                                       np.float32([0.1, 0.2]),
                                       np.float32([0.0, 0.1])],
                                      {"num_weights": 2}),
    "preloaded_multi_mp_sgd_mom_update": ([_W, _G, _M, _W, _u(7), _u(8),
                                           _u(9), _u(7),
                                           np.float32([0.1, 0.2]),
                                           np.float32([0.0, 0.1])],
                                          {"momentum": 0.9,
                                           "num_weights": 2}),
    "multi_lamb_update_phase1": ([_W, _G, _M, _V, _u(7), _u(8), _u(9),
                                  _pos(10)],
                                 {"wds": [0.0, 0.1], "t": [1, 3],
                                  "num_weights": 2}),
    "multi_lamb_update_phase2": ([_W, _G, np.float32([2.0]),
                                  np.float32([0.5]), _u(7), _u(8),
                                  np.float32([1.0]), np.float32([0.0])],
                                 {"lrs": [0.1, 0.2], "num_weights": 2}),
    "multi_adamw_update": ([_W, _G, _M, _V, _u(7), _u(8), _u(9), _pos(10)],
                           {"lrs": [0.1, 0.2], "wds": [0.0, 0.1],
                            "etas": [1.0, 0.5], "num_weights": 2}),
    "multi_mp_adamw_update": ([_W, _G, _M, _V, _W, _u(7), _u(8), _u(9),
                               _pos(10), _u(7)],
                              {"lrs": [0.1, 0.2], "wds": [0.0, 0.1],
                               "num_weights": 2}),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_update_op_matches_reference(op):
    """Each registered update's outputs against the reference's, and its
    ``out=`` form rebinding the given arrays."""
    inputs, kw = OPS[op]
    want = getattr(jnd, op)(*[jnd.array(a) for a in inputs], **kw)
    arrays = [tnd.array(a) for a in inputs]
    got = getattr(tnd, op)(*arrays, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=op)
    np.testing.assert_array_equal(arrays[0].asnumpy(), inputs[0])


def test_sgld_update_op_by_distribution():
    w = np.zeros((200, 100), np.float32)
    tmx.random.seed(3)
    got = tnd.sgld_update(tnd.array(w), tnd.array(w), lr=0.04).asnumpy()
    assert abs(got.std() - 0.2) < 0.01 and abs(got.mean()) < 0.01


def test_update_op_out_rebinds():
    w, g, m = (tnd.array(a) for a in (_W, _G, _M))
    old = w._data
    tnd.nag_mom_update(w, g, m, out=(w, m), lr=0.1, momentum=0.9)
    assert w._data is not old
    want = jnd.nag_mom_update(jnd.array(_W), jnd.array(_G), jnd.array(_M),
                              lr=0.1, momentum=0.9)
    np.testing.assert_allclose(w.asnumpy(), want[0].asnumpy(), rtol=1e-6)
    np.testing.assert_allclose(m.asnumpy(), want[1].asnumpy(), rtol=1e-6)
