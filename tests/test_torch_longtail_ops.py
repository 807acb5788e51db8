"""The port's ordering, sequence, CTC, control-flow and random ops
(``mxnet_tpu_torch/ops/{ordering,sequence,loss_ops,control_flow,
random_ops}.py``) against the JAX package, on the CPU.

Deterministic ops take the same numpy inputs in both packages and are
held by value: orderings, indices and masks exactly (ties break the same
way), f32 values at rtol 1e-5 / atol 1e-6, CTC at rtol 1e-4 (its log-space
recursion) and gradients of the densities at rtol 1e-4 / atol 1e-5.
The random draws are held by shape and dtype exactly and by distribution
(sample moments within a few standard errors), since torch's generators
do not give ``jax.random``'s bits. CTC gradients are held to torch's own
CTC in f64 (atol 1e-5): the reference's are NaN once a label row is
padded.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops.registry import get_op as jget
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import sym as tsym
from mxnet_tpu_torch.ops.registry import get_op as tget

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref(name, *arrays, **kw):
    out = jget(name).fn(*[jnp.asarray(a) for a in arrays], **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _port(name, *arrays, **kw):
    out = tget(name).fn(*[torch.from_numpy(np.array(a)) for a in arrays],
                        **kw)
    if isinstance(out, tuple):
        return tuple(o.detach().numpy() for o in out)
    return out.detach().numpy()


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _close(got, want, rtol=1e-5, atol=1e-6):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------

_TIES = np.random.RandomState(0).randint(0, 4, (3, 5, 6)).astype(np.float32)


@pytest.mark.parametrize("ret_typ", ["indices", "value", "both", "mask"])
@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("axis", [-1, 1, 0])
def test_topk_matches_reference_with_ties(ret_typ, is_ascend, axis):
    kw = dict(axis=axis, k=3, ret_typ=ret_typ, is_ascend=is_ascend)
    got, want = _port("topk", _TIES, **kw), _ref("topk", _TIES, **kw)
    for g, w in zip(got if ret_typ == "both" else [got],
                    want if ret_typ == "both" else [want]):
        _same(g, w)


@pytest.mark.parametrize("kw", [dict(k=0), dict(k=2, dtype="int32"),
                                dict(axis=None, k=4, dtype="float16")],
                         ids=["k0-all", "int32", "axis-none-f16"])
def test_topk_k_and_dtype(kw):
    _same(_port("topk", _TIES, **kw), _ref("topk", _TIES, **kw))


@pytest.mark.parametrize("op", ["sort", "argsort"])
@pytest.mark.parametrize("is_ascend", [True, False])
@pytest.mark.parametrize("axis", [-1, 0])
def test_sort_argsort_match_reference_with_ties(op, is_ascend, axis):
    kw = dict(axis=axis, is_ascend=is_ascend)
    _same(_port(op, _TIES, **kw), _ref(op, _TIES, **kw))


def test_argsort_dtype_and_sort_gradient():
    _same(_port("argsort", _TIES, dtype="int32"),
          _ref("argsort", _TIES, dtype="int32"))
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    w = np.random.RandomState(2).randn(4, 5).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jget("sort").fn(v, is_ascend=False) * w))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    (tget("sort").fn(xt, is_ascend=False) * torch.tensor(w)).sum() \
        .backward()
    _close(xt.grad.numpy(), want)


@pytest.mark.parametrize("shape", [(3, 4), (2, 3, 4)])
def test_unravel_and_ravel_match_reference(shape):
    size = int(np.prod(shape))
    idx = np.array([0, 5, size - 1, size, size + 7, -1, -2, -size - 3],
                   np.float32)
    _same(_port("_unravel_index", idx, shape=shape),
          _ref("_unravel_index", idx, shape=shape))
    coords = np.stack([np.array([0, 1, 9, -3], np.float32)] * len(shape))
    _same(_port("_ravel_multi_index", coords, shape=shape),
          _ref("_ravel_multi_index", coords, shape=shape))


# ---------------------------------------------------------------------------
# sequence
# ---------------------------------------------------------------------------

_SEQ = np.random.RandomState(3).randn(5, 3, 2).astype(np.float32)


_LENGTHS = {"none": None, "in-range": [1.0, 5.0, 3.7],
            "zero-and-past-end": [0.0, 2.0, 7.0]}


@pytest.mark.parametrize("op,axis", [("SequenceMask", 0),
                                     ("SequenceMask", 1),
                                     ("SequenceLast", 0),
                                     ("SequenceLast", 1),
                                     ("SequenceReverse", 0)])
@pytest.mark.parametrize("lengths", sorted(_LENGTHS))
def test_sequence_ops_match_reference(op, axis, lengths):
    # SequenceReverse is time-major only, in both packages
    lengths = _LENGTHS[lengths]
    data = _SEQ if axis == 0 else np.ascontiguousarray(
        _SEQ.transpose(1, 0, 2))
    kw = dict(axis=axis, use_sequence_length=lengths is not None)
    if op == "SequenceMask":
        kw["value"] = -2.5
    args = [data] if lengths is None else \
        [data, np.array(lengths, np.float32)]
    got, want = _port(op, *args, **kw), _ref(op, *args, **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------

def _ctc_case(seed, T=10, B=3, C=5, L=4, lens=(4, 2, 3)):
    rng = np.random.RandomState(seed)
    acts = rng.randn(T, B, C).astype(np.float32)
    labels = rng.randint(1, C, (B, L)).astype(np.float32)
    for i, ll in enumerate(lens):
        labels[i, ll:] = 0
    return acts, labels, np.array(lens)


def _torch_ctc(acts, labels, t_lens, l_lens, blank):
    """Per-sequence CTC losses and their f64 gradient by torch's CTC."""
    x = torch.tensor(acts, dtype=torch.float64, requires_grad=True)
    flat = np.concatenate([labels[i, :n] for i, n in enumerate(l_lens)])
    loss = torch.nn.functional.ctc_loss(
        torch.log_softmax(x, -1), torch.tensor(flat.astype(np.int64)),
        torch.tensor(t_lens), torch.tensor(l_lens), blank=blank,
        reduction="none")
    loss.sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("case", ["first", "last", "data-lengths",
                                  "label-lengths", "alias"])
def test_ctc_loss_matches_reference_and_torch(case):
    acts, labels, lens = _ctc_case(12)
    T, B, _ = acts.shape
    t_lens = np.full(B, T)
    kw, extra = {}, []
    if case == "last":  # blank C-1, 0-based labels, -1 pads
        labels = np.where(labels > 0, labels - 1, -1).astype(np.float32)
        kw["blank_label"] = "last"
    elif case == "data-lengths":
        t_lens = np.array([10, 6, 8])
        extra = [t_lens.astype(np.float32)]
        kw["use_data_lengths"] = True
    elif case == "label-lengths":
        labels[labels == 0] = 3.0  # padding ignored: the lengths rule
        extra = [None, lens.astype(np.float32)]
        kw["use_label_lengths"] = True
    name = "_contrib_CTCLoss" if case == "alias" else "ctc_loss"
    want = jget(name).fn(jnp.asarray(acts), jnp.asarray(labels),
                         *[None if e is None else jnp.asarray(e)
                           for e in extra], **kw)
    x = torch.tensor(acts, requires_grad=True)
    got = tget(name).fn(x, torch.tensor(labels),
                        *[None if e is None else torch.tensor(e)
                          for e in extra], **kw)
    _close(got[0].detach().numpy(), np.asarray(want[0]), rtol=1e-4)
    _close(got[1].detach().numpy(), np.asarray(want[1]))
    got[0].sum().backward()
    blank = acts.shape[2] - 1 if case == "last" else 0
    t_loss, t_grad = _torch_ctc(acts, labels, t_lens, lens, blank)
    _close(got[0].detach().numpy(), t_loss.astype(np.float32), rtol=1e-4)
    assert np.isfinite(x.grad.numpy()).all()
    _close(x.grad.numpy(), t_grad.astype(np.float32), rtol=1e-4, atol=1e-5)


def test_ctc_loss_through_nd_and_autograd():
    acts, labels, lens = _ctc_case(14, T=6, B=2, C=4, L=2, lens=(2, 2))
    a = tnd.array(acts)
    a.attach_grad()
    with tag.record():
        loss, logp = tnd.ctc_loss(a, tnd.array(labels))
        total = loss.sum()
    total.backward()
    want = np.asarray(jget("ctc_loss").fn(jnp.asarray(acts),
                                          jnp.asarray(labels))[0])
    _close(loss.asnumpy(), want, rtol=1e-4)
    assert logp.shape == acts.shape
    g = a.grad.asnumpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0


# ---------------------------------------------------------------------------
# control flow
# ---------------------------------------------------------------------------

def _run(nd_mod, ag, fn, arrays):
    """fn's outputs and the gradient of their total with respect to each
    array."""
    xs = [nd_mod.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with ag.record():
        outs = fn(nd_mod, *xs)
        total = outs[0].sum()
        for o in outs[1:]:
            total = total + o.sum()
    total.backward()
    return [o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs]


def _foreach_rnn(m, data, h0, w):
    def body(x, states):
        h = m.tanh(m.dot(x, w) + states[0])
        return [h, h * 2.0], [h]

    outs, states = m.contrib.foreach(body, data, [h0])
    return list(outs) + list(states)


def _foreach_rnn_unrolled(m, data, h0, w):
    h, hs = h0, []
    for t in range(data.shape[0]):
        h = m.tanh(m.dot(data[t], w) + h)
        hs.append(h)
    return [m.stack(*hs, axis=0), m.stack(*hs, axis=0) * 2.0, h]


def _while_count(m, x, s):
    out, fv = m.contrib.while_loop(
        lambda v: v[0] < 4.0,
        lambda v: (v[1] * v[0], [v[0] + 1.0, v[1] * 1.5]), [x, s],
        max_iterations=6)
    return [out] + list(fv)


def _while_count_unrolled(m, x, s):
    rows = []
    for _ in range(3):  # x = 1, 2, 3
        rows.append(s * x)
        x, s = x + 1.0, s * 1.5
    pad = m.zeros((3, 2))
    return [m.concat(m.stack(*rows, axis=0), pad, dim=0), x, s]


def _cond_branches(m, a, b):
    hi = m.contrib.cond(lambda v: v[0].sum() > v[1].sum(),
                        lambda v: v[0] * v[1], lambda v: v[0] - v[1],
                        [a, b])
    lo = m.contrib.cond(m.array([0.0]), lambda v: [v * 2.0, v + 1.0],
                        lambda v: [v * 3.0, v - 1.0], a)
    return [hi] + list(lo)


def _cond_branches_unrolled(m, a, b):
    return [a * b, a * 3.0, a - 1.0]


# case -> (fn, its unrolled oracle, arrays, the arrays whose gradient the
# reference computes: its loops differentiate their inputs only, not the
# arrays a body closes over, and its while_loop not at all)
_CF = {
    "foreach": (_foreach_rnn, _foreach_rnn_unrolled,
                [np.random.RandomState(4).randn(5, 2, 3), np.zeros((2, 4)),
                 np.random.RandomState(5).randn(3, 4)], [0, 1]),
    "while_loop": (_while_count, _while_count_unrolled,
                   [np.array([1.0]), np.array([2.0, -1.0])], []),
    "cond": (_cond_branches, _cond_branches_unrolled,
             [np.array([1.0, 2.0]), np.array([0.5, 0.1])], [0, 1]),
}


@pytest.mark.parametrize("case", sorted(_CF))
def test_control_flow_values_and_grads_match_reference(case):
    fn, unrolled, arrays, ref_grads = _CF[case]
    arrays = [a.astype(np.float32) for a in arrays]
    got, got_g = _run(tnd, tag, fn, arrays)
    oracle, oracle_g = _run(tnd, tag, unrolled, arrays)
    if ref_grads:
        want, want_g = _run(jnd, jag, fn, arrays)
    else:
        want, want_g = [o.asnumpy() for o in fn(jnd, *map(jnd.array,
                                                            arrays))], []
    assert len(got) == len(want) == len(oracle)
    for g, w, o in zip(got, want, oracle):
        _close(g, w)
        _close(g, o)
    for i, g in enumerate(got_g):
        _close(g, oracle_g[i])
        if i in ref_grads:
            _close(g, want_g[i])


# case -> (start, the limit the condition reads, max_iterations, the rows
# and the final value both packages must give)
_WHILE_PADS = {
    "stops-at-max": (0.0, 100.0, 3, [[0.0], [1.0], [2.0]], [3.0]),
    "stops-early": (0.0, 2.0, 4, [[0.0], [1.0], [0.0], [0.0]], [2.0]),
    "no-step": (5.0, 0.0, 2, [[0.0], [0.0]], [5.0]),
}


@pytest.mark.parametrize("case", sorted(_WHILE_PADS))
def test_while_loop_pads_rows_and_stops_at_max_iterations(case):
    start, limit, n, rows, final = _WHILE_PADS[case]
    for m in (tnd, jnd):
        out, fv = m.contrib.while_loop(lambda v: v < limit,
                                       lambda v: (v * 1.0, v + 1.0),
                                       m.array([start]), max_iterations=n)
        _same(out.asnumpy(), np.array(rows, np.float32))
        _same(fv.asnumpy(), np.array(final, np.float32))


# ---------------------------------------------------------------------------
# random draws: shapes and dtypes exactly, values by distribution
# ---------------------------------------------------------------------------

_N = 20000

# name -> (kwargs or tensor parameters, mean, variance) of one element
_SCALAR_DRAWS = {
    "_random_uniform": (dict(low=2.0, high=4.0), 3.0, 4.0 / 12),
    "_random_normal": (dict(loc=1.0, scale=2.0), 1.0, 4.0),
    "_random_gamma": (dict(alpha=3.0, beta=2.0), 6.0, 12.0),
    "_random_exponential": (dict(lam=2.0), 0.5, 0.25),
    "_random_poisson": (dict(lam=3.0), 3.0, 3.0),
    "_random_randint": (dict(low=0, high=10), 4.5, 99.0 / 12),
    "_random_negative_binomial": (dict(k=3, p=0.4), 4.5, 11.25),
    "_random_generalized_negative_binomial": (dict(mu=2.0, alpha=0.5), 2.0,
                                              4.0),
}


# draws whose dtype must be floating (jax.random's rule), or integer
_FLOAT_ONLY = {"_random_uniform", "_random_normal", "_random_gamma",
               "_random_exponential"}


@pytest.mark.parametrize("name", sorted(_SCALAR_DRAWS))
def test_scalar_draws_shape_dtype_and_moments(name):
    kw, mean, var = _SCALAR_DRAWS[name]
    tmx.random.seed(7)
    ints = name == "_random_randint"
    other = "float16" if not ints else "uint8"
    wrong = "int32" if name in _FLOAT_ONLY else "float16" if ints else None
    for shape, dtype in (((3, 4), None), ((5,), other), (2, "int32"
                                                         if ints else
                                                         "float32")):
        extra = {} if dtype is None else {"dtype": dtype}
        got = _port(name, shape=shape, **kw, **extra)
        want = _ref(name, shape=shape, **kw, **extra)
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (shape, dtype, got.shape, want.shape, got.dtype, want.dtype)
    if wrong is not None:  # refused in both packages
        with pytest.raises((TypeError, ValueError)):
            _ref(name, shape=(2,), dtype=wrong, **kw)
        with pytest.raises((TypeError, ValueError)):
            _port(name, shape=(2,), dtype=wrong, **kw)
    s = _port(name, shape=(_N,), **kw).astype(np.float64)
    assert abs(s.mean() - mean) < 5 * np.sqrt(var / _N), (s.mean(), mean)
    assert abs(s.var() - var) < 0.1 * var, (s.var(), var)


def test_generalized_negative_binomial_alpha_zero_is_poisson():
    tmx.random.seed(8)
    s = _port("_random_generalized_negative_binomial", mu=3.0, alpha=0.0,
              shape=(_N,))
    assert abs(s.mean() - 3.0) < 5 * np.sqrt(3.0 / _N)
    assert abs(s.var() - 3.0) < 0.3


_P2 = (np.array([[0.5, 2.0], [4.0, 1.0]], np.float32),
       np.array([[2.0, 1.0], [0.5, 3.0]], np.float32))

# name -> (parameter arrays, mean and variance per element as functions
# of them)
_TENSOR_DRAWS = {
    "_sample_uniform": ((_P2[0], _P2[0] + _P2[1]),
                        lambda a, b: ((a + b) / 2, (b - a) ** 2 / 12)),
    "_sample_normal": (_P2, lambda m, s: (m, s ** 2)),
    "_sample_gamma": (_P2, lambda a, b: (a * b, a * b * b)),
    "_sample_exponential": ((_P2[1],), lambda l: (1 / l, 1 / l ** 2)),
    "_sample_poisson": ((_P2[1],), lambda l: (l, l)),
    "_sample_negative_binomial": (
        (_P2[1] * 2, np.full((2, 2), 0.5, np.float32)),
        lambda k, p: (k * (1 - p) / p, k * (1 - p) / p ** 2)),
    "_sample_generalized_negative_binomial": (
        (_P2[1], np.array([[0.5, 0.0], [1.0, 0.25]], np.float32)),
        lambda m, a: (m, m + a * m * m)),
}


@pytest.mark.parametrize("name", sorted(_TENSOR_DRAWS))
def test_tensor_draws_shape_dtype_and_moments(name):
    params, moments = _TENSOR_DRAWS[name]
    tmx.random.seed(9)
    for shape, dtype in ((None, None), ((3,), "float16"),
                         ((2, 3), "int32")):
        kw = {"shape": shape}
        if dtype is not None:
            kw["dtype"] = dtype
        got, want = _port(name, *params, **kw), _ref(name, *params, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (shape, dtype, got.shape, want.shape, got.dtype, want.dtype)
    s = _port(name, *params, shape=(_N,)).astype(np.float64)
    mean, var = moments(*[p.astype(np.float64) for p in params])
    assert np.all(np.abs(s.mean(-1) - mean) < 5 * np.sqrt(var / _N) + 1e-9)
    assert np.all(np.abs(s.var(-1) - var) < 0.1 * var + 1e-9)


@pytest.mark.parametrize("shape", [None, 5, (2, 3)])
@pytest.mark.parametrize("get_prob", [False, True])
def test_sample_multinomial_shape_dtype_prob(shape, get_prob):
    probs = np.array([[0.1, 0.6, 0.3], [0.5, 0.0, 0.5]], np.float32)
    kw = dict(shape=shape, get_prob=get_prob)
    got, want = _port("_sample_multinomial", probs, **kw), \
        _ref("_sample_multinomial", probs, **kw)
    for g, w in zip(got if get_prob else [got], want if get_prob else [want]):
        assert g.shape == w.shape and g.dtype == w.dtype
    if get_prob:
        draws, logp = got
        flat = draws.reshape(2, -1).astype(np.int64)
        _close(logp.reshape(2, -1),
               np.log(np.take_along_axis(probs, flat, 1)), rtol=1e-5)
    tmx.random.seed(10)
    s = _port("_sample_multinomial", probs, shape=(_N,))
    for row, p in zip(s, probs):
        freq = np.bincount(row, minlength=3) / _N
        assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / _N)
                      + 1e-9), (freq, p)


def test_shuffle_and_the_front_ends():
    tmx.random.seed(11)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    sh = _port("_shuffle", x)
    assert sh.shape == x.shape
    _same(np.sort(sh[:, 0]), x[:, 0])
    _same(sh[:, 1] - sh[:, 0], np.ones(8, np.float32))  # rows stay whole
    for name, call, shape in (
            ("uniform", lambda m: m.random.uniform(0, 1, shape=(3, 2)),
             (3, 2)),
            ("normal", lambda m: m.random.normal(0, 1, shape=(4,)), (4,)),
            ("randn", lambda m: m.random.randn(2, 5), (2, 5)),
            ("randint", lambda m: m.random.randint(5, shape=(6,)), (6,)),
            ("bernoulli", lambda m: m.random.bernoulli(0.3, shape=(3,)),
             (3,)),
            ("gamma", lambda m: m.random.gamma(2.0, 1.0, shape=(2,)), (2,)),
            ("exponential", lambda m: m.random.exponential(2.0, shape=(2,)),
             (2,)),
            ("poisson", lambda m: m.random.poisson(2.0, shape=(2,)), (2,)),
            ("negative_binomial",
             lambda m: m.random.negative_binomial(2, 0.5, shape=(2,)), (2,)),
            ("generalized_negative_binomial",
             lambda m: m.random.generalized_negative_binomial(
                 1.0, 0.5, shape=(2,)), (2,)),
            ("multinomial", lambda m: m.random.multinomial(
                m.array([[0.2, 0.8], [1.0, 0.0]])), (2,)),
            ("shuffle", lambda m: m.random.shuffle(m.array(x)), (8, 3))):
        got, want = call(tnd), call(jnd)
        assert got.shape == want.shape == shape, name
        assert got.asnumpy().dtype == want.asnumpy().dtype, name
    e = tnd.random.exponential(2.0, shape=(_N,)).asnumpy()
    assert abs(e.mean() - 2.0) < 5 * 2.0 / np.sqrt(_N)
    assert tmx.sym.random.uniform is not None
    assert tmx.sym.random.multinomial is not None


# ---------------------------------------------------------------------------
# densities: values and gradients
# ---------------------------------------------------------------------------

_RS = np.random.RandomState(15)
_PDF = {
    "_random_pdf_uniform": (
        [np.array([[0.2, 0.9, 1.7], [3.5, 2.5, 4.1]], np.float32),
         np.array([0.0, 2.0], np.float32), np.array([1.0, 4.0], np.float32)],
        [0, 1, 2]),
    "_random_pdf_normal": (
        [_RS.randn(2, 4).astype(np.float32),
         np.array([0.3, -1.0], np.float32), np.array([1.5, 0.7], np.float32)],
        [0, 1, 2]),
    "_random_pdf_gamma": (
        [_RS.rand(2, 4).astype(np.float32) * 3 + 0.1,
         np.array([2.0, 0.7], np.float32), np.array([1.5, 0.5], np.float32)],
        [0, 1, 2]),
    "_random_pdf_exponential": (
        [_RS.rand(2, 4).astype(np.float32) * 2,
         np.array([0.5, 3.0], np.float32)], [0, 1]),
    "_random_pdf_poisson": (
        [np.array([[0, 1, 3, 7], [2, 0, 5, 1]], np.float32),
         np.array([1.5, 4.0], np.float32)], [1]),
    "_random_pdf_negative_binomial": (
        [np.array([[0, 1, 3, 7], [2, 0, 5, 1]], np.float32),
         np.array([2.0, 5.0], np.float32), np.array([0.3, 0.6], np.float32)],
        [1, 2]),
    "_random_pdf_generalized_negative_binomial": (
        [np.array([[0, 1, 3, 7], [2, 0, 5, 1]], np.float32),
         np.array([2.0, 5.0], np.float32), np.array([0.5, 1.5], np.float32)],
        [1, 2]),
    "_random_pdf_dirichlet": (
        [np.array([[[0.2, 0.3, 0.5], [0.6, 0.1, 0.3]],
                   [[0.1, 0.1, 0.8], [0.3, 0.3, 0.4]]], np.float32),
         np.array([[1.5, 2.0, 3.0], [0.8, 1.2, 2.5]], np.float32)], [0, 1]),
}


@pytest.mark.parametrize("name", sorted(_PDF))
@pytest.mark.parametrize("is_log", [False, True])
def test_densities_values_and_grads_match_reference(name, is_log):
    arrays, wrt = _PDF[name]
    want = _ref(name, *arrays, is_log=is_log)
    got = _port(name, *arrays, is_log=is_log)
    _close(got, want, rtol=1e-5, atol=1e-6)

    def jsum(*vals):
        full = list(map(jnp.asarray, arrays))
        for i, v in zip(wrt, vals):
            full[i] = v
        return jnp.sum(jget(name).fn(*full, is_log=is_log))

    want_g = jax.grad(jsum, argnums=tuple(range(len(wrt))))(
        *[jnp.asarray(arrays[i]) for i in wrt])
    ts = [torch.tensor(a, requires_grad=i in wrt)
          for i, a in enumerate(arrays)]
    tget(name).fn(*ts, is_log=is_log).sum().backward()
    for i, w in zip(wrt, want_g):
        g = ts[i].grad  # None: the density does not depend on it
        _close(np.zeros_like(arrays[i]) if g is None else g.numpy(),
               np.asarray(w), rtol=1e-4, atol=1e-5)


def test_pdf_known_values():
    def pdf(name, *arrays):
        return _port(name, *[np.asarray(a, np.float32) for a in arrays])

    _close(pdf("_random_pdf_normal", [[0.0]], [0.0], [1.0])[0, 0],
           np.float32(1 / np.sqrt(2 * np.pi)), rtol=1e-5)
    _close(pdf("_random_pdf_uniform", [[0.5, 3.0]], [0.0], [2.0]),
           np.array([[0.5, 0.0]], np.float32))
    _close(pdf("_random_pdf_exponential", [[0.0]], [2.0])[0, 0],
           np.float32(2.0))
    _close(pdf("_random_pdf_poisson", [[0.0]], [1.0])[0, 0],
           np.float32(np.exp(-1)))
    _close(pdf("_random_pdf_gamma", [[0.7]], [1.0], [1.0])[0, 0],
           np.float32(np.exp(-0.7)), rtol=1e-4)


# the ops this file holds to the reference (tests/test_torch_ops.py
# checks that every registered op is held somewhere)
COVERED = {"topk", "sort", "argsort", "_unravel_index", "_ravel_multi_index",
           "SequenceMask", "SequenceLast", "SequenceReverse", "ctc_loss",
           "_shuffle", "_sample_multinomial", *_SCALAR_DRAWS,
           *_TENSOR_DRAWS, *_PDF}


def test_every_op_of_the_family_is_registered_under_its_names():
    names = ["topk", "sort", "argsort", "_unravel_index", "unravel_index",
             "_ravel_multi_index", "ravel_multi_index", "SequenceMask",
             "SequenceLast", "SequenceReverse", "RNN", "ctc_loss", "CTCLoss",
             "_contrib_ctc_loss", "_contrib_CTCLoss", "_shuffle", "shuffle",
             "_sample_multinomial", "sample_multinomial"]
    names += list(_SCALAR_DRAWS) + list(_TENSOR_DRAWS) + list(_PDF)
    names += [n.lstrip("_") for n in list(_SCALAR_DRAWS)
              + list(_TENSOR_DRAWS) + list(_PDF)]
    from mxnet_tpu.ops import has_op as jhas
    from mxnet_tpu_torch.ops import has_op as thas

    assert len(set(_SCALAR_DRAWS) | set(_TENSOR_DRAWS) | set(_PDF)) + 2 == 25
    for n in names:
        assert jhas(n), n
        assert thas(n), n
        assert hasattr(tnd, n) and hasattr(tsym, n), n
    assert tnd.contrib.foreach is not None and tnd.contrib.cond is not None
    assert tnd.contrib.ctc_loss is not None
