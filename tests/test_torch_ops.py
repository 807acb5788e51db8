"""Every registered op of the port against the reference's, forward and
vjp: the same seeded numpy inputs through ``mxnet_tpu`` and
``mxnet_tpu_torch`` (on the CPU), each op invoked by name under
``autograd.record()`` on arrays with gradients attached, then
``backward`` with the same seeded head gradients. Outputs and input
gradients are held to the reference's f32 tolerances (rtol 1e-4, atol
1e-5, ``mxnet_tpu.test_utils``) unless a case states its own, with its
reason. One parametrised test per op family; ``Dropout`` is held by
distribution, since torch's generator and ``jax.random`` give different
bits."""
import zlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray.ndarray import invoke as jinvoke
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ndarray.ndarray import invoke as tinvoke
from mxnet_tpu_torch.ops import registry as tregistry

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
_SIDES = {"jax": (jnd, jag, jinvoke, jmx.cpu),
          "torch": (tnd, tag, tinvoke, tmx.cpu)}


# input makers: f(rng) -> numpy array
def U(lo=-1.0, hi=1.0, shape=(3, 4)):
    return lambda rng: rng.uniform(lo, hi, shape).astype(np.float32)


def I(lo, hi, shape=(3,), dtype=np.int32):
    return lambda rng: rng.randint(lo, hi, shape).astype(dtype)


def C(value, dtype=np.float32):
    return lambda rng: np.asarray(value, dtype)


def SPD(n=3):
    def make(rng):
        m = rng.uniform(-1, 1, (n, n))
        return (m @ m.T + n * np.eye(n)).astype(np.float32)

    return make


def LOWER(n=3):
    def make(rng):
        return (np.tril(rng.uniform(-1, 1, (n, n)))
                + 2 * np.eye(n)).astype(np.float32)

    return make


_RS0_4x5 = np.random.RandomState(0).randn(4, 5).astype(np.float32)


def case(name, inputs, kwargs=None, grad=True, rtol=RTOL, atol=ATOL,
         cmp=None, id=None):
    return pytest.param(name, inputs, kwargs or {}, grad, rtol, atol, cmp,
                        id=id or name)


def _run(side, name, arrays, kwargs, grad):
    nd, autograd, invoke, cpu = _SIDES[side]
    with cpu():
        xs = [nd.array(a) for a in arrays]
        floats = [x for x in xs if np.dtype(x.dtype).kind == "f"]
        if grad:
            for x in floats:
                x.attach_grad()
        with autograd.record():
            out = invoke(name, xs, dict(kwargs))
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        fwd = [o.asnumpy() for o in outs]
        grads = None
        if grad:
            heads = [o for o in outs if np.dtype(o.dtype).kind == "f"]
            seeds = [nd.array(np.asarray(np.random.RandomState(7 + i)
                                         .randn(*h.shape), np.float32))
                     .astype(h.dtype) for i, h in enumerate(heads)]
            autograd.backward(heads, seeds)
            grads = [x.grad.asnumpy() for x in floats]
    return fwd, grads


def _check(name, inputs, kwargs, grad, rtol, atol, cmp):
    rng = np.random.RandomState(zlib.crc32(name.encode()) % 2 ** 31)
    arrays = [make(rng) for make in inputs]
    want_f, want_g = _run("jax", name, arrays, kwargs, grad)
    got_f, got_g = _run("torch", name, arrays, kwargs, grad)
    assert len(got_f) == len(want_f)
    for g, w in zip(got_f, want_f):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        if cmp is not None:
            g, w = cmp(g), cmp(w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    if grad:
        for g, w in zip(got_g, want_g):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


_UNARY_DOMAIN = {"log": (0.1, 2), "log10": (0.1, 2), "log2": (0.1, 2),
                 "log1p": (0.1, 2), "sqrt": (0.1, 2), "rsqrt": (0.1, 2),
                 "reciprocal": (0.2, 2), "rcbrt": (0.2, 2),
                 "gamma": (0.2, 3), "gammaln": (0.2, 3),
                 "digamma": (0.2, 3), "arccosh": (1.2, 3),
                 "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9),
                 "arctanh": (-0.9, 0.9), "erfinv": (-0.9, 0.9)}
_UNARY = ["relu", "sigmoid", "tanh", "exp", "expm1", "log", "log10", "log2",
          "log1p", "sqrt", "rsqrt", "square", "abs", "sign", "round", "rint",
          "ceil", "floor", "trunc", "fix", "negative", "sin", "cos", "tan",
          "arcsin", "arccos", "arctan", "sinh", "cosh", "arcsinh", "arccosh",
          "arctanh", "hard_sigmoid", "softsign", "cbrt", "rcbrt",
          "reciprocal", "erf", "erfinv", "gamma", "gammaln", "digamma",
          "degrees", "radians", "softrelu", "silu", "log_sigmoid", "mish",
          "identity", "BlockGrad", "zeros_like", "ones_like"]
_BINARY = ["add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
           "hypot"]
_CMP = ["equal", "not_equal", "greater", "greater_equal", "lesser",
        "lesser_equal", "logical_and", "logical_or", "logical_xor"]
_SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
           "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
           "_power_scalar", "_rpower_scalar", "_maximum_scalar",
           "_minimum_scalar", "_hypot_scalar", "_equal_scalar",
           "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
           "_lesser_scalar", "_lesser_equal_scalar", "_logical_and_scalar",
           "_logical_or_scalar", "_logical_xor_scalar"]
ELEMWISE = (
    [case(n, [U(*_UNARY_DOMAIN.get(n, (-2, 2)))]) for n in _UNARY]
    + [case(n, [U(-2, 2)], grad=False) for n in ("isnan", "isinf",
                                                  "isfinite")]
    + [case("logical_not", [C([[0.0, 1.5], [-2.0, 0.0]])])]
    + [case("broadcast_" + n, [U(0.5, 2, (3, 4)), U(0.5, 2, (1, 4))])
       for n in _BINARY]
    + [case("broadcast_" + n, [I(0, 3, (3, 4), np.float32),
                               I(0, 3, (1, 4), np.float32)])
       for n in _CMP]
    + [case(n, [U(0.5, 2)], {"scalar": 0.7}) for n in _SCALAR]
    + [case("_plus_scalar", [I(0, 5, (4,))], {"scalar": 2}, grad=False,
            id="_plus_scalar-int"),
       case("_mul_scalar", [I(0, 5, (4,))], {"scalar": 2.5}, grad=False,
            id="_mul_scalar-int-by-float"),
       case("gelu", [U(-3, 3)], {"approximation": "erf"}, id="gelu-erf"),
       case("gelu", [U(-3, 3)], {"approximation": "tanh"}, id="gelu-tanh"),
       case("clip", [U(-2, 2)], {"a_min": -0.5, "a_max": 0.8}),
       case("smooth_l1", [U(-2, 2)], {"scalar": 1.5}),
       case("Cast", [U(-2, 2)], {"dtype": "float16"}),
       case("amp_cast", [U(-2, 2)], {"dtype": "float16"}),
       case("amp_multicast", [lambda r: U(-2, 2)(r).astype(np.float16),
                              U(-2, 2)], {"num_outputs": 2}),
       case("shape_array", [U()], grad=False),
       case("size_array", [U()], grad=False),
       case("MakeLoss", [U()], {"grad_scale": 2.0}),
       case("_scatter_elemwise_div", [U(0.5, 2), U(0.5, 2)])])

REDUCE = [
    *[case(n, [U(0.5, 1.5, (3, 4, 5))], kw, id=f"{n}-{i}")
      for n in ("sum", "mean", "prod", "max", "min")
      for i, kw in enumerate([{}, {"axis": 1}, {"axis": (0, 2),
                                                "keepdims": True},
                              {"axis": 1, "exclude": True}])],
    case("nansum", [C([[1.0, np.nan, 2.0], [np.nan, 3.0, 4.0]])],
         {"axis": 1}),
    case("nanprod", [C([[1.5, np.nan, 2.0], [np.nan, 3.0, 0.5]])],
         {"axis": 0}),
    case("norm", [U(-1, 1, (3, 4))], id="norm-2"),
    case("norm", [U(-1, 1, (2, 3, 4))], {"axis": ()}, id="norm-axis-none"),
    case("norm", [U(-1, 1, (2, 3, 4))], {"ord": 1, "axis": ()},
         id="norm-1-axis-none"),
    case("norm", [U(-1, 1, (3, 4))], {"ord": 1, "axis": 1,
                                      "keepdims": True}, id="norm-1"),
    case("argmax", [U(-1, 1, (3, 4))], {"axis": 1}, grad=False),
    case("argmin", [U(-1, 1, (3, 4))], {"keepdims": True}, grad=False),
    case("argmax_channel", [U(-1, 1, (3, 4))], grad=False),
    case("broadcast_axis", [U(-1, 1, (3, 1, 4))], {"axis": 1, "size": 5}),
    case("broadcast_to", [U(-1, 1, (3, 1, 4))], {"shape": (0, 5, 4)}),
    case("broadcast_like", [U(-1, 1, (1, 4)), U(-1, 1, (3, 4))]),
    case("logsumexp", [U(-2, 2, (3, 4))], {"axis": 1}),
    case("L2Normalization", [U(-1, 1, (2, 3, 4))]),
    case("L2Normalization", [U(-1, 1, (2, 3, 4))], {"mode": "channel"},
         id="L2Normalization-channel"),
]

MATRIX = [
    case("Reshape", [U(shape=(2, 3, 4))], {"shape": (-4, 1, 2, 0, 0)}),
    case("Reshape", [U(shape=(2, 3, 4))], {"shape": (-1, 0),
                                           "reverse": True},
         id="Reshape-reverse"),
    case("Flatten", [U(shape=(2, 3, 4))]),
    case("transpose", [U(shape=(2, 3, 4))], {"axes": (1, 2, 0)}),
    case("expand_dims", [U(shape=(2, 3))], {"axis": -1}),
    case("squeeze", [U(shape=(2, 1, 3, 1))], {"axis": 1}),
    case("swapaxes", [U(shape=(2, 3, 4))], {"dim1": 0, "dim2": 2}),
    case("flip", [U(shape=(2, 3, 4))], {"axis": (0, 2)}),
    case("tile", [U(shape=(2, 3))], {"reps": (2, 1, 2)}),
    case("repeat", [U(shape=(2, 3))], {"repeats": 2, "axis": 1}),
    case("repeat", [U(shape=(2, 3))], {"repeats": 3}, id="repeat-flat"),
    case("Pad", [U(shape=(1, 2, 3, 4))],
         {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
          "constant_value": 0.5}),
    case("Pad", [U(shape=(1, 2, 3, 4))],
         {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
         id="Pad-edge"),
    case("Pad", [U(shape=(1, 2, 3, 4))],
         {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
         id="Pad-reflect"),
    case("Concat", [U(shape=(2, 3)), U(shape=(2, 2))], {"dim": 1}),
    case("stack", [U(shape=(2, 3)), U(shape=(2, 3))], {"axis": 1}),
    case("SliceChannel", [U(shape=(2, 6))], {"num_outputs": 3, "axis": 1}),
    case("SliceChannel", [U(shape=(2, 3, 4))],
         {"num_outputs": 3, "axis": 1, "squeeze_axis": True},
         id="SliceChannel-squeeze"),
    case("split_v2", [U(shape=(2, 6))], {"indices": (1, 4), "axis": 1}),
    case("split_v2", [U(shape=(2, 6))], {"sections": 2, "axis": 1},
         id="split_v2-sections"),
    case("slice", [U(shape=(4, 5))], {"begin": (1, None), "end": (3, -1)}),
    case("slice", [U(shape=(4, 5))], {"begin": (3, 4), "end": (0, None),
                                      "step": (-2, -1)}, id="slice-back"),
    case("slice_axis", [U(shape=(4, 5))], {"axis": 1, "begin": 1,
                                           "end": -1}),
    case("slice_like", [U(shape=(4, 5)), U(shape=(2, 3))], {"axes": (1,)}),
    case("where", [I(0, 2, (3, 4), np.float32), U(), U()]),
    case("diag", [U(shape=(4,))], {"k": 1}),
    case("diag", [U(shape=(4, 5))], {"k": -1}, id="diag-2d"),
    case("depth_to_space", [U(shape=(1, 8, 2, 3))], {"block_size": 2}),
    case("space_to_depth", [U(shape=(1, 2, 4, 6))], {"block_size": 2}),
    case("dot", [U(shape=(3, 4)), U(shape=(4, 5))]),
    case("dot", [U(shape=(4, 3)), U(shape=(5, 4))],
         {"transpose_a": True, "transpose_b": True}, id="dot-tt"),
    case("dot", [U(shape=(2, 3, 4)), U(shape=(4, 5))], id="dot-3d"),
    case("dot", [U(shape=(4,)), U(shape=(4,))], id="dot-1d"),
    case("batch_dot", [U(shape=(2, 3, 4)), U(shape=(2, 5, 4))],
         {"transpose_b": True}),
    case("_linalg_gemm2", [U(shape=(2, 3, 4)), U(shape=(2, 4, 5))],
         {"alpha": 0.5}),
    case("_linalg_gemm", [U(shape=(3, 4)), U(shape=(3, 5)), U(shape=(4, 5))],
         {"transpose_a": True, "alpha": 2.0, "beta": 0.5}),
    case("_linalg_potrf", [SPD()]),
    case("_linalg_trsm", [LOWER(), U(shape=(3, 2))], {"alpha": 2.0}),
    case("_linalg_trsm", [LOWER(), U(shape=(2, 3))],
         {"rightside": True, "transpose": True}, id="_linalg_trsm-right"),
    case("_linalg_syrk", [U(shape=(3, 4))], {"alpha": 0.5}),
    case("khatri_rao", [U(shape=(2, 3)), U(shape=(4, 3))]),
    case("moments", [U(shape=(3, 4))], {"axes": (1,)}),
    case("histogram", [U(0, 1, (20,))], {"bin_cnt": 5, "range": (0.0, 1.0)},
         grad=False),
    case("_linalg_det", [SPD()]),
    case("_linalg_slogdet", [SPD()]),
    case("_linalg_inverse", [SPD()]),
    case("_linalg_trmm", [U(shape=(3, 3)), U(shape=(3, 2))],
         {"alpha": 1.5}),
    case("_linalg_extractdiag", [U(shape=(2, 3, 3))], {"offset": 1}),
    case("_linalg_makediag", [U(shape=(2, 3))], {"offset": -1}),
    case("_linalg_extracttrian", [U(shape=(4, 4))], {"offset": 1}),
    case("_linalg_maketrian", [U(shape=(2, 6))], {"lower": False}),
    case("cumsum", [U(shape=(3, 4))], {"axis": 1}),
    case("cumprod", [U(0.5, 1.5, (3, 4))]),
    case("batch_take", [U(shape=(3, 4)), C([1, 3, 0], np.int32)],
         grad=False),
    case("batch_take", [C(np.arange(20).reshape(4, 5)),
                        C([0, 1, -1, 7], np.int32)], grad=False,
         id="batch_take-wraps-and-fills"),
    case("cast_storage", [U()]),
    case("_linalg_potri", [LOWER()]),
    case("_linalg_sumlogdiag", [SPD()]),
    # LAPACK's sign of each factor row/column is a convention: compared up
    # to it, forward only
    case("_linalg_gelqf", [U(shape=(2, 3))], grad=False, cmp=np.abs),
    case("_linalg_syevd", [SPD()], grad=False, cmp=np.abs),
]

INDEXING = [
    case("take", [U(shape=(5, 3)), C([1, 7, -2], np.int32)]),
    case("take", [U(shape=(5, 3)), C([[1, 7], [-2, 0]], np.int32)],
         {"axis": 0, "mode": "wrap"}, id="take-wrap"),
    case("take", [U(shape=(3, 5)), C([1, 7, -7], np.int32)],
         {"axis": 1, "mode": "raise"}, id="take-fill"),
    case("Embedding", [C([[0, 3], [9, -1]], np.float32), U(shape=(5, 4))],
         {"input_dim": 5, "output_dim": 4}),
    case("one_hot", [C([0, 2, 5, -1], np.float32)], {"depth": 4},
         grad=False),
    case("pick", [U(shape=(3, 5)), C([0, 4, 9], np.float32)]),
    case("pick", [U(shape=(3, 5)), C([0, 7, -1], np.float32)],
         {"axis": 1, "keepdims": True, "mode": "wrap"}, id="pick-wrap"),
    case("gather_nd", [U(shape=(3, 4)), C([[0, 2, 5], [1, -1, 9]],
                                           np.int32)]),
    case("scatter_nd", [U(shape=(3,)), C([[0, 2, 5], [1, -1, 0]], np.int32)],
         {"shape": (3, 4)}),
    case("_scatter_set_nd", [U(shape=(3, 4)), U(shape=(2,)),
                             C([[0, 7], [1, 2]], np.int32)],
         {"shape": (3, 4)}),
    case("_backward_gather_nd", [U(shape=(3,)), C([[1, 1, 2]], np.int32)],
         {"shape": (4,)}),
    case("take_along_axis", [U(shape=(3, 4)), C([[0, 3], [5, 1], [-1, 2]],
                                                np.int32)], {"axis": 1}),
    case("_contrib_boolean_mask", [U(shape=(4, 3)), C([1, 0, 1, 1],
                                                      np.float32)]),
    case("_contrib_index_copy", [U(shape=(4, 3)), C([2, 0], np.int32),
                                 U(shape=(2, 3))]),
    case("_contrib_index_array", [U(shape=(2, 3))], grad=False),
    case("_contrib_allclose", [U(), U()], grad=False),
]

INIT = [
    case("_zeros", [], {"shape": (2, 3)}, grad=False),
    case("_ones", [], {"shape": (2, 3), "dtype": "int32"}, grad=False),
    case("_full", [], {"shape": (2,), "value": 7.5}, grad=False),
    case("_arange", [], {"start": 1, "stop": 7, "step": 1.5, "repeat": 2},
         grad=False),
    case("_linspace", [], {"start": 0, "stop": 1, "num": 5}, grad=False),
    case("_linspace", [], {"start": 0, "stop": 1, "num": 5,
                           "endpoint": False}, grad=False,
         id="_linspace-open"),
    case("_eye", [], {"N": 3, "M": 4, "k": 1}, grad=False),
]

NN = [
    case("FullyConnected", [U(shape=(2, 3, 4)), U(shape=(5, 12)),
                            U(shape=(5,))], {"num_hidden": 5}),
    case("FullyConnected", [U(shape=(2, 3, 4)), U(shape=(5, 4))],
         {"num_hidden": 5, "no_bias": True, "flatten": False},
         id="FullyConnected-noflat"),
    *[case("Activation", [U(-3, 3)], {"act_type": a}, id=f"Activation-{a}")
      for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
                "silu", "relu6")],
    *[case("LeakyReLU", [U(-3, 3)], {"act_type": a}, id=f"LeakyReLU-{a}")
      for a in ("leaky", "elu", "selu", "gelu", "rrelu")],
    case("LeakyReLU", [U(-3, 3, (2, 3, 4)), U(0, 0.5, (3,))],
         {"act_type": "prelu"}, id="LeakyReLU-prelu"),
    case("softmax", [U(-3, 3)], {"axis": 0, "temperature": 2.0}),
    case("softmax", [U(-3, 3), C([2, 4, 1], np.float32)],
         {"use_length": True}, id="softmax-length"),
    case("log_softmax", [U(-3, 3)]),
    case("softmin", [U(-3, 3)]),
    case("SoftmaxActivation", [U(-3, 3, (2, 3, 4))]),
    case("SoftmaxActivation", [U(-3, 3, (2, 3, 4))], {"mode": "channel"},
         id="SoftmaxActivation-channel"),
    case("SoftmaxOutput", [U(-3, 3, (4, 5)), C([0, 4, 2, 1], np.float32)]),
    case("SoftmaxOutput", [U(-3, 3, (4, 5)), C([0, 4, 2, 1], np.float32)],
         {"use_ignore": True, "ignore_label": 2, "normalization": "valid",
          "smooth_alpha": 0.1}, id="SoftmaxOutput-ignore-smooth"),
    case("SoftmaxOutput", [U(-3, 3, (2, 3, 4)), C([[0, 2, 1, 1],
                                                   [2, 2, 0, 1]],
                                                  np.float32)],
         {"multi_output": True, "normalization": "batch",
          "grad_scale": 2.0}, id="SoftmaxOutput-multi"),
    case("softmax_cross_entropy", [U(-3, 3, (4, 5)),
                                   C([0, 4, 2, 1], np.float32)]),
    # labels read as take_along_axis reads them: -1 wraps, 7 >= C is NaN
    case("softmax_cross_entropy", [C(_RS0_4x5), C([0, 1, 2, -1])],
         id="softmax_cross_entropy-label-wraps"),
    case("softmax_cross_entropy", [C(_RS0_4x5), C([0, 1, 2, 7])],
         id="softmax_cross_entropy-label-past-end"),
    case("LayerNorm", [U(-2, 2, (2, 3, 4)), U(0.5, 1.5, (4,)),
                       U(-0.5, 0.5, (4,))]),
    case("LayerNorm", [U(-2, 2, (2, 3, 4)), U(0.5, 1.5, (3,)),
                       U(-0.5, 0.5, (3,))], {"axis": 1, "eps": 1e-3},
         id="LayerNorm-axis1"),
    case("RMSNorm", [U(-2, 2, (2, 3, 4)), U(0.5, 1.5, (4,))]),
    case("Dropout", [U()], {"p": 0.5, "_train": False}, id="Dropout-eval"),
    case("Dropout", [U()], {"p": 0.0, "mode": "always"}, id="Dropout-p0"),
]

OPTIMIZER = [
    case("sgd_update", [U(), U()], {"lr": 0.1, "wd": 0.01,
                                    "clip_gradient": 0.5}, grad=False),
    case("sgd_mom_update", [U(), U(), U()], {"lr": 0.1, "momentum": 0.9,
                                             "wd": 0.01}, grad=False),
    case("adam_update", [U(), U(), U(), U(0.1, 1)],
         {"lr": 0.01, "wd": 0.01, "rescale_grad": 0.5}, grad=False),
    case("adamw_update", [U(), U(), U(), U(0.1, 1)],
         {"lr": 0.01, "wd": 0.01, "eta": 0.5, "clip_gradient": 0.3},
         grad=False),
    # the rest of the reference's updates (slice 4)
    case("nag_mom_update", [U(), U(), U()], {"lr": 0.1, "momentum": 0.9,
                                             "wd": 0.01}, grad=False),
    case("mp_sgd_update", [U(), U(), U()], {"lr": 0.1, "wd": 0.01},
         grad=False),
    case("mp_sgd_mom_update", [U(), U(), U(), U()],
         {"lr": 0.1, "momentum": 0.9}, grad=False),
    case("rmsprop_update", [U(), U(), U(0.1, 1)],
         {"lr": 0.01, "clip_weights": 0.5}, grad=False),
    case("rmspropalex_update", [U(), U(), U(1, 2), U(-0.1, 0.1), U()],
         {"lr": 0.01}, grad=False),
    case("ftrl_update", [U(), U(), U(), U(0.1, 1)],
         {"lr": 0.1, "lamda1": 0.3}, grad=False),
    case("signsgd_update", [U(), U()], {"lr": 0.1, "wd": 0.01}, grad=False),
    case("signum_update", [U(), U(), U()],
         {"lr": 0.1, "momentum": 0.9, "wd_lh": 0.01}, grad=False),
    case("lamb_update_phase1", [U(), U(), U(), U(0.1, 1)],
         {"t": 3, "wd": 0.01}, grad=False),
    case("lamb_update_phase2", [U(), U(), U(1, 2, (1,)), U(0.5, 1, (1,))],
         {"lr": 0.1, "lower_bound": 0.1, "upper_bound": 1.5}, grad=False),
    case("adagrad_update", [U(), U(), U(0.1, 1)], {"lr": 0.1}, grad=False),
    case("adadelta_update", [U(), U(), U(0.1, 1), U(0.1, 1)],
         {"rho": 0.8}, grad=False),
    case("ftml_update", [U(), U(), U(0.1, 1), U(0.1, 1), U()],
         {"lr": 0.01, "t": 2}, grad=False),
    case("adamax_update", [U(), U(), U(), U(0.1, 1)], {"lr": 0.01, "t": 2},
         grad=False),
    case("nadam_update", [U(), U(), U(), U(0.1, 1)],
         {"lr": 0.01, "t": 2, "m_schedule": 0.8}, grad=False),
    case("sgld_update", [U(), U()], {"lr": 0.0, "wd": 0.01}, grad=False,
         id="sgld_update-no-noise"),
    case("lars_update", [U(), U(), U()], {"lr": 0.1, "eta": 0.01},
         grad=False),
    case("dcasgd_update", [U(), U(), U(), U()],
         {"lr": 0.1, "momentum": 0.5}, grad=False),
    case("multi_sgd_update", [U(), U(), U(), U()],
         {"lrs": [0.1, 0.2], "wds": [0.0, 0.1], "num_weights": 2},
         grad=False),
    case("multi_sgd_mom_update", [U()] * 6,
         {"lrs": [0.1, 0.2], "momentum": 0.9, "num_weights": 2},
         grad=False),
    case("multi_mp_sgd_update", [U()] * 6,
         {"lrs": [0.1, 0.2], "num_weights": 2}, grad=False),
    case("multi_mp_sgd_mom_update", [U()] * 8,
         {"lrs": [0.1, 0.2], "momentum": 0.9, "num_weights": 2},
         grad=False),
    case("preloaded_multi_sgd_update",
         [U()] * 4 + [U(0.1, 0.2, (2,)), U(0, 0.1, (2,))],
         {"num_weights": 2}, grad=False),
    case("preloaded_multi_sgd_mom_update",
         [U()] * 6 + [U(0.1, 0.2, (2,)), U(0, 0.1, (2,))],
         {"momentum": 0.9, "num_weights": 2}, grad=False),
    case("preloaded_multi_mp_sgd_update",
         [U()] * 6 + [U(0.1, 0.2, (2,)), U(0, 0.1, (2,))],
         {"num_weights": 2}, grad=False),
    case("preloaded_multi_mp_sgd_mom_update",
         [U()] * 8 + [U(0.1, 0.2, (2,)), U(0, 0.1, (2,))],
         {"momentum": 0.9, "num_weights": 2}, grad=False),
    case("multi_lamb_update_phase1",
         [U(), U(), U(), U(0.1, 1)] * 2,
         {"wds": [0.0, 0.1], "t": [1, 3], "num_weights": 2}, grad=False),
    case("multi_lamb_update_phase2",
         [U(), U(), U(1, 2, (1,)), U(0.5, 1, (1,))] * 2,
         {"lrs": [0.1, 0.2], "num_weights": 2}, grad=False),
    case("multi_adamw_update", [U(), U(), U(), U(0.1, 1)] * 2,
         {"lrs": [0.1, 0.2], "wds": [0.0, 0.1], "etas": [1.0, 0.5],
          "num_weights": 2}, grad=False),
    case("multi_mp_adamw_update", [U(), U(), U(), U(0.1, 1), U()] * 2,
         {"lrs": [0.1, 0.2], "num_weights": 2}, grad=False),
]

FAMILIES = {"elemwise": ELEMWISE, "reduce": REDUCE, "matrix": MATRIX,
            "indexing": INDEXING, "init_ops": INIT, "nn": NN,
            "optimizer_ops": OPTIMIZER}
_ARGS = "name,inputs,kwargs,grad,rtol,atol,cmp"


@pytest.mark.parametrize(_ARGS, ELEMWISE)
def test_elemwise_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


@pytest.mark.parametrize(_ARGS, REDUCE)
def test_reduce_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


@pytest.mark.parametrize(_ARGS, MATRIX)
def test_matrix_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


@pytest.mark.parametrize(_ARGS, INDEXING)
def test_indexing_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


@pytest.mark.parametrize(_ARGS, INIT)
def test_init_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


@pytest.mark.parametrize(_ARGS, NN)
def test_nn_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


@pytest.mark.parametrize(_ARGS, OPTIMIZER)
def test_optimizer_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


def test_every_registered_op_has_a_case():
    """Each op the port registers (once per definition, aliases aside) is
    held to the reference here, in ``test_torch_conv_ops.py`` (the
    convolution, pooling and batch/instance/group norm ops), in
    ``test_torch_longtail_ops.py`` (ordering, sequence, CTC, random), in
    ``test_torch_rnn.py`` (``RNN``), in ``test_torch_contrib_ops.py``
    (contrib, image and the ``nn`` extras) or in
    ``test_torch_quantization.py`` (int8), and each exists in the
    reference."""
    from test_torch_contrib_ops import COVERED as CONTRIB
    from test_torch_conv_ops import CASES as CONV_CASES
    from test_torch_longtail_ops import COVERED as LONGTAIL
    from test_torch_quantization import COVERED as QUANT
    from test_torch_rnn import COVERED as RNN

    covered = {p.values[0] for cases in [*FAMILIES.values(), CONV_CASES]
               for p in cases} | LONGTAIL | RNN | CONTRIB | QUANT
    ops = {op.name for op in tregistry._REGISTRY.values()}
    assert ops - covered == set()
    from mxnet_tpu.ops import has_op
    assert all(has_op(n) for n in tregistry.list_ops())


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_by_distribution(p):
    """In train mode each unit is dropped with probability p and kept ones
    are scaled by 1 / (1 - p); the gradient passes where the unit was
    kept. Both packages, 20000 units: the dropped share within 0.02 of
    p."""
    x = np.random.RandomState(0).uniform(0.5, 1.5, (20000,)).astype(
        np.float32)
    for side in ("jax", "torch"):
        nd, autograd, invoke, cpu = _SIDES[side]
        with cpu():
            a = nd.array(x)
            a.attach_grad()
            with autograd.record():
                y = invoke("Dropout", [a], {"p": p})
            y.backward()
            out, g = y.asnumpy(), a.grad.asnumpy()
        kept = out != 0
        assert abs((~kept).mean() - p) < 0.02, (side, (~kept).mean())
        np.testing.assert_allclose(out[kept], x[kept] / (1 - p), rtol=1e-6)
        np.testing.assert_allclose(g, kept / (1 - p), rtol=1e-6)


def test_dropout_seeded_stream_repeats():
    with tmx.cpu():
        draws = []
        for _ in range(2):
            tmx.random.seed(123)
            with tag.train_mode():
                draws.append(tnd.Dropout(tnd.ones((64,)), p=0.5).asnumpy())
    np.testing.assert_array_equal(draws[0], draws[1])


def test_registry_api_matches_reference():
    """OpDef's slots, output counts (static and from kwargs), aliases,
    the loud failure on unregistered names and the string coercion of op
    parameters are the reference's."""
    from mxnet_tpu.ops import registry as jregistry

    assert tregistry.OpDef.__slots__ == jregistry.OpDef.__slots__
    for name in ("SliceChannel", "split", "sgd_mom_update", "adam_update",
                 "moments", "Concat"):
        mine, ref = tregistry.get_op(name), jregistry.get_op(name)
        assert mine.name == ref.name
        assert mine.ndarray_inputs == ref.ndarray_inputs
        assert mine.differentiable == ref.differentiable
        assert mine.tags == ref.tags
        for kw in ({}, {"num_outputs": 4}, {"num_outputs": 1,
                                             "squeeze_axis": True}):
            assert mine.n_out(kw) == ref.n_out(kw)
    assert tregistry.get_op("elemwise_add") is tregistry.get_op(
        "broadcast_add")
    for kw in ({}, {"output_mean_var": True}):
        assert tregistry.get_op("BatchNorm").n_out(kw) == \
            jregistry.get_op("BatchNorm").n_out(kw)
    with pytest.raises(NotImplementedError, match="'NoSuchOp'"):
        tregistry.get_op("NoSuchOp")
    raw = {"a": "(3, 3)", "b": "True", "c": "2", "d": "none", "e": "relu",
           "f": 1.5}
    assert tregistry.coerce_kwargs(raw) == jregistry.coerce_kwargs(raw)


def test_label_and_index_reads_pin_reference_values():
    """The values the reference gives for the inputs that once showed the
    port clamping (``softmax_cross_entropy`` labels, ``batch_take``
    indices) and reducing every axis (``norm`` over ``axis=()``)."""
    with tmx.cpu():
        x = tnd.array(_RS0_4x5)
        ce = [float(tinvoke("softmax_cross_entropy",
                            [x, tnd.array(lab)], {}).asscalar())
              for lab in ([0, 1, 2, -1], [0, 1, 2, 7])]
        bt = tinvoke("batch_take", [tnd.array(np.arange(20, dtype=np.float32)
                                              .reshape(4, 5)),
                                    tnd.array(np.array([0, 1, -1, 7],
                                                       np.int32))], {})
        nrm = tinvoke("norm", [tnd.array(-np.ones((2, 3, 4), np.float32))],
                      {"axis": ()})
    np.testing.assert_allclose(ce[0], 6.925333, rtol=1e-6)
    assert np.isnan(ce[1])
    np.testing.assert_array_equal(bt.asnumpy(), [0, 6, 14, np.nan])
    assert nrm.shape == (2, 3, 4) and (nrm.asnumpy() == 1).all()
