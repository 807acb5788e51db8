"""The port's convolution, pooling and normalisation ops (``Convolution``,
``Deconvolution``, ``Pooling``, ``BatchNorm``, ``InstanceNorm``,
``GroupNorm``) against the reference's, forward and vjp, through the
harness of ``test_torch_ops.py``: the same seeded numpy inputs through
both packages on the CPU, each op invoked by name under
``autograd.record()`` (train mode), ``backward`` with seeded head
gradients. f32 outputs and input gradients within 1e-5 relative / 1e-6
absolute unless a case states its own, with its reason. The Gluon layers
over these ops (``gluon/nn/conv_layers.py``, the BatchNorm family) are
held the same way with the reference's weights carried by structural
name: forward, input and parameter gradients, and the running statistics
BatchNorm folds."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from test_torch_ops import U, _check, case

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def c(name, inputs, kwargs, id):
    return case(name, inputs, kwargs, rtol=RTOL, atol=ATOL, id=id)


def _bn(shape, c_axis=1):
    ch = shape[c_axis]
    return [U(-2, 2, shape), U(0.5, 1.5, (ch,)), U(-0.5, 0.5, (ch,)),
            U(-0.5, 0.5, (ch,)), U(0.5, 1.5, (ch,))]


NORM = [
    c("BatchNorm", _bn((4, 3, 5, 5)), {}, "bn_train_fix_gamma"),
    c("BatchNorm", _bn((4, 3, 5, 5)), {"fix_gamma": False, "eps": 1e-5},
      "bn_train"),
    c("BatchNorm", _bn((4, 3, 5, 5)),
      {"fix_gamma": False, "output_mean_var": True}, "bn_output_mean_var"),
    c("BatchNorm", _bn((6, 4)), {"fix_gamma": False, "axis": 1},
      "bn_2d"),
    c("BatchNorm", _bn((2, 5, 3), c_axis=2),
      {"fix_gamma": False, "axis": -1, "output_mean_var": True},
      "bn_last_axis"),
    c("BatchNorm", _bn((4, 3, 5, 5)),
      {"fix_gamma": False, "use_global_stats": True}, "bn_global_stats"),
    c("BatchNorm", _bn((4, 3, 5)), {"fix_gamma": False, "_train": False},
      "bn_eval"),
    # no dim left to reduce: the statistics are the element itself (the
    # reference's reductions over axis=()), not the whole array's
    c("BatchNorm", _bn((4,), c_axis=0),
      {"fix_gamma": False, "axis": 0, "output_mean_var": True},
      "bn_1d_no_reduction"),
    c("InstanceNorm", [U(-2, 2, (2, 3)), U(0.5, 1.5, (3,)),
                       U(-0.5, 0.5, (3,))], {}, "instance_norm_no_spatial"),
    c("InstanceNorm", [U(-2, 2, (2, 3, 5, 4)), U(0.5, 1.5, (3,)),
                       U(-0.5, 0.5, (3,))], {}, "instance_norm_2d"),
    c("InstanceNorm", [U(-2, 2, (2, 3, 7)), U(0.5, 1.5, (3,)),
                       U(-0.5, 0.5, (3,))], {"eps": 1e-5},
      "instance_norm_1d"),
    c("GroupNorm", [U(-2, 2, (2, 6, 4, 3)), U(0.5, 1.5, (6,)),
                    U(-0.5, 0.5, (6,))], {"num_groups": 3},
      "group_norm"),
    c("GroupNorm", [U(-2, 2, (3, 4, 5)), U(0.5, 1.5, (4,)),
                    U(-0.5, 0.5, (4,))], {"num_groups": 1, "eps": 1e-3},
      "group_norm_one_group"),
]

CONV = [
    c("Convolution", [U(-1, 1, (2, 3, 9)), U(-1, 1, (4, 3, 3)),
                      U(-1, 1, (4,))], {"kernel": (3,), "num_filter": 4},
      "conv1d"),
    c("Convolution", [U(-1, 1, (2, 4, 9, 8)), U(-1, 1, (6, 2, 3, 3)),
                      U(-1, 1, (6,))],
      {"kernel": (3, 3), "stride": (2, 1), "pad": (1, 2),
       "dilate": (1, 2), "num_filter": 6, "num_group": 2},
      "conv2d_stride_pad_dilate_groups"),
    c("Convolution", [U(-1, 1, (2, 3, 8, 8)), U(-1, 1, (5, 3, 1, 1))],
      {"kernel": (1, 1), "num_filter": 5, "no_bias": True},
      "conv2d_1x1_no_bias"),
    c("Convolution", [U(-1, 1, (1, 2, 5, 6, 5)), U(-1, 1, (3, 2, 3, 3, 3)),
                      U(-1, 1, (3,))],
      {"kernel": (3, 3, 3), "stride": (1, 2, 1), "pad": (1, 1, 0),
       "num_filter": 3}, "conv3d"),
    c("Deconvolution", [U(-1, 1, (2, 4, 7)), U(-1, 1, (4, 3, 3)),
                        U(-1, 1, (3,))],
      {"kernel": (3,), "stride": (2,), "pad": (1,), "adj": (1,),
       "num_filter": 3, "no_bias": False}, "deconv1d_adj"),
    c("Deconvolution", [U(-1, 1, (2, 4, 5, 6)), U(-1, 1, (4, 3, 3, 2))],
      {"kernel": (3, 2), "stride": (2, 2), "pad": (1, 0),
       "num_filter": 6, "num_group": 2}, "deconv2d_groups"),
    c("Deconvolution", [U(-1, 1, (1, 3, 5, 5)), U(-1, 1, (3, 2, 3, 3)),
                        U(-1, 1, (2,))],
      {"kernel": (3, 3), "dilate": (2, 2), "pad": (1, 1),
       "num_filter": 2, "no_bias": False}, "deconv2d_dilate"),
    c("Deconvolution", [U(-1, 1, (1, 2, 3, 4, 3)), U(-1, 1, (2, 2, 2, 2, 2))],
      {"kernel": (2, 2, 2), "stride": (2, 2, 2), "num_filter": 2},
      "deconv3d"),
    # adj at or past the stride and the dilation (torch's output_padding
    # refuses it; the reference pads the dilated input by it)
    c("Deconvolution", [U(-1, 1, (2, 4, 6)), U(-1, 1, (4, 2, 2))],
      {"kernel": (2,), "stride": (2,), "pad": (0,), "adj": (2,),
       "num_filter": 4, "num_group": 2}, "deconv1d_adj_past_stride"),
]


def _deconv_sweep():
    """1-3-D, groups, dilation and adj 0-3, adj both below and above pad,
    with and without bias."""
    out = []
    for nsp in (1, 2, 3):
        for adj in range(4):
            g = 1 + (adj + nsp) % 2
            s, d, p = 1 + adj % 3, 1 + nsp % 2, (adj + nsp) % 3
            k = 2 if nsp == 3 else 3
            cin, cout = 2 * g, 2 * g
            sp = (4,) * nsp if nsp < 3 else (3,) * nsp
            ins = [U(-1, 1, (2, cin) + sp), U(-1, 1, (cin, cout // g)
                                             + (k,) * nsp)]
            kw = {"kernel": (k,) * nsp, "stride": (s,) * nsp,
                  "dilate": (d,) * nsp, "pad": (p,) * nsp,
                  "adj": (adj,) * nsp, "num_filter": cout, "num_group": g}
            if adj % 2:
                ins.append(U(-1, 1, (cout,)))
                kw["no_bias"] = False
            out.append(c("Deconvolution", ins, kw,
                         f"deconv{nsp}d_s{s}_d{d}_p{p}_adj{adj}_g{g}"))
    return out


CONV += _deconv_sweep()


def _pool(pool_type, shape, kernel, stride, pad, convention="valid",
          cip=True, id=None):
    kw = {"kernel": kernel, "stride": stride, "pad": pad,
          "pool_type": pool_type, "pooling_convention": convention,
          "count_include_pad": cip}
    return c("Pooling", [U(-2, 2, shape)], kw, id)


POOL = [
    _pool("max", (2, 3, 9, 9), (3, 3), (2, 2), (1, 1), id="max2d_valid"),
    _pool("max", (2, 3, 8, 8), (3, 3), (2, 2), (1, 1), "full",
          id="max2d_full"),
    _pool("max", (2, 3, 10), (3,), (2,), (0,), "full", id="max1d_full"),
    _pool("max", (1, 2, 5, 6, 5), (2, 2, 2), (2, 2, 2), (0, 1, 0),
          id="max3d"),
    _pool("max", (2, 2, 7, 7), (2, 2), (2, 2), (1, 1), "full",
          id="max2d_full_pad"),
    _pool("max", (2, 2, 8, 8), (3, 3), (1, 1), (2, 2),
          id="max2d_pad_past_half_window"),
    _pool("avg", (2, 3, 9, 9), (3, 3), (2, 2), (1, 1), id="avg2d_valid"),
    _pool("avg", (2, 3, 9, 9), (3, 3), (2, 2), (1, 1), cip=False,
          id="avg2d_valid_exclude_pad"),
    _pool("avg", (2, 3, 8, 8), (3, 3), (2, 2), (1, 1), "full",
          id="avg2d_full"),
    _pool("avg", (2, 3, 8, 8), (3, 3), (2, 2), (1, 1), "full", cip=False,
          id="avg2d_full_exclude_pad"),
    _pool("avg", (2, 3, 11), (4,), (3,), (1,), id="avg1d"),
    _pool("avg", (2, 3, 11), (4,), (3,), (1,), "full", cip=False,
          id="avg1d_full_exclude_pad"),
    _pool("avg", (1, 2, 6, 5, 6), (3, 2, 3), (2, 1, 2), (1, 0, 1),
          id="avg3d"),
    _pool("sum", (2, 3, 8, 8), (2, 3), (2, 2), (0, 1), id="sum2d"),
    _pool("sum", (2, 3, 8, 8), (3, 3), (2, 2), (1, 1), "full",
          id="sum2d_full"),
    _pool("lp", (2, 3, 8, 8), (2, 2), (2, 2), (0, 0), id="lp2d"),
    _pool("lp", (2, 3, 9), (3,), (2,), (1,), "full", id="lp1d_full"),
]

GLOBAL_POOL = [
    c("Pooling", [U(-2, 2, shape)], {"kernel": (1,) * (len(shape) - 2),
                                     "pool_type": t, "global_pool": True},
      f"global_{t}_{len(shape) - 2}d")
    for t in ("max", "avg", "sum", "lp")
    for shape in ((2, 3), (2, 3, 7), (2, 3, 5, 6), (1, 2, 3, 4, 3))
]

CASES = NORM + CONV + POOL + GLOBAL_POOL
_ARGS = "name,inputs,kwargs,grad,rtol,atol,cmp"


@pytest.mark.parametrize(_ARGS, NORM)
def test_norm_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


@pytest.mark.parametrize(_ARGS, CONV)
def test_conv_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


@pytest.mark.parametrize(_ARGS, POOL + GLOBAL_POOL)
def test_pool_ops(name, inputs, kwargs, grad, rtol, atol, cmp):
    _check(name, inputs, kwargs, grad, rtol, atol, cmp)


def _bf16_bn(side):
    nd, ctx = (jnd, jmx.cpu) if side == "jax" else (tnd, tmx.cpu)
    rng = np.random.RandomState(5)
    x = rng.uniform(-2, 2, (4, 3, 5, 5)).astype(np.float32)
    ch = [rng.uniform(0.5, 1.5, (3,)).astype(np.float32) for _ in range(4)]
    with ctx():
        out, mean, var = nd.BatchNorm(
            nd.array(x).astype("bfloat16"), *[nd.array(a) for a in ch],
            fix_gamma=False, output_mean_var=True, _train=True)
        return out, mean, var


def test_batch_norm_bf16_statistics_stay_f32():
    """Under bf16 data the statistics are f32 and the output stays bf16,
    in both packages; the statistics agree to f32 rounding of a sum of
    bf16 values, the output to one bf16 ulp."""
    want = _bf16_bn("jax")
    got = _bf16_bn("torch")
    assert [a.astorch().dtype for a in got] == [
        torch.bfloat16, torch.float32, torch.float32]
    assert [np.dtype(a.dtype).name for a in want] == ["bfloat16", "float32",
                                                     "float32"]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(got[0].astype("float32").asnumpy(),
                               want[0].astype("float32").asnumpy(),
                               rtol=2 ** -7, atol=2 ** -7)


def test_max_pool_tied_inputs_route_like_reference():
    """On a window whose maxima tie, both packages hand the gradient to
    one element of the tie, the first in the window's row-major order."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    grads = {}
    for side, (nd, ag, ctx) in {"jax": (jnd, jmx.autograd, jmx.cpu),
                                "torch": (tnd, tag, tmx.cpu)}.items():
        with ctx():
            a = nd.array(x)
            a.attach_grad()
            with ag.record():
                y = nd.Pooling(a, kernel=(2, 2), stride=(2, 2),
                               pool_type="max")
            y.backward()
            grads[side] = a.grad.asnumpy()
    assert grads["torch"].sum() == grads["jax"].sum() == 4.0
    np.testing.assert_array_equal(grads["torch"], grads["jax"])


# ---------------------------------------------------------------------------
# The Gluon layers over these ops (gluon/nn/conv_layers.py and the
# BatchNorm family of basic_layers.py), with the reference's weights
# ---------------------------------------------------------------------------

LAYERS = [
    ("Conv1D", dict(channels=4, kernel_size=3, strides=2, padding=1),
     (2, 3, 9)),
    ("Conv2D", dict(channels=6, kernel_size=(3, 2), padding=(1, 0),
                    dilation=(2, 1), groups=3, activation="relu"),
     (2, 3, 7, 6)),
    ("Conv3D", dict(channels=2, kernel_size=2, use_bias=False),
     (1, 2, 4, 5, 4)),
    ("Conv1DTranspose", dict(channels=3, kernel_size=3, strides=2,
                             padding=1, output_padding=1), (2, 4, 6)),
    ("Conv2DTranspose", dict(channels=4, kernel_size=3, strides=2,
                             groups=2), (2, 4, 5, 5)),
    ("Conv3DTranspose", dict(channels=2, kernel_size=2, strides=2),
     (1, 2, 3, 2, 3)),
    ("MaxPool2D", dict(pool_size=3, strides=2, padding=1, ceil_mode=True),
     (2, 3, 8, 8)),
    ("AvgPool1D", dict(pool_size=3, strides=2, padding=1,
                       count_include_pad=False), (2, 3, 10)),
    ("AvgPool3D", dict(pool_size=2, ceil_mode=True), (1, 2, 5, 4, 5)),
    ("GlobalMaxPool1D", {}, (2, 3, 7)),
    ("GlobalAvgPool2D", {}, (2, 3, 5, 6)),
    ("ReflectionPad2D", dict(padding=2), (2, 3, 5, 6)),
    ("BatchNorm", dict(momentum=0.8, epsilon=1e-3), (4, 3, 5, 5)),
    ("BatchNorm", dict(axis=-1, scale=False), (6, 4)),
    ("InstanceNorm", dict(scale=True), (2, 3, 6, 5)),
    ("GroupNorm", dict(num_groups=2), (2, 4, 3, 5)),
]


def _layer_run(side, name, kw, x, arrays, seed):
    nd, autograd, ctx = ((jnd, jmx.autograd, jmx.cpu) if side == "jax"
                         else (tnd, tag, tmx.cpu))
    mod = jmx if side == "jax" else tmx
    with ctx():
        layer = getattr(mod.gluon.nn, name)(**kw)
        layer.initialize()
        layer(nd.array(x))  # resolve deferred shapes (predict mode)
        params = layer._collect_params_with_prefix()
        if arrays is None:
            rng = np.random.RandomState(seed)
            arrays = {k: (rng.uniform(0.5, 1.5, p.shape) if "var" in k
                          else rng.uniform(-1, 1, p.shape))
                      .astype(np.float32) for k, p in params.items()}
        for k, p in params.items():
            p.set_data(nd.array(arrays[k]))
        xs = nd.array(x)
        xs.attach_grad()
        with autograd.record():
            out = layer(xs)
        out.backward(nd.array(np.random.RandomState(7).randn(*out.shape)
                              .astype(np.float32)))
        grads = {k: p.grad().asnumpy() for k, p in params.items()
                 if p.grad_req != "null"}
        stats = {k: p.data().asnumpy() for k, p in params.items()
                 if p.grad_req == "null"}
        return out.asnumpy(), xs.grad.asnumpy(), grads, stats, arrays


@pytest.mark.parametrize("name,kw,shape", LAYERS,
                         ids=[f"{n}-{i}" for i, (n, _k, _s)
                              in enumerate(LAYERS)])
def test_layers_match_reference(name, kw, shape):
    """Each layer's training-mode forward, input and parameter gradients
    and (BatchNorm) the running statistics it folds, with the
    reference's weights carried by structural name."""
    x = np.random.RandomState(3).uniform(-2, 2, shape).astype(np.float32)
    want = _layer_run("jax", name, kw, x, None, seed=4)
    got = _layer_run("torch", name, kw, x, want[-1], seed=4)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for part in (2, 3):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            np.testing.assert_allclose(got[part][k], want[part][k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
