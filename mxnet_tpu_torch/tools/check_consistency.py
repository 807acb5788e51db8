"""Op consistency sweep: the card against the CPU (the port's counterpart
of ``tools/check_tpu_consistency.py``).

The reference framework's GPU test tier reruns the CPU op suite on the
accelerator and compares each result with the CPU's (its
``check_consistency``). This sweep does that for the port: every case of
the reference's table (the same groups, names, inputs from
``RandomState(0)`` and per-case tolerances) runs on ``mx.cpu()`` and on
``mx.gpu(0)`` and is compared::

    python -m mxnet_tpu_torch.tools.check_consistency                 # all
    python -m mxnet_tpu_torch.tools.check_consistency --ops nn        # one group
    python -m mxnet_tpu_torch.tools.check_consistency --json OUT.json
    python -m mxnet_tpu_torch.tools.check_consistency --self-check    # CPU vs CPU

Exit code 0 when every case matches, 1 when any fails, 2 when ``--ops``
selects nothing. Without a card (and without ``--self-check``) the sweep
exits 1 with the port's ``platform_init_failed`` artifact; the reference
prints "nothing to cross-check" and exits 0, which would hide a missing
device.

``grad_flash`` holds the gradients of ``flash_attention`` on CUDA f32
tensors (the hand-written forward and backward kernels) to the plain
attention's gradients on the CPU. The random cases differ from the
reference's by necessity: torch's CPU and CUDA generators are different
streams, so one seed cannot give one draw on both devices. Each random
case checks instead that a seed repeats its draw exactly on each device,
and that 10**5 card draws and 10**5 CPU draws agree in mean and variance
within six standard errors of the difference of two independent sample
statistics (``_moments_bound``).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

_RANDOM_N = 100_000
_SIGMAS = 6.0


def _cases(rng):
    """(group, name, fn(nd, *arrays), inputs, kwargs-for-check): the
    forward cases, every op family."""
    x = rng.rand(4, 8).astype(np.float32) + 0.1
    xs = rng.randn(4, 8).astype(np.float32)
    pos = np.abs(rng.rand(4, 8).astype(np.float32)) + 0.1
    img = rng.rand(2, 3, 8, 8).astype(np.float32)
    w = rng.rand(4, 3, 3, 3).astype(np.float32)
    fc_w = rng.rand(16, 8).astype(np.float32)
    seq = rng.rand(6, 2, 4).astype(np.float32)
    idx = np.array([1, 0, 2, 1], np.float32)
    cases = []

    def add(group, name, fn, inputs, **kw):
        cases.append((group, name, fn, inputs, kw))

    # ---------------- elemwise unary (the long tail) ----------------
    # the reference's bands, kept as they are: ops built on log get
    # rtol=1e-3 (its accelerator's transcendental units approximated them);
    # everything else holds the tight 1e-4 default
    LOG_BAND = dict(rtol=1e-3, atol=1e-5)
    unary_simple = [
        "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt", "rsqrt",
        "cbrt", "square", "abs", "sign", "floor", "ceil", "round", "trunc",
        "rint", "fix", "sigmoid", "erf", "relu", "softsign", "gamma",
        "gammaln", "reciprocal",
    ]
    log_family = {"log", "log2", "log10", "log1p", "gammaln"}
    for name in unary_simple:
        add("elemwise", name,
            (lambda nd, a, _n=name: getattr(nd, _n)(a)), [pos],
            **(LOG_BAND if name in log_family else {}))
    trig = ["sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh",
            "cosh", "tanh", "arcsinh", "arctanh", "degrees", "radians"]
    for name in trig:
        add("elemwise", name,
            (lambda nd, a, _n=name: getattr(nd, _n)(a * 0.5)), [x - 0.5],
            **(LOG_BAND if name in ("arcsinh", "arctanh") else {}))
    add("elemwise", "arccosh", lambda nd, a: nd.arccosh(a + 1.0), [pos],
        **LOG_BAND)
    add("elemwise", "clip", lambda nd, a: nd.clip(a, a_min=0.2, a_max=0.8), [x])
    add("elemwise", "gelu_tanh", lambda nd, a: nd.gelu(a), [xs])
    add("elemwise", "hard_sigmoid", lambda nd, a: nd.hard_sigmoid(a), [xs])
    add("elemwise", "softrelu", lambda nd, a: nd.Activation(
        a, act_type="softrelu"), [xs], **LOG_BAND)

    # ---------------- elemwise binary / broadcast ----------------
    binary = ["broadcast_add", "broadcast_sub", "broadcast_mul",
              "broadcast_div", "broadcast_maximum", "broadcast_minimum",
              "broadcast_power", "broadcast_hypot"]
    for name in binary:
        add("broadcast", name,
            (lambda nd, a, b, _n=name: getattr(nd, _n)(a, b[:1] + 0.5)),
            [pos, pos])
    cmp_ops = ["broadcast_equal", "broadcast_not_equal", "broadcast_greater",
               "broadcast_lesser", "broadcast_greater_equal",
               "broadcast_lesser_equal"]
    for name in cmp_ops:
        add("broadcast", name,
            (lambda nd, a, b, _n=name: getattr(nd, _n)(
                nd.round(a * 4), nd.round(b[:1] * 4))), [x, x])
    add("broadcast", "where",
        lambda nd, c, a, b: nd.where(c > 0.5, a, b), [x, x, pos])
    add("elemwise", "maximum_scalar",
        lambda nd, a: nd._maximum_scalar(a, scalar=0.4), [x])
    add("elemwise", "power_scalar", lambda nd, a: a ** 2.5, [pos])
    add("elemwise", "rminus_scalar", lambda nd, a: 1.0 - a, [x])
    add("elemwise", "rdiv_scalar", lambda nd, a: 2.0 / a, [pos])
    add("elemwise", "mod", lambda nd, a, b: nd.broadcast_mod(
        nd.round(a * 10) + 1, nd.round(b[:1] * 3) + 1), [pos, pos])

    # ---------------- reductions ----------------
    for name in ["sum", "mean", "prod", "max", "min"]:
        add("reduce", f"{name}_axis1",
            (lambda nd, a, _n=name: getattr(nd, _n)(a, axis=1)), [x])
        add("reduce", f"{name}_all",
            (lambda nd, a, _n=name: getattr(nd, _n)(a)), [x])
    add("reduce", "nansum", lambda nd, a: nd.nansum(a, axis=0), [x])
    add("reduce", "norm_ord2", lambda nd, a: nd.norm(a, ord=2, axis=1), [x])
    add("reduce", "argmax", lambda nd, a: nd.argmax(a, axis=1), [x])
    add("reduce", "argmin", lambda nd, a: nd.argmin(a, axis=1), [x])
    add("reduce", "logsumexp",
        lambda nd, a: nd.log(nd.sum(nd.exp(a), axis=1)), [x])

    # ---------------- matrix / linalg ----------------
    add("matrix", "dot", lambda nd, a, b: nd.dot(a, b.T), [x, x])
    add("matrix", "dot_T", lambda nd, a, b: nd.dot(a.T, b), [x, x])
    add("matrix", "batch_dot",
        lambda nd, a, b: nd.batch_dot(a.reshape((2, 2, 8)),
                                      b.reshape((2, 8, 2))), [x, x])
    add("matrix", "transpose", lambda nd, a: nd.transpose(a), [x])
    add("matrix", "reshape_slice",
        lambda nd, a: nd.slice(a.reshape((8, 4)), begin=(2, 1),
                               end=(6, 3)), [x])
    add("matrix", "diag", lambda nd, a: nd.diag(a), [x])
    add("linalg", "linalg_gemm2",
        lambda nd, a, b: nd.linalg_gemm2(a, b, transpose_b=True), [x, x])
    add("linalg", "linalg_syrk",
        lambda nd, a: nd.linalg_syrk(a, transpose=False), [x])
    add("linalg", "linalg_potrf",
        lambda nd, a: nd.linalg_potrf(
            nd.dot(a, a.T) + 8.0 * nd.one_hot(
                nd.arange(4), depth=4)), [x], rtol=1e-3, atol=1e-4)
    add("matrix", "histogram",
        lambda nd, a: nd.histogram(a, bin_cnt=5, range=(0.0, 1.0))[0]
        .astype("float32"), [x])

    # ---------------- nn core ----------------
    add("nn", "FullyConnected",
        lambda nd, a, w_: nd.FullyConnected(a, w_, num_hidden=16,
                                            no_bias=True), [x, fc_w])
    add("nn", "Convolution_3x3",
        lambda nd, a, w_: nd.Convolution(a, w_, kernel=(3, 3), num_filter=4,
                                         pad=(1, 1), no_bias=True), [img, w])
    add("nn", "Convolution_stride2",
        lambda nd, a, w_: nd.Convolution(a, w_, kernel=(3, 3), num_filter=4,
                                         stride=(2, 2), no_bias=True),
        [img, w])
    add("nn", "Convolution_grouped",
        lambda nd, a, w_: nd.Convolution(
            a, w_, kernel=(3, 3), num_filter=3,
            num_group=3, pad=(1, 1), no_bias=True),
        [img, rng.rand(3, 1, 3, 3).astype(np.float32)])
    add("nn", "Deconvolution",
        lambda nd, a, w_: nd.Deconvolution(
            a, w_, kernel=(3, 3), num_filter=4, no_bias=True),
        [img, rng.rand(3, 4, 3, 3).astype(np.float32)])
    add("nn", "Pooling_max",
        lambda nd, a: nd.Pooling(a, kernel=(2, 2), stride=(2, 2),
                                 pool_type="max"), [img])
    add("nn", "Pooling_avg",
        lambda nd, a: nd.Pooling(a, kernel=(3, 3), stride=(2, 2),
                                 pad=(1, 1), pool_type="avg"), [img])
    add("nn", "Pooling_global",
        lambda nd, a: nd.Pooling(a, global_pool=True, pool_type="avg"),
        [img])
    add("nn", "softmax", lambda nd, a: nd.softmax(a, axis=-1), [x])
    add("nn", "log_softmax", lambda nd, a: nd.log_softmax(a, axis=-1), [x])
    add("nn", "softmax_temp",
        lambda nd, a: nd.softmax(a, axis=-1, temperature=2.0), [x])
    add("nn", "LayerNorm",
        lambda nd, a, g, b: nd.LayerNorm(a, g, b, axis=-1),
        [x, np.ones(8, np.float32), np.zeros(8, np.float32)])
    add("nn", "BatchNorm_inference",
        lambda nd, a, g, b, m, v: nd.BatchNorm(
            a, g, b, m, v, use_global_stats=True),
        [img, np.ones(3, np.float32), np.zeros(3, np.float32),
         np.zeros(3, np.float32), np.ones(3, np.float32)])
    add("nn", "InstanceNorm",
        lambda nd, a, g, b: nd.InstanceNorm(a, g, b),
        [img, np.ones(3, np.float32), np.zeros(3, np.float32)])
    add("nn", "L2Normalization",
        lambda nd, a: nd.L2Normalization(a, mode="instance"), [x])
    add("nn", "LRN", lambda nd, a: nd.LRN(a, nsize=3), [img])
    add("nn", "UpSampling",
        lambda nd, a: nd.UpSampling(a, scale=2, sample_type="nearest"),
        [img])
    for act in ["relu", "sigmoid", "tanh"]:
        add("nn", f"Activation_{act}",
            (lambda nd, a, _t=act: nd.Activation(a, act_type=_t)), [xs])
    add("nn", "LeakyReLU",
        lambda nd, a: nd.LeakyReLU(a, act_type="leaky", slope=0.1), [xs])
    add("nn", "PReLU",
        lambda nd, a, g: nd.LeakyReLU(a, g, act_type="prelu"),
        [xs, np.full((8,), 0.2, np.float32)])
    add("nn", "Embedding",
        lambda nd, i, w_: nd.Embedding(i, w_, input_dim=16, output_dim=8),
        [idx, fc_w])
    add("nn", "SoftmaxOutput",
        lambda nd, a, l: nd.SoftmaxOutput(a, l), [x, idx])
    add("nn", "Correlation",
        lambda nd, a, b: nd.Correlation(a, b, kernel_size=1,
                                        max_displacement=1, pad_size=1),
        [img, img * 0.5])

    # ---------------- indexing / ordering ----------------
    add("indexing", "take", lambda nd, a, i: nd.take(a, i), [x, idx])
    add("indexing", "one_hot", lambda nd, i: nd.one_hot(i, depth=4), [idx])
    add("indexing", "gather_nd",
        lambda nd, a, i: nd.gather_nd(a, i.reshape((1, 4)).astype("int32")),
        [x, idx])
    add("indexing", "slice_axis",
        lambda nd, a: nd.slice_axis(a, axis=1, begin=2, end=6), [x])
    add("indexing", "reverse", lambda nd, a: nd.reverse(a, axis=1), [x])
    add("indexing", "tile", lambda nd, a: nd.tile(a, reps=(2, 1)), [x])
    add("indexing", "pick",
        lambda nd, a, i: nd.pick(a, i, axis=1), [x, idx])
    add("ordering", "topk_value",
        lambda nd, a: nd.topk(a, k=3, ret_typ="value"), [x])
    add("ordering", "topk_indices",
        lambda nd, a: nd.topk(a, k=3).astype("float32"), [x])
    add("ordering", "sort", lambda nd, a: nd.sort(a, axis=-1), [x])
    add("ordering", "argsort",
        lambda nd, a: nd.argsort(a, axis=-1).astype("float32"), [x])

    # ---------------- sequence / rnn ----------------
    add("sequence", "SequenceReverse",
        lambda nd, s: nd.SequenceReverse(s), [seq])
    add("sequence", "SequenceMask",
        lambda nd, s, l: nd.SequenceMask(s, l, use_sequence_length=True,
                                         value=-1.0),
        [seq, np.array([3, 5], np.float32)])
    add("sequence", "SequenceLast",
        lambda nd, s, l: nd.SequenceLast(s, l, use_sequence_length=True),
        [seq, np.array([3, 5], np.float32)])
    rnn_x = rng.rand(5, 2, 4).astype(np.float32)

    def _rnn(nd, xx, mode, state_size, ngates):
        h = 3
        n_params = ngates * h * (4 + h + 2)
        if mode == "lstm":
            n_params = 4 * h * (4 + h + 2)
        params = np.linspace(-0.1, 0.1, n_params).astype(np.float32)
        init_h = nd.zeros((1, 2, h))
        args = [xx, nd.array(params), init_h]
        if mode == "lstm":
            args.append(nd.zeros((1, 2, h)))
        return nd.RNN(*args, state_size=h, num_layers=1, mode=mode)

    add("rnn", "RNN_lstm", lambda nd, xx: _rnn(nd, xx, "lstm", 3, 4),
        [rnn_x], rtol=1e-3, atol=1e-4)
    add("rnn", "RNN_gru", lambda nd, xx: _rnn(nd, xx, "gru", 3, 3),
        [rnn_x], rtol=1e-3, atol=1e-4)

    # ---------------- loss / output ----------------
    add("loss", "MakeLoss", lambda nd, a: nd.MakeLoss(nd.square(a)), [x])
    add("loss", "smooth_l1", lambda nd, a: nd.smooth_l1(a, scalar=1.0), [xs])
    add("loss", "CTCLoss",
        lambda nd, a, l: nd.CTCLoss(a, l)[0]
        if isinstance(nd.CTCLoss(a, l), (tuple, list)) else nd.CTCLoss(a, l),
        [rng.rand(6, 2, 5).astype(np.float32),
         np.array([[1, 2], [2, 3]], np.float32)], rtol=1e-3, atol=1e-4)

    # ---------------- contrib ----------------
    add("contrib", "box_nms",
        lambda nd, d: nd.contrib.box_nms(d.reshape((1, 4, 6)),
                                         overlap_thresh=0.5),
        [np.abs(rng.rand(24).astype(np.float32))])
    add("contrib", "boolean_mask",
        lambda nd, a, m: nd.contrib.boolean_mask(a, nd.round(m[:, 0])),
        [x, np.array([[1], [0], [1], [1]], np.float32)])
    add("contrib", "multibox_prior",
        lambda nd, a: nd.contrib.MultiBoxPrior(a, sizes=(0.5, 0.25),
                                               ratios=(1, 2)), [img])
    add("contrib", "roi_align",
        lambda nd, a, r: nd.contrib.ROIAlign(a, r, pooled_size=(2, 2),
                                             spatial_scale=1.0),
        [img, np.array([[0, 1, 1, 6, 6]], np.float32)])
    add("contrib", "deformable_conv_zero_offset",
        lambda nd, a, w_, o: nd.contrib.DeformableConvolution(
            a, o, w_, kernel=(3, 3), num_filter=4, pad=(1, 1),
            no_bias=True),
        [img, w, np.zeros((2, 18, 8, 8), np.float32)],
        rtol=1e-3, atol=1e-4)
    add("contrib", "index_copy",
        lambda nd, a, i, t: nd.contrib.index_copy(
            a, i.astype("int32"), t),
        [x, np.array([0, 2], np.float32), rng.rand(2, 8).astype(np.float32)])

    # ---------------- image / quantization ----------------
    add("image", "to_tensor",
        lambda nd, a: nd.image.to_tensor((a * 255).astype("uint8")),
        [rng.rand(8, 8, 3).astype(np.float32)])
    add("image", "normalize",
        lambda nd, a: nd.image.normalize(a, mean=(0.5, 0.5, 0.5),
                                         std=(0.25, 0.25, 0.25)), [img[0]])
    add("image", "resize",
        lambda nd, a: nd.image.resize(a.transpose((1, 2, 0)), size=4),
        [img[0]])
    add("image", "flip_lr",
        lambda nd, a: nd.image.flip_left_right(a.transpose((1, 2, 0))),
        [img[0]])
    add("quant", "quantize_v2",
        lambda nd, a: nd.contrib.quantize_v2(a)[0].astype("float32"), [x])
    add("quant", "quantize_dequantize",
        lambda nd, a: nd.contrib.dequantize(
            *nd.contrib.quantize_v2(a, min_calib_range=0.0,
                                    max_calib_range=1.0)), [x])

    # ---------------- optimizer updates ----------------
    add("optimizer", "sgd_mom_update",
        lambda nd, w_, g, m: nd.sgd_mom_update(w_, g, m, lr=0.01,
                                               momentum=0.9)[0],
        [x, x * 0.1, np.zeros_like(x)])
    add("optimizer", "adam_update",
        lambda nd, w_, g, m, v: nd.adam_update(w_, g, m, v, lr=0.01)[0],
        [x, x * 0.1, np.zeros_like(x), np.zeros_like(x)])
    add("optimizer", "ftrl_update",
        lambda nd, w_, g, z, n_: nd.ftrl_update(w_, g, z, n_, lr=0.01)[0],
        [x, x * 0.1, np.zeros_like(x), np.zeros_like(x)])
    add("optimizer", "lamb_phase1",
        lambda nd, w_, g, m, v: nd.lamb_update_phase1(
            w_, g, m, v, t=1, wd=0.01)[0],
        [x, x * 0.1, np.zeros_like(x), np.zeros_like(x)])

    # ---------------- control flow ----------------
    add("control", "foreach_cumsum",
        lambda nd, s: nd.contrib.foreach(
            lambda d, st: (d + st[0], [d + st[0]]), s,
            [nd.zeros((2, 4))])[0], [seq])

    # ---------------- linalg long tail ----------------------------------
    spd = np.dot(x[:4, :4], x[:4, :4].T) + 4.0 * np.eye(4, dtype=np.float32)
    tri = np.tril(rng.rand(4, 4).astype(np.float32)) + np.eye(4, dtype=np.float32)
    add("linalg", "det", lambda nd, a: nd.linalg_det(
        a[:4, :4] + 2 * nd.one_hot(nd.arange(4), depth=4)), [x],
        rtol=1e-3, atol=1e-4)
    add("linalg", "slogdet",
        lambda nd, a: nd.linalg_slogdet(a)[1], [spd], rtol=1e-3, atol=1e-4)
    add("linalg", "inverse", lambda nd, a: nd.linalg_inverse(a), [spd],
        rtol=1e-3, atol=1e-4)
    add("linalg", "gemm",
        lambda nd, a, b, c: nd.linalg_gemm(a, b, c, alpha=1.5, beta=0.5),
        [x[:4, :4], x[:4, :4], x[:4, :4]])
    add("linalg", "trmm", lambda nd, t, a: nd.linalg_trmm(t, a), [tri, spd],
        rtol=1e-3, atol=1e-4)
    add("linalg", "trsm", lambda nd, t, a: nd.linalg_trsm(t, a), [tri, spd],
        rtol=1e-3, atol=1e-4)
    add("linalg", "extractdiag",
        lambda nd, a: nd.linalg_extractdiag(a), [spd])
    add("linalg", "makediag",
        lambda nd, a: nd.linalg_makediag(a[0]), [x])
    add("linalg", "extracttrian",
        lambda nd, a: nd.linalg_extracttrian(a), [spd])
    add("linalg", "khatri_rao",
        lambda nd, a, b: nd.khatri_rao(a[:2], b[:3]), [x, x])
    add("linalg", "potri",
        lambda nd, a: nd.linalg_potri(nd.linalg_potrf(a)), [spd],
        rtol=1e-3, atol=1e-4)
    add("linalg", "sumlogdiag",
        lambda nd, a: nd.linalg_sumlogdiag(nd.linalg_potrf(a)), [spd],
        **LOG_BAND)
    add("linalg", "gelqf_recon",
        lambda nd, a: (lambda ql: nd.batch_dot(
            ql[1].reshape((1, 2, 2)), ql[0].reshape((1, 2, 8))))(
            nd.linalg_gelqf(a[:2])), [x], rtol=1e-3, atol=1e-4)
    add("linalg", "syevd_recon",
        lambda nd, a: (lambda uw: nd.dot(nd.dot(
            uw[0].T, nd.diag(uw[1])), uw[0]))(nd.linalg_syevd(a)), [spd],
        rtol=1e-3, atol=1e-4)
    add("linalg", "moments",
        lambda nd, a: nd.concat(*nd.moments(a, axes=(0,)), dim=0), [x])

    # ---------------- pdf ops (deterministic given samples) --------------
    u01 = rng.rand(2, 6).astype(np.float32) * 0.8 + 0.1
    two_z = np.zeros(2, np.float32)
    two_o = np.ones(2, np.float32)
    add("pdf", "uniform",
        lambda nd, s, lo, hi: nd.random_pdf_uniform(s, lo, hi * 2),
        [u01, two_z, two_o])
    add("pdf", "normal",
        lambda nd, s, mu, sg: nd.random_pdf_normal(s, mu, sg),
        [u01, two_z, two_o], **LOG_BAND)
    add("pdf", "exponential",
        lambda nd, s, lam: nd.random_pdf_exponential(s, lam),
        [u01, two_o], **LOG_BAND)
    add("pdf", "gamma",
        lambda nd, s, al, be: nd.random_pdf_gamma(s, al * 2, be),
        [u01, two_o, two_o], **LOG_BAND)
    add("pdf", "poisson",
        lambda nd, s, lam: nd.random_pdf_poisson(nd.round(s * 4), lam * 2),
        [u01, two_o], **LOG_BAND)

    # ---------------- control flow variants ------------------------------
    add("control", "while_loop_counter",
        lambda nd, s: nd.contrib.while_loop(
            lambda st: st[1] < 4,
            lambda st: (st[0].sum(), [st[0] * 1.5, st[1] + 1]),
            [s, nd.zeros((1,))], max_iterations=8)[1][0], [x])
    add("control", "cond_branch_then",
        lambda nd, a: nd.contrib.cond(
            lambda *_: (a.sum() > 0), lambda *_: a * 2.0,
            lambda *_: a - 1.0), [x])
    # negative-sum input forces the ELSE branch — the untaken-branch
    # lowering is the harder half of cond and must be cross-checked too
    add("control", "cond_branch_else",
        lambda nd, a: nd.contrib.cond(
            lambda *_: (a.sum() > 0), lambda *_: a * 2.0,
            lambda *_: a - 1.0), [x - 5.0])
    add("control", "foreach_stack",
        lambda nd, s: nd.contrib.foreach(
            lambda d, st: (d * 2, st), s, [])[0], [seq])

    # ---------------- quantized op family --------------------------------
    def _qfc(nd, a, w_):
        qa, mna, mxa = nd.contrib.quantize_v2(a, min_calib_range=0.0,
                                              max_calib_range=1.0)
        qw, mnw, mxw = nd.contrib.quantize_v2(w_, min_calib_range=-1.0,
                                              max_calib_range=1.0)
        acc, mn, mx = nd.contrib.quantized_fully_connected(
            qa, qw, nd.zeros((1,)), mna, mxa, mnw, mxw, no_bias=True,
            num_hidden=16)
        return nd.contrib.dequantize(acc, mn, mx)

    add("quant", "quantized_fc_chain", _qfc, [x, fc_w])

    def _qconv(nd, a, w_):
        qa, mna, mxa = nd.contrib.quantize_v2(a, min_calib_range=0.0,
                                              max_calib_range=1.0)
        qw, mnw, mxw = nd.contrib.quantize_v2(w_, min_calib_range=-1.0,
                                              max_calib_range=1.0)
        acc, mn, mx = nd.contrib.quantized_conv(
            qa, qw, nd.zeros((1,)), mna, mxa, mnw, mxw, kernel=(3, 3),
            num_filter=4, pad=(1, 1), no_bias=True)
        return nd.contrib.dequantize(acc, mn, mx)

    add("quant", "quantized_conv_chain", _qconv, [img, w])
    add("quant", "quantized_pooling",
        lambda nd, a: nd.contrib.quantized_pooling(
            *nd.contrib.quantize_v2(a, min_calib_range=0.0,
                                    max_calib_range=1.0),
            kernel=(2, 2), stride=(2, 2), pool_type="max")[0]
        .astype("float32"), [img])

    # ---------------- detection / misc tail ------------------------------
    add("contrib", "multibox_target",
        lambda nd, anch, lab, cp: nd.contrib.MultiBoxTarget(
            anch.reshape((1, 8, 4)) * 0.1 + 0.2,
            lab.reshape((1, 4, 5)) * 0.2 + 0.1,
            cp.reshape((1, 2, 8)))[0],
        [np.abs(rng.rand(32).astype(np.float32)),
         np.abs(rng.rand(20).astype(np.float32)),
         rng.rand(16).astype(np.float32)])
    add("contrib", "multibox_detection",
        lambda nd, cp, lp, anch: nd.contrib.MultiBoxDetection(
            nd.softmax(cp.reshape((1, 3, 4)), axis=1),
            lp.reshape((1, 16)), anch.reshape((1, 4, 4)) * 0.2 + 0.1,
            threshold=0.01),
        [rng.rand(12).astype(np.float32), rng.rand(16).astype(np.float32) * 0.1,
         np.abs(rng.rand(16).astype(np.float32))])
    add("misc", "pad_edge",
        lambda nd, a: nd.pad(a, mode="edge",
                             pad_width=(0, 0, 0, 0, 1, 1, 1, 1)), [img])
    add("misc", "unravel_index",
        lambda nd, a: nd.unravel_index(nd.round(a[0] * 30),
                                       shape=(8, 8)).astype("float32"), [x])
    add("misc", "ravel_multi_index",
        lambda nd, a: nd.ravel_multi_index(
            nd.round(a[:2, :4] * 6), shape=(8, 8)).astype("float32"), [x])

    # ---------------- bf16 tolerance-band variants (the product ops) ----
    bf16 = dict(dtypes=("bfloat16",), rtol=2e-2, atol=2e-2)
    add("bf16", "dot", lambda nd, a, b: nd.dot(a, b.T), [x, x], **bf16)
    add("bf16", "FullyConnected",
        lambda nd, a, w_: nd.FullyConnected(a, w_, num_hidden=16,
                                            no_bias=True), [x, fc_w], **bf16)
    add("bf16", "Convolution",
        lambda nd, a, w_: nd.Convolution(a, w_, kernel=(3, 3), num_filter=4,
                                         pad=(1, 1), no_bias=True),
        [img, w], **bf16)
    add("bf16", "softmax", lambda nd, a: nd.softmax(a, axis=-1), [x], **bf16)
    add("bf16", "exp", lambda nd, a: nd.exp(a), [x], **bf16)
    add("bf16", "LayerNorm",
        lambda nd, a, g, b: nd.LayerNorm(a, g, b, axis=-1),
        [x, np.ones(8, np.float32), np.zeros(8, np.float32)], **bf16)
    add("bf16", "batch_dot",
        lambda nd, a, b: nd.batch_dot(a.reshape((2, 2, 8)),
                                      b.reshape((2, 8, 2))), [x, x], **bf16)
    add("bf16", "Pooling_avg",
        lambda nd, a: nd.Pooling(a, kernel=(2, 2), stride=(2, 2),
                                 pool_type="avg"), [img], **bf16)

    return cases


def _grad_cases(rng):
    """(group, name, fn, inputs, kwargs): forward and backward cases, run
    through check_grad_consistency: a fixed cotangent weights the output,
    every differentiable input's gradient is compared card against CPU,
    and the case's max-rel-err is recorded."""
    x = rng.rand(4, 8).astype(np.float32) + 0.1
    xs = rng.randn(4, 8).astype(np.float32)
    pos = np.abs(rng.rand(4, 8).astype(np.float32)) + 0.1
    img = rng.rand(2, 3, 8, 8).astype(np.float32)
    w = rng.rand(4, 3, 3, 3).astype(np.float32)
    fc_w = rng.rand(16, 8).astype(np.float32)
    seq = rng.rand(6, 2, 4).astype(np.float32)
    idx = np.array([1, 0, 2, 1], np.float32)
    cases = []

    def add(group, name, fn, inputs, **kw):
        cases.append((group, name, fn, inputs, kw))

    # ---- elemwise unary vjps (the log family keeps the reference's band)
    LOG_BAND = dict(rtol=3e-3, atol=1e-4)
    for name in ["exp", "sqrt", "rsqrt", "cbrt", "square", "abs", "sigmoid",
                 "erf", "relu", "softsign", "reciprocal", "expm1"]:
        add("grad_elemwise", name,
            (lambda nd, a, _n=name: getattr(nd, _n)(a)), [pos])
    for name in ["log", "log2", "log10", "log1p"]:
        add("grad_elemwise", name,
            (lambda nd, a, _n=name: getattr(nd, _n)(a)), [pos], **LOG_BAND)
    for name in ["sin", "cos", "tan", "arcsin", "arctan", "sinh", "cosh",
                 "tanh", "arcsinh"]:
        add("grad_elemwise", name,
            (lambda nd, a, _n=name: getattr(nd, _n)(a * 0.5)), [x - 0.5])
    add("grad_elemwise", "gelu", lambda nd, a: nd.gelu(a), [xs])
    add("grad_elemwise", "clip",
        lambda nd, a: nd.clip(a, a_min=0.2, a_max=0.8), [x])

    # ---- binary / broadcast vjps (both operands)
    for name in ["broadcast_add", "broadcast_sub", "broadcast_mul",
                 "broadcast_div", "broadcast_maximum", "broadcast_minimum",
                 "broadcast_power", "broadcast_hypot"]:
        add("grad_broadcast", name,
            (lambda nd, a, b, _n=name: getattr(nd, _n)(a, b[:1] + 0.5)),
            [pos, pos])
    add("grad_broadcast", "where",
        lambda nd, c, a, b: nd.where(c > 0.5, a, b), [x, x, pos], wrt=(1, 2))

    # ---- reductions
    for name in ["sum", "mean", "prod", "max", "min"]:
        add("grad_reduce", f"{name}_axis1",
            (lambda nd, a, _n=name: getattr(nd, _n)(a, axis=1)), [x])
    add("grad_reduce", "norm_ord2",
        lambda nd, a: nd.norm(a, ord=2, axis=1), [x])
    add("grad_reduce", "logsumexp",
        lambda nd, a: nd.log(nd.sum(nd.exp(a), axis=1)), [x], **LOG_BAND)

    # ---- matrix
    add("grad_matrix", "dot", lambda nd, a, b: nd.dot(a, b.T), [x, x])
    add("grad_matrix", "batch_dot",
        lambda nd, a, b: nd.batch_dot(a.reshape((2, 2, 8)),
                                      b.reshape((2, 8, 2))), [x, x])
    add("grad_matrix", "linalg_gemm2",
        lambda nd, a, b: nd.linalg_gemm2(a, b, transpose_b=True), [x, x])
    add("grad_matrix", "transpose_slice",
        lambda nd, a: nd.slice(nd.transpose(a), begin=(1, 0), end=(7, 3)),
        [x])

    # ---- nn core (the training-critical set)
    add("grad_nn", "FullyConnected",
        lambda nd, a, w_: nd.FullyConnected(a, w_, num_hidden=16,
                                            no_bias=True), [x, fc_w])
    add("grad_nn", "Convolution_3x3",
        lambda nd, a, w_: nd.Convolution(a, w_, kernel=(3, 3), num_filter=4,
                                         pad=(1, 1), no_bias=True), [img, w])
    add("grad_nn", "Convolution_stride2",
        lambda nd, a, w_: nd.Convolution(a, w_, kernel=(3, 3), num_filter=4,
                                         stride=(2, 2), no_bias=True),
        [img, w])
    add("grad_nn", "Convolution_grouped",
        lambda nd, a, w_: nd.Convolution(
            a, w_, kernel=(3, 3), num_filter=3, num_group=3, pad=(1, 1),
            no_bias=True),
        [img, rng.rand(3, 1, 3, 3).astype(np.float32)])
    add("grad_nn", "Deconvolution",
        lambda nd, a, w_: nd.Deconvolution(
            a, w_, kernel=(3, 3), num_filter=4, no_bias=True),
        [img, rng.rand(3, 4, 3, 3).astype(np.float32)])
    add("grad_nn", "Pooling_max",
        lambda nd, a: nd.Pooling(a, kernel=(2, 2), stride=(2, 2),
                                 pool_type="max"), [img])
    add("grad_nn", "Pooling_avg",
        lambda nd, a: nd.Pooling(a, kernel=(3, 3), stride=(2, 2),
                                 pad=(1, 1), pool_type="avg"), [img])
    add("grad_nn", "Pooling_global",
        lambda nd, a: nd.Pooling(a, global_pool=True, pool_type="avg"),
        [img])
    add("grad_nn", "softmax", lambda nd, a: nd.softmax(a, axis=-1), [x])
    add("grad_nn", "log_softmax",
        lambda nd, a: nd.log_softmax(a, axis=-1), [x])
    add("grad_nn", "LayerNorm",
        lambda nd, a, g, b: nd.LayerNorm(a, g, b, axis=-1),
        [x, np.ones(8, np.float32), np.zeros(8, np.float32)])
    # BatchNorm TRAIN mode: batch stats on the forward, grads through the
    # normalization
    add("grad_nn", "BatchNorm_train",
        lambda nd, a, g, b, m, v: nd.BatchNorm(a, g, b, m, v),
        [img, np.ones(3, np.float32), np.zeros(3, np.float32),
         np.zeros(3, np.float32), np.ones(3, np.float32)], wrt=(0, 1, 2))
    add("grad_nn", "InstanceNorm",
        lambda nd, a, g, b: nd.InstanceNorm(a, g, b),
        [img, np.ones(3, np.float32), np.zeros(3, np.float32)])
    add("grad_nn", "L2Normalization",
        lambda nd, a: nd.L2Normalization(a, mode="instance"), [x])
    for act in ["relu", "sigmoid", "tanh", "softrelu"]:
        add("grad_nn", f"Activation_{act}",
            (lambda nd, a, _t=act: nd.Activation(a, act_type=_t)), [xs])
    add("grad_nn", "LeakyReLU",
        lambda nd, a: nd.LeakyReLU(a, act_type="leaky", slope=0.1), [xs])
    add("grad_nn", "PReLU",
        lambda nd, a, g: nd.LeakyReLU(a, g, act_type="prelu"),
        [xs, np.full((8,), 0.2, np.float32)])
    add("grad_nn", "Embedding_wgrad",
        lambda nd, i, w_: nd.Embedding(i, w_, input_dim=16, output_dim=8),
        [idx, fc_w], wrt=(1,))
    # SoftmaxOutput's backward IS the cross-entropy gradient (p - onehot)
    add("grad_loss", "SoftmaxOutput",
        lambda nd, a, l: nd.SoftmaxOutput(a, l), [x, idx], wrt=(0,))
    add("grad_loss", "smooth_l1",
        lambda nd, a: nd.smooth_l1(a, scalar=1.0), [xs])
    add("grad_loss", "CTCLoss",
        lambda nd, a, l: nd.CTCLoss(a, l),
        [rng.rand(6, 2, 5).astype(np.float32),
         np.array([[1, 2], [2, 3]], np.float32)],
        wrt=(0,), rtol=3e-3, atol=1e-4)

    # ---- sequence / rnn scan
    add("grad_seq", "SequenceMask",
        lambda nd, s, l: nd.SequenceMask(s, l, use_sequence_length=True,
                                         value=-1.0),
        [seq, np.array([3, 5], np.float32)], wrt=(0,))
    add("grad_seq", "SequenceReverse",
        lambda nd, s: nd.SequenceReverse(s), [seq])
    rnn_x = rng.rand(5, 2, 4).astype(np.float32)

    def _rnn_grad(nd, xx, params, mode):
        h = 3
        init_h = nd.zeros((1, 2, h))
        args = [xx, params, init_h]
        if mode == "lstm":
            args.append(nd.zeros((1, 2, h)))
        return nd.RNN(*args, state_size=h, num_layers=1, mode=mode)

    lstm_p = np.linspace(-0.1, 0.1, 4 * 3 * (4 + 3 + 2)).astype(np.float32)
    gru_p = np.linspace(-0.1, 0.1, 3 * 3 * (4 + 3 + 2)).astype(np.float32)
    add("grad_rnn", "RNN_lstm",
        lambda nd, xx, p_: _rnn_grad(nd, xx, p_, "lstm"), [rnn_x, lstm_p],
        rtol=3e-3, atol=1e-4)
    add("grad_rnn", "RNN_gru",
        lambda nd, xx, p_: _rnn_grad(nd, xx, p_, "gru"), [rnn_x, gru_p],
        rtol=3e-3, atol=1e-4)

    # ---- contrib
    add("grad_contrib", "roi_align",
        lambda nd, a, r: nd.contrib.ROIAlign(a, r, pooled_size=(2, 2),
                                             spatial_scale=1.0),
        [img, np.array([[0, 1, 1, 6, 6]], np.float32)], wrt=(0,))
    add("grad_contrib", "deformable_conv",
        lambda nd, a, w_, o: nd.contrib.DeformableConvolution(
            a, o, w_, kernel=(3, 3), num_filter=4, pad=(1, 1), no_bias=True),
        [img, w, np.zeros((2, 18, 8, 8), np.float32)], wrt=(0, 1),
        rtol=3e-3, atol=1e-4)
    add("grad_contrib", "interleaved_selfatt",
        lambda nd, qkv: nd.contrib.interleaved_matmul_selfatt_qk(
            qkv, heads=2),
        [rng.rand(6, 2, 2 * 3 * 4).astype(np.float32)])

    # ---- optimizer update rules (grad wrt the incoming gradient: the
    # update math itself must backprop identically — multi-precision /
    # second-order uses compose through these)
    add("grad_opt", "sgd_mom_update",
        lambda nd, w_, g, m: nd.sgd_mom_update(w_, g, m, lr=0.01,
                                               momentum=0.9)[0],
        [x, x * 0.1, np.zeros_like(x)], wrt=(0, 1))
    add("grad_opt", "adam_update",
        lambda nd, w_, g, m, v: nd.adam_update(w_, g, m, v, lr=0.01)[0],
        [x, x * 0.1, np.zeros_like(x), np.zeros_like(x)], wrt=(0, 1))

    # ---- bf16 band variants of the product vjps
    bf16 = dict(dtype="bfloat16", rtol=3e-2, atol=3e-2)
    add("grad_bf16", "dot", lambda nd, a, b: nd.dot(a, b.T), [x, x], **bf16)
    add("grad_bf16", "Convolution",
        lambda nd, a, w_: nd.Convolution(a, w_, kernel=(3, 3), num_filter=4,
                                         pad=(1, 1), no_bias=True),
        [img, w], **bf16)
    add("grad_bf16", "softmax",
        lambda nd, a: nd.softmax(a, axis=-1), [x], **bf16)
    add("grad_bf16", "LayerNorm",
        lambda nd, a, g, b: nd.LayerNorm(a, g, b, axis=-1),
        [x, np.ones(8, np.float32), np.zeros(8, np.float32)], **bf16)

    return cases


def _flash_grad_case(self_check=False):
    """Flash-attention vjp: the CUDA forward and backward kernels on the
    card against the plain attention's gradients on the CPU (a different
    implementation on a different device, the same math). Under
    ``self_check`` the wrappers run their plain versions on the CPU.
    Returns the worst max_rel_err."""
    import torch

    from ..ops.attention import plain_attention
    from ..ops.flash_attention import flash_attention
    from ..test_utils import max_rel_err

    rng = np.random.RandomState(3)
    B, H, S, D = 1, 2, 256, 64
    q, k, v = [rng.randn(B, H, S, D).astype(np.float32) * 0.5
               for _ in range(3)]
    cot = np.linspace(0.5, 1.5, B * H * S * D).reshape(B, H, S, D) \
        .astype(np.float32)

    def grads(attn, device):
        ts = [torch.tensor(a, device=device, requires_grad=True)
              for a in (q, k, v)]
        out = attn(*ts, causal=True)
        (out * torch.tensor(cot, device=device)).sum().backward()
        return [t.grad.cpu().numpy() for t in ts]

    ref = grads(plain_attention, "cpu")
    tst = grads(flash_attention, "cpu" if self_check else "cuda")
    worst = 0.0
    for g_t, g_r in zip(tst, ref):
        np.testing.assert_allclose(g_t, g_r, rtol=3e-3, atol=3e-4)
        worst = max(worst, max_rel_err(g_t, g_r, atol=3e-4))
    return worst


def _random_cases():
    """Seeded random ops: each repeats its draw under one seed on each
    device, and the card's draws match the CPU's in distribution."""
    return [("random", name, name) for name in
            ["uniform", "normal", "gamma", "exponential"]]


def _moments_bound(x):
    """Six standard errors of the difference of two independent sample
    means and of two sample variances of ``len(x)`` draws each, from the
    CPU sample ``x``: sqrt(2 var / n) and sqrt(2 (m4 - var^2) / n), m4
    the fourth central moment."""
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    var = x.var()
    m4 = np.mean((x - x.mean()) ** 4)
    return (_SIGMAS * np.sqrt(2.0 * var / n),
            _SIGMAS * np.sqrt(2.0 * max(m4 - var * var, 0.0) / n))


def _random_case(mx, dist, ctxs):
    """Same seed, same draw, on each device; then the moments of the
    first device's draws against the second's. Returns the worst ratio of
    a moment's difference to its bound."""
    sampler = getattr(mx.nd.random, dist)
    big = []
    for ctx in ctxs:
        draws = []
        for _ in range(2):
            mx.random.seed(1234, ctx=ctx)
            draws.append(sampler(shape=(3, 4), ctx=ctx).asnumpy())
        np.testing.assert_array_equal(draws[0], draws[1])
        mx.random.seed(1234, ctx=ctx)
        big.append(sampler(shape=(_RANDOM_N,), ctx=ctx).asnumpy()
                   .astype(np.float64))
    mean_bound, var_bound = _moments_bound(big[0])
    d_mean = abs(big[0].mean() - big[1].mean())
    d_var = abs(big[0].var() - big[1].var())
    if d_mean > mean_bound or d_var > var_bound:
        raise AssertionError(
            f"{dist}: card and CPU draws differ: |mean diff| {d_mean:.3e} "
            f"(bound {mean_bound:.3e}), |var diff| {d_var:.3e} (bound "
            f"{var_bound:.3e})")
    return max(d_mean / mean_bound, d_var / var_bound)


def _bind(mx, fn):
    """``fn(nd, *arrays)`` run inside the arrays' context, so that the
    arrays a case makes itself (``nd.zeros``) land beside its inputs."""
    def run(*arrs):
        with arrs[0].context:
            return fn(mx.nd, *arrs)
    return run


def _record(results, failures, group, name, kind, fn):
    try:
        err = fn()
    except Exception as e:  # noqa: BLE001 - report and continue
        failures.append((group, name, str(e)[:200]))
        print(f"FAIL {group:<12} {name}: {str(e)[:120]}")
        results.append({"group": group, "op": name, "kind": kind,
                        "ok": False, "error": str(e)[:300]})
        return
    print(f"OK   {group:<12} {name} (max_rel_err {err:.2e})")
    results.append({"group": group, "op": name, "kind": kind, "ok": True,
                    "max_rel_err": err})


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ops", default=None, help="only this group")
    p.add_argument("--json", default=None, help="write artifact JSON here")
    p.add_argument("--self-check", action="store_true",
                   help="cpu-vs-cpu dry run (validates the case table "
                        "without a card; used by the test suite)")
    args = p.parse_args(argv)

    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import platform
    from mxnet_tpu_torch.test_utils import (check_consistency,
                                            check_grad_consistency)

    if args.self_check:
        platform.devices_or_exit(
            what="mxnet_tpu_torch/tools/check_consistency.py", backend="cpu")
        second = mx.cpu()
    else:
        # no card: the platform_init_failed artifact and exit 1
        platform.devices_or_exit(
            what="mxnet_tpu_torch/tools/check_consistency.py")
        second = mx.gpu(0)
    ctxs = [mx.cpu(), second]

    rng = np.random.RandomState(0)
    results, failures = [], []
    n = 0
    for group, name, fn, inputs, kw in _cases(rng):
        if args.ops and group != args.ops:
            continue
        n += 1
        _record(results, failures, group, name, "forward",
                lambda: check_consistency(_bind(mx, fn), inputs,
                                          ctx_list=ctxs, **kw))

    for group, name, fn, inputs, kw in _grad_cases(rng):
        if args.ops and group != args.ops:
            continue
        n += 1
        _record(results, failures, group, name, "grad",
                lambda: check_grad_consistency(_bind(mx, fn), inputs,
                                               ctx_list=ctxs, **kw))

    if not args.ops or args.ops == "grad_flash":
        # the reference's case name; the kernels it holds are the port's
        # CUDA flash forward and backward
        n += 1
        _record(results, failures, "grad_flash", "pallas_bwd_vs_plain_cpu",
                "grad", lambda: _flash_grad_case(args.self_check))

    for group, name, dist in _random_cases():
        if args.ops and group != args.ops:
            continue
        n += 1
        _record(results, failures, group, name, "random",
                lambda: _random_case(mx, dist, ctxs))

    where = "CPU (self-check)" if args.self_check else "card"
    print(f"\n{n - len(failures)}/{n} ops consistent {where} vs CPU")
    if args.json:
        worst = {}
        for r in results:
            if r["ok"]:
                worst[r["group"]] = max(worst.get(r["group"], 0.0),
                                        r["max_rel_err"])
        payload = {
            "n_cases": n,
            "n_ok": n - len(failures),
            "device": ("cpu" if args.self_check
                       else torch.cuda.get_device_name(0)),
            "worst_by_group": worst,
            "results": results,
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")
    if n == 0:
        print(f"no cases matched --ops {args.ops!r}")
        return 2  # an empty sweep must not read as a pass
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
