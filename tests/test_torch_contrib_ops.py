"""The port's contrib, image and ``nn`` extra ops
(``mxnet_tpu_torch/ops/{contrib,image_ops,nn}.py``), ``nd.image``/
``nd.linalg`` and ``gluon.contrib.nn`` against the JAX package, on the CPU.

The same numpy inputs go through both packages. Orderings, masks and kept
NMS rows are held exactly (stable descending order: tied scores keep their
index order), f32 values at rtol 1e-5 / atol 1e-6, gradients at rtol 1e-4
/ atol 1e-5. Resizes of uint8 images truncate as ``astype`` does: their
f32 values agree within f32 rounding, so a value within 1e-4 of an integer
may truncate one apart (it is counted and bounded, never skipped). The
random image ops are held by shape and dtype exactly and by distribution.
The reference's own cases (``tests/test_contrib_aux.py``,
``tests/test_op_longtail.py``, ``tests/test_detection_map.py``) run on
both packages, with their assertions.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.ops.registry import _REGISTRY as JREG
from mxnet_tpu.ops.registry import get_op as jget
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops.registry import _REGISTRY as TREG
from mxnet_tpu_torch.ops.registry import get_op as tget

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GRTOL, GATOL = 1e-4, 1e-5


# the ops this file holds to the reference (test_torch_ops.py's census)
COVERED = {f"_contrib_{n}" for n in (
    "MultiBoxPrior", "MultiBoxTarget", "box_nms", "MultiBoxDetection",
    "ROIAlign", "arange_like", "div_sqrt_dim", "SyncBatchNorm",
    "DeformableConvolution", "ModulatedDeformableConvolution",
    "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt",
    "BilinearResize2D", "AdaptiveAvgPooling2D", "quadratic",
    "gradientmultiplier", "getnnz", "dynamic_reshape")} | {
    f"_image_{n}" for n in (
        "to_tensor", "normalize", "flip_left_right", "flip_top_bottom",
        "random_flip_left_right", "random_flip_top_bottom", "resize",
        "crop", "random_brightness", "random_contrast", "random_saturation",
        "random_hue", "random_color_jitter", "adjust_lighting",
        "random_lighting")} | {
    "LinearRegressionOutput", "MAERegressionOutput",
    "LogisticRegressionOutput", "SVMOutput", "UpSampling",
    "BilinearSampler", "GridGenerator", "SpatialTransformer", "Correlation",
    "LRN"}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref(name, *arrays, **kw):
    out = jget(name).fn(*[None if a is None else jnp.asarray(a)
                          for a in arrays], **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _port(name, *arrays, **kw):
    out = tget(name).fn(*[None if a is None else torch.from_numpy(
        np.array(a)) for a in arrays], **kw)
    if isinstance(out, tuple):
        return tuple(o.detach().numpy() for o in out)
    return out.detach().numpy()


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _grads(name, arrays, wrt, kw, seed=0):
    """(reference, port) gradients of sum(op(*arrays) * w) with respect to
    the inputs at positions ``wrt``; w is a fixed random weight."""
    out = _ref(name, *arrays, **kw)
    out0 = out[0] if isinstance(out, tuple) else out
    w = np.random.RandomState(seed).randn(*out0.shape).astype(np.float32)

    def jf(*xs):
        full = list(arrays)
        for i, x in zip(wrt, xs):
            full[i] = x
        o = jget(name).fn(*[None if a is None else jnp.asarray(a)
                            for a in full], **kw)
        o = o[0] if isinstance(o, tuple) else o
        return jnp.sum(o * w)

    want = jax.grad(jf, argnums=tuple(range(len(wrt))))(
        *[jnp.asarray(arrays[i]) for i in wrt])
    ts = [None if a is None else torch.tensor(np.array(a)) for a in arrays]
    for i in wrt:
        ts[i].requires_grad_(True)
    o = tget(name).fn(*ts, **kw)
    o = o[0] if isinstance(o, tuple) else o
    (o * torch.from_numpy(w)).sum().backward()
    # an input the output does not depend on gets no gradient: zeros
    got = [np.zeros_like(arrays[i]) if ts[i].grad is None
           else ts[i].grad.numpy() for i in wrt]
    return [np.asarray(g) for g in want], got


def _grads_close(name, arrays, wrt, kw):
    want, got = _grads(name, arrays, wrt, kw)
    for g, r in zip(got, want):
        _close(g, r, GRTOL, GATOL)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_equals_reference():
    assert set(TREG) == set(JREG)
    assert len(TREG) == 488
    assert len({id(v) for v in TREG.values()}) == 328
    for name in TREG:  # the same op under every alias
        same = {n for n in JREG if JREG[n] is JREG[name]}
        assert {n for n in TREG if TREG[n] is TREG[name]} == same, name


def test_no_registered_op_is_a_raise_stub():
    """The reference's check: no registered op starts by raising
    NotImplementedError."""
    import ast
    import inspect
    import textwrap

    for name, op in TREG.items():
        try:
            tree = ast.parse(textwrap.dedent(inspect.getsource(op.fn)))
        except (OSError, TypeError, SyntaxError):
            continue
        fn = next((n for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)), None)
        body = [s for s in (fn.body if fn else [])
                if not (isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Constant))]
        if body and isinstance(body[0], ast.Raise):
            exc = body[0].exc
            assert getattr(getattr(exc, "func", None), "id", "") != \
                "NotImplementedError", name


# ---------------------------------------------------------------------------
# multibox: prior, target, NMS, detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(sizes=(0.5, 0.25), ratios=(1, 2)),
    dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5), clip=True),
    dict(sizes=(0.37,), ratios=(1, 3), steps=(0.1, 0.08),
         offsets=(0.3, 0.6)),
], ids=["two-sizes", "clip", "steps-offsets"])
def test_multibox_prior_matches_reference(kw):
    x = np.zeros((2, 3, 5, 7), np.float32)
    _same(_port("_contrib_MultiBoxPrior", x, **kw),
          _ref("_contrib_MultiBoxPrior", x, **kw))


def _labels(rng, b, m, num_classes=4, fill=None):
    """[cls, l, t, r, b] rows, 1..fill boxes an image, -1 padding."""
    lab = np.full((b, m, 5), -1, np.float32)
    for i in range(b):
        for k in range(rng.randint(1, (fill or m) + 1)):
            x0, y0 = rng.rand(2) * 0.6
            w, h = 0.2 + rng.rand(2) * 0.2
            lab[i, k] = [rng.randint(0, num_classes), x0, y0,
                         min(x0 + w, 1.0), min(y0 + h, 1.0)]
    return lab


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multibox_target_matches_reference(seed):
    rng = np.random.RandomState(seed)
    anchors = _ref("_contrib_MultiBoxPrior", np.zeros((1, 1, 6, 6),
                                                      np.float32),
                   sizes=(0.3, 0.2), ratios=(1, 2, 0.5))
    n = anchors.shape[1]
    label = _labels(rng, 3, 4)
    cls_pred = rng.rand(3, 5, n).astype(np.float32)
    kw = dict(overlap_threshold=[0.5, 0.4, 0.6][seed])
    got = _port("_contrib_MultiBoxTarget", anchors, label, cls_pred, **kw)
    want = _ref("_contrib_MultiBoxTarget", anchors, label, cls_pred, **kw)
    _close(got[0], want[0])           # loc_target
    _same(got[1], want[1])            # loc_mask
    _same(got[2], want[2])            # cls_target
    assert got[1].any()


def test_multibox_target_forced_match_with_padding():
    """Padded ground truths all argmax to anchor 0: the forced match is a
    scatter-max, so a real match there survives them."""
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0]]], np.float32)
    label = np.array([[[-1, 0, 0, 0, 0], [-1, 0, 0, 0, 0],
                       [2.0, 0.0, 0.0, 0.1, 0.1]]], np.float32)
    cls_pred = np.zeros((1, 3, 3), np.float32)
    got = _port("_contrib_MultiBoxTarget", anchors, label, cls_pred)
    want = _ref("_contrib_MultiBoxTarget", anchors, label, cls_pred)
    for g, w in zip(got, want):
        _same(g, w)
    assert got[2][0, 0] == 3.0


def _nms_rows(seed, b=3, n=60, tie_levels=5):
    """Rows [id, score, l, t, r, b] with scores on a coarse grid (many
    ties) and overlapping boxes."""
    rng = np.random.RandomState(seed)
    d = np.zeros((b, n, 6), np.float32)
    d[..., 0] = rng.randint(0, 3, (b, n))
    d[..., 1] = np.round(rng.rand(b, n) * tie_levels) / tie_levels
    d[..., 2:4] = rng.rand(b, n, 2) * 0.7
    d[..., 4:6] = d[..., 2:4] + 0.1 + rng.rand(b, n, 2) * 0.3
    return d


_NMS_KW = {
    "default": dict(),
    "topk": dict(topk=10),
    "per-class": dict(id_index=0),
    "force-suppress-topk": dict(id_index=0, force_suppress=True, topk=25),
    "background": dict(id_index=0, background_id=1, valid_thresh=0.1),
    "threshold-0.3": dict(overlap_thresh=0.3, valid_thresh=0.2),
    "center": dict(in_format="center", overlap_thresh=0.4),
}


@pytest.mark.parametrize("case", sorted(_NMS_KW))
@pytest.mark.parametrize("seed", [0, 1])
def test_box_nms_matches_reference_with_ties(case, seed):
    d = _nms_rows(seed)
    kw = _NMS_KW[case]
    _same(_port("_contrib_box_nms", d, **kw), _ref("_contrib_box_nms", d,
                                                   **kw))


def test_box_nms_tied_scores_keep_index_order():
    """Equal scores sort in index order (the reference's stable argsort
    of the negated scores)."""
    d = np.zeros((1, 6, 6), np.float32)
    d[0, :, 1] = 0.5
    d[0, :, 2] = np.arange(6) * 0.2
    d[0, :, 4] = d[0, :, 2] + 0.1
    d[0, :, 5] = 0.1
    got = _port("_contrib_box_nms", d, overlap_thresh=0.5)
    _same(got, _ref("_contrib_box_nms", d, overlap_thresh=0.5))
    np.testing.assert_array_equal(got[0, :, 2], d[0, :, 2])


def test_box_nms_batched_leading_dims():
    d = _nms_rows(3, b=4).reshape(2, 2, 60, 6)
    _same(_port("_contrib_box_nms", d, topk=30),
          _ref("_contrib_box_nms", d, topk=30))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nms_routes_agree_bitwise(seed):
    """The card's fixed-point route and the per-row loop keep the same
    rows, on suppression matrices from real boxes and on random ones."""
    rng = np.random.RandomState(seed)
    boxes = torch.from_numpy(_nms_rows(seed, b=4, n=80)[..., 2:6].copy())
    iou = tcontrib._iou(boxes, boxes)
    lower = torch.ones(80, 80, dtype=torch.bool).tril(-1)
    for sup in (iou > 0.3, torch.from_numpy(rng.rand(4, 80, 80) < 0.05)):
        sup = sup & lower
        valid = torch.from_numpy(rng.rand(4, 80) < 0.9)
        loop = tcontrib.nms_keep_loop(sup, valid)
        fixed = tcontrib.nms_keep_fixed_point(sup, valid)
        assert torch.equal(loop, fixed)


def _nms_chain(t, shift=0.3):
    """t rows [id, score, l, t, r, b] with falling scores, each box
    overlapping only the next (IoU 0.54 with it, 0.25 with the one after):
    the greedy keep alternates, and row i is final only after i rounds."""
    d = np.zeros((1, t, 6), np.float32)
    d[0, :, 1] = np.linspace(0.9, 0.5, t, dtype=np.float32)
    d[0, :, 2] = np.arange(t, dtype=np.float32) * shift
    d[0, :, 4] = d[0, :, 2] + 1.0
    d[0, :, 5] = 1.0
    return d


@pytest.mark.parametrize("t", list(range(1, 14)))
def test_nms_fixed_point_on_chains(t):
    """The fixed point needs t - 1 rounds on a chain; it must run them all,
    for every t modulo the rounds between its convergence tests."""
    boxes = torch.from_numpy(_nms_chain(t)[..., 2:6].copy())
    sup = (tcontrib._iou(boxes, boxes) > 0.45) & torch.ones(
        t, t, dtype=torch.bool).tril(-1)
    valid = torch.ones(1, t, dtype=torch.bool)
    loop = tcontrib.nms_keep_loop(sup, valid)
    assert loop[0].tolist() == [i % 2 == 0 for i in range(t)]
    assert torch.equal(tcontrib.nms_keep_fixed_point(sup, valid), loop)


@pytest.mark.parametrize("t", [2, 3, 6, 7])
def test_box_nms_chain_matches_reference(t):
    d = _nms_chain(t)
    _same(_port("_contrib_box_nms", d, overlap_thresh=0.45),
          _ref("_contrib_box_nms", d, overlap_thresh=0.45))


_DET_KW = {"default": dict(), "topk": dict(nms_topk=20),
           "force": dict(force_suppress=True, nms_threshold=0.3),
           "no-clip-bg1": dict(clip=False, background_id=1,
                               threshold=0.2)}


@pytest.mark.parametrize("case", sorted(_DET_KW))
def test_multibox_detection_matches_reference(case):
    rng = np.random.RandomState(4)
    anchors = _ref("_contrib_MultiBoxPrior", np.zeros((1, 1, 5, 5),
                                                      np.float32),
                   sizes=(0.4, 0.25), ratios=(1, 2, 0.5))
    n = anchors.shape[1]
    cls_prob = rng.rand(2, 4, n).astype(np.float32)
    cls_prob /= cls_prob.sum(1, keepdims=True)
    loc = (rng.randn(2, n * 4) * 0.5).astype(np.float32)
    kw = _DET_KW[case]
    got = _port("_contrib_MultiBoxDetection", cls_prob, loc, anchors, **kw)
    want = _ref("_contrib_MultiBoxDetection", cls_prob, loc, anchors, **kw)
    _same(got[..., 0], want[..., 0])  # ids and the suppressed rows
    _close(got, want)
    assert (got[..., 0] >= 0).sum() > 0


# the reference's own detection cases (tests/test_contrib_aux.py), run
# on both packages


def _case_multibox_prior(M):
    x = M.nd.ones((1, 3, 4, 4))
    anchors = M.nd.contrib.MultiBoxPrior(x, sizes=(0.5, 0.25), ratios=(1, 2))
    assert anchors.shape == (1, 4 * 4 * 3, 4)
    a = anchors.asnumpy()[0]
    cx, cy = (a[0, 0] + a[0, 2]) / 2, (a[0, 1] + a[0, 3]) / 2
    np.testing.assert_allclose([cx, cy], [0.125, 0.125], atol=1e-6)
    np.testing.assert_allclose(a[0, 2] - a[0, 0], 0.5, atol=1e-6)
    return [a]


def _case_box_nms_suppresses_overlaps(M):
    boxes = np.array([[0, 0.9, 0.0, 0.0, 0.5, 0.5],
                      [0, 0.8, 0.05, 0.05, 0.55, 0.55],
                      [0, 0.7, 0.6, 0.6, 0.9, 0.9],
                      [0, 0.0, 0.0, 0.0, 0.1, 0.1]], np.float32)
    out = M.nd.contrib.box_nms(M.nd.array(boxes[None]), overlap_thresh=0.5,
                               valid_thresh=0.01).asnumpy()[0]
    kept = out[:, 1][out[:, 1] > 0]
    assert len(kept) == 2
    np.testing.assert_allclose(sorted(kept, reverse=True), [0.9, 0.7],
                               atol=1e-6)
    return [out]


def _case_box_nms_per_class(M):
    boxes = np.array([[0, 0.9, 0.0, 0.0, 0.5, 0.5],
                      [1, 0.8, 0.0, 0.0, 0.5, 0.5]], np.float32)
    out = M.nd.contrib.box_nms(M.nd.array(boxes[None]), overlap_thresh=0.5,
                               id_index=0, force_suppress=False).asnumpy()[0]
    assert (out[:, 1] > 0).sum() == 2
    out2 = M.nd.contrib.box_nms(M.nd.array(boxes[None]), overlap_thresh=0.5,
                                id_index=0,
                                force_suppress=True).asnumpy()[0]
    assert (out2[:, 1] > 0).sum() == 1
    return [out, out2]


def _case_multibox_target_matching(M):
    anchors = np.array([[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                        [0.0, 0.5, 0.5, 1.0]], np.float32)
    label = np.array([[[1.0, 0.0, 0.0, 0.5, 0.5], [-1, 0, 0, 0, 0]]],
                     np.float32)
    cls_pred = np.zeros((1, 3, 3), np.float32)
    loc_t, loc_m, cls_t = M.nd.contrib.MultiBoxTarget(
        M.nd.array(anchors[None]), M.nd.array(label), M.nd.array(cls_pred))
    cls = cls_t.asnumpy()[0]
    assert cls[0] == 2.0 and cls[1] == 0.0
    m = loc_m.asnumpy()[0].reshape(3, 4)
    assert m[0].all() and not m[1].any()
    np.testing.assert_allclose(loc_t.asnumpy()[0][:4], 0.0, atol=1e-5)
    return [loc_t.asnumpy(), loc_m.asnumpy(), cls_t.asnumpy()]


def _case_multibox_detection_decode(M):
    anchors = np.array([[0.1, 0.1, 0.3, 0.3], [0.6, 0.6, 0.9, 0.9]],
                       np.float32)
    cls_prob = np.array([[[0.1, 0.8], [0.9, 0.2]]], np.float32)
    loc_pred = np.zeros((1, 8), np.float32)
    out = M.nd.contrib.MultiBoxDetection(
        M.nd.array(cls_prob), M.nd.array(loc_pred),
        M.nd.array(anchors[None])).asnumpy()[0]
    valid = out[out[:, 0] >= 0]
    assert valid.shape[0] == 2
    best = valid[np.argmax(valid[:, 1])]
    np.testing.assert_allclose(best[1], 0.9, atol=1e-5)
    np.testing.assert_allclose(best[2:], [0.1, 0.1, 0.3, 0.3], atol=1e-5)
    return [out]


def _case_roi_align_shapes_and_values(M):
    data = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    out = M.nd.contrib.ROIAlign(M.nd.array(data), M.nd.array(rois),
                                pooled_size=(2, 2), spatial_scale=1.0)
    assert out.shape == (1, 1, 2, 2)
    v = out.asnumpy()[0, 0]
    assert v[0, 0] < v[1, 1]
    return [v]


def _case_map_end_to_end_multibox_detection(M):
    """tests/test_detection_map.py: anchors on the ground truths, zero
    offsets, confident scores -> MultiBoxDetection -> VOC07 mAP 1;
    swapped classes -> 0."""
    gt_boxes = np.asarray([[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]],
                          np.float32)
    gt_cls = [0, 1]
    extra = np.asarray([[0.0, 0.6, 0.25, 0.95]], np.float32)
    anchors = M.nd.array(np.concatenate([gt_boxes, extra])[None])
    cls_prob = np.full((1, 3, 3), 0.02, np.float32)
    cls_prob[0, 0, :] = 0.9
    for i, c in enumerate(gt_cls):
        cls_prob[0, :, i] = 0.02
        cls_prob[0, c + 1, i] = 0.9
    loc_pred = np.zeros((1, 12), np.float32)
    dets = M.nd.contrib.MultiBoxDetection(M.nd.array(cls_prob),
                                          M.nd.array(loc_pred), anchors,
                                          nms_threshold=0.45, threshold=0.1)
    labels = np.concatenate([np.asarray(gt_cls, np.float32)[:, None],
                             gt_boxes], axis=1)[None]
    m = M.metric.VOC07MApMetric(ovp_thresh=0.5)
    m.update([labels], [dets])
    assert abs(m.get()[1] - 1.0) < 1e-9, m.get()
    m2 = M.metric.VOC07MApMetric(ovp_thresh=0.5)
    bad = cls_prob.copy()
    bad[0, 1, :], bad[0, 2, :] = cls_prob[0, 2, :], cls_prob[0, 1, :]
    dets_bad = M.nd.contrib.MultiBoxDetection(
        M.nd.array(bad), M.nd.array(loc_pred), anchors, nms_threshold=0.45,
        threshold=0.1)
    m2.update([labels], [dets_bad])
    assert m2.get()[1] == 0.0
    return [dets.asnumpy(), dets_bad.asnumpy()]


_DETECTION_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_multibox_prior, _case_box_nms_suppresses_overlaps,
    _case_box_nms_per_class, _case_multibox_target_matching,
    _case_multibox_detection_decode, _case_roi_align_shapes_and_values,
    _case_map_end_to_end_multibox_detection)}


@pytest.mark.parametrize("case", sorted(_DETECTION_CASES))
def test_reference_detection_case(case):
    got = _DETECTION_CASES[case](tmx)
    want = _DETECTION_CASES[case](jmx)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# ROIAlign
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(pooled_size=(3, 3), spatial_scale=0.5, sample_ratio=2),
    dict(pooled_size=(2, 4), spatial_scale=1.0, sample_ratio=1,
         aligned=True),
], ids=["scaled", "aligned"])
def test_roi_align_matches_reference(kw):
    rng = np.random.RandomState(5)
    data = rng.randn(2, 3, 9, 11).astype(np.float32)
    rois = np.array([[0, 1.0, 2.0, 13.0, 15.0], [1, 0.0, 0.0, 4.0, 3.0],
                     [1, 5.5, 3.2, 18.0, 16.0], [0, 2.0, 2.0, 2.5, 2.2]],
                    np.float32)
    _close(_port("_contrib_ROIAlign", data, rois, **kw),
           _ref("_contrib_ROIAlign", data, rois, **kw))
    _grads_close("_contrib_ROIAlign", [data, rois], [0], kw)


# ---------------------------------------------------------------------------
# SyncBatchNorm (one device)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("fix_gamma", [True, False])
def test_sync_batch_norm_matches_reference(train, fix_gamma):
    rng = np.random.RandomState(3)
    x = (rng.rand(4, 3, 5, 5) * 3 + 1).astype(np.float32)
    gamma = rng.rand(3).astype(np.float32) + 0.5
    beta = rng.randn(3).astype(np.float32)
    mm = rng.randn(3).astype(np.float32) * 0.1
    mv = rng.rand(3).astype(np.float32) + 0.5
    kw = dict(fix_gamma=fix_gamma, _train=train, output_mean_var=True)
    args = [x, gamma, beta, mm, mv]
    for g, w in zip(_port("_contrib_SyncBatchNorm", *args, **kw),
                    _ref("_contrib_SyncBatchNorm", *args, **kw)):
        _close(g, w)
    _grads_close("_contrib_SyncBatchNorm", args, [0, 1, 2],
                 dict(fix_gamma=fix_gamma, _train=train))


def test_sync_batch_norm_single_matches_bn():
    """The reference's case: on one device SyncBatchNorm is BatchNorm."""
    rng = np.random.RandomState(3)
    x = rng.rand(4, 3, 5, 5).astype(np.float32)
    ones, zeros = np.ones(3, np.float32), np.zeros(3, np.float32)
    kw = dict(fix_gamma=False, _train=True)
    out = _port("_contrib_SyncBatchNorm", x, ones, zeros, zeros, ones, **kw)
    bn = _port("BatchNorm", x, ones, zeros, zeros, ones, **kw)
    np.testing.assert_allclose(out, bn, atol=1e-5)
    _close(out, _ref("_contrib_SyncBatchNorm", x, ones, zeros, zeros, ones,
                     **kw))


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------

_DEFORM = {
    "3x3-pad": dict(kernel=(3, 3), pad=(1, 1), num_filter=6),
    "stride-dilate": dict(kernel=(3, 3), stride=(2, 2), dilate=(2, 2),
                          pad=(2, 2), num_filter=4),
    "groups": dict(kernel=(3, 3), pad=(1, 1), num_filter=4, num_group=2,
                   num_deformable_group=2),
}


def _deform_case(name, seed=6, modulated=False):
    kw = _DEFORM[name]
    rng = np.random.RandomState(seed)
    b, c, h, w = 2, 4, 7, 8
    kh, kw_ = kw["kernel"]
    sh, sw = kw.get("stride", (1, 1))
    dh, dw = kw.get("dilate", (1, 1))
    ph, pw = kw["pad"]
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw_ - 1) - 1) // sw + 1
    dg = kw.get("num_deformable_group", 1)
    x = rng.randn(b, c, h, w).astype(np.float32)
    off = (rng.randn(b, 2 * dg * kh * kw_, ho, wo) * 1.5).astype(np.float32)
    wt = rng.randn(kw["num_filter"], c // kw.get("num_group", 1), kh,
                   kw_).astype(np.float32)
    bias = rng.randn(kw["num_filter"]).astype(np.float32)
    if modulated:
        mask = rng.rand(b, dg * kh * kw_, ho, wo).astype(np.float32)
        return [x, off, mask, wt, bias], kw
    return [x, off, wt, bias], kw


@pytest.mark.parametrize("name", sorted(_DEFORM))
@pytest.mark.parametrize("modulated", [False, True])
def test_deformable_convolution_matches_reference(name, modulated):
    op = ("_contrib_ModulatedDeformableConvolution" if modulated
          else "_contrib_DeformableConvolution")
    args, kw = _deform_case(name, modulated=modulated)
    _close(_port(op, *args, **kw), _ref(op, *args, **kw), atol=1e-5)
    _grads_close(op, args, list(range(len(args))), kw)


def _case_deformable_zero_offset_is_conv(M, fn):
    rng = np.random.RandomState(5)
    x = rng.rand(2, 4, 8, 8).astype(np.float32)
    w = rng.rand(6, 4, 3, 3).astype(np.float32)
    off = np.zeros((2, 18, 8, 8), np.float32)
    out = fn("_contrib_DeformableConvolution", x, off, w, None,
             kernel=(3, 3), pad=(1, 1), num_filter=6, no_bias=True)
    conv = fn("Convolution", x, w, None, kernel=(3, 3), pad=(1, 1),
              num_filter=6, no_bias=True)
    np.testing.assert_allclose(out, conv, atol=1e-4)
    return out


def _case_deformable_integer_offset_shifts(M, fn):
    rng = np.random.RandomState(6)
    x = rng.rand(1, 1, 6, 6).astype(np.float32)
    off = np.zeros((1, 2, 6, 6), np.float32)
    off[:, 1] = 1.0
    out = fn("_contrib_DeformableConvolution", x, off,
             np.ones((1, 1, 1, 1), np.float32), None, kernel=(1, 1),
             num_filter=1, no_bias=True)
    shifted = np.zeros((1, 1, 6, 6), np.float32)
    shifted[..., :, :-1] = x[..., :, 1:]
    np.testing.assert_allclose(out, shifted, atol=1e-5)
    return out


def _case_modulated_mask_scales(M, fn):
    rng = np.random.RandomState(7)
    x = rng.rand(1, 2, 5, 5).astype(np.float32)
    w = rng.rand(3, 2, 3, 3).astype(np.float32)
    out = fn("_contrib_ModulatedDeformableConvolution", x,
             np.zeros((1, 18, 5, 5), np.float32),
             np.full((1, 9, 5, 5), 0.5, np.float32), w, None, kernel=(3, 3),
             pad=(1, 1), num_filter=3, no_bias=True)
    conv = fn("Convolution", x, w, None, kernel=(3, 3), pad=(1, 1),
              num_filter=3, no_bias=True)
    np.testing.assert_allclose(out, 0.5 * conv, atol=1e-4)
    return out


_DEFORM_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_deformable_zero_offset_is_conv,
    _case_deformable_integer_offset_shifts, _case_modulated_mask_scales)}


@pytest.mark.parametrize("case", sorted(_DEFORM_CASES))
def test_reference_deformable_case(case):
    _close(_DEFORM_CASES[case](tmx, _port), _DEFORM_CASES[case](jmx, _ref),
           atol=1e-5)


# ---------------------------------------------------------------------------
# interleaved attention matmuls
# ---------------------------------------------------------------------------

def test_interleaved_selfatt_matches_reference_and_manual():
    rng = np.random.RandomState(8)
    S, B, H, hd = 6, 2, 2, 4
    qkv = rng.rand(S, B, H * 3 * hd).astype(np.float32)
    scores = _port("_contrib_interleaved_matmul_selfatt_qk", qkv, heads=H)
    _close(scores, _ref("_contrib_interleaved_matmul_selfatt_qk", qkv,
                        heads=H))
    x = qkv.reshape(S, B, H, 3, hd)
    q = np.moveaxis(x[:, :, :, 0], 0, 2).reshape(B * H, S, hd)
    k = np.moveaxis(x[:, :, :, 1], 0, 2).reshape(B * H, S, hd)
    np.testing.assert_allclose(
        scores, np.einsum("nqd,nkd->nqk", q, k) / np.sqrt(hd), atol=1e-5)
    att = np.asarray(jax.nn.softmax(scores, axis=-1))
    out = _port("_contrib_interleaved_matmul_selfatt_valatt", qkv, att,
                heads=H)
    assert out.shape == (S, B, H * hd)
    _close(out, _ref("_contrib_interleaved_matmul_selfatt_valatt", qkv, att,
                     heads=H))
    _grads_close("_contrib_interleaved_matmul_selfatt_valatt", [qkv, att],
                 [0, 1], dict(heads=H))
    _grads_close("_contrib_interleaved_matmul_selfatt_qk", [qkv], [0],
                 dict(heads=H))


def test_interleaved_encdec_matches_reference():
    rng = np.random.RandomState(9)
    Sq, Sk, B, H, hd = 3, 5, 2, 2, 4
    q = rng.rand(Sq, B, H * hd).astype(np.float32)
    kv = rng.rand(Sk, B, H * 2 * hd).astype(np.float32)
    scores = _port("_contrib_interleaved_matmul_encdec_qk", q, kv, heads=H)
    assert scores.shape == (B * H, Sq, Sk)
    _close(scores, _ref("_contrib_interleaved_matmul_encdec_qk", q, kv,
                        heads=H))
    att = np.asarray(jax.nn.softmax(scores, axis=-1))
    out = _port("_contrib_interleaved_matmul_encdec_valatt", kv, att,
                heads=H)
    assert out.shape == (Sq, B, H * hd)
    _close(out, _ref("_contrib_interleaved_matmul_encdec_valatt", kv, att,
                     heads=H))
    _grads_close("_contrib_interleaved_matmul_encdec_qk", [q, kv], [0, 1],
                 dict(heads=H))


# ---------------------------------------------------------------------------
# resize: jax.image.resize's semantics (BilinearResize2D, UpSampling,
# _image_resize)
# ---------------------------------------------------------------------------

_RESIZES = [((2, 3, 8, 10), dict(height=5, width=5)),
            ((1, 2, 4, 6), dict(height=9, width=13)),
            ((2, 1, 7, 7), dict(height=3, width=11)),
            ((1, 3, 6, 5), dict(scale_height=1.5, scale_width=0.5))]


@pytest.mark.parametrize("shape,kw", _RESIZES,
                         ids=["down", "up", "mixed", "scales"])
def test_bilinear_resize_2d_matches_reference(shape, kw):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    _close(_port("_contrib_BilinearResize2D", x, **kw),
           _ref("_contrib_BilinearResize2D", x, **kw))
    _grads_close("_contrib_BilinearResize2D", [x], [0], kw)


def test_bilinear_resize_like_mode():
    x = np.random.RandomState(2).randn(1, 2, 6, 6).astype(np.float32)
    like = np.zeros((1, 2, 4, 9), np.float32)
    _close(_port("_contrib_BilinearResize2D", x, like, mode="like"),
           _ref("_contrib_BilinearResize2D", x, like, mode="like"))


def _truncated_agree(got, want, want_f32):
    """uint8 results of a resize: equal, except where the reference's f32
    value lies within 1e-4 of an integer (f32 rounding on either side of
    it), where they differ by one at most."""
    diff = got.astype(np.int32) - want.astype(np.int32)
    near = np.abs(want_f32 - np.round(want_f32)) < 1e-4
    assert np.all(np.abs(diff) <= 1)
    assert not np.any(diff[~near]), np.argwhere(diff & ~near)[:5]


@pytest.mark.parametrize("size,keep_ratio,interp", [
    (5, False, 1), (8, True, 1), ((13, 7), False, 1), (17, False, 1),
    (5, False, 0), ((13, 7), False, 0), (17, True, 0)])
@pytest.mark.parametrize("layout", ["hwc", "nhwc"])
def test_image_resize_matches_reference(size, keep_ratio, interp, layout):
    rng = np.random.RandomState(10)
    shape = (8, 10, 3) if layout == "hwc" else (2, 8, 10, 3)
    kw = dict(size=size, keep_ratio=keep_ratio, interp=interp)
    x = rng.rand(*shape).astype(np.float32)
    _close(_port("_image_resize", x, **kw), _ref("_image_resize", x, **kw))
    img = rng.randint(0, 256, shape).astype(np.uint8)
    got, want = _port("_image_resize", img, **kw), _ref("_image_resize",
                                                        img, **kw)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    if interp == 0:
        _same(got, want)
    else:
        from jax import image as jimage

        want_f32 = np.asarray(jimage.resize(
            jnp.asarray(img), want.shape, method="linear"))
        _truncated_agree(got, want, want_f32)


@pytest.mark.parametrize("out_size", [(1, 1), (2, 3), (3, 4), 5],
                         ids=["global", "exact", "adaptive", "int"])
def test_adaptive_avg_pooling_matches_reference(out_size):
    x = np.random.RandomState(4).randn(2, 3, 6, 9).astype(np.float32)
    kw = dict(output_size=out_size)
    _close(_port("_contrib_AdaptiveAvgPooling2D", x, **kw),
           _ref("_contrib_AdaptiveAvgPooling2D", x, **kw), atol=1e-5)
    _grads_close("_contrib_AdaptiveAvgPooling2D", [x], [0], kw)


# ---------------------------------------------------------------------------
# the small contrib ops
# ---------------------------------------------------------------------------

def test_small_contrib_ops_match_reference():
    rng = np.random.RandomState(11)
    x = rng.randn(3, 4, 5).astype(np.float32)
    x[0, 1] = 0.0
    for kw in (dict(), dict(start=2.0, step=0.5, axis=1)):
        _same(_port("_contrib_arange_like", x, **kw),
              _ref("_contrib_arange_like", x, **kw))
    _close(_port("_contrib_div_sqrt_dim", x), _ref("_contrib_div_sqrt_dim",
                                                   x))
    _close(_port("_contrib_quadratic", x, a=1.5, b=-2.0, c=0.25),
           _ref("_contrib_quadratic", x, a=1.5, b=-2.0, c=0.25))
    for kw in (dict(), dict(axis=1)):
        _same(_port("_contrib_getnnz", x, **kw), _ref("_contrib_getnnz", x,
                                                      **kw))
    like = np.zeros((5, 12), np.float32)
    _same(_port("_contrib_dynamic_reshape", x, like),
          _ref("_contrib_dynamic_reshape", x, like))
    _same(_port("_contrib_gradientmultiplier", x, scalar=-0.5), x)
    _grads_close("_contrib_gradientmultiplier", [x], [0], dict(scalar=-0.5))
    _grads_close("_contrib_quadratic", [x], [0], dict(a=1.5, b=-2.0))
    _grads_close("_contrib_div_sqrt_dim", [x], [0], {})


# ---------------------------------------------------------------------------
# image ops
# ---------------------------------------------------------------------------

_IMG = np.random.RandomState(12).randint(0, 256, (6, 7, 3)).astype(np.uint8)
_IMGF = np.random.RandomState(13).rand(2, 6, 7, 3).astype(np.float32)


@pytest.mark.parametrize("name,data,kw", [
    ("_image_to_tensor", _IMG, {}),
    ("_image_to_tensor", _IMG[None].repeat(2, 0), {}),
    ("_image_flip_left_right", _IMG, {}),
    ("_image_flip_top_bottom", _IMGF, {}),
    ("_image_crop", _IMG, dict(x=2, y=1, width=4, height=3)),
    ("_image_crop", _IMGF, dict(x=0, y=2, width=7, height=2)),
    ("_image_adjust_lighting", _IMGF, dict(alpha=(0.1, -0.2, 0.05))),
    ("_image_adjust_lighting", _IMG, dict(alpha=(0.5, 0.3, -0.2))),
], ids=["to_tensor", "to_tensor-nhwc", "flip_lr", "flip_tb", "crop",
        "crop-nhwc", "lighting", "lighting-uint8"])
def test_deterministic_image_ops_match_reference(name, data, kw):
    got, want = _port(name, data, **kw), _ref(name, data, **kw)
    assert got.dtype == want.dtype
    _close(got.astype(np.float64), want.astype(np.float64))


def test_image_normalize_matches_reference():
    t = _port("_image_to_tensor", _IMG)
    kw = dict(mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3))
    _close(_port("_image_normalize", t, **kw),
           _ref("_image_normalize", t, **kw))
    t4 = _port("_image_to_tensor", _IMG[None].repeat(2, 0))
    _close(_port("_image_normalize", t4, **kw),
           _ref("_image_normalize", t4, **kw))


def _draws(name, data, n, **kw):
    tmx.random.seed(7)
    return np.stack([_port(name, data, **kw) for _ in range(n)])


def test_random_flips_by_distribution():
    for name, axis in (("_image_random_flip_left_right", 1),
                       ("_image_random_flip_top_bottom", 0)):
        outs = _draws(name, _IMG, 400, p=0.3)
        assert outs.dtype == np.uint8 and outs.shape[1:] == _IMG.shape
        flipped = np.array([np.array_equal(o, np.flip(_IMG, axis))
                            for o in outs])
        same = np.array([np.array_equal(o, _IMG) for o in outs])
        assert np.all(flipped | same)
        # 400 coins at p 0.3: mean 120, sd 9.2
        assert abs(flipped.sum() - 120) < 4 * 9.2, flipped.sum()


def _uniform_ok(samples, lo, hi):
    """Samples of U(lo, hi): in range, mean and variance within four
    standard errors."""
    n = len(samples)
    assert samples.min() >= lo - 1e-6 and samples.max() <= hi + 1e-6
    mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
    assert abs(samples.mean() - mean) < 4 * math.sqrt(var / n)
    assert abs(samples.var() - var) < 4 * var * math.sqrt(0.8 / n)


def test_random_brightness_contrast_saturation_by_distribution():
    data = np.full((4, 5, 3), 2.0, np.float32)
    data[..., 1] = 3.0
    n = 500
    b = _draws("_image_random_brightness", data, n, min_factor=0.5,
               max_factor=1.5)
    assert b.shape == (n,) + data.shape and b.dtype == np.float32
    _uniform_ok(b[:, 0, 0, 0] / 2.0, 0.5, 1.5)
    gray = (data * np.array([0.299, 0.587, 0.114], np.float32)).sum(-1)
    for name in ("_image_random_contrast", "_image_random_saturation"):
        out = _draws(name, data, n, min_factor=0.2, max_factor=0.8)
        # out = f x + (1 - f) g: f from the green channel's blend
        g = gray.mean() if name == "_image_random_contrast" else gray[0, 0]
        f = (out[:, 0, 0, 1] - g) / (3.0 - g)
        _uniform_ok(f, 0.2, 0.8)
        want = _ref(name, data, min_factor=0.5, max_factor=0.5)
        _close(_port(name, data, min_factor=0.5, max_factor=0.5), want)


def test_random_hue_and_lighting_by_distribution():
    rng = np.random.RandomState(11)
    img = rng.rand(6, 6, 3).astype(np.float32)
    # zero range: the same rotation (identity) in both packages
    _close(_port("_image_random_hue", img, min_factor=0.0, max_factor=0.0),
           _ref("_image_random_hue", img, min_factor=0.0, max_factor=0.0),
           atol=1e-5)
    np.testing.assert_allclose(
        _port("_image_random_hue", img, min_factor=0.0, max_factor=0.0),
        img, atol=1e-5)
    # a rotation keeps the luma (Y of YIQ)
    h = _draws("_image_random_hue", img, 50, min_factor=-0.3,
               max_factor=0.3)
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    np.testing.assert_allclose(h @ luma, np.broadcast_to(img @ luma,
                                                         h.shape[:-1]),
                               atol=1e-5)
    # lighting: the shift is eigvec @ (eigval * alpha), alpha ~ N(0, s^2)
    zero = np.zeros((1, 1, 3), np.float32)
    n = 400
    shifts = _draws("_image_random_lighting", zero, n, alpha_std=0.05)
    shifts = shifts.reshape(n, 3)
    from mxnet_tpu_torch.ops.image_ops import _EIGVAL, _EIGVEC

    alpha = np.linalg.solve(_EIGVEC.astype(np.float64),
                            shifts.T.astype(np.float64)).T / _EIGVAL
    assert abs(alpha.mean()) < 4 * 0.05 / math.sqrt(3 * n)
    assert abs(alpha.std() - 0.05) < 0.05 * 4 * math.sqrt(0.5 / (3 * n))


def test_random_color_jitter_shapes_and_zero_ranges():
    img = _IMGF[0]
    out = _draws("_image_random_color_jitter", img, 5, brightness=0.1,
                 contrast=0.1, saturation=0.1, hue=0.1)
    assert out.shape == (5,) + img.shape and np.isfinite(out).all()
    _same(_port("_image_random_color_jitter", img), img)


def _case_image_ops_basic(M, fn):
    rng = np.random.RandomState(10)
    img = rng.randint(0, 255, (8, 10, 3)).astype(np.uint8)
    t = fn("_image_to_tensor", img)
    assert t.shape == (3, 8, 10) and t.dtype == np.float32 and t.max() <= 1
    n = fn("_image_normalize", t, mean=(0.5, 0.5, 0.5), std=(0.2, 0.2, 0.2))
    np.testing.assert_allclose(n, (t - 0.5) / 0.2, atol=1e-6)
    f = fn("_image_flip_left_right", img)
    np.testing.assert_array_equal(f, img[:, ::-1])
    c = fn("_image_crop", img, x=2, y=1, width=4, height=3)
    assert c.shape == (3, 4, 3)
    r = fn("_image_resize", img, size=5)
    assert r.shape == (5, 5, 3)
    r2 = fn("_image_resize", img, size=8, keep_ratio=True)
    assert r2.shape == (8, 10, 3)
    return [t, n, f, c]


def _case_image_random_ops_seeded(M, fn):
    M.random.seed(42)
    img = np.random.RandomState(11).rand(6, 6, 3).astype(np.float32)
    assert fn("_image_random_brightness", img, min_factor=0.5,
              max_factor=1.5).shape == img.shape
    assert np.isfinite(fn("_image_random_saturation", img, min_factor=0.5,
                          max_factor=1.5)).all()
    assert np.isfinite(fn("_image_random_hue", img, min_factor=-0.1,
                          max_factor=0.1)).all()
    assert fn("_image_random_color_jitter", img, brightness=0.1,
              contrast=0.1, saturation=0.1, hue=0.1).shape == img.shape
    assert fn("_image_random_lighting", img,
              alpha_std=0.05).shape == img.shape
    h0 = fn("_image_random_hue", img, min_factor=0.0, max_factor=0.0)
    np.testing.assert_allclose(h0, img, atol=1e-5)
    return [h0]


def _case_nd_image_namespace_and_gluon_sync_bn(M, fn):
    rng = np.random.RandomState(16)
    img = M.nd.array(rng.randint(0, 255, (4, 5, 3)).astype(np.uint8))
    t = M.nd.image.to_tensor(img)
    assert t.shape == (3, 4, 5)
    flipped = M.nd.image.flip_left_right(img)
    np.testing.assert_array_equal(flipped.asnumpy(), img.asnumpy()[:, ::-1])
    M.gluon.block._SCOPE.counters = {}
    net = M.gluon.contrib.nn.SyncBatchNorm(in_channels=3)
    net.initialize()
    x = M.nd.array(rng.rand(2, 3, 4, 4).astype(np.float32))
    with M.autograd.record():
        out = net(x)
    assert out.shape == x.shape
    assert float(np.abs(net.running_mean.data().asnumpy()).sum()) > 0
    return [t.asnumpy(), out.asnumpy(), net.running_mean.data().asnumpy(),
            net.running_var.data().asnumpy()]


_IMAGE_CASES = {f.__name__[len("_case_"):]: f for f in (
    _case_image_ops_basic, _case_image_random_ops_seeded,
    _case_nd_image_namespace_and_gluon_sync_bn)}


@pytest.mark.parametrize("case", sorted(_IMAGE_CASES))
def test_reference_image_case(case):
    got = _IMAGE_CASES[case](tmx, _port)
    want = _IMAGE_CASES[case](jmx, _ref)
    for g, w in zip(got, want):
        _close(g, w)


def test_image_api(tmp_path):
    """tests/test_contrib_aux.py::test_image_api on both packages."""
    from PIL import Image

    img = np.random.RandomState(0).randint(0, 255, (20, 30, 3)) \
        .astype(np.uint8)
    p = str(tmp_path / "t.png")
    Image.fromarray(img).save(p)
    outs = []
    for M in (tmx, jmx):
        loaded = M.image.imread(p)
        assert loaded.shape == (20, 30, 3)
        r = M.image.imresize(loaded, 15, 10)
        assert r.shape == (10, 15, 3)
        c, _ = M.image.center_crop(loaded, (10, 10))
        assert c.shape == (10, 10, 3)
        augs = M.image.CreateAugmenter((3, 8, 8), rand_mirror=True,
                                       mean=True, std=True)
        out = loaded
        for a in augs:
            out = a(out)
        assert out.shape[0] == 8 or out.shape == (8, 8, 3)
        outs.append([loaded.asnumpy(), r.asnumpy(), c.asnumpy()])
    for g, w in zip(*outs):
        _same(g, w)


def test_nd_linalg_namespace_matches_reference():
    rng = np.random.RandomState(3)
    a = rng.randn(2, 3, 4).astype(np.float32)
    b = rng.randn(2, 4, 5).astype(np.float32)
    _close(tnd.linalg.gemm2(tnd.array(a), tnd.array(b)).asnumpy(),
           jnd.linalg.gemm2(jnd.array(a), jnd.array(b)).asnumpy())
    spd = rng.randn(3, 3).astype(np.float32)
    spd = spd @ spd.T + 3 * np.eye(3, dtype=np.float32)
    _close(tnd.linalg.potrf(tnd.array(spd)).asnumpy(),
           jnd.linalg.potrf(jnd.array(spd)).asnumpy(), atol=1e-5)
    with pytest.raises(AttributeError):
        tnd.linalg.no_such_op  # noqa: B018
    with pytest.raises(AttributeError):
        tnd.image.no_such_op  # noqa: B018


# ---------------------------------------------------------------------------
# nn extras
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput"])
def test_regression_outputs_match_reference(name):
    rng = np.random.RandomState(14)
    data = rng.randn(4, 3).astype(np.float32)
    label = rng.randn(4, 3).astype(np.float32)
    _close(_port(name, data, label), _ref(name, data, label))
    want, got = _grads(name, [data, label], [0, 1], dict(grad_scale=2.0))
    _close(got[0], want[0], GRTOL, GATOL)
    _same(got[1], want[1])  # the label's gradient: zero


def test_svm_output_is_identity():
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    lab = np.zeros(3, np.float32)
    _same(_port("SVMOutput", x, lab), _ref("SVMOutput", x, lab))


@pytest.mark.parametrize("case", ["nearest", "nearest-concat", "bilinear"])
def test_upsampling_matches_reference(case):
    rng = np.random.RandomState(15)
    x = rng.randn(2, 3, 4, 5).astype(np.float32)
    if case == "nearest":
        args, kw = [x], dict(scale=2)
    elif case == "nearest-concat":
        args = [rng.randn(2, 3, 4, 4).astype(np.float32),
                rng.randn(2, 2, 2, 2).astype(np.float32),
                rng.randn(2, 1, 8, 8).astype(np.float32)]
        kw = dict(scale=2, num_args=3)
    else:
        args = [x, np.zeros((3, 1, 4, 4), np.float32)]
        kw = dict(scale=3, sample_type="bilinear", num_filter=3)
    _close(_port("UpSampling", *args, **kw), _ref("UpSampling", *args, **kw))
    _grads_close("UpSampling", args, [0], kw)


def test_spatial_transformer_family_matches_reference():
    rng = np.random.RandomState(16)
    data = rng.randn(2, 3, 6, 7).astype(np.float32)
    theta = np.array([[0.9, 0.1, 0.05, -0.1, 1.1, 0.0],
                      [1.2, 0.0, -0.3, 0.2, 0.8, 0.1]], np.float32)
    kw = dict(transform_type="affine", target_shape=(5, 4))
    grid = _ref("GridGenerator", theta, **kw)
    _close(_port("GridGenerator", theta, **kw), grid)
    grid = grid.copy()
    grid[0, :, 0, 0] = [1.3, -1.2]  # a sample outside the input
    _close(_port("BilinearSampler", data, grid),
           _ref("BilinearSampler", data, grid))
    _grads_close("BilinearSampler", [data, grid], [0, 1], {})
    kw2 = dict(target_shape=(5, 4))
    _close(_port("SpatialTransformer", data, theta, **kw2),
           _ref("SpatialTransformer", data, theta, **kw2))
    _grads_close("SpatialTransformer", [data, theta], [0, 1], kw2)


_CORR = [(1, 2, 1, 1, 2, True), (3, 2, 1, 2, 3, True),
         (1, 1, 2, 1, 1, False), (3, 4, 2, 2, 4, False)]


def _ref_corr(d1, d2, ks, md, s1, s2, pad, mult=True):
    """tests/test_op_longtail.py's brute-force FlowNet correlation."""
    n, c, h, w = d1.shape
    kr = (ks - 1) // 2
    border = md + kr
    ph, pw = h + 2 * pad, w + 2 * pad
    oh = math.ceil((ph - 2 * border) / s1)
    ow = math.ceil((pw - 2 * border) / s1)
    ngr = md // s2
    ngw = 2 * ngr + 1
    p1 = np.zeros((n, c, ph, pw))
    p1[:, :, pad:pad + h, pad:pad + w] = d1
    p2 = np.zeros((n, c, ph, pw))
    p2[:, :, pad:pad + h, pad:pad + w] = d2
    out = np.zeros((n, ngw * ngw, oh, ow))
    for b in range(n):
        for i in range(oh):
            for j in range(ow):
                y1, x1 = i * s1 + border, j * s1 + border
                for pi in range(-ngr, ngr + 1):
                    for qi in range(-ngr, ngr + 1):
                        ch = (pi + ngr) * ngw + (qi + ngr)
                        y2, x2 = y1 + pi * s2, x1 + qi * s2
                        acc = 0.0
                        for u in range(-kr, kr + 1):
                            for v in range(-kr, kr + 1):
                                for cc in range(c):
                                    a = p1[b, cc, y1 + u, x1 + v]
                                    inb = (0 <= y2 + u < ph
                                           and 0 <= x2 + v < pw)
                                    bb = p2[b, cc, y2 + u, x2 + v] \
                                        if inb else 0.0
                                    acc += a * bb if mult else abs(a - bb)
                        out[b, ch, i, j] = acc / (ks * ks * c)
    return out


@pytest.mark.parametrize("cfg", _CORR[:3], ids=["k1", "k3-s2", "absdiff"])
def test_correlation_matches_naive_and_reference(cfg):
    rng = np.random.RandomState(0)
    d1 = rng.rand(2, 3, 8, 9).astype(np.float32)
    d2 = rng.rand(2, 3, 8, 9).astype(np.float32)
    got = _port("Correlation", d1, d2, *cfg)
    np.testing.assert_allclose(got, _ref_corr(d1, d2, *cfg), atol=1e-5)
    _close(got, _ref("Correlation", d1, d2, *cfg))


@pytest.mark.parametrize("cfg", [_CORR[1], _CORR[3]], ids=["mult",
                                                           "absdiff"])
def test_correlation_gradients_match_reference(cfg):
    rng = np.random.RandomState(1)
    d1 = rng.rand(1, 2, 9, 9).astype(np.float32)
    d2 = rng.rand(1, 2, 9, 9).astype(np.float32)
    kw = dict(zip(("kernel_size", "max_displacement", "stride1", "stride2",
                   "pad_size", "is_multiply"), cfg))
    _grads_close("Correlation", [d1, d2], [0, 1], kw)


def test_lrn_matches_reference():
    x = np.random.RandomState(17).randn(2, 7, 3, 4).astype(np.float32)
    for kw in (dict(), dict(alpha=1e-3, beta=0.5, knorm=1.0, nsize=3)):
        _close(_port("LRN", x, **kw), _ref("LRN", x, **kw))
        _grads_close("LRN", [x], [0], kw)


# ---------------------------------------------------------------------------
# shape inference on meta tensors: no op of this slice reads the host
# ---------------------------------------------------------------------------

def test_new_ops_infer_shapes_symbolically():
    sym = tmx.sym
    data = sym.var("data")
    anchors = sym.contrib.MultiBoxPrior(data, sizes=(0.3,), ratios=(1, 2))
    _, out, _ = anchors.infer_shape(data=(2, 3, 6, 6))
    assert out == [(1, 72, 4)]
    det = sym.contrib.MultiBoxDetection(sym.var("p"), sym.var("l"), anchors,
                                        nms_topk=10)
    _, out, _ = det.infer_shape(p=(2, 4, 72), l=(2, 288), data=(2, 3, 6, 6))
    assert out == [(2, 72, 6)]
    nms = sym.contrib.box_nms(sym.var("rows"), topk=5)
    assert nms.infer_shape(rows=(3, 40, 6))[1] == [(3, 40, 6)]
    tgt = sym.contrib.MultiBoxTarget(anchors, sym.var("lab"), sym.var("cp"))
    _, out, _ = tgt.infer_shape(data=(2, 3, 6, 6), lab=(2, 3, 5),
                                cp=(2, 4, 72))
    assert out == [(2, 288), (2, 288), (2, 72)]


# ---------------------------------------------------------------------------
# gluon.contrib.nn
# ---------------------------------------------------------------------------

def _reset_counters():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}


def test_gluon_contrib_nn_blocks_match_reference():
    from mxnet_tpu.gluon.contrib import nn as jcnn
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon.contrib import nn as tcnn
    from mxnet_tpu_torch.gluon import nn as tnn

    rng = np.random.RandomState(18)
    x = rng.randn(2, 3, 5, 5).astype(np.float32)
    outs = []
    for cnn, gnn, nd in ((jcnn, jnn, jnd), (tcnn, tnn, tnd)):
        _reset_counters()
        for cls in (cnn.HybridConcurrent, cnn.Concurrent):
            net = cls(axis=1)
            net.add(gnn.Conv2D(2, 3, padding=1, in_channels=3),
                    cnn.Identity(), gnn.Conv2D(1, 1, in_channels=3))
            net.initialize()
            for p in net.collect_params().values():
                p.set_data(nd.array(np.random.RandomState(1).randn(
                    *p.shape).astype(np.float32)))
            outs.append(net(nd.array(x)).asnumpy())
    for g, w in zip(outs[2:], outs[:2]):
        _close(g, w, atol=1e-5)


def test_sync_batch_norm_layer_matches_reference_and_traces():
    from mxnet_tpu.gluon.contrib.nn import SyncBatchNorm as JSBN
    from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm as TSBN

    rng = np.random.RandomState(19)
    x = (rng.randn(4, 3, 4, 4) * 2 + 1).astype(np.float32)
    res = []
    for cls, M, nd in ((JSBN, jmx, jnd), (TSBN, tmx, tnd)):
        _reset_counters()
        net = cls(in_channels=3, momentum=0.8)
        net.initialize()
        with M.autograd.record():
            out = net(nd.array(x))
        pred = net(nd.array(x))
        res.append([out.asnumpy(), pred.asnumpy(),
                    net.running_mean.data().asnumpy(),
                    net.running_var.data().asnumpy()])
    for g, w in zip(res[1], res[0]):
        _close(g, w, atol=1e-5)
    # traced: the running statistics are auxiliary states that a bound
    # Executor folds in training, as BatchNorm's
    _reset_counters()
    net = TSBN(in_channels=3, momentum=0.8)
    net.initialize()
    sym = net(tmx.sym.var("data"))
    assert sym.list_auxiliary_states() == ["syncbatchnorm0_running_mean",
                                           "syncbatchnorm0_running_var"]
    exe = sym.simple_bind(ctx=tmx.cpu(), data=x.shape)
    exe.aux_dict["syncbatchnorm0_running_var"][:] = 1.0
    exe.forward(is_train=True, data=tnd.array(x))
    _close(exe.aux_dict["syncbatchnorm0_running_mean"].asnumpy(), res[0][2],
           atol=1e-5)
