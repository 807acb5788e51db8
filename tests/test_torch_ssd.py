"""The port's SSD (``mxnet_tpu_torch/models/ssd.py``) against the JAX
package's, on the CPU, at a small size: ``ssd_300(num_classes=5)`` on
64 x 64 images, batch 2, with the reference's initialized weights carried
by its ``.params`` file.

The forward (anchors exactly, predictions at rtol 1e-5 / atol 1e-6),
the targets (``MultiBoxTarget``
under ``autograd.pause``: masks and classes exactly), the loss (rtol
1e-5) and every gradient of one training step (rtol 1e-4, and atol 1e-5
of the tensor's largest magnitude: a convolution's weight gradient sums
8192 positions in f32) are held to the reference's; ``detect`` keeps the
same rows, their values at f32 tolerance. The loss's hard-negative
mining is also held to a plain numpy statement of it.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.models import SSDMultiBoxLoss as JLoss
from mxnet_tpu.models import ssd_300 as jssd_300
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.gluon import block as tblock
from mxnet_tpu_torch.models import SSDMultiBoxLoss, ssd_300

torch.set_num_threads(1)

NUM_CLASSES, SIZE, BATCH = 5, 64, 2


def _make_batch(rng, batch=BATCH, size=SIZE, num_classes=NUM_CLASSES):
    """example/ssd/train.py's make_batch: 1-3 boxes an image, -1 pads."""
    imgs = rng.rand(batch, 3, size, size).astype(np.float32)
    labels = np.full((batch, 3, 5), -1, np.float32)
    for b in range(batch):
        for k in range(rng.randint(1, 4)):
            cls = rng.randint(0, num_classes)
            x0, y0 = rng.rand(2) * 0.6
            w, h = 0.2 + rng.rand(2) * 0.2
            labels[b, k] = [cls, x0, y0, min(x0 + w, 1.0), min(y0 + h, 1.0)]
    return imgs, labels


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(reference, port) ssd_300(5) with the reference's initialized
    weights, carried by its .params file."""
    path = str(tmp_path_factory.mktemp("ssd") / "ssd.params")
    x, _ = _make_batch(np.random.RandomState(0))
    jblock._SCOPE.counters = {}
    jmx.random.seed(0)
    ref = jssd_300(num_classes=NUM_CLASSES)
    ref.initialize()
    ref(jnd.array(x))
    ref.save_parameters(path)
    tblock._SCOPE.counters = {}
    with tmx.cpu():
        port = ssd_300(num_classes=NUM_CLASSES)
        port.load_parameters(path, ctx=tmx.cpu())
    assert list(ref.collect_params()) == list(port.collect_params())
    return ref, port


def _close(got, want, rtol=1e-5, atol=1e-5):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_forward_matches_reference(nets):
    ref, port = nets
    x, _ = _make_batch(np.random.RandomState(1))
    want = [o.asnumpy() for o in ref(jnd.array(x))]
    with tmx.cpu():
        got = [o.asnumpy() for o in port(tnd.array(x))]
    # 64 -> 8 after the base: (8^2 + 4^2 + 2^2) x 4 anchors
    assert want[0].shape == (1, 336, 4)
    assert want[1].shape == (BATCH, 336, NUM_CLASSES + 1)
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g, w, atol=1e-6)


def test_hybridized_forward_is_the_eager_one(nets):
    _, port = nets
    x, _ = _make_batch(np.random.RandomState(2))
    with tmx.cpu():
        eager = [o.asnumpy() for o in port(tnd.array(x))]
        port.hybridize()
        try:
            hyb = [o.asnumpy() for o in port(tnd.array(x))]
        finally:
            port.hybridize(False)
    for h, e in zip(hyb, eager):
        np.testing.assert_array_equal(h, e)


def _step(M, ad, nd, net, loss_fn, x, labels):
    """example/ssd/train.py's step: targets under pause, then the loss and
    its gradients under record. Returns (targets, loss, {name: grad})."""
    anchors, cls_preds, box_preds = net(nd.array(x))
    with ad.pause():
        loc_t, loc_m, cls_t = nd.contrib.MultiBoxTarget(
            anchors, nd.array(labels), cls_preds.transpose((0, 2, 1)))
    with ad.record():
        anchors, cls_preds, box_preds = net(nd.array(x))
        loss = loss_fn(cls_preds, box_preds, cls_t, loc_t, loc_m)
    loss.backward()
    grads = {n: p.grad().asnumpy() for n, p in net.collect_params().items()
             if p.grad_req != "null"}
    stats = {n: p.data().asnumpy() for n, p in net.collect_params().items()
             if p.grad_req == "null"}
    return ([loc_t.asnumpy(), loc_m.asnumpy(), cls_t.asnumpy()],
            float(loss.asnumpy().reshape(-1)[0]), grads, stats)


def test_training_step_matches_reference(nets):
    ref, port = nets
    x, labels = _make_batch(np.random.RandomState(3))
    want = _step(jmx, jag, jnd, ref, JLoss(), x, labels)
    with tmx.cpu():
        got = _step(tmx, tag, tnd, port, SSDMultiBoxLoss(), x, labels)
    (gt, gl, gg, gs), (wt, wl, wg, ws) = got, want
    _close(gt[0], wt[0], atol=1e-6)               # loc_target
    np.testing.assert_array_equal(gt[1], wt[1])    # loc_mask
    np.testing.assert_array_equal(gt[2], wt[2])    # cls_target
    assert wt[2].max() > 0
    np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert set(gg) == set(wg)
    for name in wg:
        scale = max(float(np.abs(wg[name]).max()), 1.0)
        _close(gg[name], wg[name], rtol=1e-4, atol=1e-5 * scale)
    for name in ws:  # the running statistics the step folded
        _close(gs[name], ws[name], atol=1e-6)


def test_detect_keeps_the_reference_rows(nets):
    ref, port = nets
    x, _ = _make_batch(np.random.RandomState(4))
    want = ref.detect(jnd.array(x), nms_threshold=0.45, threshold=0.01,
                      nms_topk=400).asnumpy()
    with tmx.cpu():
        got = port.detect(tnd.array(x), nms_threshold=0.45, threshold=0.01,
                          nms_topk=400).asnumpy()
    assert got.shape == want.shape == (BATCH, 336, 6)
    for b in range(BATCH):
        g = got[b][got[b, :, 0] >= 0]
        w = want[b][want[b, :, 0] >= 0]
        assert len(g) == len(w) > 0
        # the same rows: sorted the same way, values at f32 tolerance
        g = g[np.lexsort(g.T[::-1])]
        w = w[np.lexsort(w.T[::-1])]
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        _close(g, w, atol=1e-6)


def _numpy_loss(cp, bp, ct, bt, bm, ratio=3.0, lambd=1.0):
    """SSDMultiBoxLoss written out in numpy (f64)."""
    cp = cp.astype(np.float64)
    m = cp.max(-1, keepdims=True)
    logp = cp - m - np.log(np.exp(cp - m).sum(-1, keepdims=True))
    ce = -np.take_along_axis(logp, ct.astype(int)[..., None], -1)[..., 0]
    pos = ct > 0
    num_pos = max(pos.sum(), 1)
    total = 0.0
    for b in range(ce.shape[0]):
        k = min(int(ratio * pos[b].sum()), ce.shape[1] - 1)
        neg = np.where(pos[b], -np.inf, ce[b])
        hard = np.zeros_like(pos[b])
        if k > 0:
            thresh = np.sort(neg)[::-1][k - 1]
            hard = (neg >= thresh) & ~pos[b]  # ties at the threshold kept
        total += ce[b][pos[b] | hard].sum()
    diff = np.abs((bp - bt) * bm).astype(np.float64)
    sl1 = np.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return total / num_pos + lambd * sl1.sum() / num_pos


@pytest.mark.parametrize("ties", [False, True])
def test_multibox_loss_matches_reference_and_numpy(ties):
    rng = np.random.RandomState(5)
    b, n, c = 2, 40, 4
    cp = rng.randn(b, n, c).astype(np.float32)
    if ties:  # equal negative losses at the mining threshold
        cp[:, ::3] = cp[0, 0]
    ct = np.zeros((b, n), np.float32)
    ct[0, [1, 7]] = [2, 3]
    ct[1, 4] = 1
    bp = rng.randn(b, n * 4).astype(np.float32)
    bt = rng.randn(b, n * 4).astype(np.float32)
    bm = (rng.rand(b, n * 4) < 0.2).astype(np.float32)
    args = [cp, bp, ct, bt, bm]
    want = JLoss()(*[jnd.array(a) for a in args]).asnumpy()
    with tmx.cpu():
        got = SSDMultiBoxLoss()(*[tnd.array(a) for a in args]).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got.reshape(-1)[0], _numpy_loss(*args),
                               rtol=1e-5)


def test_example_training_loop_runs(nets):
    """example/ssd/train.py at a smoke size: Trainer SGD (lr 1e-3,
    momentum 0.9, wd 5e-4), a few steps, finite losses, then detect and
    the VOC07 mAP of a held-out batch in [0, 1]."""
    tblock._SCOPE.counters = {}
    rng = np.random.RandomState(6)
    with tmx.cpu():
        tmx.random.seed(0)
        net = ssd_300(num_classes=NUM_CLASSES)
        net.initialize()
        net.hybridize()
        x, labels = _make_batch(rng)
        net(tnd.array(x))
        trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 1e-3, "momentum": 0.9,
                                     "wd": 5e-4})
        loss_fn = SSDMultiBoxLoss()
        losses = []
        for _ in range(3):
            x, labels = _make_batch(rng)
            loss = _train_step(net, loss_fn, x, labels)
            trainer.step(BATCH)
            losses.append(loss)
        assert all(np.isfinite(losses))
        metric = tmx.metric.VOC07MApMetric(ovp_thresh=0.5)
        ex, elabels = _make_batch(np.random.RandomState(99))
        metric.update([tnd.array(elabels)], [net.detect(tnd.array(ex))])
        name, value = metric.get()
    assert 0.0 <= value <= 1.0


def _train_step(net, loss_fn, x, labels):
    anchors, cls_preds, _ = net(tnd.array(x))
    with tag.pause():
        targets = tnd.contrib.MultiBoxTarget(
            anchors, tnd.array(labels), cls_preds.transpose((0, 2, 1)))
    with tag.record():
        _, cls_preds, box_preds = net(tnd.array(x))
        loss = loss_fn(cls_preds, box_preds, targets[2], targets[0],
                       targets[1])
    loss.backward()
    return float(loss.asnumpy().reshape(-1)[0])
