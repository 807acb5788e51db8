"""The port's vision model zoo (``mxnet_tpu_torch.gluon.model_zoo``)
against the reference's, on the CPU.

Every name of the reference's ``get_model`` table builds and runs forward
at a small size; the reference's own ``tests/test_model_zoo.py`` cases run
through the port; and one net of each family, ResNet-18 v1 and v2 as
thumbnails (32 x 32), gets the reference's weights and running statistics
(carried by structural name with ``gluon.utils.set_params_from_numpy``)
and must give the reference's logits within 1e-4, in predict mode (the
running statistics) and in training mode (the batch statistics, which
the BatchNorm layers then fold into their running statistics).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo import get_model as jget_model
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd
from mxnet_tpu_torch.gluon.model_zoo import get_model, vision
from mxnet_tpu_torch.gluon.utils import set_params_from_numpy

torch.set_num_threads(1)

# the smallest square input each family's fixed-size pools accept
_SIZE = {"alexnet": 64, "inceptionv3": 299}
LOGIT_TOL = 1e-4


@pytest.mark.parametrize("name", sorted(vision._models))
def test_every_zoo_name_runs_forward(name):
    from mxnet_tpu.gluon.model_zoo import vision as jvision

    assert set(vision._models) == set(jvision._models)
    size = _SIZE.get(name, 32)
    with mx.cpu():
        net = get_model(name, classes=7)
        net.initialize()
        out = net(nd.ones((1, 3, size, size)))
    assert out.shape == (1, 7)
    assert np.isfinite(out.asnumpy()).all()


def _carried(name, size, seed, **kw):
    """(reference net, port net, input): the reference's seeded weights
    and perturbed running statistics in both. The port's forward resolves
    the deferred shapes, which the reference's parameters then take, and
    the reference runs hybridized: one compiled program instead of a
    compile per op."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    with mx.cpu():
        net = get_model(name, **kw)
        net.initialize()
        net(nd.array(x))
    shapes = {k: p.shape
              for k, p in net._collect_params_with_prefix().items()}
    jmx.random.seed(seed)
    ref = jget_model(name, **kw)
    ref.initialize()
    arrays = {}
    for k, p in ref._collect_params_with_prefix().items():
        if p._data is None:
            p._finish_deferred_init(shapes[k])
        a = p.data().asnumpy()
        if k.endswith("running_mean"):
            a = rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        p.set_data(jnd.array(a))
        arrays[k] = a
    ref.hybridize()
    with mx.cpu():
        set_params_from_numpy(net, arrays)
    return ref, net, x


CARRIED = [("resnet18_v1", 32, {"thumbnail": True}),
           ("resnet18_v2", 32, {"thumbnail": True}),
           ("vgg11_bn", 32, {}), ("alexnet", 64, {}),
           ("squeezenet1.1", 32, {}), ("densenet121", 32, {}),
           ("mobilenet0.25", 32, {}), ("mobilenetv2_0.25", 32, {}),
           ("inceptionv3", 299, {})]


@pytest.mark.parametrize("name,size,kw", CARRIED,
                         ids=[c[0] for c in CARRIED])
def test_carried_weights_give_reference_logits(name, size, kw):
    ref, net, x = _carried(name, size, seed=3, classes=10, **kw)
    want = ref(jnd.array(x)).asnumpy()
    with mx.cpu():
        got = net(nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", ["resnet18_v1", "resnet18_v2"])
def test_carried_weights_train_mode_forward_and_statistics(name):
    """Training-mode forward (BatchNorm on batch statistics, Dropout-free
    nets) and the running statistics it leaves behind."""
    ref, net, x = _carried(name, 32, seed=4, classes=10, thumbnail=True)
    with jag.train_mode():
        want = ref(jnd.array(x)).asnumpy()
    with mx.cpu(), autograd.train_mode():
        got = net(nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    ref_p = ref._collect_params_with_prefix()
    stats = [k for k in ref_p if "running" in k]
    assert stats
    for k, p in net._collect_params_with_prefix().items():
        if k in stats:
            np.testing.assert_allclose(p.data().asnumpy(),
                                       ref_p[k].data().asnumpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_set_params_from_numpy_rejects_mismatches():
    with mx.cpu():
        net = get_model("squeezenet1.1", classes=3)
        net.initialize()
        net(nd.ones((1, 3, 32, 32)))
        arrays = {k: p.data().asnumpy()
                  for k, p in net._collect_params_with_prefix().items()}
        key = next(iter(arrays))
        with pytest.raises(ValueError, match="missing"):
            set_params_from_numpy(net, {k: v for k, v in arrays.items()
                                        if k != key})
        with pytest.raises(ValueError, match="shape"):
            set_params_from_numpy(net, {**arrays,
                                        key: arrays[key][..., :1]})


# ---------------------------------------------------------------------------
# The reference's tests/test_model_zoo.py cases, through the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["resnet18_v1", "resnet18_v2"])
def test_resnet_thumbnail_train_step(name):
    with mx.cpu():
        net = get_model(name, classes=10, thumbnail=True)
        net.initialize()
        x = nd.ones((2, 3, 32, 32))
        out = net(x)
        assert out.shape == (2, 10)

        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        y = nd.array(np.array([1, 2], np.int32))
        with autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(2)
    assert np.isfinite(loss.asnumpy()).all()


@pytest.mark.parametrize("name,size", [
    ("resnet50_v1", 64), ("resnet50_v2", 64),
    ("mobilenet0.25", 64), ("mobilenetv2_0.25", 64),
    ("squeezenet1.1", 64),
])
def test_zoo_forward_shapes(name, size):
    with mx.cpu():
        net = get_model(name, classes=7)
        net.initialize()
        out = net(nd.ones((1, 3, size, size)))
    assert out.shape == (1, 7)


def test_vgg_and_alexnet_small():
    with mx.cpu():
        net = vision.vgg11(classes=5)
        net.initialize()
        assert net(nd.ones((1, 3, 64, 64))).shape == (1, 5)
        net = vision.alexnet(classes=5)
        net.initialize()
        assert net(nd.ones((1, 3, 224, 224))).shape == (1, 5)


def test_densenet_small():
    with mx.cpu():
        net = vision.densenet121(classes=4)
        net.initialize()
        assert net(nd.ones((1, 3, 64, 64))).shape == (1, 4)


def test_resnet_hybridize_consistency():
    with mx.cpu():
        net = get_model("resnet18_v1", classes=10, thumbnail=True)
        net.initialize()
        x = nd.array(np.random.RandomState(0).randn(2, 3, 32, 32)
                     .astype(np.float32))
        eager = net(x).asnumpy()
        net.hybridize()
        hyb = net(x).asnumpy()
    np.testing.assert_allclose(eager, hyb, rtol=1e-4, atol=1e-4)


def test_get_model_unknown():
    with pytest.raises(ValueError):
        get_model("resnet_1202")


def test_pretrained_raises():
    with pytest.raises(RuntimeError, match="pretrained"):
        get_model("resnet18_v1", pretrained=True)


def test_save_load_roundtrip(tmp_path):
    """The reference's case: save_parameters, then load_parameters into a
    fresh net, which gives the same output; the file holds the structural
    names that set_params_from_numpy takes."""
    with mx.cpu():
        net = get_model("mobilenet0.25", classes=3)
        net.initialize()
        x = nd.ones((1, 3, 32, 32))
        ref = net(x).asnumpy()
        path = str(tmp_path / "m.params")
        net.save_parameters(path)
        net2 = get_model("mobilenet0.25", classes=3)
        net2.load_parameters(path, ctx=mx.cpu())
        np.testing.assert_allclose(ref, net2(x).asnumpy(), rtol=1e-5,
                                   atol=1e-6)
        arrays = {k: v.asnumpy() for k, v in nd.load(path).items()}
        assert set(arrays) == set(net._collect_params_with_prefix())
        net3 = get_model("mobilenet0.25", classes=3)
        net3.initialize()
        set_params_from_numpy(net3, arrays)
        np.testing.assert_allclose(ref, net3(x).asnumpy(), rtol=1e-5,
                                   atol=1e-6)
