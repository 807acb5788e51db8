"""``mxnet_tpu_torch.test_utils`` against the reference's
``mxnet_tpu.test_utils``, on the CPU: the same verdicts and the same
reported errors on the same numpy inputs, through both packages.

Differences by design: ``list_gpus`` lists the CUDA cards torch sees (the
reference's always returns ``[]``) and ``list_tpus`` returns ``[]`` (the
reference's lists its TPU devices).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import test_utils as ttu

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def test_surface_equals_the_reference():
    assert ttu.__all__ == jtu.__all__
    for n in ttu.__all__:
        assert callable(getattr(ttu, n))


def test_device_lists():
    assert ttu.list_tpus() == []
    assert ttu.list_gpus() == list(range(torch.cuda.device_count()))


def test_default_context_env(monkeypatch):
    monkeypatch.setenv("MXNET_TEST_DEFAULT_CTX", "cpu:0")
    assert ttu.default_context() == tmx.cpu(0)
    monkeypatch.delenv("MXNET_TEST_DEFAULT_CTX")
    assert ttu.default_context() == tmx.cpu()  # the current context


_PAIRS = {
    "equal_f32": (np.ones((3, 4), np.float32), np.ones((3, 4), np.float32)),
    "close_f32": (np.full((3,), 1.0, np.float32),
                  np.full((3,), 1.0 + 5e-6, np.float32)),
    "far_f32": (np.full((3,), 1.0, np.float32),
                np.full((3,), 1.01, np.float32)),
    "close_f16": (np.full((3,), 1.0, np.float16),
                  np.full((3,), 1.005, np.float16)),
    "int": (np.arange(6, dtype=np.int32), np.arange(6, dtype=np.int32)),
    "nan": (np.array([np.nan, 1.0], np.float32),
            np.array([np.nan, 1.0], np.float32)),
}


@pytest.mark.parametrize("name", sorted(_PAIRS))
@pytest.mark.parametrize("equal_nan", [False, True])
def test_almost_equal_and_same_agree(name, equal_nan):
    a, b = _PAIRS[name]
    assert ttu.almost_equal(a, b, equal_nan=equal_nan) == \
        jtu.almost_equal(a, b, equal_nan=equal_nan)
    assert ttu.same(a, b) == jtu.same(a, b)
    assert ttu.max_rel_err(a, b) == jtu.max_rel_err(a, b) or (
        np.isnan(ttu.max_rel_err(a, b)) and np.isnan(jtu.max_rel_err(a, b)))


@pytest.mark.parametrize("name", sorted(_PAIRS))
def test_assert_almost_equal_raises_alike(name):
    a, b = _PAIRS[name]
    outcomes = []
    for tu, mx in ((jtu, jmx), (ttu, tmx)):
        try:
            tu.assert_almost_equal(mx.nd.array(a, dtype=a.dtype),
                                   mx.nd.array(b, dtype=b.dtype))
            outcomes.append(None)
        except AssertionError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_assert_almost_equal_shape_mismatch():
    for tu in (jtu, ttu):
        with pytest.raises(AssertionError, match="shape mismatch"):
            tu.assert_almost_equal(np.ones(3), np.ones(4))


def test_rand_helpers():
    np.random.seed(3)
    s = ttu.rand_shape_nd(3, dim=5)
    assert len(s) == 3 and all(1 <= d <= 5 for d in s)
    x = ttu.rand_ndarray((2, 3), dtype=np.float32, scale=0.5)
    assert isinstance(x, tmx.nd.NDArray) and x.shape == (2, 3)
    assert float(abs(x.asnumpy()).max()) <= 0.5


def _fn(x, w):
    return (x * w).sum(axis=1, keepdims=True) * x


@pytest.mark.parametrize("seed", [0, 1])
def test_check_numeric_gradient_agrees(seed):
    r = np.random.RandomState(seed)
    xs = [r.rand(2, 3).astype(np.float32), r.rand(2, 1).astype(np.float32)]
    for tu in (jtu, ttu):
        tu.check_numeric_gradient(_fn, xs)


def test_check_numeric_gradient_catches_a_wrong_gradient():
    # the second factor is a constant copy: autograd sees x, the finite
    # differences 2x
    for tu, mx in ((jtu, jmx), (ttu, tmx)):
        with pytest.raises(AssertionError):
            tu.check_numeric_gradient(
                lambda x: x * mx.nd.array(x.asnumpy()),
                [np.full((2, 2), 2.0, np.float32)])


@pytest.mark.parametrize("dtypes", [("float32",), ("float32", "float16")])
def test_check_consistency_agrees(dtypes):
    r = np.random.RandomState(5)
    xs = [r.rand(3, 4).astype(np.float32)]
    fn = (lambda x: (x * 2 + 1).sum(axis=0))
    got = ttu.check_consistency(fn, xs, ctx_list=[tmx.cpu(), tmx.cpu()],
                                dtypes=dtypes)
    want = jtu.check_consistency(fn, xs, ctx_list=[jmx.cpu(), jmx.cpu()],
                                 dtypes=dtypes)
    assert got == pytest.approx(want, abs=1e-6)


def test_check_grad_consistency_agrees():
    r = np.random.RandomState(6)
    xs = [r.rand(3, 4).astype(np.float32), r.rand(4, 2).astype(np.float32)]
    got = ttu.check_grad_consistency(lambda a, b: tmx.nd.dot(a, b), xs,
                                     ctx_list=[tmx.cpu(), tmx.cpu()])
    want = jtu.check_grad_consistency(lambda a, b: jmx.nd.dot(a, b), xs,
                                      ctx_list=[jmx.cpu(), jmx.cpu()])
    assert got == want == 0.0
