"""The port's sparse arrays and custom operators against the reference:
``nd.sparse`` (CSR and row-sparse metadata, ``retain``, ``tostype``, dense
compute, ``.params`` files that store them dense) and ``mx.operator``
(``CustomOp``/``CustomOpProp``/``register``, the ``Custom`` op eagerly,
under ``autograd.record`` and inside a traced Symbol). The cases of
``tests/test_np_sparse_cf.py`` for the numpy frontend, the sparse arrays
and the custom op run on the port here and in ``test_torch_numpy.py``.

Both packages get the same seeded numpy inputs; values are held bitwise
(integer metadata, files) or at rtol 1e-6 (float results).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.ndarray import sparse as jsparse

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ndarray import sparse as tsparse


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _dense(seed=0, shape=(5, 6), density=0.4):
    r = np.random.RandomState(seed)
    d = r.randn(*shape).astype(np.float32)
    d[r.rand(*shape) > density] = 0
    return d


def test_csr_roundtrip():
    dense = np.array([[0, 1, 0], [2, 0, 3]], np.float32)
    csr = tsparse.csr_matrix(dense)
    assert csr.stype == "csr"
    np.testing.assert_allclose(csr.todense().asnumpy(), dense)
    np.testing.assert_allclose(csr.indptr.asnumpy(), [0, 1, 3])
    np.testing.assert_allclose(csr.indices.asnumpy(), [1, 0, 2])
    np.testing.assert_allclose(csr.data.asnumpy(), [1, 2, 3])
    csr2 = tsparse.csr_matrix(([1.0, 2, 3], [1, 0, 2], [0, 1, 3]),
                              shape=(2, 3))
    np.testing.assert_allclose(csr2.todense().asnumpy(), dense)
    out = tnd.dot(csr, tnd.array(np.eye(3, dtype=np.float32)))
    np.testing.assert_allclose(out.asnumpy(), dense)


def test_row_sparse_and_retain():
    dense = np.zeros((4, 2), np.float32)
    dense[1] = [1, 2]
    dense[3] = [3, 4]
    rs = tsparse.row_sparse_array(dense)
    assert rs.stype == "row_sparse"
    np.testing.assert_allclose(rs.indices.asnumpy(), [1, 3])
    kept = rs.retain(tnd.array(np.array([3], np.float32)))
    np.testing.assert_allclose(kept.indices.asnumpy(), [3])
    np.testing.assert_allclose(kept.todense().asnumpy()[1], 0)
    assert rs.tostype("default").stype == "default"
    assert rs.tostype("csr").stype == "csr"


@pytest.mark.parametrize("seed,shape", [(0, (5, 6)), (1, (1, 7)),
                                        (2, (8, 1)), (3, (4, 4))])
def test_csr_metadata_matches_reference(seed, shape):
    d = _dense(seed, shape)
    j, t = jsparse.csr_matrix(d), tsparse.csr_matrix(d)
    for attr in ("indptr", "indices", "data"):
        a, b = getattr(j, attr).asnumpy(), getattr(t, attr).asnumpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.todense().asnumpy(), d)
    data, indices, indptr = (j.data.asnumpy(), j.indices.asnumpy(),
                             j.indptr.asnumpy())
    t2 = tsparse.csr_matrix((data, indices, indptr), shape=shape)
    np.testing.assert_array_equal(t2.asnumpy(), d)


@pytest.mark.parametrize("keep", [[0, 2], [4], [], [1, 3, 4, 9]])
def test_row_sparse_retain_matches_reference(keep):
    d = _dense(5, (5, 3), density=0.5)
    d[2] = 0
    j, t = jsparse.row_sparse_array(d), tsparse.row_sparse_array(d)
    np.testing.assert_array_equal(j.indices.asnumpy(), t.indices.asnumpy())
    np.testing.assert_array_equal(j.data.asnumpy(), t.data.asnumpy())
    jk = j.retain(jnd.array(np.array(keep, np.float32)))
    tk = t.retain(tnd.array(np.array(keep, np.float32)))
    np.testing.assert_array_equal(jk.indices.asnumpy(), tk.indices.asnumpy())
    np.testing.assert_array_equal(jk.asnumpy(), tk.asnumpy())
    rs = tsparse.row_sparse_array((d[[0, 3]], [0, 3]), shape=(5, 3))
    js = jsparse.row_sparse_array((d[[0, 3]], [0, 3]), shape=(5, 3))
    np.testing.assert_array_equal(rs.asnumpy(), js.asnumpy())


@pytest.mark.parametrize("stype", ["csr", "row_sparse", "default"])
def test_tostype_from_dense(stype):
    d = _dense(6)
    t = tnd.array(d).tostype(stype)
    assert t.stype == stype
    np.testing.assert_array_equal(t.asnumpy(), d)
    j = jsparse.csr_matrix(d) if stype == "csr" \
        else jsparse.row_sparse_array(d)
    if stype != "default":
        np.testing.assert_array_equal(t.indices.asnumpy(),
                                      j.indices.asnumpy())
    with pytest.raises(ValueError):
        tnd.array(d).tostype("coo")


def test_sparse_operands_compute_densely():
    d, w = _dense(7, (4, 5)), np.random.RandomState(8).randn(5, 3)
    w = w.astype(np.float32)
    tout = tnd.dot(tsparse.csr_matrix(d), tnd.array(w)).asnumpy()
    jout = jnd.dot(jsparse.csr_matrix(d), jnd.array(w)).asnumpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        (tsparse.row_sparse_array(d) * 2).asnumpy(), d * 2)


def test_params_file_stores_sparse_dense(tmp_path):
    d = _dense(9)
    tnd.save(str(tmp_path / "t.params"), {"w": tsparse.csr_matrix(d),
                                          "r": tsparse.row_sparse_array(d)})
    jnd.save(str(tmp_path / "j.params"), {"w": jsparse.csr_matrix(d),
                                          "r": jsparse.row_sparse_array(d)})
    assert (tmp_path / "t.params").read_bytes() == \
        (tmp_path / "j.params").read_bytes()
    back = tnd.load(str(tmp_path / "j.params"))
    assert back["w"].stype == "default"
    np.testing.assert_array_equal(back["w"].asnumpy(), d)


# ----------------------------------------------------------------------------
# custom operators
# ----------------------------------------------------------------------------

def _register_sigmoid(mx, name):
    @mx.operator.register(name)
    class MySigmoidProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class MySigmoid(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]
                    y = 1.0 / (1.0 + (-x).exp())
                    self.assign(out_data[0], req[0], y)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    raise AssertionError("backward is never called")

            return MySigmoid()

    return MySigmoidProp


def _register_scaled_sum(mx, name):
    @mx.operator.register(name)
    class ScaledSumProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "diff"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class ScaledSum(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * 2 + in_data[1])
                    self.assign(out_data[1], "add", in_data[0] - in_data[1])

            return ScaledSum()

    return ScaledSumProp


def test_custom_op():
    _register_sigmoid(tmx, "mysigmoid")
    assert "mysigmoid" in tmx.operator.get_all_registered_operators()
    x = tnd.array(np.array([0.0, 1.0], np.float32))
    out = tnd.Custom(x, op_type="mysigmoid")
    np.testing.assert_allclose(out.asnumpy(),
                               1 / (1 + np.exp([-0.0, -1.0])), rtol=1e-6)


def test_custom_op_matches_reference_with_two_outputs():
    _register_scaled_sum(jmx, "scaled_sum")
    _register_scaled_sum(tmx, "scaled_sum")
    r = np.random.RandomState(12)
    a, b = r.randn(3, 4).astype(np.float32), r.randn(3, 4).astype(np.float32)
    j = jnd.Custom(jnd.array(a), jnd.array(b), op_type="scaled_sum")
    t = tnd.Custom(tnd.array(a), tnd.array(b), op_type="scaled_sum")
    for x, y in zip(j, t):
        np.testing.assert_allclose(x.asnumpy(), y.asnumpy(), rtol=1e-6)
        assert y.dtype == np.float32


def test_custom_op_gradient_flows_through_forward_ops():
    _register_sigmoid(tmx, "mysigmoid_grad")
    _register_sigmoid(jmx, "mysigmoid_grad")
    xs = np.array([-1.0, 0.0, 2.0], np.float32)
    grads = []
    for mx, nd in ((jmx, jnd), (tmx, tnd)):
        x = nd.array(xs)
        x.attach_grad()
        with mx.autograd.record():
            y = nd.Custom(x, op_type="mysigmoid_grad")
            loss = (y * y).sum()
        loss.backward()
        grads.append(x.grad.asnumpy())
    s = 1 / (1 + np.exp(-xs))
    np.testing.assert_allclose(grads[1], 2 * s * s * (1 - s), rtol=1e-5)
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5)


def test_custom_op_unregistered_raises():
    with pytest.raises(ValueError, match="not registered"):
        tnd.Custom(tnd.array([1.0]), op_type="no_such_custom_op")


def test_custom_op_traces_into_a_symbol():
    """Inside the port's Symbol and shape traces the outputs are meta
    tensors; the bound graph then runs the forward on real tensors."""
    _register_sigmoid(tmx, "mysigmoid_sym")
    data = tmx.sym.Variable("data")
    net = tmx.sym.Custom(data, op_type="mysigmoid_sym", name="cs")
    arg_shapes, out_shapes, _ = net.infer_shape(data=(2, 3))
    assert out_shapes == [(2, 3)]
    x = np.random.RandomState(13).randn(2, 3).astype(np.float32)
    exe = net.simple_bind(ctx=tmx.cpu(), data=(2, 3))
    out = exe.forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(out, 1 / (1 + np.exp(-x)), rtol=1e-6)


def test_custom_outputs_sit_on_the_inputs_device():
    _register_scaled_sum(tmx, "scaled_sum_dev")
    a = tnd.array(np.ones((2, 2), np.float32))
    outs = tnd.Custom(a, a, op_type="scaled_sum_dev")
    assert all(o.context == a.context for o in outs)
    np.testing.assert_array_equal(outs[1].asnumpy(), np.zeros((2, 2)))
