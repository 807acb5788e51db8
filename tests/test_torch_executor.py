"""The port's ``Executor`` and shape engine (``mxnet_tpu_torch/
executor.py``, ``analysis/shape_infer.py``) against the JAX package, on
the CPU.

The same graphs are bound in both packages with the same numpy values:
forward outputs, gradients under ``grad_req`` ``write``/``add``/``null``,
a second ``backward`` after one ``forward`` (the reference recomputes;
the port keeps its tape), BatchNorm's auxiliary fold, ``bind`` with given
arrays, ``copy_params_from``; and the shape engine's answers (
``infer_shape``, ``infer_type``, ``Symbol.shape`` from the shape hints
alone, node-attributed errors). f32 results at rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import symbol as jsym
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import GraphAnalysisError, MXNetError
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.executor import _build_graph_fn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def _net(S):
    """data (4, 6) -> FC 5 -> tanh -> FC 3 -> sum of squares."""
    x = S.Variable("data")
    h = S.Activation(S.FullyConnected(x, num_hidden=5, name="fc1"),
                     act_type="tanh")
    out = S.FullyConnected(h, num_hidden=3, name="fc2")
    return S.sum(S.square(out))


_VALS = {"data": np.random.RandomState(0).randn(4, 6),
         "fc1_weight": np.random.RandomState(1).randn(5, 6) * 0.5,
         "fc1_bias": np.random.RandomState(2).randn(5) * 0.1,
         "fc2_weight": np.random.RandomState(3).randn(3, 5) * 0.5,
         "fc2_bias": np.random.RandomState(4).randn(3) * 0.1}
_VALS = {k: v.astype(np.float32) for k, v in _VALS.items()}


def _run(pkg, S, grad_req="write", backwards=1, head=None):
    exe = _net(S).simple_bind(ctx=pkg.cpu(), grad_req=grad_req, data=(4, 6))
    (out,) = exe.forward(is_train=True, **_VALS)
    for _ in range(backwards):
        exe.backward(None if head is None else pkg.nd.array(head))
    return out.asnumpy(), {k: v.asnumpy() for k, v in exe.grad_dict.items()}


@pytest.mark.parametrize("grad_req,backwards", [("write", 1), ("write", 2),
                                                ("add", 1), ("add", 2)])
def test_forward_backward_grad_req(grad_req, backwards):
    want_out, want = _run(jmx, jsym, grad_req, backwards)
    got_out, got = _run(mx, sym, grad_req, backwards)
    np.testing.assert_allclose(got_out, want_out, **TOL)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_backward_with_head_gradient():
    head = np.array(0.5, np.float32)  # the output is 0-d
    _o, want = _run(jmx, jsym, head=head)
    _o, got = _run(mx, sym, head=head)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_grad_req_null():
    exe = _net(sym).simple_bind(grad_req="null", data=(4, 6))
    assert exe.grad_dict == {}
    (out,) = exe.forward(is_train=True, **_VALS)
    want, _g = _run(jmx, jsym)
    np.testing.assert_allclose(out.asnumpy(), want, **TOL)
    with pytest.raises(MXNetError, match="backward"):
        exe.backward()
    with pytest.raises(ValueError, match="grad_req"):
        _net(sym).simple_bind(grad_req="sum", data=(4, 6))


def test_predict_forward_keeps_no_tape():
    exe = _net(sym).simple_bind(data=(4, 6))
    exe.forward(is_train=False, **_VALS)
    with pytest.raises(MXNetError):
        exe.backward()


def test_bind_with_arrays_and_copy_params_from():
    args = {k: nd.array(v) for k, v in _VALS.items()}
    grads = {k: nd.zeros(v.shape) for k, v in _VALS.items()}
    exe = _net(sym).bind(mx.cpu(), args=args, args_grad=grads)
    assert exe.arg_dict["fc1_weight"] is args["fc1_weight"]
    exe.forward(is_train=True)
    exe.backward()
    _o, want = _run(jmx, jsym)
    np.testing.assert_allclose(grads["fc1_weight"].asnumpy(),
                               want["fc1_weight"], **TOL)
    # copy_params_from copies: later writes to the source do not show
    exe2 = _net(sym).simple_bind(data=(4, 6))
    src = {k: nd.array(v) for k, v in _VALS.items()}
    exe2.copy_params_from(src)
    src["fc2_bias"][:] = 100.0
    np.testing.assert_array_equal(exe2.arg_dict["fc2_bias"].asnumpy(),
                                  _VALS["fc2_bias"])


@pytest.mark.parametrize("use_global_stats", [False, True])
def test_batchnorm_aux_fold_matches_reference(use_global_stats):
    """Training forward through BatchNorm: output, input and parameter
    gradients, and the moving statistics the Executor folds (momentum
    0.8), against the reference; predict mode reads the statistics."""
    x = np.random.RandomState(5).randn(6, 3, 4).astype(np.float32) * 3
    gamma = np.array([1.0, 0.5, 2.0], np.float32)
    beta = np.array([0.1, -0.2, 0.3], np.float32)
    res = []
    for pkg, S in ((jmx, jsym), (mx, sym)):
        out = S.BatchNorm(S.Variable("data"), fix_gamma=False, momentum=0.8,
                          use_global_stats=use_global_stats, name="bn")
        exe = S.square(out).simple_bind(ctx=pkg.cpu(), data=x.shape)
        exe.aux_dict["bn_moving_mean"][:] = 0.5
        (o,) = exe.forward(is_train=True, data=x, bn_gamma=gamma,
                           bn_beta=beta)
        exe.backward()
        aux = {k: v.asnumpy() for k, v in exe.aux_dict.items()}
        (p,) = exe.forward(is_train=False, data=x)
        res.append((o.asnumpy(), {k: v.asnumpy() for k, v
                                  in exe.grad_dict.items()}, aux,
                    p.asnumpy()))
    (wo, wg, wa, wp), (go, gg, ga, gp) = res
    np.testing.assert_allclose(go, wo, **TOL)
    for k in wg:
        np.testing.assert_allclose(gg[k], wg[k], err_msg=k, rtol=1e-5,
                                   atol=1e-5)
    assert ga.keys() == wa.keys() == {"bn_moving_mean", "bn_moving_var"}
    for k in wa:
        np.testing.assert_allclose(ga[k], wa[k], err_msg=k, **TOL)
    if not use_global_stats:
        assert not np.allclose(wa["bn_moving_mean"], 0.5)
    np.testing.assert_allclose(gp, wp, **TOL)


def test_build_graph_fn_is_one_function_of_tensors():
    """_build_graph_fn (the entry point batch serving builds on): the DAG
    as fn(args, aux) -> (outputs, new aux), here on plain tensors."""
    names, aux_names, fn, has_aux = _build_graph_fn(_net(sym), train=False)
    assert names == list(_VALS) and aux_names == [] and not has_aux
    outs, new_aux = fn([torch.from_numpy(_VALS[n]) for n in names], [])
    want, _g = _run(jmx, jsym)
    np.testing.assert_allclose(outs[0].numpy(), want, **TOL)
    assert new_aux == ()


# ---------------------------------------------------------------------------
# the shape engine
# ---------------------------------------------------------------------------

def test_infer_shape_and_type_match_reference():
    for build in (_net, lambda S: S.BatchNorm(S.Variable("data"),
                                              name="bn")):
        want = build(jsym).infer_shape(data=(4, 6))
        assert build(sym).infer_shape(data=(4, 6)) == want
    assert sym.Variable("a").infer_type() == ([np.float32], [np.float32],
                                              [])
    v = sym.Variable("a", shape=(2, 3), dtype="float16")
    got = sym.cast(v, dtype="float32").infer_type()
    assert got == ([np.float16], [np.float32], [])


def test_symbol_shape_from_hints_alone():
    """``.shape`` answers from Variable shape hints, evaluating each node
    on meta tensors: a flash-attention node at the flash lengths included
    (its wrapper meets meta tensors and counts no launch)."""
    from mxnet_tpu_torch.ops.attention import fused_attention
    from mxnet_tpu_torch.ops.flash_attention import flash_attention_fwd

    x = sym.var("data", shape=(2, 12, 2048, 8))
    launches = flash_attention_fwd.launches
    att = sym.invoke_fn(lambda q, k, v: fused_attention(q, k, v,
                                                        causal=True),
                        [x, x, x])
    assert att.shape == (2, 12, 2048, 8)
    assert flash_attention_fwd.launches == launches
    fc = sym.FullyConnected(att.reshape((2, -1)), num_hidden=4, name="fc")
    assert fc.shape == (2, 4) and fc.ndim == 2


def test_shape_errors_name_the_node():
    a = sym.FullyConnected(sym.Variable("data"), num_hidden=3, name="fc")
    with pytest.raises(GraphAnalysisError) as e:
        a.shape
    assert e.value.rule_id == "missing-shape"
    bad = sym.broadcast_add(sym.var("x", shape=(2, 3)),
                            sym.var("y", shape=(4, 5)), name="add")
    with pytest.raises(GraphAnalysisError) as e:
        bad.infer_shape()
    assert e.value.node == "add" and e.value.rule_id == "shape-mismatch"
    assert e.value.input_shapes == [(2, 3), (4, 5)]
