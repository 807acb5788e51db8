"""The port's symbolic frontend (``mxnet_tpu_torch.symbol``), ``Module``,
``BucketingModule``, ``model`` checkpoints and ``SymbolBlock`` against the
JAX package, on the CPU.

The cases of ``tests/test_symbol_module.py`` (and the SymbolBlock case of
``tests/test_api_surface.py``) run through the port, plus the
cross-package contract: the same graph gives the same JSON in both
packages and loads in the other; ``infer_shape`` agrees on the MLP and on
a tiny TransformerLM traced from its Gluon block; ``Module.fit`` on the
MLP from the same initial parameters with ``shuffle=False`` ends one
epoch at the same weights (f32 tolerances: rtol 1e-5, atol 1e-6); and
``model.save_checkpoint`` files load across packages.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
from mxnet_tpu import nd as jnd
from mxnet_tpu import symbol as jsym
from mxnet_tpu.io import NDArrayIter as JIter
from mxnet_tpu.module import Module as JModule
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.io import DataBatch, NDArrayIter
from mxnet_tpu_torch.module import BucketingModule, Module

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with mx.cpu():
        yield


def _mlp_symbol(S=sym, hidden=16, classes=4):
    data = S.Variable("data")
    net = S.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.FullyConnected(net, num_hidden=classes, name="fc2")
    return S.SoftmaxOutput(net, name="softmax")


# ---------------------------------------------------------------------------
# tests/test_symbol_module.py, through the port
# ---------------------------------------------------------------------------

def test_symbol_arguments_and_outputs():
    s = _mlp_symbol()
    assert s.list_arguments() == ["data", "fc1_weight", "fc1_bias",
                                  "fc2_weight", "fc2_bias", "softmax_label"]
    assert s.list_outputs() == ["softmax_output"]


def test_symbol_infer_shape():
    s = _mlp_symbol(hidden=16, classes=4)
    arg_shapes, out_shapes, aux_shapes = s.infer_shape(data=(8, 10))
    d = dict(zip(s.list_arguments(), arg_shapes))
    assert d["fc1_weight"] == (16, 10)
    assert d["fc1_bias"] == (16,)
    assert d["fc2_weight"] == (4, 16)
    assert out_shapes == [(8, 4)]
    assert aux_shapes == []


def test_symbol_json_roundtrip():
    s = _mlp_symbol()
    s2 = sym.load_json(s.tojson())
    assert s2.list_arguments() == s.list_arguments()
    assert s2.infer_shape(data=(2, 6))[1] == [(2, 4)]


def test_executor_forward_matches_numpy():
    data = sym.Variable("data")
    w = sym.Variable("w")
    out = sym.FullyConnected(data, w, no_bias=True, num_hidden=3, name="fc")
    exe = out.simple_bind(grad_req="null", data=(2, 5), w=(3, 5))
    x = np.random.RandomState(0).rand(2, 5).astype(np.float32)
    wv = np.random.RandomState(1).rand(3, 5).astype(np.float32)
    (y,) = exe.forward(is_train=False, data=x, w=wv)
    np.testing.assert_allclose(y.asnumpy(), x @ wv.T, rtol=1e-5, atol=1e-6)


def test_executor_backward_gradients():
    data = sym.Variable("data")
    out = sym.FullyConnected(data, num_hidden=1, no_bias=True, name="fc")
    exe = sym.sum(out).simple_bind(grad_req="write", data=(4, 3))
    exe.forward(is_train=True, data=np.ones((4, 3), np.float32),
                fc_weight=np.full((1, 3), 2.0, np.float32))
    exe.backward()
    np.testing.assert_allclose(exe.grad_dict["fc_weight"].asnumpy(),
                               np.full((1, 3), 4.0), rtol=1e-5)
    np.testing.assert_allclose(exe.grad_dict["data"].asnumpy(),
                               np.full((4, 3), 2.0), rtol=1e-5)


def test_module_fit_mlp():
    rng = np.random.RandomState(0)
    x = rng.randn(256, 8).astype(np.float32)
    wtrue = rng.randn(8, 3).astype(np.float32)
    y = np.argmax(x @ wtrue, axis=1).astype(np.float32)
    it = NDArrayIter(x, y, batch_size=32, shuffle=True)
    mod = Module(_mlp_symbol(hidden=32, classes=3), context=mx.cpu())
    mod.fit(it, num_epoch=12, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5})
    score = mod.score(it, "acc")
    assert score[0][1] > 0.9, f"train accuracy too low: {score}"


def test_module_predict_and_checkpoint(tmp_path):
    rng = np.random.RandomState(1)
    x = rng.randn(32, 6).astype(np.float32)
    y = rng.randint(0, 3, 32).astype(np.float32)
    it = NDArrayIter(x, y, batch_size=8)
    mod = Module(_mlp_symbol(hidden=8, classes=3))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()
    preds = mod.predict(it)
    assert preds.shape == (32, 3)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 1)
    mod2 = Module.load(prefix, 1)
    mod2.bind(it.provide_data, it.provide_label, for_training=False)
    mod2.init_params()
    np.testing.assert_array_equal(preds.asnumpy(), mod2.predict(it).asnumpy())


def test_batchnorm_symbolic_aux_update():
    data = sym.Variable("data")
    net = sym.BatchNorm(data, name="bn", fix_gamma=False, momentum=0.5)
    exe = net.simple_bind(grad_req="null", data=(4, 3))
    assert set(exe.aux_dict) == {"bn_moving_mean", "bn_moving_var"}
    x = np.random.RandomState(0).rand(4, 3).astype(np.float32) * 10
    exe.forward(is_train=True, data=x, bn_gamma=np.ones(3, np.float32),
                bn_beta=np.zeros(3, np.float32))
    np.testing.assert_allclose(exe.aux_dict["bn_moving_mean"].asnumpy(),
                               0.5 * x.mean(axis=0), rtol=1e-4, atol=1e-5)


def test_bucketing_module_shares_params():
    def sym_gen(seq_len):
        data = sym.Variable("data")
        net = sym.FullyConnected(data, num_hidden=4, name="fc",
                                 flatten=False)
        net = sym.mean(net, axis=1)
        return sym.SoftmaxOutput(net, name="softmax"), ("data",), \
            ("softmax_label",)

    mod = BucketingModule(sym_gen, default_bucket_key=10)
    mod.bind([("data", (2, 10, 5))], [("softmax_label", (2,))])
    mod.init_params()
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    w0 = mod._buckets[10]._exec.arg_dict["fc_weight"].asnumpy()
    for key, t in ((10, 10), (6, 6), (10, 10)):
        batch = DataBatch([nd.ones((2, t, 5))], [nd.zeros((2,))],
                          bucket_key=key,
                          provide_data=[("data", (2, t, 5))],
                          provide_label=[("softmax_label", (2,))])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    m10 = mod._buckets[10]._exec.arg_dict["fc_weight"]
    m6 = mod._buckets[6]._exec.arg_dict["fc_weight"]
    assert m10 is m6
    assert mod._buckets[6]._updater is mod._buckets[10]._updater
    assert not np.array_equal(m10.asnumpy(), w0)


def test_symbol_arithmetic_and_eval():
    a, b = sym.Variable("a"), sym.Variable("b")
    c = (a + b) * 2.0 - 1.0
    exe = c.simple_bind(grad_req="null", a=(2, 2), b=(2, 2))
    (out,) = exe.forward(a=np.ones((2, 2), np.float32),
                         b=np.ones((2, 2), np.float32))
    np.testing.assert_allclose(out.asnumpy(), np.full((2, 2), 3.0))
    (ev,) = c.eval(a=nd.ones((2, 2)), b=nd.ones((2, 2)))
    np.testing.assert_allclose(ev.asnumpy(), np.full((2, 2), 3.0))


def test_multi_output_indexing():
    data = sym.Variable("data")
    s = sym.SliceChannel(data, num_outputs=3, axis=1, name="split")
    assert len(s.list_outputs()) == 3
    exe = s[0].simple_bind(grad_req="null", data=(2, 6))
    (out,) = exe.forward(data=np.arange(12, dtype=np.float32).reshape(2, 6))
    assert out.shape == (2, 2)


def test_symbolblock_imports_roundtrip(tmp_path):
    """tests/test_api_surface.py::test_symbolblock_imports_roundtrip."""
    data = sym.Variable("data")
    out = sym.FullyConnected(data, sym.Variable("fc_weight"),
                             sym.Variable("fc_bias"), num_hidden=4,
                             name="fc")
    out = sym.Activation(out, act_type="relu", name="act")
    rng = np.random.RandomState(0)
    arg = {"fc_weight": nd.array(rng.rand(4, 3).astype(np.float32)),
           "fc_bias": nd.array(np.zeros(4, np.float32))}
    prefix = str(tmp_path / "m")
    mx.model.save_checkpoint(prefix, 3, out, arg, {})
    blk = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                       prefix + "-0003.params")
    x = nd.array(rng.rand(2, 3).astype(np.float32))
    ref = np.maximum(x.asnumpy() @ arg["fc_weight"].asnumpy().T, 0)
    np.testing.assert_allclose(blk(x).asnumpy(), ref, rtol=1e-5)
    blk.hybridize()
    np.testing.assert_allclose(blk(x).asnumpy(), ref, rtol=1e-5)
    assert set(blk._reg_params) == {"fc_weight", "fc_bias"}
    mx.model.save_checkpoint(str(tmp_path / "bad"), 0, out,
                             {"fc_weight": arg["fc_weight"]}, {})
    with pytest.raises(KeyError):
        mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                     str(tmp_path / "bad-0000.params"))


def test_symbolic_hooks_and_refusals(tmp_path):
    """Parameter.var, the gluon export descriptor, optimize_for, and the
    entry points that wait for other queue items raise naming them (an
    ONNX export without example inputs raises before it writes)."""
    net = mx.gluon.nn.Dense(3, in_units=2)
    net.initialize()
    v = net.weight.var()
    assert v.name == "dense0_weight" and v.attr("__shape__") == (3, 2)
    net.export(str(tmp_path / "d"), epoch=2)
    meta = json.load(open(tmp_path / "d-symbol.json"))
    assert meta["param_map"] == {"weight": "dense0_weight",
                                 "bias": "dense0_bias"}
    traced = sym.load_json(meta["symbol"])
    assert traced.list_arguments() == ["data", "dense0_weight",
                                       "dense0_bias"]
    assert set(nd.load(str(tmp_path / "d-0002.params"))) == {"weight",
                                                             "bias"}
    with pytest.raises(ValueError, match="example_inputs"):
        net.export(str(tmp_path / "o"), format="onnx")
    # optimize_for: the block hybridizes (the reference's), the Symbol
    # runs a graph pass and refuses an unknown one
    net.optimize_for(nd.ones((1, 2)), backend="x")
    assert net._active
    with pytest.raises(ValueError, match="unknown subgraph"):
        traced.optimize_for("x")
    # the linters (queue item A15(e)): a report, and a bind that lints
    assert not traced.lint().has_errors
    mod = Module(_mlp_symbol(), context=mx.cpu())
    mod.bind([("data", (2, 3))], [("softmax_label", (2,))], lint="warn")
    assert not mod._exec.lint_report.has_errors


def test_module_entry_points_default_to_the_card(monkeypatch):
    """Without a ``with mx.cpu():`` scope, Module, simple_bind and
    nd.load go to the card, and with no card they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mx.context.Context._default, "stack", [])
    with pytest.raises(MXNetError, match="CUDA"):
        Module(_mlp_symbol())
    with pytest.raises(MXNetError, match="CUDA"):
        _mlp_symbol().simple_bind(data=(2, 3))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def test_symbol_json_identical_and_loads_across_packages():
    with jmx.name.NameManager(), mx.name.NameManager():
        js = _mlp_symbol(jsym).tojson()
        ts = _mlp_symbol(sym).tojson()
    assert ts == js
    back = jsym.load_json(ts)
    mine = sym.load_json(js)
    assert back.list_arguments() == mine.list_arguments()
    assert mine.infer_shape(data=(5, 7)) == back.infer_shape(data=(5, 7))
    # BatchNorm: auxiliary states re-derived from the op slots on load
    with jmx.name.NameManager(), mx.name.NameManager():
        jbn = jsym.BatchNorm(jsym.Variable("data"), name="bn").tojson()
        tbn = sym.BatchNorm(sym.Variable("data"), name="bn").tojson()
    assert jbn == tbn
    assert sym.load_json(jbn).list_auxiliary_states() == \
        ["bn_moving_mean", "bn_moving_var"]


def test_invoke_fn_placeholder_cannot_be_loaded():
    out = sym.invoke_fn(lambda x: x * 2, [sym.Variable("data")])
    js = out.tojson()
    assert json.loads(js)["nodes"][1]["op"] == "_invoke_fn"
    with pytest.raises(ValueError, match="_invoke_fn"):
        sym.load_json(js).simple_bind(data=(2,))
    with pytest.raises(ValueError, match="_invoke_fn"):
        jsym.load_json(js).simple_bind(data=(2,))


def _mlp_fit(pkg, S, Iter, Mod, arrays, x, y, ctx):
    it = Iter(x, y, batch_size=8, shuffle=False)
    mod = Mod(_mlp_symbol(S, hidden=8, classes=3), context=ctx)
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params={k: pkg.nd.array(v) for k, v in arrays.items()})
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_mlp_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(40, 6).astype(np.float32)
    y = rng.randint(0, 3, 40).astype(np.float32)
    arrays = {"fc1_weight": rng.randn(8, 6).astype(np.float32) * 0.3,
              "fc1_bias": np.zeros(8, np.float32),
              "fc2_weight": rng.randn(3, 8).astype(np.float32) * 0.3,
              "fc2_bias": np.zeros(3, np.float32)}
    want = _mlp_fit(jmx, jsym, JIter, JModule, arrays, x, y, jmx.cpu())
    got = _mlp_fit(mx, sym, NDArrayIter, Module, arrays, x, y, mx.cpu())
    assert got.keys() == want.keys()
    for k in want:
        assert not np.allclose(want[k], arrays[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_model_checkpoint_across_packages(tmp_path):
    """model.save_checkpoint of either package: the same .params bytes and
    symbol JSON, loaded by the other (the port's arrays on ctx)."""
    with jmx.name.NameManager(), mx.name.NameManager():
        js, ts = _mlp_symbol(jsym), _mlp_symbol(sym)
    rng = np.random.RandomState(4)
    vals = {"fc1_weight": rng.randn(16, 5).astype(np.float32),
            "fc1_bias": rng.randn(16).astype(np.float32)}
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    jmx.model.save_checkpoint(jp, 1, js, {k: jnd.array(v)
                                          for k, v in vals.items()}, {})
    mx.model.save_checkpoint(tp, 1, ts, {k: nd.array(v)
                                         for k, v in vals.items()}, {})
    for suffix in ("-symbol.json", "-0001.params"):
        assert open(jp + suffix, "rb").read() == open(tp + suffix,
                                                      "rb").read()
    s, arg, aux = mx.model.load_checkpoint(jp, 1, ctx=mx.cpu())
    assert s.list_arguments() == ts.list_arguments() and aux == {}
    for k, v in vals.items():
        np.testing.assert_array_equal(arg[k].asnumpy(), v)
        assert arg[k].context == mx.cpu()
    _s, jarg, _aux = jmx.model.load_checkpoint(tp, 1)
    for k, v in vals.items():
        np.testing.assert_array_equal(jarg[k].asnumpy(), v)


# ---------------------------------------------------------------------------
# the tiny TransformerLM traced from its Gluon block
# ---------------------------------------------------------------------------

_LM = dict(vocab_size=64, units=32, hidden_size=64, num_layers=2,
           num_heads=2, max_length=32)


def _traced_lms():
    """(reference symbol, reference net, port symbol, port net) of the
    tiny LM, each traced over data (2, 16) in a fresh name scope, the
    port net holding the reference's parameters."""
    from mxnet_tpu.models import transformer_lm as jlm
    from mxnet_tpu_torch.models import transformer_lm as tlm

    jnet, tnet = jlm(**_LM), tlm(**_LM)
    jnet.initialize()
    tnet.initialize()
    for (n, p), q in zip(jnet.collect_params().items(),
                         tnet.collect_params().values()):
        assert q.name == n
        q.set_data(p.data().asnumpy())
    with jmx.name.NameManager():
        js = jnet(jsym.var("data", shape=(2, 16)))
    with mx.name.NameManager():
        ts = tnet(sym.var("data", shape=(2, 16)))
    return js, jnet, ts, tnet


def test_tiny_lm_traces_like_reference():
    js, jnet, ts, tnet = _traced_lms()
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_arguments()[1] == "transformerlm0_word_embed_weight"
    assert ts.list_outputs() == js.list_outputs()
    assert ts.infer_shape(data=(2, 16)) == js.infer_shape(data=(2, 16))
    ops = sorted({n._op for n in ts._topo() if n._op})
    assert ops == sorted({n._op for n in js._topo() if n._op})
    assert "_invoke_fn" in ops
    assert ts.tojson() == js.tojson()


def test_tiny_lm_executor_matches_reference():
    """Forward and backward of the traced tiny LM through each package's
    Executor, from the reference's own parameters, at rtol 1e-5; the
    absolute floor is 1e-6 of each array's largest element (a gradient
    element near 0 sums 32 products of magnitude ~10 in f32)."""
    js, jnet, ts, tnet = _traced_lms()
    x = np.random.RandomState(0).randint(0, 64, (2, 16)).astype(np.float32)
    head = np.random.RandomState(1).randn(2, 16, 64).astype(np.float32)
    params = {p.name: p.data().asnumpy()
              for p in jnet.collect_params().values()}
    outs, grads = [], []
    for S, pkg, s in ((jsym, jmx, js), (sym, mx, ts)):
        exe = s.simple_bind(ctx=pkg.cpu(), data=(2, 16))
        exe.copy_params_from({k: pkg.nd.array(v) for k, v in params.items()})
        (o,) = exe.forward(is_train=True, data=pkg.nd.array(x))
        exe.backward(pkg.nd.array(head))
        outs.append(o.asnumpy())
        grads.append({k: v.asnumpy() for k, v in exe.grad_dict.items()
                      if k != "data"})
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    assert grads[1].keys() == grads[0].keys()
    for k in grads[0]:
        floor = 1e-6 * max(1.0, float(np.abs(grads[0][k]).max()))
        np.testing.assert_allclose(grads[1][k], grads[0][k], rtol=1e-5,
                                   atol=floor, err_msg=k)
    # and the traced graph equals the port's own Gluon forward
    np.testing.assert_allclose(outs[1], tnet(nd.array(x)).asnumpy(),
                               rtol=1e-6, atol=1e-6)
