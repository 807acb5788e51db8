"""The port's ONNX export and import (``mxnet_tpu_torch/contrib/onnx.py``,
``_onnx_proto.py``, ``HybridBlock.export(format="onnx")``) against the JAX
package's, on the CPU, with no ``onnx`` package.

Graphs built with the ``sym`` API under the same names export to files
byte-identical to the reference's: the CNN, the word-LM LSTM, GRU and
vanilla RNNs (bidirectional too) and the attention block. Each package
imports the other's file and computes the same outputs (rtol 1e-5, atol
1e-6; the recurrent and attention graphs at the reference's 2e-5). Gluon
blocks traced to Symbols differ between the packages by design (the
port's BatchNorm statistics are auxiliary states), so their exports are
held by value: each file is imported and run. The reference's cases of
``tests/test_onnx.py`` and ``tests/test_onnx_models.py`` run on both
packages, the fixture encoded independently of ``_onnx_proto`` included.
"""
import struct

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon import block as jblock
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import _onnx_proto as P
from mxnet_tpu_torch.contrib import onnx as tonnx
from mxnet_tpu_torch.gluon import block as tblock

torch.set_num_threads(1)

PACKAGES = {"reference": jmx, "port": tmx}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _eval(M, sym, feed):
    out = sym.eval(**{k: M.nd.array(v) if isinstance(v, np.ndarray) else v
                      for k, v in feed.items()})
    return (out[0] if isinstance(out, (list, tuple)) else out).asnumpy()


# ---------------------------------------------------------------------------
# graphs built with the sym API, the same names in both packages
# ---------------------------------------------------------------------------

def _small_cnn(M, rng):
    S = M.sym
    data = S.Variable("data")
    c1 = S.Convolution(data, S.Variable("conv1_weight"), kernel=(3, 3),
                       num_filter=8, pad=(1, 1), no_bias=True, name="conv1")
    bn = S.BatchNorm(c1, S.Variable("bn1_gamma"), S.Variable("bn1_beta"),
                     S.Variable("bn1_moving_mean"),
                     S.Variable("bn1_moving_var"), fix_gamma=False,
                     name="bn1")
    act = S.Activation(bn, act_type="relu", name="relu1")
    pool = S.Pooling(act, kernel=(2, 2), stride=(2, 2), pool_type="max",
                     name="pool1")
    fc = S.FullyConnected(pool, S.Variable("fc1_weight"),
                          S.Variable("fc1_bias"), num_hidden=10, name="fc1")
    sym = S.softmax(fc, axis=-1, name="out")
    params = {
        "conv1_weight": rng.randn(8, 3, 3, 3).astype(np.float32) * 0.1,
        "bn1_gamma": rng.rand(8).astype(np.float32) + 0.5,
        "bn1_beta": rng.randn(8).astype(np.float32) * 0.1,
        "bn1_moving_mean": rng.randn(8).astype(np.float32) * 0.1,
        "bn1_moving_var": rng.rand(8).astype(np.float32) + 0.5,
        "fc1_weight": rng.randn(10, 8 * 4 * 4).astype(np.float32) * 0.1,
        "fc1_bias": rng.randn(10).astype(np.float32) * 0.1}
    feed = {"data": rng.rand(1, 3, 8, 8).astype(np.float32)}
    return sym, params, [(1, 3, 8, 8)], feed, 1e-5


def _word_lm(M, rng, mode="lstm", layers=2, bidirectional=False):
    """Embedding -> fused RNN -> FC(flatten=False): the word_lm family."""
    from mxnet_tpu_torch.ops.rnn import rnn_param_size

    S = M.sym
    T, N, V, E, H = 5, 2, 11, 6, 4
    dirs = 2 if bidirectional else 1
    emb = S.Embedding(S.Variable("data"), S.Variable("emb_weight"),
                      input_dim=V, output_dim=E, name="emb")
    ins = [emb, S.Variable("rnn_params"), S.Variable("h0")]
    if mode == "lstm":
        ins.append(S.Variable("c0"))
    rnn = S.RNN(*ins, state_size=H, num_layers=layers, mode=mode,
                bidirectional=bidirectional, name="rnn")
    dec = S.FullyConnected(rnn, num_hidden=V, flatten=False, name="decoder")
    n_p = rnn_param_size(mode, E, H, num_layers=layers,
                         bidirectional=bidirectional)
    params = {"emb_weight": rng.randn(V, E).astype(np.float32) * 0.1,
              "rnn_params": rng.randn(n_p).astype(np.float32) * 0.2,
              "decoder_weight": rng.randn(V, H * dirs).astype(np.float32)
              * 0.1,
              "decoder_bias": rng.randn(V).astype(np.float32) * 0.1}
    state = (layers * dirs, N, H)
    feed = {"data": rng.randint(0, V, (T, N)).astype(np.float32),
            "h0": rng.randn(*state).astype(np.float32) * 0.1}
    shapes = [(T, N), state]
    if mode == "lstm":
        feed["c0"] = rng.randn(*state).astype(np.float32) * 0.1
        shapes.append(state)
    return dec, params, shapes, feed, 2e-5


def _attention(M, rng):
    S = M.sym
    B, Sq, D = 2, 4, 6
    x = S.Variable("x")
    q = S.batch_dot(S.broadcast_mul(x, S.Variable("one")),
                    S.tile(S.expand_dims(S.Variable("wq"), axis=0),
                           reps=(B, 1, 1)), name="q")
    scores = S.batch_dot(q, x, transpose_b=True, name="scores")
    attn = S.softmax(scores, axis=-1, name="attn")
    ctx_ = S.batch_dot(attn, x, name="ctx")
    ln = S.LayerNorm(ctx_, S.Variable("ln_gamma"), S.Variable("ln_beta"),
                     axis=-1, eps=1e-5, name="ln")
    out = S.gelu(ln, name="act")
    params = {"wq": rng.randn(D, D).astype(np.float32) * 0.3,
              "one": np.ones((1, 1, 1), np.float32),
              "ln_gamma": rng.rand(D).astype(np.float32) + 0.5,
              "ln_beta": rng.randn(D).astype(np.float32) * 0.1}
    feed = {"x": rng.randn(B, Sq, D).astype(np.float32)}
    return out, params, [(B, Sq, D)], feed, 2e-5


def _elemwise_gap(M, rng):
    S = M.sym
    c = S.Convolution(S.Variable("data"), S.Variable("w"), kernel=(1, 1),
                      num_filter=4, no_bias=True, name="c")
    s = S.broadcast_add(c, c, name="dbl")
    g = S.Pooling(s, global_pool=True, pool_type="avg", kernel=(1, 1),
                  name="gap")
    params = {"w": rng.randn(4, 3, 1, 1).astype(np.float32)}
    return g, params, [(2, 3, 5, 5)], {"data": rng.rand(2, 3, 5, 5).astype(
        np.float32)}, 1e-5


def _fc_flatten_false(M, rng):
    fc = M.sym.FullyConnected(M.sym.Variable("x"), num_hidden=3,
                              flatten=False, name="proj")
    params = {"proj_weight": rng.randn(3, 5).astype(np.float32),
              "proj_bias": rng.randn(3).astype(np.float32)}
    return fc, params, [(4, 7, 5)], {"x": rng.randn(4, 7, 5).astype(
        np.float32)}, 1e-5


def _fix_gamma_bn(M, rng):
    S = M.sym
    bn = S.BatchNorm(S.Variable("data"), S.Variable("g"), S.Variable("b"),
                     S.Variable("m"), S.Variable("v"), fix_gamma=True,
                     name="bn")
    params = {"g": rng.rand(3).astype(np.float32) + 2.0,
              "b": np.zeros(3, np.float32), "m": np.zeros(3, np.float32),
              "v": np.ones(3, np.float32)}
    return bn, params, [(2, 3, 4, 4)], {"data": rng.rand(2, 3, 4, 4).astype(
        np.float32)}, 1e-5


_GRAPHS = {
    "cnn": _small_cnn,
    "word-lm-lstm": _word_lm,
    "gru": lambda M, rng: _word_lm(M, rng, "gru"),
    "rnn-relu": lambda M, rng: _word_lm(M, rng, "rnn_relu"),
    "rnn-tanh": lambda M, rng: _word_lm(M, rng, "rnn_tanh", layers=1),
    "bi-lstm": lambda M, rng: _word_lm(M, rng, "lstm", 2, True),
    "bi-gru": lambda M, rng: _word_lm(M, rng, "gru", 1, True),
    "attention": _attention,
    "elemwise-gap": _elemwise_gap,
    "fc-flatten-false": _fc_flatten_false,
    "fix-gamma-bn": _fix_gamma_bn,
}


def _export(M, name, path):
    with M.name.NameManager():  # auto-names independent of earlier tests
        sym, params, shapes, feed, tol = _GRAPHS[name](
            M, np.random.RandomState(0))
    nd_params = {k: M.nd.array(v) for k, v in params.items()}
    M.contrib.onnx.export_model(sym, nd_params, shapes, onnx_file_path=path)
    return sym, params, feed, tol


@pytest.mark.parametrize("name", sorted(_GRAPHS))
def test_export_bytes_and_cross_import_match_reference(name, tmp_path):
    paths = {k: str(tmp_path / f"{k}.onnx") for k in PACKAGES}
    built = {k: _export(M, name, paths[k]) for k, M in PACKAGES.items()}
    blobs = {k: open(p, "rb").read() for k, p in paths.items()}
    assert blobs["port"] == blobs["reference"]
    sym, params, feed, tol = built["reference"]
    want = _eval(jmx, sym, {**feed, **params})
    for importer in PACKAGES:       # each package imports the other's file
        for writer in PACKAGES:
            M = PACKAGES[importer]
            isym, iargs, iaux = M.contrib.onnx.import_model(paths[writer])
            got = _eval(M, isym, {**feed, **iargs, **iaux})
            np.testing.assert_allclose(got, want, rtol=tol,
                                       atol=tol if tol > 1e-5 else 1e-6)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_onnx.py, tests/test_onnx_models.py)
# ---------------------------------------------------------------------------

def _forward(M, sym, params, x, aux=None):
    args = dict(params)
    args["data"] = x
    aux_names = sym.list_auxiliary_states()
    ex = sym.bind(M.cpu(), {n: args[n] for n in sym.list_arguments()},
                  aux_states={n: (aux or params)[n] for n in aux_names}
                  if aux_names else None)
    return ex.forward(is_train=False)[0].asnumpy()


def _case_roundtrip_cnn(M, tmp_path):
    rng = np.random.RandomState(0)
    sym, params, _, _, _ = _small_cnn(M, rng)
    params = {k: M.nd.array(v) for k, v in params.items()}
    path = str(tmp_path / f"model-{M.__name__}.onnx")
    assert M.contrib.onnx.export_model(sym, params, (1, 3, 8, 8),
                                       onnx_file_path=path) == path
    assert len(open(path, "rb").read()) > 2000
    sym2, arg_params, aux_params = M.contrib.onnx.import_model(path)
    x = M.nd.array(rng.rand(1, 3, 8, 8).astype(np.float32))
    ref = _forward(M, sym, params, x)
    merged = {**arg_params, **aux_params}
    got = _forward(M, sym2, merged, x, aux=merged)
    assert ref.shape == got.shape == (1, 10)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=-1), 1.0, rtol=1e-5)
    return [got]


def _case_bytes_are_valid_protobuf(M, tmp_path):
    rng = np.random.RandomState(1)
    sym, params, _, _, _ = _small_cnn(M, rng)
    path = str(tmp_path / f"m-{M.__name__}.onnx")
    M.contrib.onnx.export_model(sym, {k: M.nd.array(v) for k, v in
                                      params.items()}, (1, 3, 8, 8),
                                onnx_file_path=path)
    model = P.parse_message(open(path, "rb").read())
    assert model[1][0] == 7
    assert P.ints_of(P.parse_message(model[8][0])[2]) == [9]
    graph = P.parse_message(model[7][0])
    ops = [P.string_of(P.parse_message(n)[4][0]) for n in graph[1]]
    assert {"Conv", "Gemm", "BatchNormalization"} <= set(ops)
    names = [P.string_of(P.parse_message(r)[8][0]) for r in graph[5]]
    assert "conv1_weight" in names
    return [np.frombuffer(open(path, "rb").read(), np.uint8)]


def _case_elemwise_and_global_pool(M, tmp_path):
    rng = np.random.RandomState(2)
    g, params, _, _, _ = _elemwise_gap(M, rng)
    params = {k: M.nd.array(v) for k, v in params.items()}
    path = str(tmp_path / f"m2-{M.__name__}.onnx")
    M.contrib.onnx.export_model(g, params, (2, 3, 5, 5), onnx_file_path=path)
    sym2, arg_params, _ = M.contrib.onnx.import_model(path)
    x = M.nd.array(rng.rand(2, 3, 5, 5).astype(np.float32))
    ref = _forward(M, g, params, x)
    got = _forward(M, sym2, dict(arg_params), x)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    return [got]


def _case_unsupported_op_raises(M, tmp_path):
    bad = M.sym.gammaln(M.sym.Variable("data"), name="e")
    with pytest.raises(ValueError, match="no ONNX mapping"):
        M.contrib.onnx.export_model(bad, {}, (2, 2), onnx_file_path=str(
            tmp_path / "x.onnx"))
    return []


def _case_fix_gamma_exports_ones(M, tmp_path):
    rng = np.random.RandomState(0)
    bn, params, _, _, _ = _fix_gamma_bn(M, rng)
    params = {k: M.nd.array(v) for k, v in params.items()}
    path = str(tmp_path / f"bn-{M.__name__}.onnx")
    M.contrib.onnx.export_model(bn, params, (2, 3, 4, 4),
                                onnx_file_path=path)
    sym2, arg_params, aux_params = M.contrib.onnx.import_model(path)
    merged = {**arg_params, **aux_params}
    np.testing.assert_allclose(merged["g"].asnumpy(), np.ones(3), rtol=0)
    x = M.nd.array(rng.rand(2, 3, 4, 4).astype(np.float32))
    ref = _forward(M, bn, params, x)
    got = _forward(M, sym2, merged, x, aux=merged)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    return [got]


def _case_gemm_transb0_rejected(M, tmp_path):
    O = M.contrib.onnx
    graph = (O._node("Gemm", ["data", "w", "b"], ["out"], "g",
                     O._attr_int("transB", 0))
             + P.field_string(2, "t")
             + P.field_message(5, O._tensor("w", np.ones((4, 3),
                                                         np.float32)))
             + P.field_message(5, O._tensor("b", np.zeros(4, np.float32)))
             + P.field_message(11, O._value_info("data", (2, 3)))
             + P.field_message(12, O._value_info("out", ())))
    model = (P.field_varint(1, 7) + P.field_message(7, graph)
             + P.field_message(8, P.field_varint(2, 9)))
    path = str(tmp_path / "t.onnx")
    open(path, "wb").write(model)
    with pytest.raises(ValueError, match="transB"):
        O.import_model(path)
    return [np.frombuffer(model, np.uint8)]


def _roundtrip(M, graph, tmp_path):
    sym, params, shapes, feed, tol = graph
    path = str(tmp_path / f"rt-{M.__name__}.onnx")
    M.contrib.onnx.export_model(sym, {k: M.nd.array(v) for k, v in
                                      params.items()}, shapes,
                                onnx_file_path=path)
    isym, iargs, iaux = M.contrib.onnx.import_model(path)
    ref = _eval(M, sym, {**feed, **params})
    got = _eval(M, isym, {**feed, **iargs, **iaux})
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)
    return isym, got


def _case_word_lm_lstm_roundtrip(M, tmp_path):
    isym, got = _roundtrip(M, _word_lm(M, np.random.RandomState(0)),
                           tmp_path)
    assert [n._op for n in isym._base()._topo() if n._op].count("RNN") == 2
    return [got]


def _case_attention_block_roundtrip(M, tmp_path):
    return [_roundtrip(M, _attention(M, np.random.RandomState(1)),
                       tmp_path)[1]]


def _case_fc_flatten_false_roundtrip(M, tmp_path):
    return [_roundtrip(M, _fc_flatten_false(M, np.random.RandomState(2)),
                       tmp_path)[1]]


def _vint(n):
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += struct.pack("B", b7 | 0x80)
        else:
            return out + struct.pack("B", b7)


def _len_field(tag, payload):
    return _vint((tag << 3) | 2) + _vint(len(payload)) + payload


def _int_field(tag, v):
    return _vint(tag << 3) + _vint(v)


def _fixture_bytes():
    """Gemm(x, W, b) -> Relu, encoded field by field from the onnx.proto3
    spec by its own encoder (struct), not ``_onnx_proto``."""
    W = np.array([[1, 2], [3, 4], [0, -1]], np.float32)
    bias = np.array([0.5, -0.5, 0.0], np.float32)

    def tensor(name, arr):
        t = b"".join(_int_field(1, d) for d in arr.shape)
        return (t + _int_field(2, 1) + _len_field(8, name.encode())
                + _len_field(9, arr.tobytes()))

    attr = (_len_field(1, b"transB") + _int_field(3, 1) + _int_field(20, 2))
    gemm = (_len_field(1, b"x") + _len_field(1, b"W") + _len_field(1, b"bias")
            + _len_field(2, b"g_out") + _len_field(3, b"gemm0")
            + _len_field(4, b"Gemm") + _len_field(5, attr))
    relu = (_len_field(1, b"g_out") + _len_field(2, b"y")
            + _len_field(3, b"relu0") + _len_field(4, b"Relu"))
    dim = _len_field(1, _int_field(1, 2))
    ttype = _int_field(1, 1) + _len_field(2, _len_field(2, dim + dim))
    vinfo = _len_field(1, b"x") + _len_field(2, _len_field(1, ttype))
    out_info = _len_field(1, b"y") + _len_field(2, _len_field(1, ttype))
    graph = (_len_field(1, gemm) + _len_field(1, relu)
             + _len_field(2, b"external_fixture")
             + _len_field(5, tensor("W", W))
             + _len_field(5, tensor("bias", bias))
             + _len_field(11, vinfo) + _len_field(12, out_info))
    model = (_int_field(1, 7) + _len_field(7, graph)
             + _len_field(8, _int_field(2, 9)))
    return model, W, bias


def _case_external_fixture_import(M, tmp_path):
    raw, W, bias = _fixture_bytes()
    path = tmp_path / "external.onnx"
    path.write_bytes(raw)
    sym, args, aux = M.contrib.onnx.import_model(str(path))
    x = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    got = _eval(M, sym, {"x": x, **args, **aux})
    np.testing.assert_allclose(got, np.maximum(x @ W.T + bias, 0.0),
                               rtol=1e-6, atol=1e-6)
    return [got]


def _case_import_dangling_reference_raises(M, tmp_path):
    raw, _, _ = _fixture_bytes()
    bad = raw.replace(b"\x0a\x05g_out", b"\x0a\x05ghost", 1)
    assert bad != raw
    path = tmp_path / "bad.onnx"
    path.write_bytes(bad)
    with pytest.raises(ValueError, match="undeclared|unsupported"):
        M.contrib.onnx.import_model(str(path))
    return []


def _graph_file(M, nodes, inits, x_shape, tmp_path, name):
    graph = (nodes + P.field_string(2, "g")
             + b"".join(P.field_message(5, M.contrib.onnx._tensor(k, v))
                        for k, v in inits)
             + P.field_message(11, M.contrib.onnx._value_info("x", x_shape))
             + P.field_message(12, M.contrib.onnx._value_info("y", ())))
    model = (P.field_varint(1, 7) + P.field_message(7, graph)
             + P.field_message(8, P.field_varint(2, 9)))
    path = tmp_path / name
    path.write_bytes(model)
    return str(path)


def _case_lstm_default_state_import(M, tmp_path):
    O = M.contrib.onnx
    rng = np.random.RandomState(3)
    T, N, E, H = 3, 4, 5, 2
    inits = [("W", rng.randn(1, 4 * H, E).astype(np.float32) * 0.3),
             ("R", rng.randn(1, 4 * H, H).astype(np.float32) * 0.3),
             ("B", rng.randn(1, 8 * H).astype(np.float32) * 0.1)]
    nodes = (O._node("LSTM", ["x", "W", "R", "B"], ["y4"], "l0",
                     O._attr_int("hidden_size", H))
             + O._node("Squeeze", ["y4"], ["y"], "sq", b""))
    path = _graph_file(M, nodes, inits, (T, N, E), tmp_path, "l.onnx")
    sym, args, aux = O.import_model(path)
    got = _eval(M, sym, {"x": rng.randn(T, N, E).astype(np.float32),
                         **args, **aux})
    assert got.shape == (T, N, H)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    return [got]


def _case_gru_import_rejects_default_recurrence(M, tmp_path):
    O = M.contrib.onnx
    rng = np.random.RandomState(5)
    H, E, T, N = 2, 3, 2, 1
    inits = [("W", rng.randn(1, 3 * H, E).astype(np.float32)),
             ("R", rng.randn(1, 3 * H, H).astype(np.float32))]
    nodes = (O._node("GRU", ["x", "W", "R"], ["y4"], "g0",
                     O._attr_int("hidden_size", H))
             + O._node("Squeeze", ["y4"], ["y"], "sq", b""))
    path = _graph_file(M, nodes, inits, (T, N, E), tmp_path, "g.onnx")
    with pytest.raises(ValueError, match="linear_before_reset"):
        O.import_model(path)
    return []


def _sigmoid(v):
    return 1.0 / (1.0 + np.exp(-v))


def _gru_dir(Wd, Rd, Bd, xs, H, N):
    """The ONNX spec's GRU (linear_before_reset=1, gates [z, r, h])."""
    Wz, Wr, Wh = Wd[:H], Wd[H:2 * H], Wd[2 * H:]
    Rz, Rr, Rh = Rd[:H], Rd[H:2 * H], Rd[2 * H:]
    Wbz, Wbr, Wbh = Bd[:H], Bd[H:2 * H], Bd[2 * H:3 * H]
    Rbz, Rbr, Rbh = Bd[3 * H:4 * H], Bd[4 * H:5 * H], Bd[5 * H:]
    h = np.zeros((N, H), np.float32)
    ys = []
    for xt in xs:
        z = _sigmoid(xt @ Wz.T + h @ Rz.T + Wbz + Rbz)
        r = _sigmoid(xt @ Wr.T + h @ Rr.T + Wbr + Rbr)
        hh = np.tanh(xt @ Wh.T + r * (h @ Rh.T + Rbh) + Wbh)
        h = (1 - z) * hh + z * h
        ys.append(h.copy())
    return np.stack(ys)


def _case_gru_gate_order_vs_spec_reference(M, tmp_path):
    O = M.contrib.onnx
    rng = np.random.RandomState(6)
    H, E, T, N = 2, 3, 3, 2
    W = rng.randn(1, 3 * H, E).astype(np.float32) * 0.4
    R = rng.randn(1, 3 * H, H).astype(np.float32) * 0.4
    B = rng.randn(1, 6 * H).astype(np.float32) * 0.2
    x = rng.randn(T, N, E).astype(np.float32)
    nodes = (O._node("GRU", ["x", "W", "R", "B"], ["y4"], "g0",
                     O._attr_int("hidden_size", H)
                     + O._attr_int("linear_before_reset", 1))
             + O._node("Squeeze", ["y4"], ["y"], "sq", b""))
    path = _graph_file(M, nodes, [("W", W), ("R", R), ("B", B)], (T, N, E),
                       tmp_path, "gspec.onnx")
    sym, args, aux = O.import_model(path)
    got = _eval(M, sym, {"x": x, **args, **aux})
    np.testing.assert_allclose(got, _gru_dir(W[0], R[0], B[0], list(x), H,
                                             N), rtol=1e-5, atol=1e-5)
    return [got]


def _case_bidirectional_gru_vs_spec_reference(M, tmp_path):
    O = M.contrib.onnx
    rng = np.random.RandomState(11)
    H, E, T, N = 2, 3, 4, 2
    W = rng.randn(2, 3 * H, E).astype(np.float32) * 0.4
    R = rng.randn(2, 3 * H, H).astype(np.float32) * 0.4
    B = rng.randn(2, 6 * H).astype(np.float32) * 0.2
    x = rng.randn(T, N, E).astype(np.float32)
    fwd = _gru_dir(W[0], R[0], B[0], list(x), H, N)
    bwd = _gru_dir(W[1], R[1], B[1], list(x[::-1]), H, N)[::-1]
    want = np.stack([fwd, bwd], axis=1).transpose(0, 2, 1, 3) \
        .reshape(T, N, 2 * H)
    nodes = (O._node("GRU", ["x", "W", "R", "B"], ["y4"], "g0",
                     O._attr_int("hidden_size", H)
                     + O._attr_int("linear_before_reset", 1)
                     + O._attr_str("direction", "bidirectional"))
             + O._node("Transpose", ["y4"], ["yt"], "tr",
                       O._attr_ints("perm", (0, 2, 1, 3)))
             + O._node("Reshape", ["yt", "rshape"], ["y"], "rs", b""))
    path = _graph_file(M, nodes, [("W", W), ("R", R), ("B", B),
                                  ("rshape", np.asarray([0, 0, 2 * H],
                                                        np.int64))],
                       (T, N, E), tmp_path, "bigru.onnx")
    sym, args, aux = O.import_model(path)
    got = _eval(M, sym, {"x": x, **args, **aux})
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    return [got]


def _case_gluon_block_onnx_export(M, tmp_path):
    _reset()
    rng = np.random.RandomState(8)
    net = M.gluon.nn.HybridSequential()
    net.add(M.gluon.nn.Dense(16, activation="relu", in_units=8))
    net.add(M.gluon.nn.Dense(4, in_units=16))
    _init_from_seed(M, net, 8)
    x = M.nd.array(rng.rand(5, 8).astype(np.float32))
    ref = net(x).asnumpy()
    prefix = str(tmp_path / f"mlp-{M.__name__}")
    net.export(prefix, epoch=3, format="onnx", example_inputs=x)
    isym, iargs, iaux = M.contrib.onnx.import_model(prefix + "-0003.onnx")
    got = _eval(M, isym, {"data": x.asnumpy(), **iargs, **iaux})
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    return [got]


def _case_gluon_conv_block_onnx_export(M, tmp_path):
    _reset()
    rng = np.random.RandomState(9)
    nn = M.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, kernel_size=3, padding=1, in_channels=3,
                      activation="relu"))
    net.add(nn.MaxPool2D(pool_size=2, strides=2))
    net.add(nn.Dense(6))
    x = M.nd.array(rng.rand(2, 3, 8, 8).astype(np.float32))
    net.initialize()
    net(x)
    _init_from_seed(M, net, 9)
    ref = net(x).asnumpy()
    prefix = str(tmp_path / f"cnn-{M.__name__}")
    net.export(prefix, format="onnx", example_inputs=x)
    isym, iargs, iaux = M.contrib.onnx.import_model(prefix + "-0000.onnx")
    got = _eval(M, isym, {"data": x.asnumpy(), **iargs, **iaux})
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    return [got]


def _reset():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}


def _init_from_seed(M, net, seed):
    """The same weights in both packages: initialized, then overwritten
    from a numpy seed in name order."""
    if not all(p._data is not None for p in net.collect_params().values()):
        net.initialize()
    rng = np.random.RandomState(seed)
    for p in net.collect_params().values():
        p.set_data(M.nd.array(rng.randn(*p.shape).astype(np.float32) * 0.3))


def _bidirectional_case(mode, layers):
    def case(M, tmp_path):
        graph = _word_lm(M, np.random.RandomState(7), mode, layers, True)
        return [_roundtrip(M, graph, tmp_path)[1]]
    return case


def _gru_vanilla_case(mode):
    def case(M, tmp_path):
        isym, got = _roundtrip(M, _word_lm(M, np.random.RandomState(4), mode),
                               tmp_path)
        assert [n._op for n in isym._base()._topo()].count("RNN") == 2
        return [got]
    return case


_CASES = {
    "roundtrip_cnn": _case_roundtrip_cnn,
    "bytes_are_valid_protobuf": _case_bytes_are_valid_protobuf,
    "elemwise_and_global_pool": _case_elemwise_and_global_pool,
    "unsupported_op_raises": _case_unsupported_op_raises,
    "fix_gamma_exports_ones": _case_fix_gamma_exports_ones,
    "gemm_transb0_rejected": _case_gemm_transb0_rejected,
    "word_lm_lstm_roundtrip": _case_word_lm_lstm_roundtrip,
    "attention_block_roundtrip": _case_attention_block_roundtrip,
    "fc_flatten_false_roundtrip": _case_fc_flatten_false_roundtrip,
    "external_fixture_import": _case_external_fixture_import,
    "import_dangling_reference_raises":
        _case_import_dangling_reference_raises,
    "lstm_default_state_import": _case_lstm_default_state_import,
    "gru_vanilla_roundtrip[gru]": _gru_vanilla_case("gru"),
    "gru_vanilla_roundtrip[rnn_relu]": _gru_vanilla_case("rnn_relu"),
    "gru_vanilla_roundtrip[rnn_tanh]": _gru_vanilla_case("rnn_tanh"),
    "gru_import_rejects_default_recurrence":
        _case_gru_import_rejects_default_recurrence,
    "gru_gate_order_vs_spec_reference":
        _case_gru_gate_order_vs_spec_reference,
    "bidirectional_rnn_roundtrip[lstm-1]": _bidirectional_case("lstm", 1),
    "bidirectional_rnn_roundtrip[lstm-2]": _bidirectional_case("lstm", 2),
    "bidirectional_rnn_roundtrip[gru-1]": _bidirectional_case("gru", 1),
    "gluon_block_onnx_export": _case_gluon_block_onnx_export,
    "gluon_conv_block_onnx_export": _case_gluon_conv_block_onnx_export,
    "bidirectional_gru_vs_spec_reference":
        _case_bidirectional_gru_vs_spec_reference,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_reference_onnx_case(case, tmp_path):
    want = _CASES[case](jmx, tmp_path)
    got = _CASES[case](tmx, tmp_path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == np.uint8:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


def test_gluon_resnet_export_holds_by_value(tmp_path):
    """A traced ResNet-18 v1 (BatchNorm statistics as auxiliary states in
    the port) exported by each package; each file imports into both and
    gives the reference net's logits."""
    from mxnet_tpu.gluon.model_zoo import get_model as jget_model
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    rng = np.random.RandomState(10)
    x = rng.rand(2, 3, 32, 32).astype(np.float32)
    _reset()
    jmx.random.seed(0)
    jnet = jget_model("resnet18_v1", classes=10)
    jnet.initialize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    jnet.save_parameters(str(tmp_path / "r.params"))
    tnet = get_model("resnet18_v1", classes=10)
    tnet.load_parameters(str(tmp_path / "r.params"), ctx=tmx.cpu())
    paths = {}
    for k, (M, net) in {"reference": (jmx, jnet), "port": (tmx, tnet)} \
            .items():
        net.export(str(tmp_path / k), format="onnx",
                   example_inputs=M.nd.array(x))
        paths[k] = str(tmp_path / f"{k}-0000.onnx")
    for writer, path in paths.items():
        for M in PACKAGES.values():
            isym, iargs, iaux = M.contrib.onnx.import_model(path)
            got = _eval(M, isym, {"data": x, **iargs, **iaux})
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_export_validates_before_writing(tmp_path):
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    with pytest.raises(ValueError, match="example_inputs"):
        net.export(str(tmp_path / "d"), format="onnx")
    deferred = tmx.gluon.nn.Dense(2)
    deferred.initialize()
    with pytest.raises(ValueError, match="deferred"):
        deferred.export(str(tmp_path / "d"), format="onnx",
                        example_inputs=tmx.nd.ones((1, 3)))
    assert not list(tmp_path.iterdir())
    with pytest.raises(tmx.MXNetError, match="stablehlo"):
        net.export(str(tmp_path / "d"), format="stablehlo")


def test_proto_reader_accepts_packed_ints():
    packed = P.field_bytes(8, b"".join(P._varint(v) for v in (1, 300, 7)))
    assert P.ints_of(P.parse_message(packed)[8]) == [1, 300, 7]
    neg = P.field_varint(3, -2)
    assert P.ints_of(P.parse_message(neg)[3]) == [-2]
    assert tonnx._tuple("(3, 3)") == (3, 3)
