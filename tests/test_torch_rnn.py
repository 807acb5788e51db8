"""The port's recurrent stack (``ops/rnn.py``, ``gluon.rnn``, ``mx.rnn``,
``BucketSentenceIter``) against the JAX package, on the CPU.

The fused ``RNN`` op runs its per-step loop here (the CPU route); on a
card it runs cuDNN through ``torch._VF``, and that route is held to the
loop here too, on the CPU, with the same weights. Both packages get the
same numpy inputs and weights (Gluon weights carried through ``.params``
files); f32 values are held at rtol 1e-5 / atol 1e-5 and gradients at
rtol 1e-4 / atol 1e-5 (recurrences of up to 6 steps).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops.registry import get_op as jget
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.ops.registry import get_op as tget

torch.set_num_threads(1)

COVERED = {"RNN"}  # the ops this file holds to the reference

RTOL, ATOL = 1e-5, 1e-5
GRTOL, GATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with tmx.cpu():
        yield


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the RNN op
# ---------------------------------------------------------------------------

_MODES = ["lstm", "gru", "rnn_tanh", "rnn_relu"]


def _op_case(mode, layers, bidir, seed=0, T=5, N=3, C=4, H=6):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidir else 1
    size = trnn.rnn_param_size(mode, C, H, layers, bidir)
    arrays = [rng.randn(T, N, C).astype(np.float32),
              (rng.randn(size) * 0.4).astype(np.float32),
              (rng.randn(layers * dirs, N, H) * 0.5).astype(np.float32)]
    if mode == "lstm":
        arrays.append((rng.randn(layers * dirs, N, H) * 0.5)
                      .astype(np.float32))
    kw = dict(state_size=H, num_layers=layers, mode=mode,
              bidirectional=bidir, state_outputs=True)
    heads = [rng.randn(T, N, H * dirs).astype(np.float32),
             rng.randn(layers * dirs, N, H).astype(np.float32),
             rng.randn(layers * dirs, N, H).astype(np.float32)]
    return arrays, kw, heads


def _ref_op(arrays, kw, heads):
    """Outputs and the gradient of sum(out_i * head_i) w.r.t. every input,
    by the reference's op and jax.grad."""
    def f(*a):
        outs = jget("RNN").fn(*a, **kw)
        return sum(jnp.sum(o * h) for o, h in zip(outs, heads)), outs

    (_, outs), grads = jax.value_and_grad(f, argnums=tuple(
        range(len(arrays))), has_aux=True)(*map(jnp.asarray, arrays))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_run(fn, arrays, heads):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = fn(*ts)
    sum((o * torch.tensor(h)).sum() for o, h in zip(outs, heads)).backward()
    return [o.detach().numpy() for o in outs], [t.grad.numpy() for t in ts]


def _port_op(arrays, kw, heads):
    return _port_run(lambda *t: tget("RNN").fn(*t, **kw), arrays, heads)


@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bidir"])
def test_rnn_op_matches_reference_values_and_grads(mode, layers, bidir):
    arrays, kw, heads = _op_case(mode, layers, bidir)
    want, want_g = _ref_op(arrays, kw, heads)
    got, got_g = _port_op(arrays, kw, heads)
    assert len(got) == len(want) == (3 if mode == "lstm" else 2)
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(got_g, want_g):
        _close(g, w, GRTOL, GATOL)


@pytest.mark.parametrize("case", ["no-state-outputs", "clip",
                                  "sequence-length"])
def test_rnn_op_options_match_reference(case):
    arrays, kw, heads = _op_case("lstm", 2, False, seed=1)
    if case == "no-state-outputs":
        kw["state_outputs"] = False
        want = np.asarray(jget("RNN").fn(*map(jnp.asarray, arrays), **kw))
        got = tget("RNN").fn(*map(torch.tensor, arrays), **kw).numpy()
        _close(got, want)
        return
    if case == "clip":
        kw.update(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.3)
    else:
        kw.update(use_sequence_length=True,
                  sequence_length=np.array([5.0, 2.0, 3.0], np.float32))
    seq = kw.pop("sequence_length", None)
    jkw = dict(kw, **({} if seq is None else
                      {"sequence_length": jnp.asarray(seq)}))
    tkw = dict(kw, **({} if seq is None else
                      {"sequence_length": torch.tensor(seq)}))
    want = [np.asarray(o) for o in jget("RNN").fn(*map(jnp.asarray, arrays),
                                                  **jkw)]
    got = [o.numpy() for o in tget("RNN").fn(*map(torch.tensor, arrays),
                                             **tkw)]
    for g, w in zip(got, want):
        _close(g, w)


def _cudnn_route(kw):
    """The op's library route (what it runs on a CUDA tensor), called on
    CPU tensors: torch._VF runs its own CPU kernels here."""
    def fn(data, params, state, cell=None):
        layers = trnn.rnn_unpack_params(params, kw["mode"], data.shape[2],
                                        kw["state_size"], kw["num_layers"],
                                        kw["bidirectional"])
        out, h, c = trnn.rnn_cudnn(data, layers, state, cell, kw["mode"],
                                   kw.get("p", 0.0), kw.get("_train", False))
        return [out, h] + ([c] if c is not None else [])
    return fn


def _loop_route(kw):
    def fn(data, params, state, cell=None):
        layers = trnn.rnn_unpack_params(params, kw["mode"], data.shape[2],
                                        kw["state_size"], kw["num_layers"],
                                        kw["bidirectional"])
        out, hs, cs = trnn.rnn_loop(data, layers, state, cell, kw["mode"],
                                    kw.get("p", 0.0), kw.get("_train", False))
        return [out, torch.stack(hs)] + ([torch.stack(cs)] if cs else [])
    return fn


@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bidir"])
def test_library_route_matches_the_per_step_loop(mode, layers, bidir):
    arrays, kw, heads = _op_case(mode, layers, bidir, seed=2)
    want, want_g = _port_run(_loop_route(kw), arrays, heads)
    got, got_g = _port_run(_cudnn_route(kw), arrays, heads)
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(got_g, want_g):
        _close(g, w, GRTOL, GATOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_library_route_dropout_draws_the_loops_masks(mode):
    """With p > 0 in training both routes draw one mask per inner layer
    from the framework's generator in the same order: the same seed gives
    the same result."""
    arrays, kw, heads = _op_case(mode, 3, True, seed=3)
    kw.update(p=0.5, _train=True)
    tmx.random.seed(5)
    want, want_g = _port_run(_loop_route(kw), arrays, heads)
    tmx.random.seed(5)
    got, got_g = _port_run(_cudnn_route(kw), arrays, heads)
    for g, w in zip(got + got_g, want + want_g):
        _close(g, w, GRTOL, GATOL)


def test_route_is_chosen_by_device_and_cuda_never_loops(monkeypatch):
    assert trnn.rnn_route(torch.device("cuda", 0)) == "cudnn"
    assert trnn.rnn_route("cuda") == "cudnn"
    assert trnn.rnn_route("cpu") == "loop"
    assert trnn.rnn_route("meta") == "loop"
    arrays, kw, heads = _op_case("lstm", 2, False, seed=4)
    want = [o.numpy() for o in tget("RNN").fn(*map(torch.tensor, arrays),
                                              **kw)]
    # take the CUDA branch on CPU tensors: it runs the library route ...
    monkeypatch.setattr(trnn, "rnn_route", lambda dev: "cudnn")
    monkeypatch.setattr(trnn, "rnn_loop", None)  # never the loop
    monkeypatch.setattr(torch.backends.cudnn, "is_available", lambda: True)
    before = trnn.rnn_calls["cudnn"]
    got = [o.numpy() for o in tget("RNN").fn(*map(torch.tensor, arrays),
                                             **kw)]
    assert trnn.rnn_calls["cudnn"] == before + 1
    for g, w in zip(got, want):
        _close(g, w)
    # ... or raises when cuDNN is off
    monkeypatch.setattr(torch.backends.cudnn, "enabled", False)
    with pytest.raises(MXNetError, match="cuDNN"):
        tget("RNN").fn(*map(torch.tensor, arrays), **kw)


def test_param_size_and_unpack_match_reference():
    for mode in _MODES:
        for layers, bidir in ((1, False), (3, True)):
            size = trnn.rnn_param_size(mode, 7, 5, layers, bidir)
            from mxnet_tpu.ops.rnn import rnn_param_size, rnn_unpack_params

            assert size == rnn_param_size(mode, 7, 5, layers, bidir)
            flat = np.arange(size, dtype=np.float32)
            want = rnn_unpack_params(jnp.asarray(flat), mode, 7, 5, layers,
                                     bidir)
            got = trnn.rnn_unpack_params(torch.tensor(flat), mode, 7, 5,
                                         layers, bidir)
            for wl, gl in zip(want, got):
                for wd, gd in zip(wl, gl):
                    for w, g in zip(wd, gd):
                        np.testing.assert_array_equal(g.numpy(),
                                                      np.asarray(w))


def test_rnn_op_through_nd_and_autograd():
    arrays, kw, _ = _op_case("gru", 2, True, seed=6)
    xs = [tnd.array(a) for a in arrays]
    for x in xs:
        x.attach_grad()
    with tag.record():
        out, h = tnd.RNN(*xs, **kw)
        loss = (out * out).sum() + h.sum()
    loss.backward()
    jxs = [jnd.array(a) for a in arrays]
    for x in jxs:
        x.attach_grad()
    with jag.record():
        jout, jh = jnd.RNN(*jxs, **kw)
        jloss = (jout * jout).sum() + jh.sum()
    jloss.backward()
    _close(out.asnumpy(), jout.asnumpy())
    for x, jx in zip(xs, jxs):
        _close(x.grad.asnumpy(), jx.grad.asnumpy(), GRTOL, GATOL)


def test_rnn_shape_rule_matches_reference():
    from mxnet_tpu import sym as jsym
    from mxnet_tpu_torch import sym as tsym

    for mode, bidir in (("lstm", True), ("gru", False)):
        shapes = []
        for S in (jsym, tsym):
            data = S.Variable("data")
            kw = dict(state_size=8, num_layers=2, mode=mode,
                      bidirectional=bidir, state_outputs=True, name="rnn")
            out = S.RNN(data, S.Variable("rnn_parameters"),
                        S.Variable("rnn_state"),
                        *([S.Variable("rnn_state_cell")]
                          if mode == "lstm" else []), **kw)
            arg, outs, _ = out.infer_shape(data=(7, 3, 5))
            shapes.append((arg, outs))
        assert shapes[0] == shapes[1], shapes


# ---------------------------------------------------------------------------
# gluon.rnn layers, weights carried through .params files
# ---------------------------------------------------------------------------

def _layer_pair(kind, **kw):
    from mxnet_tpu.gluon import rnn as jr
    from mxnet_tpu_torch.gluon import rnn as tr

    ref = getattr(jr, kind)(**kw)
    port = getattr(tr, kind)(**kw)
    ref.initialize()
    port.initialize(ctx=tmx.cpu())
    return ref, port


_LAYERS = {
    "LSTM-2-bidir-TNC": ("LSTM", dict(hidden_size=6, num_layers=2,
                                      bidirectional=True, input_size=4)),
    "LSTM-2-NTC": ("LSTM", dict(hidden_size=6, num_layers=2, layout="NTC",
                                input_size=4)),
    "GRU-2-bidir-NTC": ("GRU", dict(hidden_size=5, num_layers=2,
                                    layout="NTC", bidirectional=True,
                                    input_size=4)),
    "RNN-relu-1": ("RNN", dict(hidden_size=5, input_size=4)),
    "RNN-tanh-2-bidir": ("RNN", dict(hidden_size=5, num_layers=2,
                                     activation="tanh", bidirectional=True,
                                     input_size=4)),
}


@pytest.mark.parametrize("case", sorted(_LAYERS))
@pytest.mark.parametrize("states", [False, True],
                         ids=["zero-states", "explicit-states"])
def test_gluon_layer_matches_reference_through_params_files(case, states,
                                                           tmp_path):
    kind, kw = _LAYERS[case]
    ref, port = _layer_pair(kind, **kw)
    assert list(ref.collect_params()) == list(port.collect_params())
    ref.save_parameters(str(tmp_path / "ref.params"))
    port.load_parameters(str(tmp_path / "ref.params"), ctx=tmx.cpu())
    rng = np.random.RandomState(7)
    T, N = 5, 3
    shape = (T, N, 4) if kw.get("layout", "TNC") == "TNC" else (N, T, 4)
    x = rng.randn(*shape).astype(np.float32)
    info = port.state_info(N)
    st = [(rng.randn(*i["shape"]) * 0.5).astype(np.float32) for i in info]
    res = []
    for mod_nd, ag, net in ((jnd, jag, ref), (tnd, tag, port)):
        xa = mod_nd.array(x)
        xa.attach_grad()
        args = [xa] + ([[mod_nd.array(s) for s in st]] if states else [])
        with ag.record():
            out = net(*args)
            outs = [out[0]] + list(out[1]) if states else [out]
            loss = sum((o * o).sum() for o in outs[1:]) + \
                (outs[0] * outs[0]).sum()
        loss.backward()
        res.append(([o.asnumpy() for o in outs], xa.grad.asnumpy(),
                    {k: p.grad().asnumpy()
                     for k, p in net.collect_params().items()}))
    (w_out, w_xg, w_pg), (g_out, g_xg, g_pg) = res
    for g, w in zip(g_out, w_out):
        _close(g, w)
    _close(g_xg, w_xg, GRTOL, GATOL)
    for k in w_pg:
        _close(g_pg[k], w_pg[k], GRTOL, GATOL)
    # and the port's file loads into the reference
    port.save_parameters(str(tmp_path / "port.params"))
    from mxnet_tpu.gluon import rnn as jr

    jblock._SCOPE.counters = {}
    ref2 = getattr(jr, kind)(**kw)
    ref2.load_parameters(str(tmp_path / "port.params"))
    for k, p in ref2.collect_params().items():
        np.testing.assert_array_equal(
            p.data().asnumpy(), port.collect_params()[k].data().asnumpy())


def test_gluon_layer_hybridized_equals_eager_and_deferred_input_size():
    from mxnet_tpu_torch.gluon import rnn as tr

    net = tr.LSTM(6, num_layers=2, layout="NTC")  # input size deferred
    net.initialize(ctx=tmx.cpu())
    x = tnd.array(np.random.RandomState(8).randn(3, 5, 4)
                  .astype(np.float32))
    eager = net(x).asnumpy()
    assert net.l0_i2h_weight.shape == (24, 4)
    net.hybridize()
    _close(net(x).asnumpy(), eager)
    st = net.begin_state(3, ctx=tmx.cpu())
    out, new = net(x, st)
    _close(out.asnumpy(), eager)
    assert [s.shape for s in new] == [(2, 3, 6), (2, 3, 6)]


# ---------------------------------------------------------------------------
# gluon.rnn cells
# ---------------------------------------------------------------------------

def _cell(m, case):
    r = m.gluon.rnn
    if case == "rnn":
        return r.RNNCell(5, input_size=4)
    if case == "lstm":
        return r.LSTMCell(5, input_size=4)
    if case == "gru":
        return r.GRUCell(5, input_size=4)
    if case == "sequential":
        seq = r.SequentialRNNCell()
        seq.add(r.LSTMCell(5, input_size=4))
        seq.add(r.DropoutCell(0.0))
        seq.add(r.ResidualCell(r.GRUCell(5, input_size=5)))
        return seq
    if case == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(3, input_size=4),
                                   r.GRUCell(3, input_size=4))
    if case == "zoneout-eval":
        return r.ZoneoutCell(r.LSTMCell(5, input_size=4), 0.3, 0.3)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["rnn", "lstm", "gru", "sequential",
                                  "bidirectional", "zoneout-eval"])
@pytest.mark.parametrize("layout,merge", [("NTC", True), ("TNC", False),
                                          ("NTC", False)])
def test_gluon_cells_unroll_matches_reference(case, layout, merge):
    rng = np.random.RandomState(9)
    T, N = 4, 2
    x = rng.randn(*((N, T, 4) if layout == "NTC" else (T, N, 4))) \
        .astype(np.float32)
    res = []
    for m, mod_nd in ((jmx, jnd), (tmx, tnd)):
        jblock._SCOPE.counters = {}
        tblock._SCOPE.counters = {}
        cell = _cell(m, case)
        cell.initialize(**({} if m is jmx else {"ctx": tmx.cpu()}))
        if m is jmx:
            wants = {k: p.data().asnumpy()
                     for k, p in cell.collect_params().items()}
        else:
            for k, p in cell.collect_params().items():
                p.set_data(wants[k])
        outs, states = cell.unroll(T, mod_nd.array(x), layout=layout,
                                   merge_outputs=merge)
        outs = [outs] if merge else list(outs)
        res.append([o.asnumpy() for o in outs + list(states)])
    assert len(res[0]) == len(res[1])
    for g, w in zip(res[1], res[0]):
        _close(g, w)


@pytest.mark.parametrize("case", ["lstm", "gru", "sequential",
                                  "bidirectional"])
def test_gluon_cells_unroll_valid_length(case):
    """``valid_length`` masks each sequence's steps past its length (and
    the backward cell of a BidirectionalCell reads each sequence's valid
    prefix reversed): the same as unrolling each sequence alone at its
    length. (The reference's unroll passes the lengths to SequenceMask as
    a keyword NDArray, which its dispatch does not unwrap, and raises.)"""
    rng = np.random.RandomState(16)
    T, N = 4, 3
    x = rng.randn(N, T, 4).astype(np.float32)
    valid = [4, 2, 3]
    cell = _cell(tmx, case)
    cell.initialize(ctx=tmx.cpu())
    outs, _ = cell.unroll(T, tnd.array(x), layout="NTC", merge_outputs=True,
                          valid_length=tnd.array(np.array(valid,
                                                          np.float32)))
    got = outs.asnumpy()
    for n, length in enumerate(valid):
        alone, _ = cell.unroll(length, tnd.array(x[n:n + 1, :length]),
                               layout="NTC", merge_outputs=True)
        _close(got[n, :length], alone.asnumpy()[0])
        assert (got[n, length:] == 0).all()


def test_gluon_cell_steps_and_hybridizes():
    from mxnet_tpu_torch.gluon import rnn as tr

    cell = tr.LSTMCell(5, input_size=4)
    cell.initialize(ctx=tmx.cpu())
    x = tnd.array(np.random.RandomState(10).randn(2, 4).astype(np.float32))
    st = cell.begin_state(2, ctx=tmx.cpu())
    out, new = cell(x, st)
    cell.hybridize()
    out2, new2 = cell(x, st)
    _close(out2.asnumpy(), out.asnumpy())
    for a, b in zip(new2, new):
        _close(a.asnumpy(), b.asnumpy())
    with pytest.raises(NotImplementedError):
        tr.BidirectionalCell(tr.RNNCell(2), tr.RNNCell(2))(x, st)


# ---------------------------------------------------------------------------
# mx.rnn symbolic cells and FusedRNNCell
# ---------------------------------------------------------------------------

def _sym_cells(m, case):
    r = m.rnn
    if case == "lstm":
        return r.LSTMCell(5, prefix="l0_")
    if case == "gru":
        return r.GRUCell(5, prefix="g0_")
    if case == "rnn":
        return r.RNNCell(5, activation="relu", prefix="r0_")
    if case == "stack":
        seq = r.SequentialRNNCell()
        seq.add(r.LSTMCell(5, prefix="l0_"))
        seq.add(r.DropoutCell(0.0))
        seq.add(r.ResidualCell(r.GRUCell(5, prefix="g1_")))
        return seq
    if case == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(3, prefix="fw_"),
                                   r.GRUCell(3, prefix="bw_"))
    if case == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(5, prefix="z_"), 0.25, 0.5)
    if case == "fused-bidir":
        return r.FusedRNNCell(5, num_layers=2, mode="gru",
                              bidirectional=True, prefix="f_")
    raise ValueError(case)


@pytest.mark.parametrize("case", ["lstm", "gru", "rnn", "stack",
                                  "bidirectional", "zoneout", "fused-bidir"])
def test_symbolic_cells_match_reference(case):
    rng = np.random.RandomState(11)
    T, N, C = 4, 2, 5
    x = rng.randn(N, T, C).astype(np.float32)
    feeds, res = None, []
    for m, mod_nd in ((jmx, jnd), (tmx, tnd)):
        cell = _sym_cells(m, case)
        data = m.sym.Variable("data")
        outs, states = cell.unroll(T, data, merge_outputs=True)
        group = m.sym.Group([outs] + list(states))
        if feeds is None:
            arg_shapes, _, _ = group.infer_shape(data=x.shape)
            feeds = {n: (rng.randn(*s) * 0.3).astype(np.float32)
                     for n, s in zip(group.list_arguments(), arg_shapes)
                     if n != "data"}
        kw = {} if m is jmx else {"ctx": tmx.cpu()}
        got = group.eval(data=mod_nd.array(x),
                         **{k: mod_nd.array(v) for k, v in feeds.items()},
                         **kw)
        res.append([g.asnumpy() for g in got])
    for g, w in zip(res[1], res[0]):
        _close(g, w)


def test_fused_cell_pack_unpack_and_unfused_equivalence():
    from mxnet_tpu.rnn import FusedRNNCell as JFused
    from mxnet_tpu_torch.rnn import FusedRNNCell, LSTMCell, \
        SequentialRNNCell

    rng = np.random.RandomState(12)
    T, N, C, H = 4, 2, 3, 5
    args = {}
    for li in range(2):
        isz = C if li == 0 else H
        args[f"lstm_l{li}_i2h_weight"] = rng.randn(4 * H, isz).astype(
            np.float32) * 0.3
        args[f"lstm_l{li}_h2h_weight"] = rng.randn(4 * H, H).astype(
            np.float32) * 0.3
        args[f"lstm_l{li}_i2h_bias"] = rng.randn(4 * H).astype(
            np.float32) * 0.1
        args[f"lstm_l{li}_h2h_bias"] = rng.randn(4 * H).astype(
            np.float32) * 0.1
    fused = FusedRNNCell(H, num_layers=2, mode="lstm", prefix="lstm_")
    packed = fused.pack_weights(args)
    want = JFused(H, num_layers=2, mode="lstm",
                  prefix="lstm_").pack_weights(args)
    np.testing.assert_array_equal(packed["lstm_parameters"],
                                  want["lstm_parameters"])
    back = fused.unpack_weights({"lstm_parameters":
                                 packed["lstm_parameters"]}, C)
    for k, v in args.items():
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(NotImplementedError):
        FusedRNNCell(H, bidirectional=True).pack_weights(args)

    x = rng.randn(N, T, C).astype(np.float32)
    data = tmx.sym.Variable("data")
    f_out, _ = fused.unroll(T, data, merge_outputs=True)
    seq = SequentialRNNCell()
    for li in range(2):
        seq.add(LSTMCell(H, prefix=f"lstm_l{li}_"))
    s_out, _ = seq.unroll(T, data, merge_outputs=True)
    got = f_out.eval(ctx=tmx.cpu(), data=tnd.array(x),
                     lstm_parameters=tnd.array(packed["lstm_parameters"]))
    ref = s_out.eval(ctx=tmx.cpu(), data=tnd.array(x),
                     **{k: tnd.array(v) for k, v in args.items()})
    _close(got[0].asnumpy(), ref[0].asnumpy())


# ---------------------------------------------------------------------------
# BucketSentenceIter and a tiny BucketingModule LM
# ---------------------------------------------------------------------------

def _sentences(n=150, vocab=20, seed=13):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, vocab, rng.randint(2, 11)))
            for _ in range(n)]


@pytest.mark.parametrize("buckets", [[4, 8, 12], None],
                         ids=["explicit", "inferred"])
def test_bucket_sentence_iter_yields_the_reference_batches(buckets):
    from mxnet_tpu.rnn import BucketSentenceIter as JIter
    from mxnet_tpu_torch.rnn import BucketSentenceIter

    sents = _sentences()
    out = []
    for Iter in (JIter, BucketSentenceIter):
        np.random.seed(3)
        it = Iter(sents, batch_size=4, buckets=buckets, invalid_label=0)
        batches = []
        for _epoch in range(2):
            it.reset()
            # copies now: the reference's arrays can alias the buckets'
            # numpy rows, which the next reset shuffles in place
            batches += [(b.bucket_key, b.data[0].asnumpy().copy(),
                         b.label[0].asnumpy().copy(),
                         b.provide_data[0].shape) for b in it]
        out.append((it.buckets, it.default_bucket_key,
                    it.provide_data[0].shape, batches))
    (jb, jd, jp, jbatch), (tb, td, tp, tbatch) = out
    assert (jb, jd, jp) == (tb, td, tp)
    assert len(jbatch) == len(tbatch) > 0
    for (jk, jx, jy, js), (tk, tx, ty, ts) in zip(jbatch, tbatch):
        assert jk == tk and js == ts
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    with pytest.raises(ValueError):
        BucketSentenceIter([[1, 2]], batch_size=4)


def _lm_sym_gen(m, fused, V=20, E=6, H=5):
    def sym_gen(seq_len):
        data = m.sym.Variable("data")
        label = m.sym.Variable("softmax_label")
        emb = m.sym.Embedding(data, input_dim=V, output_dim=E, name="embed")
        if fused:
            cell = m.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                      prefix="lstm_")
        else:
            cell = m.rnn.SequentialRNNCell()
            for li in range(2):
                cell.add(m.rnn.LSTMCell(H, prefix=f"lstm_l{li}_"))
        outputs, _ = cell.unroll(seq_len, emb, layout="NTC",
                                 merge_outputs=True)
        pred = m.sym.FullyConnected(outputs, num_hidden=V, flatten=False,
                                    name="pred")
        pred = m.sym.reshape(pred, shape=(-1, V))
        out = m.sym.SoftmaxOutput(pred, m.sym.reshape(label, shape=(-1,)),
                                  name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


@pytest.mark.parametrize("fused", [False, True], ids=["cells", "fused"])
def test_bucketing_module_lm_tracks_reference(fused):
    from mxnet_tpu.module import BucketingModule as JBM
    from mxnet_tpu.rnn import BucketSentenceIter as JIter
    from mxnet_tpu_torch.module import BucketingModule
    from mxnet_tpu_torch.rnn import BucketSentenceIter

    sents = _sentences(seed=14)
    init = None
    losses = []
    for m, BM, Iter, kw in ((jmx, JBM, JIter, {}),
                            (tmx, BucketingModule, BucketSentenceIter,
                             {"context": tmx.cpu()})):
        np.random.seed(4)
        it = Iter(sents, batch_size=4, buckets=[6, 11], invalid_label=0)
        mod = BM(_lm_sym_gen(m, fused), default_bucket_key=11, **kw)
        mod.bind([("data", (4, 11))], [("softmax_label", (4, 11))])
        if init is None:
            mod.init_params()
            init = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        mod.init_params(arg_params={k: m.nd.array(v)
                                    for k, v in init.items()},
                        force_init=True)
        mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
        run = []
        for _epoch in range(2):
            it.reset()
            for batch in it:
                mod.forward(batch, is_train=True)
                out = mod.get_outputs()[0].asnumpy()
                lbl = batch.label[0].asnumpy().reshape(-1).astype(int)
                p = out[np.arange(len(lbl)), lbl]
                run.append(float(-np.log(np.maximum(p, 1e-9)).mean()))
                mod.backward()
                mod.update()
        losses.append(run)
    assert len(losses[0]) == len(losses[1]) > 10
    assert np.isfinite(losses[1]).all()
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4, atol=1e-5)
