"""The port's static analyzers (``mxnet_tpu_torch.analysis``) against the
reference's (``mxnet_tpu.analysis``) on the CPU.

Every GraphLinter rule fixture of ``tests/test_analysis.py`` is built with
each package's own ``sym`` API (or loaded from the same ``tojson()``
text) and linted by each package's linter: the findings' ``(rule_id,
severity, node)`` are equal. The port's zoo lints clean at the
reference's shapes; the TraceLinter's source, dtype and cache checks,
the engine program-bound proofs (fused update, serve, decode) on clean
CPU traffic and on forced churn, the ShardingLinter, the bind/serve lint
surfaces, ``MXNET_GRAPH_LINT`` and the CLI are covered below.
"""
import json
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
from mxnet_tpu import analysis as janalysis
from mxnet_tpu import symbol as jsym

import mxnet_tpu_torch as mx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import analysis as tanalysis
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.analysis import (GraphAnalysisError, GraphLinter,
                                      Report, Severity, TraceLinter,
                                      list_passes)
from mxnet_tpu_torch.module import Module

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with mx.cpu():
        yield


def _key(report):
    return sorted((f.rule_id, f.severity, f.node) for f in report)


def _mlp(S, hidden=8, classes=3):
    data = S.Variable("data")
    net = S.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = S.Activation(net, act_type="relu", name="relu1")
    net = S.FullyConnected(net, num_hidden=classes, name="fc2")
    return S.SoftmaxOutput(net, name="softmax")


# ---------------------------------------------------------------------------
# GraphLinter: every rule fixture, through both packages
# ---------------------------------------------------------------------------

def _dead_graph(S, A):
    x, y = S.Variable("data"), S.Variable("other")
    keep = S.relu(x, name="keep")
    dead = S.broadcast_add(S.sigmoid(y, name="dead_op"), keep,
                           name="dead_add")
    graph = json.loads(S.Group([keep, dead]).tojson())
    graph["heads"] = [graph["heads"][0]]
    return A.GraphLinter().lint(graph)


_UNKNOWN = {"nodes": [{"op": "null", "name": "data", "inputs": []},
                      {"op": "bogus_op_xyz", "name": "b",
                       "inputs": [[0, 0, 0]]}],
            "heads": [[1, 0, 0]]}


def _fanout(S):
    x = S.relu(S.Variable("data"), name="hub")
    return S.Group([S.sigmoid(x, name=f"c{i}") for i in range(9)])


# name -> f(S, A) -> Report, S the package's symbol module, A its analysis
_FIXTURES = {
    "duplicate_name": lambda S, A: S.Group(
        [S.relu(S.Variable("data"), name="same"),
         S.sigmoid(S.Variable("data"), name="same")]).lint(),
    "dead_node_unused_argument": _dead_graph,
    "unknown_op": lambda S, A: A.GraphLinter().lint(_UNKNOWN),
    "shape_mismatch": lambda S, A: _mlp(S).lint(data=(4,)),
    "shape_clean": lambda S, A: _mlp(S).lint(data=(4, 6)),
    "missing_shape": lambda S, A: S.dot(
        S.Variable("data"), S.Variable("w"), name="d").lint(data=(2, 3)),
    "zero_size_mean": lambda S, A: S.mean(
        S.Variable("data"), axis=1, name="m").lint(data=(2, 0)),
    "nonzero_mean": lambda S, A: S.mean(
        S.Variable("data"), axis=1).lint(data=(2, 3)),
    "zero_size_sum": lambda S, A: S.sum(
        S.Variable("data"), axis=1).lint(data=(2, 0)),
    "zero_size_prod": lambda S, A: S.prod(
        S.Variable("data"), axis=1).lint(data=(2, 0)),
    "nondiff_on_grad_path": lambda S, A: S.argmax(
        _mlp(S), axis=-1, name="pred").lint(data=(2, 6)),
    "argmax_raw_input": lambda S, A: S.argmax(
        S.Variable("data"), axis=-1).lint(data=(2, 6)),
    "log_of_softmax": lambda S, A: S.log(
        S.softmax(S.Variable("data"), name="sm"), name="lg").lint(),
    "log_softmax_clean": lambda S, A: S.log_softmax(
        S.Variable("data")).lint(),
    "exp_on_raw_input": lambda S, A: S.exp(
        S.Variable("data"), name="e").lint(),
    "exp_normalized": lambda S, A: S.exp(
        S.log_softmax(S.Variable("data"))).lint(),
    "high_fanout": lambda S, A: _fanout(S).lint(),
    "fanout_threshold": lambda S, A: A.GraphLinter(
        fanout_threshold=20).lint(_fanout(S)),
    "pass_selection": lambda S, A: A.GraphLinter(passes=["structure"]).lint(
        S.log(S.softmax(S.Variable("data"), name="sm"), name="lg")),
    "disable": lambda S, A: A.GraphLinter(disable={"log-of-softmax"}).lint(
        S.log(S.softmax(S.Variable("data"), name="sm"), name="lg")),
    "json_graph": lambda S, A: A.GraphLinter().lint(
        _mlp(S).tojson(), shapes={"data": (4, 6)}),
    "json_graph_bad_shape": lambda S, A: A.GraphLinter().lint(
        _mlp(S).tojson(), shapes={"data": (4,)}),
}


@pytest.mark.parametrize("name", sorted(_FIXTURES))
def test_graph_rule_fixture_matches_the_reference(name):
    ref = _FIXTURES[name](jsym, janalysis)
    port = _FIXTURES[name](sym, tanalysis)
    assert _key(port) == _key(ref), (port.format(), ref.format())


def test_each_rule_fires_on_its_fixture():
    fires = {"duplicate_name": "duplicate-name",
             "dead_node_unused_argument": "dead-node",
             "unknown_op": "unknown-op", "shape_mismatch": "shape-mismatch",
             "missing_shape": "missing-shape",
             "zero_size_mean": "zero-size-reduction",
             "nondiff_on_grad_path": "nondiff-on-grad-path",
             "log_of_softmax": "log-of-softmax",
             "exp_on_raw_input": "exp-on-raw-input",
             "high_fanout": "high-fanout"}
    for name, rule in fires.items():
        assert rule in {f.rule_id for f in _FIXTURES[name](sym, tanalysis)}
    for name in ("shape_clean", "nonzero_mean", "zero_size_sum",
                 "zero_size_prod", "argmax_raw_input", "log_softmax_clean",
                 "exp_normalized", "fanout_threshold", "pass_selection",
                 "disable", "json_graph"):
        assert not _FIXTURES[name](sym, tanalysis).findings, name
    f = _FIXTURES["shape_mismatch"](sym, tanalysis).by_rule(
        "shape-mismatch").findings[0]
    assert (f.node, f.op, f.severity) == ("fc1", "FullyConnected",
                                          Severity.ERROR)


def test_passes_and_rule_ids_are_the_reference():
    assert list_passes() == janalysis.list_passes()
    with pytest.raises(ValueError, match="unknown lint passes"):
        GraphLinter(passes=["nope"])


def test_invoke_fn_node_lints_clean():
    from mxnet_tpu_torch.ndarray.ndarray import invoke_fn

    x = sym.Variable("x", shape=(2, 3))
    w = invoke_fn(lambda a: torch.tanh(a) * 2.0, [x * 1.0])
    assert not w.lint(x=(2, 3)).findings  # inline OpDef: not unknown-op


def test_traced_lm_with_any_batch_lints_clean():
    """The served LM's graph (batch dimension 0) passes the shape
    pre-flight through its attention node, as the card's pre-flight
    runs it."""
    from mxnet_tpu_torch import models

    net = models.transformer_lm(vocab_size=97, units=32, hidden_size=64,
                                num_layers=2, num_heads=4, max_length=64)
    net.initialize()
    with mx.name.NameManager():
        logits = net(sym.var("data", shape=(0, 64)))
    linter_ctx = tanalysis.LintContext()
    res = linter_ctx.infer(tanalysis.GraphView.from_symbol(logits))
    assert res.out_shapes == [(0, 64, 97)] and not res.findings
    assert not logits.lint().findings


# ---------------------------------------------------------------------------
# the zoo lints clean at the reference's shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "resnet18_v1", "resnet18_v2", "mobilenet0.25", "mobilenetv2_0.25",
    "squeezenet1.1", "alexnet", "vgg11_bn", "densenet121",
])
def test_model_zoo_lints_clean(name):
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    rep = get_model(name, classes=10).lint(data=(1, 3, 224, 224))
    assert not rep.errors, rep.format()
    assert "not-symbolically-traceable" not in {f.rule_id for f in rep}


def test_models_lint_clean():
    from mxnet_tpu_torch.models.seq2seq import Seq2SeqTransformer
    from mxnet_tpu_torch.models.ssd import ssd_300
    from mxnet_tpu_torch.models.transformer import bert_tiny

    for net, shapes in ((bert_tiny(), {"data": (2, 8)}),
                        (Seq2SeqTransformer(
                            src_vocab=50, tgt_vocab=60, units=16,
                            hidden_size=32, num_layers=1, num_heads=2,
                            max_length=16, dropout=0.0),
                         {"src": (2, 5), "tgt": (2, 6)}),
                        (ssd_300(num_classes=3), {"data": (1, 3, 64, 64)})):
        rep = net.lint(**shapes)
        assert not rep.errors, rep.format()
        assert "not-symbolically-traceable" not in {f.rule_id for f in rep}


# ---------------------------------------------------------------------------
# bind / module / serve surfaces and MXNET_GRAPH_LINT
# ---------------------------------------------------------------------------

def test_bind_lint_error_rejects_bad_graph():
    with pytest.raises(GraphAnalysisError) as ei:
        _mlp(sym).simple_bind(grad_req="null", lint="error", data=(4,))
    assert ei.value.node == "fc1" and "fc1" in str(ei.value)
    assert isinstance(ei.value, ValueError)
    with pytest.raises(jmx.base.GraphAnalysisError) as ej:
        _mlp(jsym).simple_bind(grad_req="null", lint="error", data=(4,))
    assert (ei.value.node, ei.value.rule_id) == (ej.value.node,
                                                 ej.value.rule_id)


def test_bind_lint_warn_off_and_list_args():
    noisy = sym.log(sym.softmax(sym.Variable("data"), name="sm"), name="lg")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        exe = noisy.simple_bind(grad_req="null", lint="warn", data=(2, 3))
    assert any("log-of-softmax" in str(x.message) for x in w)
    assert exe.forward(data=nd.ones((2, 3)))[0].shape == (2, 3)
    assert _mlp(sym).simple_bind(grad_req="null",
                                 data=(4, 6)).lint_report is None
    with pytest.raises(ValueError, match="lint must be"):
        _mlp(sym).simple_bind(grad_req="null", lint="loud", data=(4, 6))
    out = sym.dot(sym.Variable("a"), sym.Variable("b"), name="d")
    with pytest.raises(GraphAnalysisError) as ei:
        out.bind(args=[nd.ones((2, 3)), nd.ones((5, 7))], lint="error")
    assert ei.value.node == "d"
    exe = out.bind(args=[nd.ones((2, 3)), nd.ones((3, 7))], lint="error")
    assert not exe.lint_report.has_errors


def test_module_bind_lint():
    mod = Module(_mlp(sym), context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 6))], lint="error")
    assert not mod._exec.lint_report.has_errors
    with pytest.raises(GraphAnalysisError) as ei:
        Module(_mlp(sym), context=mx.cpu()).bind(
            data_shapes=[("data", (4,))], lint="error")
    assert ei.value.node == "fc1"


def test_graph_lint_env_default(monkeypatch):
    monkeypatch.setenv("MXNET_GRAPH_LINT", "error")
    with pytest.raises(GraphAnalysisError):
        _mlp(sym).simple_bind(grad_req="null", data=(4,))
    monkeypatch.setenv("MXNET_GRAPH_LINT", "warn")
    exe = _mlp(sym).simple_bind(grad_req="null", data=(4, 6))
    assert exe.lint_report is not None and not exe.lint_report.findings
    monkeypatch.delenv("MXNET_GRAPH_LINT")
    assert _mlp(sym).simple_bind(grad_req="null",
                                 data=(4, 6)).lint_report is None


def test_inference_engine_lint_error():
    from mxnet_tpu_torch.serve import InferenceEngine

    rng = np.random.RandomState(0)
    arg = {"fc1_weight": rng.randn(8, 6).astype(np.float32),
           "fc1_bias": np.zeros(8, np.float32),
           "fc2_weight": rng.randn(3, 8).astype(np.float32),
           "fc2_bias": np.zeros(3, np.float32)}
    eng = InferenceEngine(_mlp(sym), arg, max_batch_size=2, lint="error")
    assert eng.lint_report is not None and not eng.lint_report.has_errors
    bad = sym.Group([sym.relu(sym.Variable("data"), name="same"),
                     sym.sigmoid(sym.Variable("data"), name="same")])
    with pytest.raises(GraphAnalysisError):
        InferenceEngine(bad, {}, lint="error")


def test_report_api():
    from mxnet_tpu_torch.analysis import Finding

    rep = Report([Finding("a", Severity.INFO, "m"),
                  Finding("b", Severity.ERROR, "m", node="n", op="o")])
    assert rep.has_errors and len(rep) == 2
    with pytest.raises(GraphAnalysisError) as ei:
        rep.raise_if_errors()
    assert ei.value.node == "n" and ei.value.rule_id == "b"
    assert [f.rule_id for f in ei.value.findings] == ["b"]


# ---------------------------------------------------------------------------
# TraceLinter
# ---------------------------------------------------------------------------

class _LeakyBlock(mx.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        scale = float(x.sum())  # a host sync (flagged by the source scan)
        arr = x.asnumpy()  # ditto
        return x * (scale + arr.shape[0])


class _JLeakyBlock(jmx.gluon.HybridBlock):
    def hybrid_forward(self, F, x):
        scale = float(x.sum())
        arr = x.asnumpy()
        return x * (scale + arr.shape[0])


def test_trace_lint_concretization_leak_matches_the_reference():
    port = TraceLinter().lint(_LeakyBlock())
    ref = janalysis.TraceLinter().lint(_JLeakyBlock())
    leaks = port.by_rule("concretization-leak").findings
    assert len(leaks) == 2
    assert all("test_torch_analysis.py" in f.location for f in leaks)
    assert _key(port) == _key(ref)


def test_trace_lint_clean_block_and_dtypes():
    net = mx.gluon.nn.Dense(4, in_units=3)
    assert not TraceLinter().lint(net).findings
    net.initialize()
    rep = Report(TraceLinter().check_dtypes(
        net, nd.ones((2, 3), dtype=np.float16)))
    assert "weak-dtype-promotion" in {f.rule_id for f in rep}
    assert not TraceLinter().check_dtypes(net, nd.ones((2, 3)))


def test_trace_lint_retrace_churn():
    net = mx.gluon.nn.Dense(2, in_units=3, flatten=False)
    net.initialize()
    net.hybridize()
    with TraceLinter(retrace_threshold=3).watch(net) as tl:
        for b in range(1, 6):  # 5 distinct input shapes -> 5 signatures
            net(nd.ones((b, 3)))
    f = tl.report().by_rule("retrace-churn").findings[0]
    assert "5 distinct signatures" in f.message
    with TraceLinter(retrace_threshold=3).watch(net) as tl2:
        for _ in range(5):
            net(nd.ones((2, 3)))
    assert not tl2.report().by_rule("retrace-churn").findings


def _watched_fit(S, A, ctx, Iter, mutate_momentum):
    """Five SGD steps of the MLP under ``TraceLinter.watch``, rewriting
    ``optimizer.momentum`` from a Python float each step when asked.
    Returns (module, the watch's report)."""
    rng = np.random.RandomState(0)
    x = rng.randn(10, 6).astype(np.float32)
    y = rng.randint(0, 3, 10).astype(np.float32)
    mod = (Module if S is sym else jmx.module.Module)(_mlp(S), context=ctx)
    mod.bind(data_shapes=[("data", (2, 6))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params()
    with A.TraceLinter().watch(mod) as tl:
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        for i, batch in enumerate(Iter(x, y, batch_size=2)):
            if mutate_momentum:
                mod._optimizer.momentum = 0.9 - 0.01 * i
            mod.forward_backward(batch)
            mod.update()
    return mod, tl.report().by_rule("update-retrace-churn")


@pytest.mark.parametrize("mutate", [False, True])
def test_update_engine_churn_matches_the_reference(mutate):
    from mxnet_tpu.io import NDArrayIter as JIter

    from mxnet_tpu_torch.io import NDArrayIter

    mod, port = _watched_fit(sym, tanalysis, mx.cpu(), NDArrayIter, mutate)
    _jmod, ref = _watched_fit(jsym, janalysis, jmx.cpu(), JIter, mutate)
    assert [f.rule_id for f in port] == [f.rule_id for f in ref] == (
        ["update-retrace-churn"] if mutate else [])
    log = mod._updater._engine.compile_log
    assert len(log) == (5 if mutate else 1)
    assert {"static", "avals", "state_structure", "flags"} <= set(log[0])
    if mutate:
        assert "static hyperparameters (5 distinct)" in port.findings[
            0].message


def test_serve_engine_bound_clean_and_forced_churn():
    from mxnet_tpu_torch.serve import InferenceEngine

    rng = np.random.RandomState(0)
    arg = {"fc1_weight": rng.randn(8, 6).astype(np.float32),
           "fc1_bias": np.zeros(8, np.float32),
           "fc2_weight": rng.randn(3, 8).astype(np.float32),
           "fc2_bias": np.zeros(3, np.float32)}
    eng = InferenceEngine(_mlp(sym), arg, max_batch_size=4, lint="error")
    for n in (1, 2, 3, 4, 1, 3, 5, 2):  # every bucket, a chunked request
        eng.infer([rng.rand(n, 6).astype(np.float32)])
    assert len(eng.compile_log) == len(eng.buckets)
    assert TraceLinter().check_serve_engine(eng) == []
    eng._programs.clear()  # the bucket-1 program runs its first run again
    eng.infer([rng.rand(1, 6).astype(np.float32)])
    f = TraceLinter().check_serve_engine(eng)
    assert [(x.rule_id, x.severity) for x in f] == [
        ("serve-retrace-churn", Severity.ERROR)]


def test_decode_engine_bound_clean_and_forced_churn():
    from mxnet_tpu_torch.models import transformer as tt
    from mxnet_tpu_torch.serve.decode import DecodeEngine, DecodeScheduler

    mx.random.seed(7)
    lm = tt.transformer_lm(vocab_size=97, units=32, hidden_size=64,
                           num_layers=2, num_heads=4, max_length=64,
                           dropout=0.0)
    lm.initialize()
    lm(nd.zeros((1, 8)))
    eng = DecodeEngine(tt.decode_config(lm), tt.decode_params(lm),
                       device="cpu", slots=2, page_size=8, num_pages=16,
                       prompt_buckets=[8, 16])
    sched = DecodeScheduler(eng, max_new_tokens=3)
    try:
        for n in (3, 9, 13, 5):  # both prompt buckets, mixed lengths
            toks = list(sched.generate(np.arange(1, n + 1) % 90 + 1))
            assert len(toks) == 3
    finally:
        sched.close()
    kinds = sorted(e["kind"] for e in eng.compile_log)
    assert kinds == ["prefill", "prefill", "step"]
    assert TraceLinter().check_decode_engine(eng) == []
    eng._programs.clear()  # the step program runs its first run again
    step = next(e for e in eng.compile_log if e["kind"] == "step")
    slots, pages = step["sig"][3][0]  # the page tables' shape
    eng.step(np.zeros(slots), np.zeros(slots), np.zeros((slots, pages)),
             np.zeros(slots), np.zeros(slots))  # idle rows: scratch page
    f = TraceLinter().check_decode_engine(eng)
    assert {(x.rule_id, x.severity) for x in f} == {
        ("decode-retrace-churn", Severity.ERROR)}


# ---------------------------------------------------------------------------
# ShardingLinter
# ---------------------------------------------------------------------------

_SHAPES = {"rank_bad_weight": (8,), "typo_weight": (8, 8),
           "ragged_weight": (8, 6), "sharded_weight": (64, 64),
           "plain_weight": (64, 64), "small_bias": (8,)}


def _sharding(A, P, rules_cls, mesh):
    rules = rules_cls([(r"rank_bad", P("dp", "tp")), (r"typo", P("zz")),
                       (r"ragged", P(None, "tp")), (r"sharded", P("tp", None))])
    return A.ShardingLinter(mesh, rules, large_param_threshold=1000)


def test_sharding_lint_matches_the_reference():
    from jax.sharding import PartitionSpec as JP
    from mxnet_tpu import parallel as jpar

    from mxnet_tpu_torch import parallel as tpar

    mesh = tpar.make_mesh({"dp": 2, "tp": 4},
                          devices=[torch.device("cpu")] * 8)
    linter = _sharding(tanalysis, tpar.P, tpar.ShardingRules, mesh)
    port = linter.lint(_SHAPES)
    ref = _sharding(janalysis, JP, jpar.ShardingRules,
                    jpar.make_mesh({"dp": 2, "tp": 4})).lint(_SHAPES)
    assert _key(port) == _key(ref)
    by_node = {f.node: f.rule_id for f in port}
    assert by_node == {"rank_bad_weight": "spec-rank-mismatch",
                       "typo_weight": "unknown-mesh-axis",
                       "ragged_weight": "indivisible-dim",
                       "plain_weight": "replicated-large-param"}
    net = mx.gluon.nn.Dense(64, in_units=64)
    net.initialize()
    rep = linter.lint_params(net.collect_params().values())
    assert "replicated-large-param" in {f.rule_id for f in rep}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_graph_lint(tmp_path, capsys):
    from mxnet_tpu_torch.analysis.cli import main

    good = tmp_path / "good.json"
    good.write_text(_mlp(sym).tojson())
    assert main([str(good), "--shape", "data=4,6"]) == 0
    assert main([str(good), "--shape", "data=4"]) == 1
    assert main(["--list-rules"]) == 0
    bad = tmp_path / "unknown.json"
    bad.write_text(json.dumps(_UNKNOWN))
    assert main([str(bad)]) == 1
    assert main([str(bad), "--json", "--disable", "unknown-op"]) == 0
    capsys.readouterr()
    assert main(["concurrency", "--list-rules"]) == 0
    assert "lock-order-cycle" in capsys.readouterr().out
    assert main(["dataplane", "--list-rules"]) == 0
    assert "env-registry-drift" in capsys.readouterr().out
