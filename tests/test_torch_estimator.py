"""The port's ``gluon.contrib.estimator`` (``Estimator`` and its event
handlers) against the JAX package, on the CPU.

The cases of ``tests/test_estimator.py`` and
``tests/test_checkpoint.py::test_estimator_checkpoint_resume_fresh_net``
run through the port, plus the cross-package contract: from the same
initial weights and the same ``DataLoader`` batches, a fit runs the same
handler events and ends at the same metrics and weights (SGD, f32
tolerances rtol 1e-5 / atol 1e-6); the ``.params`` files that
``CheckpointHandler`` writes load into the other package's net bitwise,
and a fit resumed from the other package's full-state checkpoint starts
from its weights bitwise.
"""
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.gluon.block as jblock
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.gluon.block as tblock
from mxnet_tpu_torch import MXNetError, nd
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.contrib.estimator import (CheckpointHandler,
                                                     EarlyStoppingHandler,
                                                     Estimator, HealthHandler,
                                                     LoggingHandler,
                                                     MetricHandler,
                                                     StoppingHandler,
                                                     ValidationHandler)
from mxnet_tpu_torch.gluon.contrib.estimator.event_handler import (
    BatchBegin, BatchEnd, EpochBegin, EpochEnd, TrainBegin, TrainEnd)

torch.set_num_threads(1)
PKGS = {"jax": jmx, "torch": mx}
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _on_cpu():
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    with mx.cpu():
        yield


def _toy_data(M=mx, n=64, dim=8, classes=4, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    y = rng.randint(0, classes, n).astype(np.float32)
    ds = M.gluon.data.ArrayDataset(M.nd.array(x), M.nd.array(y))
    return M.gluon.data.DataLoader(ds, batch_size=batch)


def _toy_net(M=mx, classes=4, dim=8):
    net = M.gluon.nn.HybridSequential()
    net.add(M.gluon.nn.Dense(16, activation="relu", in_units=dim),
            M.gluon.nn.Dense(classes, in_units=16))
    net.initialize()
    return net


def _net_pair(classes=4, seed=0):
    """The toy net in both packages, the port's holding the reference's
    initial weights."""
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    jmx.random.seed(seed)
    nets = {k: _toy_net(M, classes) for k, M in PKGS.items()}
    jmx.random.seed(seed)
    for jp, tp in zip(nets["jax"].collect_params().values(),
                      nets["torch"].collect_params().values()):
        assert jp.name == tp.name
        tp.set_data(jp.data().asnumpy())
    return nets


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


# ---------------------------------------------------------------------------
# tests/test_estimator.py, through the port
# ---------------------------------------------------------------------------

def _recorder(events):
    class Recorder(TrainBegin, EpochBegin, BatchEnd, EpochEnd, TrainEnd):
        def train_begin(self, est, *a, **k):
            events.append("train_begin")

        def epoch_begin(self, est, *a, **k):
            events.append("epoch_begin")

        def batch_end(self, est, *a, **k):
            events.append("batch_end")

        def epoch_end(self, est, *a, **k):
            events.append("epoch_end")

        def train_end(self, est, *a, **k):
            events.append("train_end")

    return Recorder()


def test_estimator_fit_and_handlers():
    events = []
    net = _toy_net()
    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                    metrics=mx.metric.Accuracy(),
                    trainer=mx.gluon.Trainer(net.collect_params(), "adam",
                                             {"learning_rate": 0.05}))
    metrics = est.fit(_toy_data(), epochs=2, event_handlers=[_recorder(events)])
    assert events[0] == "train_begin" and events[-1] == "train_end"
    assert events.count("epoch_begin") == 2 and events.count("epoch_end") == 2
    assert events.count("batch_end") == 8
    names = [m.get()[0] for m in metrics]
    assert "accuracy" in names and "loss" in names
    assert np.isfinite(dict(m.get() for m in metrics)["loss"])


def test_estimator_converges_and_validates():
    net = _toy_net(classes=2)
    rng = np.random.RandomState(1)
    x = rng.randn(128, 8).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    train = mx.gluon.data.DataLoader(
        mx.gluon.data.ArrayDataset(nd.array(x), nd.array(y)), batch_size=32)
    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                    metrics=mx.metric.Accuracy(),
                    trainer=mx.gluon.Trainer(net.collect_params(), "adam",
                                             {"learning_rate": 0.05}))
    est.fit(train, val_data=train, epochs=10)
    acc = dict(m.get() for m in est.train_metrics)["accuracy"]
    val_acc = dict(m.get() for m in est.val_metrics)["validation accuracy"]
    assert acc > 0.8, acc
    assert val_acc > 0.8, val_acc


def test_estimator_checkpoint_and_early_stop(tmp_path):
    net = _toy_net()
    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                    metrics=mx.metric.Accuracy(),
                    trainer=mx.gluon.Trainer(net.collect_params(), "sgd",
                                             {"learning_rate": 0.0}))
    loss_metric = [m for m in est.train_metrics if m.get()[0] == "loss"][0]
    ckpt = CheckpointHandler(str(tmp_path), model_prefix="toy",
                             monitor=loss_metric, save_best=True)
    early = EarlyStoppingHandler(monitor=loss_metric, patience=1)
    est.fit(_toy_data(), epochs=50, event_handlers=[ckpt, early])
    assert early.stop_training
    assert os.path.exists(str(tmp_path / "toy-epoch0.params"))
    net2 = _toy_net()
    net2.load_parameters(str(tmp_path / "toy-epoch0.params"))


def test_estimator_checkpoint_resume_fresh_net(tmp_path):
    np.random.seed(3)
    mx.random.seed(3)
    X = np.random.randn(40, 6).astype(np.float32)
    y = np.random.randint(0, 3, 40).astype(np.float32)
    loader = mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(X, y),
                                      batch_size=8)

    def make():
        np.random.seed(3)
        mx.random.seed(3)
        net = nn.Dense(3)
        net.initialize()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        return net, Estimator(net, loss=mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              trainer=tr)

    net1, est1 = make()
    est1.fit(train_data=loader, epochs=2,
             event_handlers=[CheckpointHandler(str(tmp_path), batch_period=3)])
    p1 = _weights(net1)
    net2, est2 = make()  # fresh instance: different auto-prefix
    h = CheckpointHandler(str(tmp_path), resume_from_checkpoint=True)
    h.train_begin(est2)
    assert h.resumed_from is not None
    p2 = _weights(net2)
    assert p1.keys() == p2.keys()
    for k in p1:
        np.testing.assert_array_equal(p1[k], p2[k], err_msg=k)
    for k, s in est1.trainer._updaters[0].states.items():
        np.testing.assert_array_equal(
            s.asnumpy(), est2.trainer._updaters[0].states[k].asnumpy())


def test_health_handler_waits_for_the_health_plane():
    with pytest.raises(MXNetError, match="A15"):
        HealthHandler()


def test_default_handlers_and_priorities():
    net = _toy_net()
    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss())
    hs = est._prepare_handlers(None, val_data=_toy_data(), epochs=3,
                               batches=None)
    kinds = [type(h) for h in hs]
    assert kinds == [StoppingHandler, MetricHandler, ValidationHandler,
                     LoggingHandler]
    assert hs[0].max_epoch == 3
    mine = StoppingHandler(max_batch=2)
    assert est._prepare_handlers([mine], None, None, 2)[0] is mine
    with pytest.raises(ValueError):
        Estimator(net, mx.gluon.loss.L2Loss(), metrics=["acc"])


def test_stop_on_max_batch_and_logging(caplog):
    net = _toy_net()
    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                    trainer=mx.gluon.Trainer(net.collect_params(), "sgd",
                                             {"learning_rate": 0.1}))
    events = []
    with caplog.at_level(logging.INFO, "mxnet_tpu_torch.estimator"):
        est.fit(_toy_data(), batches=3, event_handlers=[
            _recorder(events), LoggingHandler(log_interval="batch",
                                              metrics=est.train_metrics)])
    assert events.count("batch_end") == 3
    assert "Training begin" in caplog.text
    assert "[Batch 3]" in caplog.text
    assert "Train finished" in caplog.text


def test_train_end_runs_when_a_batch_fails():
    ended = []

    class Fail(BatchBegin, TrainEnd):
        def batch_begin(self, est, *a, **k):
            raise RuntimeError("bad batch")

        def train_end(self, est, *a, **k):
            ended.append(True)

    net = _toy_net()
    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss())
    with pytest.raises(RuntimeError, match="bad batch"):
        est.fit(_toy_data(), epochs=1, event_handlers=[Fail()])
    assert ended == [True]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["plain", "hybridized"])
def test_fit_matches_reference(hybridize):
    nets = _net_pair()
    results = {}
    for key, M in PKGS.items():
        events = []
        net = nets[key]
        if hybridize:
            net.hybridize()
        est = M.gluon.contrib.estimator.Estimator(
            net, M.gluon.loss.SoftmaxCrossEntropyLoss(),
            metrics=M.metric.Accuracy(),
            trainer=M.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1, "momentum": 0.9}))
        rec = _recorder(events)
        M_rec = type("R", (M.gluon.contrib.estimator.event_handler.TrainBegin,
                           M.gluon.contrib.estimator.event_handler.EpochBegin,
                           M.gluon.contrib.estimator.event_handler.BatchEnd,
                           M.gluon.contrib.estimator.event_handler.EpochEnd,
                           M.gluon.contrib.estimator.event_handler.TrainEnd),
                     {k: getattr(rec, k) for k in
                      ("train_begin", "epoch_begin", "batch_end",
                       "epoch_end", "train_end")})()
        per_epoch = []

        class Track(M.gluon.contrib.estimator.event_handler.EpochEnd):
            priority = 10 ** 9  # after the metrics

            def epoch_end(self, est, *a, **k):
                per_epoch.append(dict(m.get() for m in est.train_metrics))

        est.fit(_toy_data(M), val_data=_toy_data(M, seed=1), epochs=3,
                event_handlers=[M_rec, Track()])
        results[key] = (events, per_epoch, _weights(net),
                        dict(m.get() for m in est.val_metrics))
    (je, jm, jw, jv), (te, tm, tw, tv) = results["jax"], results["torch"]
    assert te == je
    for t, j in zip(tm, jm):
        assert t.keys() == j.keys()
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, atol=ATOL)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for k in jv:
        np.testing.assert_allclose(tv[k], jv[k], rtol=RTOL, atol=ATOL)


def test_early_stop_matches_reference():
    nets = _net_pair()
    stopped = {}
    for key, M in PKGS.items():
        net = nets[key]
        est = M.gluon.contrib.estimator.Estimator(
            net, M.gluon.loss.SoftmaxCrossEntropyLoss(),
            trainer=M.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5}))
        loss_m = [m for m in est.train_metrics if m.get()[0] == "loss"][0]
        early = M.gluon.contrib.estimator.EarlyStoppingHandler(
            monitor=loss_m, patience=2, min_delta=0.05)
        est.fit(_toy_data(M), epochs=40, event_handlers=[early])
        stopped[key] = (early.stopped_epoch, early.best, _weights(net))
    assert stopped["torch"][0] == stopped["jax"][0]
    np.testing.assert_allclose(stopped["torch"][1], stopped["jax"][1],
                               rtol=RTOL, atol=ATOL)
    for k, v in stopped["jax"][2].items():
        np.testing.assert_allclose(stopped["torch"][2][k], v, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_params_carry_across_packages(tmp_path, writer):
    """The per-epoch .params file of one package's CheckpointHandler loads
    into the other package's net bitwise, and the nets then predict the
    same batch."""
    nets = _net_pair()
    M = PKGS[writer]
    net = nets[writer]
    est = M.gluon.contrib.estimator.Estimator(
        net, M.gluon.loss.SoftmaxCrossEntropyLoss(),
        trainer=M.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1}))
    est.fit(_toy_data(M), epochs=2, event_handlers=[
        M.gluon.contrib.estimator.CheckpointHandler(str(tmp_path),
                                                    model_prefix="toy")])
    reader = "jax" if writer == "torch" else "torch"
    other = PKGS[reader]
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    net2 = _toy_net(other)
    net2.load_parameters(str(tmp_path / "toy-epoch1.params"))
    w1, w2 = _weights(net), _weights(net2)
    assert w1.keys() == w2.keys()
    for k in w1:
        np.testing.assert_array_equal(w1[k], w2[k], err_msg=k)
    x = np.random.RandomState(9).randn(5, 8).astype(np.float32)
    np.testing.assert_allclose(net2(other.nd.array(x)).asnumpy(),
                               net(M.nd.array(x)).asnumpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_resume_from_the_other_packages_checkpoint(tmp_path, writer):
    """A full-state checkpoint (CheckpointManager, batch_period) written by
    one package's fit resumes the other package's fresh net and trainer
    bitwise: weights and SGD momentum slots."""
    nets = _net_pair()
    M = PKGS[writer]
    net = nets[writer]
    tr = M.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9})
    est = M.gluon.contrib.estimator.Estimator(
        net, M.gluon.loss.SoftmaxCrossEntropyLoss(), trainer=tr)
    est.fit(_toy_data(M), epochs=1, event_handlers=[
        M.gluon.contrib.estimator.CheckpointHandler(str(tmp_path),
                                                    batch_period=4,
                                                    epoch_period=None)])
    reader = "jax" if writer == "torch" else "torch"
    R = PKGS[reader]
    jblock._SCOPE.counters = {}
    tblock._SCOPE.counters = {}
    net2 = _toy_net(R)
    tr2 = R.gluon.Trainer(net2.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    est2 = R.gluon.contrib.estimator.Estimator(
        net2, R.gluon.loss.SoftmaxCrossEntropyLoss(), trainer=tr2)
    h = R.gluon.contrib.estimator.CheckpointHandler(
        str(tmp_path), resume_from_checkpoint=True)
    h.train_begin(est2)
    assert h.resumed_from == 4 and h.current_batch == 4
    w1, w2 = _weights(net), _weights(net2)
    for k in w1:
        np.testing.assert_array_equal(w1[k], w2[k], err_msg=k)
    s1, s2 = tr._updaters[0].states, tr2._updaters[0].states
    assert sorted(s1) == sorted(s2)
    for k in s1:
        np.testing.assert_array_equal(np.asarray(s1[k].asnumpy()),
                                      np.asarray(s2[k].asnumpy()))
