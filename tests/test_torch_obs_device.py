"""The port's device plane (``mxnet_tpu_torch/obs/device.py``) against the
reference's ``mxnet_tpu/obs/device.py`` and against the analytic formulas,
on the CPU.

- the pure functions: ``roofline_class`` and ``attribute`` give equal
  results (and equal ``device.mfu.*`` metrics) for the same cost dicts and
  peaks; ``LeakDetector`` equal verdicts on the same seeded series;
  ``record`` files the reference's metrics and ``device.compile`` event;
- the peaks: the H100 SXM's data-sheet figures by card name, the f32 rate
  for an f32 record, ``set_peak`` and the env winning as in the reference;
- the capture: a ``DecodeEngine``'s prefill and step records and an
  ``InferenceEngine`` bucket's record (a tiny TransformerLM traced to a
  Symbol, its attention on the flash path) equal the analytic count of
  their matmuls plus each port kernel counted once by its formula
  (``ops/flash_attention.py``), the kernels' plain versions hidden; a
  step span's paged share follows that step's lengths;
- ``live_bytes`` is 0 in a process with no card; ``sample`` feeds the
  gauge, the counter lane and the leak detector.

Flops are integers: equality is exact.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu import obs as jobs
from mxnet_tpu.obs import device as jdev
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import obs as tobs
from mxnet_tpu_torch.obs import device as tdev
from mxnet_tpu_torch.ops.flash_attention import (flash_bwd_cost,
                                                 flash_fwd_cost,
                                                 paged_decode_cost)

V, U, L, H, HID, S = 97, 32, 2, 4, 64, 16
D = U // H


@pytest.fixture(autouse=True)
def _clean():
    for o in (jobs, tobs):
        o.disable()
        o.reset()
    yield
    for o in (jobs, tobs):
        o.disable()
        o.reset()


COSTS = [{"flops": 10 ** 9, "bytes_accessed": 10 ** 6},
         {"flops": 10 ** 6, "bytes_accessed": 10 ** 9},
         {"flops": 0, "bytes_accessed": 5}, {"flops": 7}, {}, None]


@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("peaks", [(989.0, 3350.0), (67.0, 3350.0),
                                   (0.2, 20.0)])
def test_roofline_and_attribution_equal(cost, peaks):
    assert tdev.roofline_class(cost, *peaks) == \
        jdev.roofline_class(cost, *peaks)
    for o, dev in ((jobs, jdev), (tobs, tdev)):
        o.enable()
    for seconds in (0.0, 1e-3, 2.5):
        assert tdev.attribute("serve.execute", seconds, cost, *peaks) == \
            jdev.attribute("serve.execute", seconds, cost, *peaks)
    assert tobs.metrics.snapshot() == jobs.metrics.snapshot()


def test_annotate_span_folds_attrs_into_a_live_span():
    tobs.enable()
    with tobs.span("serve.execute", bucket=2) as sp:
        attrs = tdev.annotate_span(sp, "serve.execute", 1e-3,
                                   {"flops": 10 ** 9,
                                    "bytes_accessed": 10 ** 6})
    (ev,) = tobs.trace.drain()
    assert ev["args"] == dict(bucket=2, **attrs)
    assert tdev.annotate_span(tobs.trace._NOOP, "x", 1.0, COSTS[0]) != {}


@pytest.mark.parametrize("seed", range(3))
def test_leak_detector_equal_on_seeded_series(seed):
    rng = np.random.default_rng(seed)
    series = np.cumsum(rng.integers(0, 3 << 20, 60)) * (seed % 2) \
        + rng.integers(0, 1 << 19, 60)
    found = []
    for dev in (jdev, tdev):
        det = dev.LeakDetector(window=8, warmup=2,
                               threshold_bytes_per_step=1 << 20)
        found.append([det.observe(int(n)) for n in series])
    assert found[0] == found[1]


def test_record_files_the_reference_metrics_and_event():
    cost = {"flops": 123, "bytes_accessed": 456, "peak_hbm_bytes": 789}
    for o, dev in ((jobs, jdev), (tobs, tdev)):
        o.enable()
        dev.record("serve", "bucket4", dict(cost))
        dev.record("serve", "bucket8", dict(cost, peak_hbm_bytes=7))
    assert tobs.metrics.snapshot() == jobs.metrics.snapshot()
    strip = [{k: v for k, v in e.items() if k not in ("ts", "tid", "pid")}
             for e in tobs.trace.drain()]
    assert strip == [{k: v for k, v in e.items()
                      if k not in ("ts", "tid", "pid")}
                     for e in jobs.trace.drain()]
    assert tdev.cost_of("serve", "bucket4") == cost
    assert set(tdev.costs()) == {("serve", "bucket4"), ("serve", "bucket8")}


def test_peaks_by_card_name_dtype_and_overrides(monkeypatch):
    assert tdev.card_peaks("NVIDIA H100 80GB HBM3") == (989.0, 67.0, 3350.0)
    assert tdev.card_peaks("Some Other Card") is None
    # a process with no card: the reference's CPU placeholder
    assert tdev.get_peak() == tdev.get_peak(device="cpu") == (0.2, 20.0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tdev.get_peak(device="cuda") == (989.0, 3350.0)
    assert tdev.get_peak(dtype="float32", device="cuda") == (67.0, 3350.0)
    rl = tdev.roofline_class({"flops": 67 * 1000, "bytes_accessed": 3350,
                              "dtype": "float32", "device": "cuda"})
    assert rl["machine_balance_flop_per_byte"] == 20.0
    monkeypatch.setenv("MXNET_DEVICE_PEAK_GBPS", "100")
    assert tdev.get_peak(device="cuda") == (989.0, 100.0)
    tdev.set_peak(tflops=1.5)
    assert tdev.get_peak(dtype="float32", device="cuda") == (1.5, 100.0)


def test_activation_follows_the_flag_and_the_env(monkeypatch):
    assert not tdev.active()
    tobs.enable()
    assert tdev.active()
    monkeypatch.setenv("MXNET_DEVICE_COST", "0")
    assert not tdev.active()
    tobs.disable()
    monkeypatch.setenv("MXNET_DEVICE_COST", "1")
    assert tdev.active()


def test_live_bytes_without_a_card_and_sample():
    assert tdev.live_bytes() == 0
    assert tdev.sample() is None  # obs off: one flag check
    tobs.enable()
    assert tdev.sample(step=1) == 0
    assert tobs.metrics.snapshot()["gauges"]["device.live_bytes"] == 0.0
    (ev,) = tobs.trace.drain()
    assert ev["ph"] == "C" and ev["name"] == "device.live_bytes"


# ---------------------------------------------------------------------------
# captures of the serving engines against the analytic formulas
# ---------------------------------------------------------------------------

def _dense_flops(rows):
    """2 x multiply-adds of every matmul of the LM over ``rows`` rows:
    per layer qkv, proj and the two FFN products, then the LM head."""
    return 2 * rows * (L * (3 * U * U + U * U + 2 * U * HID) + U * V)


@pytest.fixture(scope="module")
def lm():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import transformer as tm

    with mx.cpu():
        mx.random.seed(3)
        net = tm.transformer_lm(vocab_size=V, units=U, hidden_size=HID,
                                num_layers=L, num_heads=H, max_length=64,
                                dropout=0.0)
        net.initialize(ctx=mx.cpu())
        net(mx.nd.zeros((1, 8)))
    return net


def test_decode_records_equal_the_formulas(lm):
    from mxnet_tpu_torch import serve

    tobs.enable()
    eng = serve.DecodeEngine(lm, slots=4, page_size=8, num_pages=24,
                             prompt_buckets=[8, 16], device="cpu")
    eng.warmup()
    recs = {e["label"]: e for e in eng.compile_log}
    assert set(recs) == {"prefill8", "prefill16", "step"}
    for b in (8, 16):
        r = recs[f"prefill{b}"]
        # the prefill's attention is plain einsums (counted by dispatch):
        # QK^T and PV over the bucket, per head and layer
        assert r["flops"] == _dense_flops(b) + L * H * 2 * (2 * b * b * D)
        assert r["kernels"] == {}
        assert r is not None and tdev.cost_of("decode", f"prefill{b}") == {
            k: v for k, v in r.items()
            if k not in ("sig", "kind", "label", "cache_hit")}
    step = recs["step"]
    share = step["kernels"]["paged_decode_attention"]
    f0, b0 = paged_decode_cost([0] * 4, 8, H, D, 4)  # warmup: length 0
    assert share == {"calls": L, "flops": L * f0, "bytes_accessed": L * b0}
    assert step["flops"] == _dense_flops(4) + L * f0
    assert step["dtype"] == "float32" and step["device"] == "cpu"
    assert step["argument_bytes"] > eng.kv.numel() * 4
    assert list(step)[:4] == ["sig", "kind", "label", "cache_hit"]
    assert [k for k in step if k in tdev.COST_FIELDS] == \
        list(tdev.COST_FIELDS)

    # a step at real lengths: its span's paged share follows them
    tobs.trace.drain()
    lengths = np.array([5, 17, 0, 9], np.int32)
    tables = np.zeros((4, eng.max_pages), np.int32)
    tables[:, :3] = np.arange(1, 13).reshape(4, 3)
    eng.step(np.zeros(4, np.int32), np.maximum(lengths - 1, 0), tables,
             lengths, np.zeros(4, np.float32))
    (sp,) = [e for e in tobs.trace.drain()
             if e["name"] == "decode.execute"]
    f1, b1 = paged_decode_cost(lengths.tolist(), 8, H, D, 4)
    a = sp["args"]
    assert (a["paged_flops"], a["paged_bytes"]) == (L * f1, L * b1)
    assert a["attended"] == 31 and a["pages"] == 1 + 3 + 0 + 2
    assert a["flops"] == _dense_flops(4) + L * f1
    assert a["roofline"] in ("compute", "bandwidth")
    assert a["compile"] is False and "analytic_mfu" in a


def test_serve_bucket_record_counts_the_flash_kernel_once(lm, monkeypatch):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch import symbol as sym

    monkeypatch.setenv("MXNET_ATTENTION_IMPL", "flash")
    with mx.cpu(), mx.name.NameManager():
        logits = lm(sym.var("data", shape=(0, S)))
    arg = {p.name: p.data() for p in lm.collect_params().values()}
    eng = serve.InferenceEngine(logits, arg, data_names=("data",),
                                buckets=[2], lint="off", ctx=mx.cpu())
    tobs.enable()
    x = np.random.RandomState(0).randint(0, V, (2, S)).astype(np.float32)
    out = eng.infer([x])[0][0]
    rec = eng.compile_log[0]
    q = torch.zeros((2, H, S, D))
    ff, fb = flash_fwd_cost(q, q, q, True)
    assert ff == 4 * D * 2 * H * S * (S + 1) // 2
    assert rec["kernels"] == {"flash_attention_fwd": {
        "calls": L, "flops": L * ff, "bytes_accessed": L * fb}}
    assert rec["flops"] == _dense_flops(2 * S) + L * ff
    assert tdev.cost_of("serve", "bucket2")["flops"] == rec["flops"]
    # tracing changes no result
    tobs.disable()
    assert np.array_equal(eng.infer([x])[0][0], out)


def test_bwd_formula_and_offsets():
    q = torch.zeros((1, 2, 8, 4))
    assert flash_bwd_cost(q, q, q, q, None, q, None, True) == (
        10 * 4 * 2 * 36, 8 * 2 * 8 * 4 * 4 + 2 * 2 * 8 * 4)
    assert flash_fwd_cost(q, q, q, False)[0] == 4 * 4 * 2 * 64
    # ring attention's offsets: +S sees everything, -S nothing
    assert flash_fwd_cost(q, q, q, True, None, 8)[0] == 4 * 4 * 2 * 64
    assert flash_fwd_cost(q, q, q, True, None, -8)[0] == 0


def test_capture_counts_a_kernel_wrapper_once_and_hides_its_body():
    from mxnet_tpu_torch.ops.flash_attention import flash_decode_attention

    q = torch.randn(2, H, D)
    pages = torch.randn(6, 4, H, D)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    lengths = torch.tensor([7, 2], dtype=torch.int32)

    def twice():
        a = flash_decode_attention(q, pages, pages, table, lengths)
        return flash_decode_attention(q, pages, pages, table, lengths) + a

    out, cost = tdev.capture(twice, (), site="t", label="x")
    f1, b1 = paged_decode_cost([7, 2], 4, H, D, 4)
    assert cost["kernels"]["paged_decode_attention"] == {
        "calls": 2, "flops": 2 * f1, "bytes_accessed": 2 * b1}
    # the one op outside the wrappers: the add (no flops)
    assert cost["flops"] == 2 * f1
    assert cost["bytes_accessed"] == 2 * b1 + 3 * out.numel() * 4
    assert tdev.capturing() is None
    assert math.isfinite(float(out.sum()))


def test_card_capture_peak_is_the_bytes_requested(monkeypatch):
    # the caching allocator hands out a cached block whole when what is
    # left of it is 1 MiB or less, so the allocated bytes depend on the
    # process's earlier allocations; the record takes the bytes asked for
    mib = 2 ** 20
    stats = {"requested_bytes.all.current": 5 * mib,
             "requested_bytes.all.peak": 9 * mib}

    def reset(device=None):
        stats["requested_bytes.all.peak"] = stats[
            "requested_bytes.all.current"]

    def program():
        stats["requested_bytes.all.peak"] += 3 * mib
        return torch.ones(4)

    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda device=None: dict(stats))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 5 * mib)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: 9 * mib)
    _, cost = tdev.capture(program, (), site="t", label="card",
                           device="cuda", arg_tensors=())
    assert cost["device"] == "cuda"
    assert cost["temp_bytes"] == cost["peak_hbm_bytes"] == 3 * mib


def test_card_capture_peak_ignores_earlier_garbage(monkeypatch):
    # a reference cycle that holds card memory from before the window and
    # is collected inside it (the collector runs in whichever thread
    # allocates) must not lower the program's peak: capture collects first
    import gc

    mib = 2 ** 20
    stats = {"requested_bytes.all.current": 5 * mib,
             "requested_bytes.all.peak": 5 * mib}

    class _Held:
        def __del__(self):  # its 4 MiB on the card go back
            stats["requested_bytes.all.current"] -= 4 * mib

    def reset(device=None):
        stats["requested_bytes.all.peak"] = stats[
            "requested_bytes.all.current"]

    def program():
        gc.collect()  # as a collection inside the window would
        stats["requested_bytes.all.peak"] = max(
            stats["requested_bytes.all.peak"],
            stats["requested_bytes.all.current"] + 3 * mib)
        return torch.ones(4)

    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda device=None: dict(stats))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    held = _Held()
    held.cycle = held
    del held
    _, cost = tdev.capture(program, (), site="t", label="garbage",
                           device="cuda", arg_tensors=())
    assert cost["temp_bytes"] == cost["peak_hbm_bytes"] == 3 * mib


def test_training_capture_sites_name_a15():
    # the training capture sites are ported (below), as are the training
    # planes of A15 (health, regress, fleetstats), and
    # ShardedTrainer.step_cost is a record
    for name in ("health", "regress", "fleetstats"):
        assert getattr(tobs, name).__name__ == f"mxnet_tpu_torch.obs.{name}"
    tobs.enable()
    tr, x, y = _sharded_trainer()
    assert tr.step_cost is None
    tr.step(x, y)
    assert tr.step_cost["flops"] > 0 and tr.step_cost["device"] == "cpu"
    assert tdev.cost_of("train_step", "HybridSequential") == tr.step_cost


# ---------------------------------------------------------------------------
# the training capture sites (tests/test_device_obs.py's training cases)
# ---------------------------------------------------------------------------

COST_KEYS = ("flops", "bytes_accessed", "peak_hbm_bytes")


def _assert_cost_fields(entry, where):
    for k in COST_KEYS:
        assert k in entry, f"{where}: compile_log entry missing {k!r}"
        assert isinstance(entry[k], int), f"{where}: {k} not an int"
    assert entry["flops"] > 0, f"{where}: zero flops"
    assert entry["bytes_accessed"] > 0, f"{where}: zero bytes_accessed"
    assert entry["peak_hbm_bytes"] > 0, f"{where}: zero peak_hbm_bytes"


def _mlp_symbol(num_classes=2):
    from mxnet_tpu_torch import symbol as sym

    x = sym.Variable("data")
    h = sym.FullyConnected(x, num_hidden=8, name="fc1")
    h = sym.Activation(h, act_type="relu", name="relu1")
    out = sym.FullyConnected(h, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(out, name="softmax")


def _tiny_resnet(num_classes=2):
    from mxnet_tpu_torch import symbol as sym

    data = sym.Variable("data")
    body = sym.Convolution(data, num_filter=4, kernel=(3, 3), stride=(1, 1),
                           pad=(1, 1), no_bias=True, name="conv0")
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name="bn1")
    act1 = sym.Activation(bn1, act_type="relu", name="relu1")
    conv1 = sym.Convolution(act1, num_filter=4, kernel=(3, 3), stride=(1, 1),
                            pad=(1, 1), no_bias=True, name="conv1")
    body = conv1 + body
    pool = sym.Pooling(body, global_pool=True, kernel=(8, 8),
                       pool_type="avg", name="pool1")
    flat = sym.Flatten(pool, name="flatten")
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")


def _sharded_trainer():
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch import parallel as par

    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="relu"))
    net.add(gluon.nn.Dense(2))
    net.initialize(ctx=tmx.cpu())
    mesh = par.make_mesh({"dp": 1}, devices=[torch.device("cpu")])
    tr = par.ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                            mesh, optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1})
    with tmx.cpu():
        x = nd.array(np.ones((4, 6), np.float32))
        y = nd.array(np.zeros(4, np.int32))
    return tr, x, y


def test_fused_engine_compile_log_carries_device_cost():
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.optimizer import create
    from mxnet_tpu_torch.optimizer.fused import FusedUpdateEngine

    tobs.enable()
    eng = FusedUpdateEngine(create("sgd", learning_rate=0.1))
    w = NDArray(torch.ones((16, 8)))
    g = NDArray(torch.full((16, 8), 0.5))
    eng.apply([0], [w], [g], [None])
    eng.apply([0], [w], [g], [None])
    assert len(eng.compile_log) == 1  # steady state: no second record
    _assert_cost_fields(eng.compile_log[0], "fused")
    # SGD's lowering, one operation an element of each op: rescale * g,
    # + wd * w, * lr, w - (optimizer/fused.py _low_sgd)
    assert eng.compile_log[0]["flops"] == 4 * 16 * 8
    assert tdev.cost_of("update", "SGD")["flops"] > 0
    execs = [e for e in tobs.trace.events()
             if e[1] == "update.fused" and not e[6]["compile"]]
    assert execs and "analytic_mfu" in execs[0][6]
    assert execs[0][6]["roofline"] in ("compute", "bandwidth")


def test_executor_forward_backward_compile_log():
    from mxnet_tpu_torch.executor import Executor

    tobs.enable()
    ex = Executor(_mlp_symbol(), ctx=tmx.cpu(),
                  shapes={"data": (4, 6), "softmax_label": (4,)},
                  grad_req="write")
    ex.forward(is_train=True, data=np.ones((4, 6), np.float32))
    ex.backward()
    assert {e["site"] for e in ex.compile_log} == {"forward", "backward"}
    for entry in ex.compile_log:
        _assert_cost_fields(entry, f"executor/{entry['site']}")
    fwd = [e for e in ex.compile_log if e["site"] == "forward"][0]
    # the two products: 4 x 6 x 8 and 4 x 8 x 2 multiply-adds
    assert fwd["flops"] == 2 * 4 * (6 * 8 + 8 * 2)
    ex.forward(is_train=True, data=np.ones((4, 6), np.float32))
    ex.backward()
    assert len(ex.compile_log) == 2


def test_cachedop_compile_log():
    from mxnet_tpu_torch import gluon, nd

    tobs.enable()
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="relu"))
    net.add(gluon.nn.Dense(2))
    net.initialize(ctx=tmx.cpu())
    net.hybridize()
    with tmx.cpu():
        x = nd.array(np.ones((2, 6), np.float32))
    net(x)
    net(x)
    log = net._cached_op.compile_log
    assert len(log) == 1
    _assert_cost_fields(log[0], "cachedop")
    assert log[0]["flops"] == 2 * 2 * (6 * 8 + 8 * 2)


def test_capture_inactive_without_telemetry():
    """Zero cost when off: no signature is built, no record kept."""
    from mxnet_tpu_torch.executor import Executor

    assert not tdev.active()
    ex = Executor(_mlp_symbol(), ctx=tmx.cpu(),
                  shapes={"data": (2, 6), "softmax_label": (2,)},
                  grad_req="null")
    ex.forward(is_train=False, data=np.ones((2, 6), np.float32))
    assert ex.compile_log == [] and not ex._seen_sigs
    assert ex._last_inputs is None


def test_two_batch_resnet_fit_has_memory_track_and_mfu_attrs(tmp_path):
    import io as _io
    import json

    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.obs.export import to_prometheus
    from mxnet_tpu_torch.tools import trace_report

    tobs.enable()
    rng = np.random.RandomState(7)
    X = rng.randn(8, 3, 8, 8).astype(np.float32)
    y = rng.randint(0, 2, 8).astype(np.float32)
    with tmx.cpu():
        it = NDArrayIter(X, y, batch_size=4)  # 2 batches an epoch
        mod = Module(_tiny_resnet(), context=tmx.cpu())
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05})
    trace_path = str(tmp_path / "trace.json")
    tobs.export(trace_path)
    with open(trace_path) as f:
        evs = json.load(f)["traceEvents"]
    # the memory counter lane, one sample a batch: 0 in a process with no
    # card (the port's live bytes are the card's allocator's)
    mem = [e for e in evs if e.get("ph") == "C"
           and e["name"] == "device.live_bytes"]
    assert len(mem) >= 4
    assert all(e["args"]["value"] == tdev.live_bytes() == 0 for e in mem)
    for span_name, phase in (("device.forward", "forward"),
                             ("device.backward", "backward"),
                             ("update.fused", "update")):
        attrs = [e.get("args") or {} for e in evs
                 if e.get("ph") == "X" and e["name"] == span_name]
        hits = [a for a in attrs if "analytic_mfu" in a]
        assert hits, f"no analytic_mfu attr on any {span_name} span"
        assert hits[0]["roofline"] in ("compute", "bandwidth")
        h = tobs.metrics.registry.get(f"device.mfu.{phase}")
        assert h is not None and h.count > 0
    rep = trace_report.report(trace_path)
    assert "device.live_bytes" in {c["name"] for c in rep["counters"]}
    assert rep["device_programs"]
    top = rep["device_programs"][0]
    assert top["flops"] > 0 and top["site"] in ("executor", "update")
    buf = _io.StringIO()
    trace_report.render(rep, stream=buf)
    assert "device.live_bytes" in buf.getvalue()
    assert "Top programs by device cost" in buf.getvalue()
    merged = trace_report.merged_chrome([trace_path])
    assert any(e.get("ph") == "C" for e in merged["traceEvents"])
    assert "mxnet_device_live_bytes" in to_prometheus(
        tobs.metrics.snapshot())


def test_sharded_trainer_ragged_batch_after_capture():
    """The captured first step keeps no executable that a later batch of
    another shape could trip over: a ragged batch still steps, and the
    net's own forward works after the trainer's steps."""
    from mxnet_tpu_torch import nd

    tobs.enable()
    tr, x, y = _sharded_trainer()
    float(tr.step(x, y).asnumpy())
    assert tr.step_cost and tr.step_cost["flops"] > 0
    first = tr.step_cost
    with tmx.cpu():
        x2 = nd.array(np.ones((2, 6), np.float32))
        y2 = nd.array(np.zeros(2, np.int32))
    assert np.isfinite(float(tr.step(x2, y2).asnumpy()))
    assert tr.step_cost is first  # one record: the first captured step
    tr.net.hybridize()
    with tmx.cpu():
        assert np.isfinite(tr.net(x2).asnumpy()).all()


def test_leak_detector_flags_retained_arrays():
    """A deliberately retained tensor list trips the detector (fed the
    bytes the list holds: the live bytes a card would report; the card's
    own reading is ``tests/test_torch_cuda.py``'s)."""
    det = tdev.LeakDetector(window=8, warmup=2,
                            threshold_bytes_per_step=1000)
    retained, fired = [], None
    for _ in range(30):
        retained.append(torch.ones(256))  # 1 KB a step
        fired = fired or det.observe(sum(t.numel() * 4 for t in retained))
    assert fired is not None and fired["slope_bytes_per_step"] > 500


def test_leak_detector_quiet_over_20_step_steady_state_fit():
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module

    tobs.enable()
    rng = np.random.RandomState(0)
    X = rng.randn(40, 6).astype(np.float32)
    y = rng.randint(0, 2, 40).astype(np.float32)
    tdev.monitor.reset()
    with tmx.cpu():
        it = NDArrayIter(X, y, batch_size=2)  # 20 batches an epoch
        mod = Module(_mlp_symbol(), context=tmx.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.01})
    assert tdev.monitor._seen == 20  # one sample a batch
    assert tdev.monitor.findings == []
    assert not [e for e in tobs.trace.events()
                if e[1] == "device.leak_suspected"]


def test_fused_dispatch_bound_holds_with_capture():
    """The captured first run changes nothing of the steady update: one
    program call, its operators only."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.optimizer import create
    from mxnet_tpu_torch.optimizer.fused import FusedUpdateEngine

    tobs.enable()
    eng = FusedUpdateEngine(create("sgd", learning_rate=0.1, momentum=0.9))
    ws = [NDArray(torch.ones((8, 4))) for _ in range(3)]
    gs = [NDArray(torch.ones((8, 4))) for _ in range(3)]
    sts = [NDArray(torch.zeros((8, 4))) for _ in range(3)]
    eng.apply([0, 1, 2], ws, gs, sts)  # the captured first run
    with profiler.count_dispatches() as c:
        eng.apply([0, 1, 2], ws, gs, sts)
    tobs.disable()
    with profiler.count_dispatches() as c_off:
        eng.apply([0, 1, 2], ws, gs, sts)
    assert c.compiled == 1 and c.d2h == 0, c.as_dict()
    assert c.eager_ops == c_off.eager_ops
    assert len(eng.compile_log) == 1
    _assert_cost_fields(eng.compile_log[0], "fused/momentum")
