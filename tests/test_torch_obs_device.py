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


def test_training_capture_sites_name_a15():
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import ShardedTrainer

    with pytest.raises(MXNetError, match="A15"):
        ShardedTrainer.step_cost.fget(None)
    for name in ("health", "fleetstats", "regress"):
        with pytest.raises(MXNetError, match="A15"):
            getattr(tobs, name)
