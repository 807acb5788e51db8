"""Decode serving: the port's DecodeEngine/DecodeScheduler (mxnet_tpu_torch,
on the CPU) against the JAX package's, with the same weights, at the size
of tests/test_decode.py (vocab 97, 32 units, 2 layers, 4 heads, 4 slots,
pages of 8, 16 pages, buckets [8, 16])."""
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.models import transformer as jt
from mxnet_tpu.serve import DecodeEngine as JaxEngine
from mxnet_tpu.serve import DecodeScheduler as JaxScheduler
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.models import transformer as tt
from mxnet_tpu_torch.serve import (DeadlineExceeded, DecodeEngine,
                                   DecodeScheduler, RequestRejected)

# tiny shapes need no intra-op threads; the suite runs test files in
# parallel workers beside timing-sensitive tests
torch.set_num_threads(1)

ENGINE = dict(slots=4, page_size=8, num_pages=16, prompt_buckets=[8, 16])
PROMPT_LENGTHS = (3, 5, 8, 9, 13, 16)
NEW = 6


def _prompt(n):
    return np.arange(1, n + 1, dtype=np.int64) % 90 + 1


@pytest.fixture(scope="module")
def weights():
    mx.random.seed(20261017)
    lm = jt.transformer_lm(vocab_size=97, units=32, hidden_size=64,
                           num_layers=2, num_heads=4, max_length=64,
                           dropout=0.0)
    lm.initialize()
    lm(nd.zeros((1, 8)))  # deferred-init shape inference
    return lm, jt.decode_config(lm), jt.decode_params(lm)


@pytest.fixture(scope="module")
def jax_side(weights):
    lm, _cfg, _params = weights
    eng = JaxEngine(lm, **ENGINE)
    eng._warmup_fresh = eng.warmup()
    sched = JaxScheduler(eng, max_new_tokens=NEW)
    yield eng, sched
    sched.close()


@pytest.fixture(scope="module")
def port(weights):
    _lm, cfg, params = weights
    eng = DecodeEngine(cfg, params, device="cpu", **ENGINE)
    eng._warmup_fresh = eng.warmup()
    sched = DecodeScheduler(eng, max_new_tokens=NEW)
    yield eng, sched
    sched.close()
    assert sched.stopped_clean
    eng.pool.assert_baseline()


def _dense_greedy(cfg, lm, prompt, n):
    """Full causal forward per new token: no paging, no batching."""
    toks, ref = [int(t) for t in prompt], []
    params = tt.decode_params(lm)
    with torch.no_grad():
        for _ in range(n):
            logits, _k, _v = tt.lm_prefill(cfg, params,
                                           torch.tensor([toks]))
            ref.append(int(torch.argmax(logits[0, len(toks) - 1])))
            toks.append(ref[-1])
    return ref


def test_warmup_shapes_match_reference(jax_side, port):
    jeng, _ = jax_side
    peng, _ = port
    assert peng.buckets == jeng.buckets == [8, 16]
    assert peng._warmup_fresh == jeng._warmup_fresh == len(peng.buckets) + 1
    assert peng.warmup() == 0  # idempotent: every shape already seen
    assert set(peng.stats()) == set(jeng.stats())  # the reference's keys


@pytest.mark.parametrize("n", PROMPT_LENGTHS)
def test_greedy_stream_identical_to_reference(jax_side, port, weights, n):
    _jeng, jsched = jax_side
    peng, psched = port
    _lm, cfg, params = weights
    got = list(psched.generate(_prompt(n), max_new_tokens=NEW))
    want = list(jsched.generate(_prompt(n), max_new_tokens=NEW))
    assert got == want and len(got) == NEW
    lm = tt.from_numpy_params(cfg, params, device="cpu")
    assert got == _dense_greedy(cfg, lm, _prompt(n), NEW)
    peng.pool.assert_baseline()


def test_out_of_range_prompt_ids_match_reference(jax_side, port, weights):
    """A prompt holding ids at or past the vocabulary (and a negative one)
    streams what the reference streams: its gather clamps such ids, where
    torch indexing would raise (and on CUDA poison the context)."""
    _jeng, jsched = jax_side
    peng, psched = port
    _lm, cfg, params = weights
    for prompt in ([5, 40000], [3, 97, -2, 96, 500]):
        got = list(psched.generate(prompt, max_new_tokens=NEW))
        want = list(jsched.generate(prompt, max_new_tokens=NEW))
        assert got == want and len(got) == NEW
        lm = tt.from_numpy_params(cfg, params, device="cpu")
        assert got == _dense_greedy(cfg, lm, prompt, NEW)
    peng.pool.assert_baseline()


def test_concurrent_streams_equal_sequential(port):
    _eng, sched = port
    prompts = [_prompt(n) for n in (5, 3, 13, 9)]
    got = [None] * len(prompts)

    def run(i):
        got[i] = list(sched.generate(prompts[i], max_new_tokens=NEW))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    for i, p in enumerate(prompts):
        assert got[i] == list(sched.generate(p, max_new_tokens=NEW)), i


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_cancel_returns_pages(port):
    eng, sched = port
    cancelled = sched.stats()["cancelled"]
    gen = sched.generate(_prompt(9), max_new_tokens=40)
    next(gen)
    next(gen)
    gen.close()  # hang-up is the cancel signal
    assert _wait(lambda: eng.pool.used() == 0)
    eng.pool.assert_baseline()
    assert sched.stats()["cancelled"] == cancelled + 1


def test_deadline_returns_pages(port):
    eng, sched = port
    shed = sched.stats()["shed_by_reason"]["deadline"]
    with pytest.raises(DeadlineExceeded):
        sched.submit(_prompt(3), deadline_ms=0.0)  # dead on arrival
    with pytest.raises(DeadlineExceeded):
        for _ in sched.generate(_prompt(3), max_new_tokens=60,
                                deadline_ms=1):
            time.sleep(0.005)
    assert _wait(lambda: eng.pool.used() == 0)
    eng.pool.assert_baseline()
    st = sched.stats()
    assert st["shed_by_reason"]["deadline"] >= shed + 2
    assert st["shed"] == sum(st["shed_by_reason"].values())


def test_compile_log_stable_under_mixed_traffic(port):
    eng, sched = port
    n_before = len(eng.compile_log)
    for n in (16, 1, 7, 12, 2):
        assert len(list(sched.generate(_prompt(n), max_new_tokens=3))) == 3
    assert len(eng.compile_log) == n_before
    kinds = [e["kind"] for e in eng.compile_log]
    assert kinds.count("step") == 1
    assert kinds.count("prefill") == len(eng.buckets)
    assert all(e["cache_hit"] is False for e in eng.compile_log)
    with pytest.raises(RequestRejected):
        eng.bucket_for(17)  # over the largest bucket: shed


def test_engine_accepts_the_port_module(weights):
    _lm, cfg, params = weights
    lm = tt.from_numpy_params(cfg, params, device="cpu")
    eng = DecodeEngine(lm, device="cpu", **ENGINE)
    assert eng.cfg == cfg
    table = eng.pool.alloc("s", 1)
    tok = eng.prefill(_prompt(5), table)
    assert tok == _dense_greedy(cfg, lm, _prompt(5), 1)[0]
    eng.pool.free("s")
    eng.pool.assert_baseline()


def test_engine_without_device_raises_on_cpu_only_host(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    _lm, cfg, params = weights
    with pytest.raises(MXNetError, match="no CUDA device"):
        DecodeEngine(cfg, params, **ENGINE)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        DecodeEngine(cfg, params, device="cuda", **ENGINE)


def test_bucket_validation_matches_reference(weights):
    _lm, cfg, params = weights
    port_kw = dict(device="cpu")
    for make, kw in ((JaxEngine, {}), (DecodeEngine, port_kw)):
        for bad in ([12], [0], [128]):
            with pytest.raises(ValueError):
                make(cfg, params, slots=4, page_size=8, num_pages=16,
                     prompt_buckets=bad, **kw)
    # a pool of 4 usable pages caps prompts at 32 positions
    ref = JaxEngine(cfg, params, slots=2, page_size=8, num_pages=5)
    eng = DecodeEngine(cfg, params, slots=2, page_size=8, num_pages=5,
                       **port_kw)
    assert eng.buckets == ref.buckets == [8, 16, 32]
    assert eng.max_pages == ref.max_pages == 4
