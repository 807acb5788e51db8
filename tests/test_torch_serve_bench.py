"""The port's ``serve_bench`` (``mxnet_tpu_torch/tools/serve_bench.py``)
against the reference's ``tools/serve_bench.py``, on the CPU.

Each leg runs at the ``mlp`` size for one to two seconds with
``device="cpu"`` and must return a dict with exactly the keys of the
reference's leg, with sane values: requests completed without an error,
the program bound held, no page leaked, a killed replica restarted; the
``--scale`` and ``--ramp`` legs drive replica groups of 2 CPU ranks
(``ReplicaPool.sharded``). The telemetry legs (``--obs-overhead``/
``--wire-hop``/``--prof-overhead``) run from the command line here and are
held to the reference's keys in ``tests/test_torch_obs_serve.py``; a leg
with no card and no ``--device cpu`` raises instead of falling back to
the CPU.
"""
import json
import os
import sys

import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.tools import serve_bench as tsb

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import serve_bench as jsb
    finally:
        sys.path.pop(0)
    return jsb


_BENCH_KEYS = {"model", "mode", "clients", "request_rows", "duration_s",
               "completed", "shed", "errors", "qps", "p50_ms", "p95_ms",
               "p99_ms", "max_ms", "compiled_programs", "buckets"}


@pytest.mark.parametrize("mode", ["closed", "open"])
def test_run_bench_keys_and_values(mode):
    res = tsb.run_bench(model="mlp", mode=mode, duration=1.0, clients=2,
                        qps=80.0, max_batch_size=4, device="cpu")
    extra = {"offered_qps", "shed_rate"} if mode == "open" else set()
    assert set(res) == _BENCH_KEYS | extra
    assert res["completed"] > 0 and res["errors"] == 0
    assert res["compiled_programs"] <= len(res["buckets"]) == 3
    assert res["p50_ms"] <= res["p99_ms"] <= res["max_ms"]


def test_run_bench_keys_equal_the_reference():
    """The reference's own closed-loop leg, on its CPU backend: the same
    keys."""
    ref = _ref().run_bench(model="mlp", mode="closed", duration=0.5,
                           clients=1, max_batch_size=4)
    port = tsb.run_bench(model="mlp", mode="closed", duration=0.5,
                         clients=1, max_batch_size=4, device="cpu")
    assert set(ref) == set(port)
    assert ref["buckets"] == port["buckets"]


def test_percentile_and_build_model_agree():
    jsb = _ref()
    vals = sorted([0.5, 0.1, 0.9, 0.3, 0.7])
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert tsb._percentile(vals, q) == jsb._percentile(vals, q)
    assert str(tsb._percentile([], 0.5)) == "nan"
    net, arg, aux, feat = tsb._build_model("mlp", device="cpu")
    jnet, jarg, jaux, jfeat = jsb._build_model("mlp")
    assert feat == jfeat and aux == jaux == {}
    assert sorted(arg) == sorted(jarg)
    for k in arg:
        assert (arg[k] == jarg[k]).all()
    assert net.list_arguments() == jnet.list_arguments()


def test_zoo_model_is_traced_to_a_symbol(monkeypatch):
    monkeypatch.setenv("SERVE_BENCH_IMAGE_SIZE", "16")
    net, arg, aux, feat = tsb._build_model("resnet18_v1", device="cpu")
    assert feat == (3, 16, 16)
    assert set(arg) | set(aux) | {"data"} == set(net.list_arguments()) | \
        set(net.list_auxiliary_states())
    assert aux  # the moving statistics of the BatchNorms


def test_run_chaos_bench_keys_and_recovery():
    res = tsb.run_chaos_bench(model="mlp", duration=2.0, qps=60.0,
                              replicas=2, max_batch_size=4, device="cpu")
    assert set(res) == {"mode", "model", "replicas", "offered_qps",
                        "duration_s", "deadline_ms", "hedge_ms", "kill_at_s",
                        "recovered_at_s", "recovery_s", "windows",
                        "failovers", "breaker_trips", "hedges", "restarts",
                        "lost"}
    assert [w["window"] for w in res["windows"]] == \
        ["before", "during", "after"]
    assert res["kill_at_s"] is not None and res["lost"] == 0
    assert sum(w["ok"] for w in res["windows"]) > 0


def test_run_decode_bench_keys_and_invariants():
    res = tsb.run_decode_bench(duration=1.5, clients=3, slots=2,
                               num_pages=32, max_new_tokens=6, device="cpu")
    assert set(res) == {"duration_s", "clients", "slots", "page_size",
                        "num_pages", "max_new_tokens", "streams_completed",
                        "streams_cancelled", "shed", "errors", "tokens_out",
                        "decode_tokens_per_s", "ttft_ms_p50",
                        "decode_p50_per_token_ms",
                        "decode_p99_per_token_ms", "occupancy",
                        "scheduler_steps", "compiled_programs", "buckets",
                        "program_bound_ok", "pages_leaked"}
    assert res["tokens_out"] > 0 and res["errors"] == 0
    assert res["program_bound_ok"] and res["pages_leaked"] == 0


def test_run_cold_bench_keys_and_gate():
    res = tsb.run_cold_bench(model="mlp", max_batch_size=2, timeout=120.0,
                             device="cpu")
    assert set(res) == {"model", "max_batch_size", "cold_start_to_ready_s",
                        "cold_s", "warm_s", "speedup", "warm_wall_win",
                        "compiles_cold", "compiles_warm",
                        "fresh_compiles_cold", "fresh_compiles_warm",
                        "cache_hits_warm", "progcache_cold",
                        "progcache_warm", "host_cores", "note", "ok"}
    assert res["ok"] and res["compiles_cold"] == 2
    assert res["fresh_compiles_warm"] == 0 and res["cache_hits_warm"] == 2
    assert res["progcache_warm"]["hit"] == 2
    assert "torch import" in res["note"]


@pytest.mark.parametrize("flag,item", [("--obs-overhead", "A15"),
                                       ("--wire-hop", "A15"),
                                       ("--prof-overhead", "A15")])
def test_later_legs_name_their_item(flag, item, capsys):
    # the legs of A15's serving half are ported: each prints its JSON
    assert tsb.main([flag, "--device", "cpu", "--duration", "0.6",
                     "--clients", "2"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["model"] == "mlp" and res["duration_s"] == 0.6


def test_run_scale_bench_keys_and_no_errors():
    res = tsb.run_scale_bench(groups_list=(1, 2), tp=2, duration=0.5,
                              clients=2, request_rows=2, device="cpu")
    want = _ref().run_scale_bench(groups_list=(1, 2), tp=2, duration=0.3,
                                  clients=2, request_rows=2)
    assert set(res) == set(want)
    assert set(res["groups"]) == {"1", "2"}
    for g, r in res["groups"].items():
        assert set(r) == set(want["groups"][g])
        assert r["errors"] == 0 and r["completed"] > 0
        assert r["ready_replicas"] == int(g)
    assert res["mode"] == "scale" and res["tp"] == 2


def test_run_ramp_bench_keys_and_no_errors():
    res = tsb.run_ramp_bench(duration=3.0, qps_lo=5.0, qps_hi=20.0,
                             groups=2, tp=2, interval=0.3, device="cpu")
    want = _ref().run_ramp_bench(duration=2.0, qps_lo=5.0, qps_hi=10.0,
                                 groups=2, tp=2, interval=0.3)
    assert set(res) == set(want)
    assert [set(w) for w in res["windows"]] == \
        [set(w) for w in want["windows"]]
    assert res["errors"] == 0 and res["ok"] > 0
    assert res["start_replicas"] == 1 and res["groups"] == 2


def test_no_card_and_no_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the leg runs there")
    with pytest.raises(MXNetError, match="CUDA"):
        tsb.run_bench(model="mlp", duration=0.2, clients=1)


def test_main_json_line(capsys):
    assert tsb.main(["--mode", "closed", "--duration", "0.5", "--clients",
                     "1", "--json", "--device", "cpu"]) == 0
    import json

    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["mode"] == "closed"
