"""Sharded serving in the port (``InferenceEngine(mesh=, rules=,
data_spec=)``, ``serve/group.py``, ``ReplicaPool.sharded``) against the
JAX package, on the CPU (``tests/test_serve_mesh.py``'s cases).

A mesh device of the port is a rank of a job (one process each, gloo), so
the sharded engines run in jobs of ranks (``tools/launch.py`` running
``tools/mesh_worker.py``): a job of 2 ranks (the reference's MLP on tp 2,
and a small ``transformer_lm`` traced to a Symbol outside any mesh scope,
served on tp 2 under ``bert_sharding_rules()``) and one of 4 (the MLP on
tp 4 and on dp 2 x tp 2). While they run, this process computes the
reference's sharded engines on its 8-device CPU mesh from the same
parameters. Outputs are held at the reference's own tolerance (rtol 1e-5,
atol 1e-6, ``tests/test_serve_mesh.py:128``); a mesh of one rank is
bitwise the unsharded engine.

The pools (``ReplicaPool.sharded``) are groups of 2 ranks on a
``{"dp": 2, "tp": 2}`` plan of CPU slots, each group a job of its own
started through picklable factories (``mesh_worker.mlp_server``). Left
out: the ``TraceLinter`` proof of the program bound (the analysis plane
is queue item A15; the engine's own accounting is asserted) and the
Prometheus text of the fleet's gauges (the gauges are asserted; the
exposition is held to the reference's in ``tests/test_torch_obs_*.py``).
"""
import functools
import json
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import parallel as jpar
from mxnet_tpu import serve as jserve
from mxnet_tpu import symbol as jsym

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import obs, serve
from mxnet_tpu_torch import parallel as par
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serve.fleet import FleetServer, ReplicaPool, Router
from mxnet_tpu_torch.serve.group import pid_alive
from mxnet_tpu_torch.tools import mesh_worker as W
from test_torch_ring_attention import run_job

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
X = np.random.RandomState(3).rand(3, 32).astype(np.float32)
LM = {"vocab_size": 96, "units": 32, "hidden_size": 64, "num_layers": 2,
      "num_heads": 4, "max_length": 16}
CPU_RANKS = {"OMP_NUM_THREADS": "1"}
WAIT = 90.0


def _mlp_params():
    rng = np.random.RandomState(7)
    return {"fc1_weight": rng.randn(64, 32).astype(np.float32) * 0.1,
            "fc1_bias": rng.randn(64).astype(np.float32) * 0.01,
            "fc2_weight": rng.randn(8, 64).astype(np.float32) * 0.1,
            "fc2_bias": np.zeros(8, np.float32)}


def _rows():
    rng = np.random.RandomState(1)
    out = {f"x{n}": rng.rand(n, 32).astype(np.float32) for n in range(1, 9)}
    out["big"] = rng.rand(19, 32).astype(np.float32)
    return out


def _ref_engine(axes, arg):
    from jax.sharding import PartitionSpec as P

    rules = jpar.ShardingRules([("fc1_weight|fc1_bias", P("tp")),
                                ("fc2_weight", P(None, "tp"))])
    return jserve.InferenceEngine(W.serve_symbol(jsym, "mlp"), arg,
                                  max_batch_size=8, lint="off",
                                  mesh=jpar.make_mesh(axes), rules=rules)


def _ref_mlp(axes):
    arg = _mlp_params()
    eng = _ref_engine(axes, arg)
    out = {k: eng.predict(v) for k, v in _rows().items()}
    eng.reload({k: v * 2.0 for k, v in arg.items()})
    out["reloaded"] = eng.predict(_rows()["x3"])
    return out


def _ref_lm():
    """The reference's small LM, its parameters and the tokens, and its
    sharded engine's logits at 1 and 2 rows."""
    from mxnet_tpu.gluon.block import _SCOPE
    from mxnet_tpu.models import bert_sharding_rules, transformer_lm

    _SCOPE.counters = {}
    jmx.random.seed(0)
    net = transformer_lm(**LM)
    net.initialize()
    params = {k: v.data().asnumpy()
              for k, v in net._collect_params_with_prefix().items()}
    tokens = np.random.RandomState(0).randint(
        0, LM["vocab_size"], (W.SERVE_LM_ROWS, LM["max_length"])).astype(
            np.float32)
    with jmx.name.NameManager():
        logits = net(jsym.var("data", shape=(0, LM["max_length"])))
    arg = {p.name: p.data() for p in net.collect_params().values()}
    eng = jserve.InferenceEngine(logits, arg, buckets=(1, 2), lint="off",
                                 mesh=jpar.make_mesh({"tp": 2}),
                                 rules=bert_sharding_rules())
    out = {f"out{n}": eng.predict(tokens[:n]) for n in (1, 2)}
    eng.reload({k: v.asnumpy() * W.SERVE_LM_RELOAD_SCALE
                for k, v in arg.items()})
    out["reloaded"] = eng.predict(tokens)
    return params, out


def _mlp_inputs(scenarios):
    inputs = {}
    for s in scenarios:
        for k, v in _mlp_params().items():
            inputs[f"{s}/param/{k}"] = v
        for k, v in _rows().items():
            inputs[f"{s}/{k}"] = v
    return inputs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The 2-rank job, with the references computed here meanwhile, then
    the 4-rank one (one job at a time keeps the host's cores free for the
    other test workers)."""
    lm_params, lm_ref = _ref_lm()
    two = ["serve_mlp_tp2", "serve_lm_tp2"]
    inputs = _mlp_inputs(["serve_mlp_tp2"])
    inputs.update({f"serve_lm_tp2/param/{k}": v
                   for k, v in lm_params.items()})
    res2, refs = run_job(
        2, two, str(tmp_path_factory.mktemp("serve2")), inputs,
        lambda: {"tp2": _ref_mlp({"tp": 2}), "tp4": _ref_mlp({"tp": 4}),
                 "dp2tp2": _ref_mlp({"dp": 2, "tp": 2}), "lm": lm_ref},
        env={"MXNET_MESH_LM": json.dumps(LM)})
    four = ["serve_mlp_tp4", "serve_mlp_dp2tp2"]
    res4, _refs = run_job(4, four, str(tmp_path_factory.mktemp("serve4")),
                          _mlp_inputs(four), dict)
    return {**res2, **res4}, refs


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def test_one_rank_slice_bitwise_per_bucket():
    """A slice of one rank is the unsharded engine: bitwise in every
    bucket, with the same program count (tests/test_serve_mesh.py:110)."""
    arg = _mlp_params()
    with tmx.cpu():
        plain = serve.InferenceEngine(W.serve_symbol(sym, "mlp"), arg,
                                      max_batch_size=8, lint="off")
        mesh1 = par.make_mesh({"tp": 1}, devices=[torch.device("cpu")])
        sharded = serve.InferenceEngine(
            W.serve_symbol(sym, "mlp"), arg, max_batch_size=8, lint="off",
            mesh=mesh1, rules=W.serve_rules(par, "mlp"))
    rng = np.random.RandomState(0)
    for n in (1, 2, 3, 5, 8):
        x = rng.rand(n, 32).astype(np.float32)
        assert np.array_equal(plain.predict(x), sharded.predict(x)), n
    assert sharded.num_programs == plain.num_programs


@pytest.mark.parametrize("axes", ["tp2", "tp4"])
def test_sharded_engine_tp_equivalence_and_program_bound(jobs, axes):
    res, refs = jobs
    r0, ref = res[f"serve_mlp_{axes}"][0], refs[axes]
    n_tp = int(axes[2:])
    assert r0["mesh"] == {"tp": n_tp} and r0["mesh_devices"] == n_tp
    assert r0["sharded_params"] == 3
    for n in range(1, 9):
        np.testing.assert_allclose(r0[f"out{n}"], ref[f"x{n}"], rtol=RTOL,
                                   atol=ATOL, err_msg=f"{axes} n={n}")
    assert r0["repeats_bitwise"]
    np.testing.assert_allclose(r0["big"], ref["big"], rtol=RTOL, atol=ATOL)
    assert r0["big"].shape == (19, 8)
    assert r0["num_programs"] <= r0["buckets"]


@pytest.mark.parametrize("axes", ["tp2", "tp4"])
def test_sharded_engine_warmup_and_ragged_traffic(jobs, axes):
    r0 = jobs[0][f"serve_mlp_{axes}"][0]
    assert r0["warmup"] == r0["buckets"] == 4
    assert r0["compiles_added"] == 0


@pytest.mark.parametrize("axes", ["tp2", "tp4"])
def test_sharded_engine_reload_keeps_shardings(jobs, axes):
    res, refs = jobs
    ranks = res[f"serve_mlp_{axes}"]
    r0, n_tp = ranks[0], int(axes[2:])
    assert r0["staged"] == 1 and r0["version_while_staged"] == 0
    assert r0["committed"] == 1
    np.testing.assert_allclose(r0["reloaded"], refs[axes]["reloaded"],
                               rtol=RTOL, atol=ATOL)
    assert not np.allclose(r0["reloaded"], r0["out3"])
    assert r0["compiles_after_reload"] == 0
    assert "aval mismatch" in r0["aval_error"]
    want = {"fc1_weight": [64 // n_tp, 32], "fc1_bias": [64 // n_tp],
            "fc2_weight": [8, 64 // n_tp]}
    assert r0["leader_shards"] == want
    for peer in ranks[1:]:
        assert peer["peer"] and peer["shards"] == want
        assert peer["version"] == 1


def test_dp2_tp2_engine_batch_matches_reference(jobs):
    res, refs = jobs
    r0 = res["serve_mlp_dp2tp2"][0]
    assert r0["mesh"] == {"dp": 2, "tp": 2} and r0["mesh_devices"] == 4
    for n in range(1, 9):
        np.testing.assert_allclose(r0[f"out{n}"], refs["dp2tp2"][f"x{n}"],
                                   rtol=RTOL, atol=ATOL, err_msg=f"n={n}")
    np.testing.assert_allclose(r0["big"], refs["dp2tp2"]["big"], rtol=RTOL,
                               atol=ATOL)


def test_small_lm_traced_outside_mesh_serves_on_tp2(jobs):
    """The attention layer finds the engine's mesh when it runs: a graph
    traced outside any mesh scope, its fused QKV projection sharded over
    tp, equals the reference's sharded engine and one process's."""
    res, refs = jobs
    r0, peer = res["serve_lm_tp2"]
    for n in (1, 2):
        np.testing.assert_allclose(r0[f"out{n}"], refs["lm"][f"out{n}"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r0[f"out{n}"], r0[f"one{n}"],
                                   rtol=RTOL, atol=ATOL)
    assert r0["repeat_bitwise"] and r0["warmup"] == 2
    np.testing.assert_allclose(r0["reloaded"], refs["lm"]["reloaded"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r0["reloaded"], r0["one_reloaded"],
                               rtol=RTOL, atol=ATOL)
    assert r0["compiles_after_reload"] == 0
    assert "aval mismatch" in r0["aval_error"]
    qkv = "transformerlm0_enc_layer0_attn_qkv_weight"
    assert r0["leader_shards"][qkv] == peer["shards"][qkv] == \
        [3 * LM["units"] // 2, LM["units"]]
    # QKV, FFN and projection of each layer, the embedding and decoder
    assert r0["sharded_params"] == 6 * LM["num_layers"] + 2


# ---------------------------------------------------------------------------
# replica groups behind the Router
# ---------------------------------------------------------------------------

def _wait(cond, what, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"{what}: not within {timeout} s"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def mlp_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mlp") / "mlp.npz")
    np.savez(path, **_mlp_params())
    return path


def _plan(groups, tp=2):
    return par.make_mesh({"dp": groups, "tp": tp},
                         devices=[torch.device("cpu")] * (groups * tp))


def _pool(mlp_path, groups, start=None, **kw):
    kw.setdefault("probe_interval", 0.1)
    return ReplicaPool.sharded(
        functools.partial(W.mlp_server, "mlp", mlp_path, 8),
        mesh=_plan(groups), start=start, env=CPU_RANKS, **kw)


def _ref_tp2():
    return _ref_engine({"tp": 2}, _mlp_params()).predict(X)


def test_sharded_pool_replica_groups_bitwise_and_failover(mlp_path):
    pool = _pool(mlp_path, 2, backoff_base=0.05, backoff_cap=0.5)
    pool.start()
    try:
        assert len(pool.ready_members()) == 2
        assert pool.spare_slices == 0
        groups = [m.handle for m in pool.members()]
        assert all(len(g.pids) == 2 for g in groups)
        assert not set(groups[0].pids) & set(groups[1].pids)
        router = Router(pool)
        front = FleetServer(router, port=0)
        front.start()
        cli = serve.ServeClient("127.0.0.1", front.port)
        try:
            outs = [np.asarray(cli.infer(X)) for _ in range(6)]
            # round-robin hits both groups; the same shard config: bitwise
            assert all(np.array_equal(o, outs[0]) for o in outs)
            np.testing.assert_allclose(outs[0], _ref_tp2(), rtol=RTOL,
                                       atol=ATOL)
            old = list(groups[0].pids)
            pool.kill(0)
            for _ in range(4):
                assert np.array_equal(
                    np.asarray(cli.infer(X, deadline_ms=5000)), outs[0])
            m0 = pool.members()[0]
            _wait(lambda: m0.restarts >= 1 and m0.state == "ready",
                  "group 0's restart")
            # restarted as a unit: new ranks, none of the old ones left
            assert not set(m0.handle.pids) & set(old)
            assert not any(pid_alive(p) for p in old)
            assert np.array_equal(np.asarray(cli.infer(X)), outs[0])
        finally:
            cli.close()
            front.stop()
    finally:
        pool.stop()
    assert not any(pid_alive(p) for g in groups for p in g.pids)


def test_elastic_join_activates_at_generation_boundary(mlp_path):
    pool = _pool(mlp_path, 4, start=1)
    pool.start()
    try:
        assert len(pool.ready_members()) == 1
        assert pool.spare_slices == 3
        gen0 = pool.generation
        idx = pool.add_replica(pool.new_sharded_handle(), wait_ready=True)
        assert pool._members[idx].state == "ready"
        assert len(pool.ready_members()) == 2
        assert pool.generation == gen0 + 1  # exactly one boundary
        assert pool.spare_slices == 2
        st = pool.stats()
        assert st["members"][str(idx)]["state"] == "ready"
        assert st["generation"] == pool.generation
        assert st["spare_slices"] == 2
    finally:
        pool.stop()


def test_elastic_scale_in_drains_with_zero_lost(mlp_path):
    pool = _pool(mlp_path, 2)
    pool.start()
    router = Router(pool)
    errors, results = [], []
    stop = threading.Event()

    def traffic():
        while not stop.is_set():
            try:
                outs, _v = router.infer([X], deadline_ms=5000)
                results.append(outs[0])
            except Exception as e:  # noqa: BLE001 — the assertion target
                errors.append(e)

    try:
        ref = np.asarray(router.infer([X])[0][0])
        threads = [threading.Thread(target=traffic) for _ in range(3)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        victim = max(pool.ready_members(), key=lambda m: m.idx)
        assert pool.remove_replica(victim.idx, drain_timeout=10.0)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not errors, f"lost {len(errors)} requests: {errors[:3]}"
        assert len(pool.ready_members()) == 1
        assert pool._members[victim.idx].state == "removed"
        assert pool.spare_slices == 1  # the slice came back
        assert all(np.array_equal(np.asarray(r), ref) for r in results)
        # the freed slice is reusable: join again onto it
        idx = pool.add_replica(pool.new_sharded_handle(), wait_ready=True)
        assert len(pool.ready_members()) == 2
        assert pool._members[idx].state == "ready"
        assert pool.spare_slices == 0
    finally:
        stop.set()
        router.close(timeout=5)
        pool.stop()


def test_remove_replica_idempotent_and_supervisor_leaves_leavers_alone(
        mlp_path):
    pool = _pool(mlp_path, 2, probe_interval=0.05)
    pool.start()
    try:
        assert pool.remove_replica(1, drain_timeout=5.0)
        assert pool.remove_replica(1, drain_timeout=5.0)  # idempotent
        gen = pool.generation
        time.sleep(0.4)  # the supervisor must not resurrect the leaver
        assert pool._members[1].state == "removed"
        assert pool.generation == gen
        assert len(pool.ready_members()) == 1
        assert not any(pid_alive(p) for p in pool._members[1].handle.pids)
    finally:
        pool.stop()


def test_fleet_gauges_of_a_sharded_pool(mlp_path):
    obs.enable()
    try:
        pool = _pool(mlp_path, 2)
        pool.start()
        router = Router(pool)
        try:
            for _ in range(4):
                router.infer([X])
            deadline = time.monotonic() + 10.0
            snap = {}
            while time.monotonic() < deadline:
                snap = obs.metrics.snapshot()["gauges"]
                if "fleet.replica0.queue_depth" in snap \
                        and "fleet.replica1.queue_depth" in snap:
                    break
                time.sleep(0.1)
            assert "fleet.replica0.queue_depth" in snap
            assert "fleet.replica1.occupancy" in snap
            assert snap.get("fleet.replicas_total") == 2
            assert "fleet.generation" in snap
            router.stats()  # mirrors per-replica breaker state
            snap = obs.metrics.snapshot()["gauges"]
            assert snap.get("fleet.replica0.breaker_state") == 0  # closed
            pst = pool.stats()
            assert set(pst["members"]) == {"0", "1"}
            for v in pst["members"].values():
                assert {"state", "queue_depth", "occupancy"} <= set(v)
            pool.remove_replica(1, drain_timeout=5.0)
            gone = obs.metrics.snapshot()["gauges"]
            assert "fleet.replica1.queue_depth" not in gone
            assert "fleet.replica1.breaker_state" not in gone
        finally:
            router.close(timeout=5)
            pool.stop()
    finally:
        obs.disable()
        obs.reset()


def test_closure_factory_raises():
    with pytest.raises(MXNetError, match="picklable"):
        ReplicaPool.sharded(lambda sub: None, mesh=_plan(2))

    def local(sub):
        return None

    with pytest.raises(MXNetError, match="closure"):
        ReplicaPool.sharded(functools.partial(local), groups=1)
