"""Load generator for the ``mxnet_tpu_torch`` serving endpoint (counterpart
of the reference's ``tools/serve_bench.py``).

Two drive modes against an in-process endpoint (or ``--connect host:port``
for an external one):

- **closed-loop** (``--mode closed``): N client threads, each sending the
  next request the moment the previous reply lands — the throughput
  ceiling and the latency the system settles at under maximum sustainable
  pressure;
- **open-loop** (``--mode open``): requests arrive on a Poisson process at
  ``--qps`` offered load, regardless of completions — tail latency under a
  traffic model. Sheds (rejections, deadline misses) are counted, not
  retried.

Reports p50/p95/p99 latency, achieved throughput against offered load,
shed rate and the engine's program count (the bucketing bound), as a table
or one JSON line a mode (``--json``).

Further legs, each printing JSON: ``--chaos`` drives the open-loop load
through a supervised fleet (``serve/fleet.py``), hard-kills one replica a
third of the way in and reports error rate and p50/p99 before, during and
after the kill-to-recovery window; ``--decode`` streams tokens with churn
through the paged-KV decode engine; ``--cold`` times a ``ProcReplica``
child from spawn to ready against an empty program cache, then a second
one against the cache the first filled (the warm start).

``--scale`` drives closed-loop load through data-parallel replica groups
(``ReplicaPool.sharded``: each group a job of ``--tp`` ranks serving a
tensor-parallel engine) on dp 1/2/4 slices of a ``dp x tp`` plan and
reports qps per group count; ``--ramp`` climbs an open-loop load from
``--qps-lo`` to ``--qps-hi`` against a sharded fleet the ``Autoscaler``
grows from one group toward ``--groups``, and reports every scale event
and the shed count. A plan's ranks share the host's cards round-robin
(or its CPU with ``--device cpu``).

``--obs-overhead`` runs the closed loop with telemetry off and then on at
head-sample rate ``--sample`` and reports the qps delta;
``--prof-overhead`` interleaves three configurations (off, recording
everything, recording into the tail plane's buffers with the sampling
profiler at ``--hz``) and reports what the tail plane and the profiler
add; ``--wire-hop`` reports the client p50 less the mean execute time
(the copy counts of the reference's copy tracker are queue item A15, its
item 4, of the port: those keys are None).

Every leg runs on the card unless ``--device cpu`` is given; without a
card and without it, building the engine raises.

Run: ``python -m mxnet_tpu_torch.tools.serve_bench --chaos --json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from . import join_all


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return float("nan")
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def _ctx(device):
    """The placement of a leg: the card by default, the CPU on request."""
    from .. import context

    if device == "cpu":
        return context.cpu()
    if device in ("gpu", "cuda"):
        return context.gpu(0)
    raise ValueError(f"device={device!r}: want 'gpu' or 'cpu'")


def _build_model(model: str, classes: int = 10, device="gpu"):
    """Return (symbol, arg_params, aux_params, feature_shape). ``mlp`` is a
    two-layer perceptron; any other name is a model-zoo CNN (thumbnail
    variant, ``SERVE_BENCH_IMAGE_SIZE`` pixels, default 32) traced to a
    Symbol."""
    from .. import random as mxrandom
    from .. import symbol as sym

    rng = np.random.RandomState(0)
    if model == "mlp":
        data = sym.Variable("data")
        net = sym.FullyConnected(data, num_hidden=64, name="fc1")
        net = sym.Activation(net, act_type="relu", name="relu1")
        net = sym.FullyConnected(net, num_hidden=classes, name="fc2")
        net = sym.softmax(net, name="prob")
        arg = {"fc1_weight": rng.randn(64, 32).astype(np.float32) * 0.1,
               "fc1_bias": np.zeros(64, np.float32),
               "fc2_weight": rng.randn(classes, 64).astype(np.float32) * 0.1,
               "fc2_bias": np.zeros(classes, np.float32)}
        return net, arg, {}, (32,)
    from .. import nd
    from ..gluon.model_zoo import get_model
    from ..serve import _split_arg_aux

    ctx = _ctx(device)
    mxrandom.seed(0)
    img = int(os.environ.get("SERVE_BENCH_IMAGE_SIZE", 32))
    zoo = get_model(model, classes=classes, thumbnail=True)
    zoo.initialize(ctx=ctx)
    zoo(nd.array(rng.rand(1, 3, img, img).astype(np.float32), ctx=ctx))
    traced = zoo(sym.Variable("data"))
    net = sym.softmax(traced, name="prob")
    all_params = {p.name: p.data() for p in zoo._iter_params()}
    arg, aux = _split_arg_aux(all_params, net)
    return net, arg, aux, (3, img, img)


def run_bench(model="mlp", mode="closed", duration=5.0, clients=4, qps=200.0,
              max_batch_size=8, max_linger_ms=2.0, deadline_ms=None,
              request_rows=1, connect=None, warmup=True, device="gpu"):
    """Drive the endpoint; returns the result dict (see module doc)."""
    from .. import serve

    srv = None
    feat = None
    if connect:
        host, _, port = connect.partition(":")
        addr = (host, int(port))
        engine = None
        feat_env = os.environ.get("SERVE_BENCH_FEATURE", "32")
        feat = tuple(int(d) for d in feat_env.split(",") if d)
    else:
        net, arg, aux, feat = _build_model(model, device=device)
        engine = serve.InferenceEngine(net, arg, aux,
                                       max_batch_size=max_batch_size,
                                       lint="off", ctx=_ctx(device))
        if warmup:
            engine.warmup(feat)  # first calls never pollute latencies
        srv = serve.ServeServer(engine, port=0, max_linger_ms=max_linger_ms)
        srv.start()
        addr = ("127.0.0.1", srv.port)

    rng = np.random.RandomState(1)
    payload = rng.rand(request_rows, *feat).astype(np.float32)
    lat_lock = threading.Lock()
    latencies: list = []
    shed = [0]
    errors = [0]
    stop_at = [0.0]

    def one_request(cli):
        t0 = time.perf_counter()
        try:
            cli.infer(payload, deadline_ms=deadline_ms)
        except (serve.RequestRejected, serve.DeadlineExceeded):
            with lat_lock:
                shed[0] += 1
            return
        except serve.ServeError:
            with lat_lock:
                errors[0] += 1
            return
        dt = time.perf_counter() - t0
        with lat_lock:
            latencies.append(dt)

    t_start = time.perf_counter()
    stop_at[0] = t_start + duration
    if mode == "closed":
        def closed_worker():
            cli = serve.ServeClient(*addr)
            while time.perf_counter() < stop_at[0]:
                one_request(cli)
            cli.close()

        threads = [threading.Thread(target=closed_worker)
                   for _ in range(clients)]
        for t in threads:
            t.start()
        join_all(threads, duration + 60, "closed-loop clients")
        offered = None
    elif mode == "open":
        # Poisson arrivals: a dispatcher sleeps exponential gaps and hands
        # each request to a pooled connection — arrivals never wait on
        # completions (that would turn the experiment closed-loop and hide
        # queueing collapse), so the pool grows on exhaustion
        pool = [serve.ServeClient(*addr) for _ in range(max(clients, 8))]
        free = list(range(len(pool)))
        free_lock = threading.Lock()
        inflight = []
        n_sent = 0

        def fire(idx):
            one_request(pool[idx])
            with free_lock:
                free.append(idx)

        while time.perf_counter() < stop_at[0]:
            time.sleep(rng.exponential(1.0 / qps))
            with free_lock:
                if free:
                    idx = free.pop()
                else:  # every connection busy: open another, don't stall
                    pool.append(serve.ServeClient(*addr))
                    idx = len(pool) - 1
            th = threading.Thread(target=fire, args=(idx,))
            th.start()
            inflight.append(th)
            n_sent += 1
        join_all(inflight, 30, "open-loop requests")
        for cli in pool:
            cli.close()
        offered = n_sent / (time.perf_counter() - t_start)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    wall = time.perf_counter() - t_start

    lat = sorted(latencies)
    n_ok = len(lat)
    out = {
        "model": model, "mode": mode, "clients": clients,
        "request_rows": request_rows, "duration_s": round(wall, 2),
        "completed": n_ok, "shed": shed[0], "errors": errors[0],
        "qps": round(n_ok * request_rows / wall, 2),
        "p50_ms": round(_percentile(lat, 0.50) * 1e3, 3) if lat else None,
        "p95_ms": round(_percentile(lat, 0.95) * 1e3, 3) if lat else None,
        "p99_ms": round(_percentile(lat, 0.99) * 1e3, 3) if lat else None,
        "max_ms": round(lat[-1] * 1e3, 3) if lat else None,
    }
    if offered is not None:
        out["offered_qps"] = round(offered * request_rows, 2)
        out["shed_rate"] = round(shed[0] / max(shed[0] + n_ok, 1), 4)
    if engine is not None:
        out["compiled_programs"] = engine.num_programs
        out["buckets"] = list(engine.buckets)
    if srv is not None:
        srv.stop()
    return out


def run_cold_bench(model="mlp", max_batch_size=8, timeout=180.0,
                   keep_artifact=None, device="gpu"):
    """Cold-start-to-ready A/B: a fresh ``ProcReplica`` child against an
    empty persistent program cache (cold: every bucket's first run is
    counted and written, and on a card its kernels are built by ``nvcc``
    and stored), SIGKILLed, then another against the now-populated cache
    (warm: every bucket a hit, the kernels loaded from their entries).
    ``start_to_ready_s`` is wall time from process spawn to the readiness
    probe answering OK, measured by the parent: the number a fleet
    autoscaler waits on.

    The gate is the reference's, on the deterministic quantity: the warm
    replica ran ZERO fresh programs (every ``compile_log`` entry a
    ``cache_hit``, no more entries than cold's), cold ran some. Wall times
    are reported as measured (``host_cores`` noted)."""
    import shutil
    import tempfile

    from .. import nd, serve
    from ..context import cpu
    from ..model import save_checkpoint

    tmp = keep_artifact or tempfile.mkdtemp(prefix="mxnet-torch-coldstart-")
    created = keep_artifact is None
    try:
        net, arg, aux, feat = _build_model(model, device=device)
        prefix = os.path.join(tmp, "model")
        with cpu():
            save_checkpoint(
                prefix, 0, net,
                {k: nd.array(np.asarray(v)) for k, v in arg.items()},
                {k: nd.array(np.asarray(v)) for k, v in aux.items()})
        cache_dir = os.path.join(tmp, "progcache")
        shape_arg = ",".join(str(d) for d in feat)
        plat = "cpu" if device == "cpu" else "gpu"
        legs = {}
        for leg in ("cold", "warm"):
            # an inherited MXNET_PROGCACHE=0 veto would disable the
            # explicit dir: this A/B is about the armed cache
            rep = serve.ProcReplica(
                prefix,
                args=["--epoch", "0", "--warmup-shape", shape_arg,
                      "--max-batch-size", str(max_batch_size)],
                env={"MXNET_SERVE_PLATFORM": plat, "MXNET_PROGCACHE": "1"},
                progcache_dir=cache_dir)
            rep.idx = 0
            t0 = time.perf_counter()
            cli = None
            graceful = False
            try:
                addr = rep.start()
                cli = serve.ServeClient(*addr, timeout=5.0)
                ready = False
                deadline = time.perf_counter() + timeout
                while time.perf_counter() < deadline:
                    try:
                        if cli.ready():
                            ready = True
                            break
                    except Exception:  # noqa: BLE001 — still booting
                        pass
                    if not rep.alive():
                        break
                    time.sleep(0.05)
                t_ready = time.perf_counter() - t0
                if not ready:
                    raise RuntimeError(
                        f"{leg} replica never became ready in {timeout}s")
                eng = cli.stats().get("engine", {})
                legs[leg] = {
                    "start_to_ready_s": round(t_ready, 3),
                    "compiles": int(eng.get("compiles", 0)),
                    "cache_hits": int(eng.get("cache_hits", 0)),
                    "progcache": eng.get("progcache"),
                }
                # the cold leg always exits by SIGKILL; warm stops
                # gracefully unless something above raised — the finally
                # must never leak the child
                graceful = leg == "warm"
            finally:
                if cli is not None:
                    try:
                        cli.close()
                    except Exception:  # noqa: BLE001 — already torn down
                        pass
                if not graceful:
                    rep.kill()
                rep.stop()  # reap
        cold, warm = legs["cold"], legs["warm"]
        cold_fresh = cold["compiles"] - cold["cache_hits"]
        warm_fresh = warm["compiles"] - warm["cache_hits"]
        ok = (warm_fresh == 0 and cold_fresh > 0
              and warm["cache_hits"] == warm["compiles"] > 0
              and warm["compiles"] <= cold["compiles"])
        return {
            "model": model,
            "max_batch_size": max_batch_size,
            "cold_start_to_ready_s": warm["start_to_ready_s"],
            "cold_s": cold["start_to_ready_s"],
            "warm_s": warm["start_to_ready_s"],
            "speedup": round(cold["start_to_ready_s"]
                             / max(warm["start_to_ready_s"], 1e-9), 3),
            "warm_wall_win": warm["start_to_ready_s"]
            < cold["start_to_ready_s"],
            "compiles_cold": cold["compiles"],
            "compiles_warm": warm["compiles"],
            "fresh_compiles_cold": cold_fresh,
            "fresh_compiles_warm": warm_fresh,
            "cache_hits_warm": warm["cache_hits"],
            "progcache_cold": cold["progcache"],
            "progcache_warm": warm["progcache"],
            "host_cores": os.cpu_count(),
            "note": "start-to-ready includes the interpreter and the torch "
                    "import; the wall win scales with the kernels' nvcc "
                    "builds and the first runs' capture, the compile "
                    "counts are the deterministic gate",
            "ok": ok,
        }
    finally:
        if created:
            shutil.rmtree(tmp, ignore_errors=True)


def run_decode_bench(duration=4.0, clients=6, slots=4, page_size=8,
                     num_pages=64, max_new_tokens=24, churn=True,
                     device="gpu"):
    """Autoregressive decode bench: a tiny transformer LM behind the
    paged-KV engine and the streaming wire, driven by ``clients``
    concurrent streams with churn (periodic early hang-ups and one hopeless
    deadline lane), so join/leave and page reclaim are on the measured
    path.

    Headline numbers: ``decode_tokens_per_s`` and
    ``decode_p99_per_token_ms`` (the client-observed inter-token gap,
    first token excluded; it carries queue wait and prefill and is
    ``ttft_ms_p50``). The program bound and the zero-residual-pages check
    ride along: a retrace or a page leak shows in the result."""
    from .. import nd, serve
    from ..models.transformer import transformer_lm
    from ..serve.decode import DecodeEngine, DecodeScheduler

    ctx = _ctx(device)
    lm = transformer_lm(vocab_size=257, units=64, hidden_size=128,
                        num_layers=2, num_heads=4, max_length=128,
                        dropout=0.0)
    lm.initialize(ctx=ctx)
    lm(nd.zeros((1, 8), ctx=ctx))
    eng = DecodeEngine(lm, slots=slots, page_size=page_size,
                       num_pages=num_pages, device=ctx)
    eng.warmup()  # first calls never pollute token-gap numbers
    sched = DecodeScheduler(eng, max_new_tokens=max_new_tokens)
    srv = serve.ServeServer(engine=None, decode=sched, port=0)
    srv.start()

    lock = threading.Lock()
    gaps: list = []          # inter-token gaps, first token excluded
    ttfts: list = []         # submit -> first token
    tokens = [0]
    completed = [0]
    cancelled = [0]
    shed = [0]
    errors = [0]
    stop_at = time.perf_counter() + duration

    def worker(wid):
        rng = np.random.RandomState(100 + wid)
        cli = serve.ServeClient("127.0.0.1", srv.port)
        my_gaps, my_ttfts = [], []
        rounds = 0
        try:
            while time.perf_counter() < stop_at:
                rounds += 1
                n = int(rng.randint(3, 33))
                prompt = rng.randint(1, 250, size=n).astype(np.int32)
                mode = "normal"
                if churn and wid == 0 and rounds % 3 == 2:
                    mode = "cancel"
                elif churn and wid == 1 and rounds % 5 == 3:
                    mode = "deadline"
                try:
                    if mode == "cancel":
                        gen = cli.generate(prompt,
                                           max_new_tokens=max_new_tokens)
                        next(gen)
                        next(gen)
                        gen.close()  # hang-up: the server reclaims pages
                        with lock:
                            cancelled[0] += 1
                            tokens[0] += 2
                        continue
                    dl = 1.0 if mode == "deadline" else None
                    t_sent = time.perf_counter()
                    t_prev = t_sent
                    got = 0
                    for _tok in cli.generate(prompt,
                                             max_new_tokens=max_new_tokens,
                                             deadline_ms=dl):
                        now = time.perf_counter()
                        if got == 0:
                            my_ttfts.append(now - t_sent)
                        else:
                            my_gaps.append(now - t_prev)
                        t_prev = now
                        got += 1
                    with lock:
                        completed[0] += 1
                        tokens[0] += got
                except (serve.DeadlineExceeded, serve.RequestRejected,
                        serve.Draining):
                    with lock:
                        shed[0] += 1
                except serve.ServeError:
                    with lock:
                        errors[0] += 1
        finally:
            cli.close()
            with lock:
                gaps.extend(my_gaps)
                ttfts.extend(my_ttfts)

    t_start = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(clients)]
    for th in threads:
        th.start()
    join_all(threads, duration + 60, "decode clients")
    wall = time.perf_counter() - t_start
    st = sched.stats()
    srv.stop()
    sigs = {repr(e["sig"]) for e in eng.compile_log}
    gaps.sort()
    ttfts.sort()
    return {
        "duration_s": round(wall, 2), "clients": clients, "slots": slots,
        "page_size": page_size, "num_pages": num_pages,
        "max_new_tokens": max_new_tokens,
        "streams_completed": completed[0],
        "streams_cancelled": cancelled[0],
        "shed": shed[0], "errors": errors[0],
        "tokens_out": tokens[0],
        "decode_tokens_per_s": round(tokens[0] / wall, 2),
        "ttft_ms_p50": (round(_percentile(ttfts, 0.50) * 1e3, 3)
                        if ttfts else None),
        "decode_p50_per_token_ms": (round(_percentile(gaps, 0.50) * 1e3, 3)
                                    if gaps else None),
        "decode_p99_per_token_ms": (round(_percentile(gaps, 0.99) * 1e3, 3)
                                    if gaps else None),
        "occupancy": round(st["occupancy"], 3),
        "scheduler_steps": st["steps"],
        "compiled_programs": len(eng.compile_log),
        "buckets": list(eng.buckets),
        "program_bound_ok": len(sigs) == len(eng.buckets) + 1,
        "pages_leaked": eng.pool.used(),
    }


def _closed_drive(addr, payload, clients, duration, deadline_ms=None):
    """Closed-loop drive against an already-running endpoint; returns
    (sorted latencies, shed, errors, wall_seconds)."""
    from .. import serve

    lock = threading.Lock()
    lats: list = []
    shed = [0]
    errors = [0]
    t_start = time.perf_counter()
    stop_at = t_start + duration

    def worker():
        cli = serve.ServeClient(*addr)
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                cli.infer(payload, deadline_ms=deadline_ms)
            except (serve.RequestRejected, serve.DeadlineExceeded):
                with lock:
                    shed[0] += 1
                continue
            except serve.ServeError:
                with lock:
                    errors[0] += 1
                continue
            with lock:
                lats.append(time.perf_counter() - t0)
        cli.close()

    threads = [threading.Thread(target=worker) for _ in range(clients)]
    for t in threads:
        t.start()
    join_all(threads, duration + 60, "load clients")
    return sorted(lats), shed[0], errors[0], time.perf_counter() - t_start


def _serve_rules(model):
    """Tensor-parallel rules of the bench models: the mlp gets the
    Megatron split (fc1 row-parallel, fc2 column-parallel: one all-reduce
    at the output); zoo models serve replicated parameters."""
    from ..parallel import P, ShardingRules

    if model == "mlp":
        return ShardingRules([("fc1_weight|fc1_bias", P("tp")),
                              ("fc2_weight", P(None, "tp"))])
    return ShardingRules()


def _sharded_server(model, max_batch_size, max_linger_ms, device, submesh):
    """A replica group's ``make_server`` (module level: it runs in every
    rank of the group): the bench model on ``submesh``, warmed, behind a
    started ``ServeServer``."""
    from .. import serve

    net, arg, aux, feat = _build_model(model, device=device)
    engine = serve.InferenceEngine(net, arg, aux,
                                   max_batch_size=max_batch_size,
                                   lint="off", mesh=submesh,
                                   rules=_serve_rules(model))
    engine.warmup(feat)
    srv = serve.ServeServer(engine, port=0, max_linger_ms=max_linger_ms)
    srv.start()
    return srv


def _plan(groups, tp, device):
    """A ``dp x tp`` mesh of device slots: the host's cards round-robin,
    or the CPU."""
    import torch

    from .. import parallel as par

    need = int(groups) * int(tp)
    if _ctx(device).device_type == "gpu":
        cards = torch.cuda.device_count()
        if not cards:
            from ..base import MXNetError

            raise MXNetError("serve_bench: no CUDA card (pass --device cpu)")
        slots = [torch.device("cuda", i % cards) for i in range(need)]
    else:
        slots = [torch.device("cpu")] * need
    return par.make_mesh({"dp": int(groups), "tp": int(tp)}, devices=slots)


def _sharded_fleet(model, mesh, *, start=None, max_batch_size=8,
                   max_linger_ms=1.0, probe_interval=0.15, device="gpu"):
    """(pool, router, front, feat): data-parallel replica groups on the
    mesh's dp slices, each serving a tensor-parallel engine, behind one
    FleetServer front."""
    import functools

    from ..serve.fleet import FleetServer, ReplicaPool, Router

    feat = (32,) if model == "mlp" else (3,) + (int(os.environ.get(
        "SERVE_BENCH_IMAGE_SIZE", 32)),) * 2
    make_server = functools.partial(_sharded_server, model, max_batch_size,
                                    max_linger_ms, device)
    pool = ReplicaPool.sharded(make_server, mesh=mesh, start=start,
                               probe_interval=probe_interval,
                               backoff_base=0.1, backoff_cap=1.0)
    pool.start()
    router = Router(pool)
    front = FleetServer(router, port=0)
    front.start()
    return pool, router, front, feat


def run_scale_bench(model="mlp", groups_list=(1, 2, 4), tp=2, duration=4.0,
                    clients=16, max_batch_size=8, request_rows=4,
                    max_linger_ms=1.0, device="gpu"):
    """serve qps against the number of data-parallel replica groups: for
    each ``groups`` a ``dp x tp`` plan is sliced into tensor-parallel
    replica groups (one engine per slice, its parameters shard-resident),
    closed-loop load runs through one FleetServer front, and the report
    carries qps per group count and the ``scaling_dp<g>`` ratios (qps over
    the first count's)."""
    rng = np.random.RandomState(1)
    results = {}
    for groups in groups_list:
        pool, router, front, feat = _sharded_fleet(
            model, _plan(groups, tp, device), max_batch_size=max_batch_size,
            max_linger_ms=max_linger_ms, device=device)
        try:
            payload = rng.rand(request_rows, *feat).astype(np.float32)
            lat, shed, errors, wall = _closed_drive(
                ("127.0.0.1", front.port), payload, clients, duration)
            results[str(groups)] = {
                "qps": round(len(lat) * request_rows / wall, 2),
                "p50_ms": round(_percentile(lat, 0.50) * 1e3, 3)
                if lat else None,
                "p99_ms": round(_percentile(lat, 0.99) * 1e3, 3)
                if lat else None,
                "completed": len(lat), "shed": shed, "errors": errors,
                "ready_replicas": len(pool.ready_members()),
            }
        finally:
            front.stop()
            pool.stop()
    host_cores = len(os.sched_getaffinity(0)) \
        if hasattr(os, "sched_getaffinity") else (os.cpu_count() or 1)
    out = {"mode": "scale", "model": model, "tp": tp, "clients": clients,
           "duration_s": duration, "request_rows": request_rows,
           "max_batch_size": max_batch_size, "host_cores": host_cores,
           "groups": results}
    base = results.get(str(groups_list[0]), {}).get("qps")
    for g in groups_list[1:]:
        q = results.get(str(g), {}).get("qps")
        if base and q:
            out[f"scaling_dp{g}"] = round(q / base, 2)
    max_g = max(int(g) for g in groups_list)
    if host_cores < max_g:
        # the ranks share the host's cores (and, on one card, the card):
        # compute-bound scaling caps below the group count
        out["note"] = (f"host has {host_cores} cores for {max_g} replica "
                       f"groups; compute-bound scaling caps at "
                       f"~{host_cores}x — run on >= {max_g} cores or real "
                       "devices for the near-linear check")
    return out


def run_ramp_bench(model="mlp", duration=14.0, qps_lo=30.0, qps_hi=450.0,
                   groups=4, tp=2, start_replicas=1, max_batch_size=8,
                   max_linger_ms=4.0, deadline_ms=2000.0, interval=0.4,
                   request_rows=4, device="gpu"):
    """An open-loop load ramp against an autoscaled sharded fleet: offered
    qps climbs linearly lo -> hi over the run while the Autoscaler (its
    default factory, the pool's spare slices) watches windowed burn,
    queue depth and occupancy and grows the pool from ``start_replicas``
    toward ``groups``. Reports the scale events (times and reasons),
    shed and error counts and per-third latency windows."""
    from .. import serve
    from ..serve.autoscale import Autoscaler, AutoscalePolicy

    pool, router, front, feat = _sharded_fleet(
        model, _plan(groups, tp, device), start=start_replicas,
        max_batch_size=max_batch_size, max_linger_ms=max_linger_ms,
        device=device)
    policy = AutoscalePolicy(min_replicas=start_replicas,
                             max_replicas=groups,
                             queue_out=max(2.0, max_batch_size / 2),
                             occupancy_out=0.85, burn_out=1.0,
                             hysteresis=4, cooldown_s=2.0,
                             scale_in_cooldown_s=10.0)
    scaler = Autoscaler(pool, router, policy=policy,
                        interval=interval).start()

    rng = np.random.RandomState(1)
    payload = rng.rand(request_rows, *feat).astype(np.float32)
    addr = ("127.0.0.1", front.port)
    lock = threading.Lock()
    records: list = []  # (t_sent, outcome, latency)
    pool_clients = [serve.ServeClient(*addr) for _ in range(8)]
    free = list(range(len(pool_clients)))

    def fire(idx, t_sent):
        t0 = time.perf_counter()
        try:
            pool_clients[idx].infer(payload, deadline_ms=deadline_ms)
            outcome = "ok"
        except (serve.RequestRejected, serve.Draining):
            outcome = "shed"
        except serve.DeadlineExceeded:
            outcome = "deadline"
        except serve.ServeError:
            outcome = "error"
        with lock:
            records.append((t_sent, outcome, time.perf_counter() - t0))
            free.append(idx)

    t_mono0 = time.monotonic()  # scaler events are monotonic-stamped
    t_start = time.perf_counter()
    inflight = []
    ready_timeline = [(0.0, len(pool.ready_members()))]
    try:
        while time.perf_counter() < t_start + duration:
            t = time.perf_counter() - t_start
            qps = qps_lo + (qps_hi - qps_lo) * min(t / duration, 1.0)
            time.sleep(rng.exponential(1.0 / qps))
            r = len(pool.ready_members())
            if r != ready_timeline[-1][1]:
                ready_timeline.append((round(t, 2), r))
            with lock:
                if free:
                    idx = free.pop()
                else:
                    pool_clients.append(serve.ServeClient(*addr))
                    idx = len(pool_clients) - 1
            th = threading.Thread(target=fire,
                                  args=(idx, time.perf_counter() - t_start))
            th.start()
            inflight.append(th)
        join_all(inflight, 30, "autoscale requests")
    finally:
        scaler.stop()
        events = [{"t_s": round(e["t"] - t_mono0, 2),
                   "action": e["action"], "reason": e["reason"],
                   "ready": e["ready"]} for e in scaler.events]
        fleet_stats = router.stats()
        front.stop()
        pool.stop()
        for cli in pool_clients:
            cli.close()

    def window(name, lo, hi):
        rows = [r for r in records if lo <= r[0] < hi]
        lat = sorted(r[2] for r in rows if r[1] == "ok")
        return {"window": name, "sent": len(rows), "ok": len(lat),
                "shed": sum(1 for r in rows if r[1] in ("shed", "deadline")),
                "errors": sum(1 for r in rows if r[1] == "error"),
                "p50_ms": round(_percentile(lat, 0.5) * 1e3, 2)
                if lat else None,
                "p99_ms": round(_percentile(lat, 0.99) * 1e3, 2)
                if lat else None}

    third = duration / 3.0
    shed_total = sum(1 for r in records if r[1] in ("shed", "deadline"))
    return {
        "mode": "ramp", "model": model, "tp": tp, "groups": groups,
        "start_replicas": start_replicas, "duration_s": duration,
        "qps_lo": qps_lo, "qps_hi": qps_hi, "deadline_ms": deadline_ms,
        "sent": len(records),
        "ok": sum(1 for r in records if r[1] == "ok"),
        "shed": shed_total,
        "errors": sum(1 for r in records if r[1] == "error"),
        "scale_out_events": sum(1 for e in events
                                if e["action"] == "scale_out"),
        "scale_in_events": sum(1 for e in events
                               if e["action"] == "scale_in"),
        "events": events,
        "ready_timeline": ready_timeline,
        "final_generation": pool.generation,
        "failovers": fleet_stats["failovers"],
        "windows": [window("ramp_lo", 0.0, third),
                    window("ramp_mid", third, 2 * third),
                    window("ramp_hi", 2 * third, duration + 1e9)],
    }


def run_obs_overhead(model="mlp", duration=4.0, sample=0.1, clients=4,
                     max_batch_size=8, request_rows=1, threshold_pct=5.0,
                     device="gpu"):
    """What tracing costs: the same closed-loop bench twice through the
    engine → batcher → socket stack, telemetry off, then on with head
    sampling at ``sample``; the qps delta is ``obs_overhead_pct``. The
    caller's telemetry flag, rate and JSONL stream are restored."""
    from .. import obs

    was_on = obs.enabled()
    prev_rate = obs.context.sample_rate()
    prev_stream = obs.trace.tracer.stream_path
    obs.disable()
    try:
        off = run_bench(model=model, mode="closed", duration=duration,
                        clients=clients, max_batch_size=max_batch_size,
                        request_rows=request_rows, device=device)
        obs.context.set_sample_rate(sample)
        obs.enable()
        on = run_bench(model=model, mode="closed", duration=duration,
                       clients=clients, max_batch_size=max_batch_size,
                       request_rows=request_rows, device=device)
    finally:
        obs.disable()
        obs.context.set_sample_rate(prev_rate)
        if was_on:
            obs.enable(jsonl=prev_stream)  # resume the caller's stream
        else:
            obs.reset()  # telemetry was off: leave no residue
    qps_off, qps_on = off["qps"], on["qps"]
    pct = 100.0 * (qps_off - qps_on) / qps_off if qps_off else 0.0
    return {"model": model, "sample_rate": sample,
            "duration_s": duration, "clients": clients,
            "qps_off": qps_off, "qps_on": qps_on,
            "p99_ms_off": off["p99_ms"], "p99_ms_on": on["p99_ms"],
            "obs_overhead_pct": round(pct, 2),
            "threshold_pct": threshold_pct,
            "ok": bool(pct < threshold_pct)}


def run_wire_hop(model="mlp", duration=4.0, clients=4, max_batch_size=8,
                 request_rows=1, device="gpu"):
    """The wire hop: a closed-loop serve run's p50 client latency less
    the mean per-request execute time (``hop_ms_p50``: queueing, framing,
    copies). The reference's copy-tracker counts (bytes copied, serialize
    calls, host syncs per request) are queue item A15 (item 4) of the
    port: those keys are None."""
    from .. import obs

    was_on = obs.enabled()
    prev_rate = obs.context.sample_rate()
    prev_stream = obs.trace.tracer.stream_path
    obs.disable()
    try:
        obs.context.set_sample_rate(0.0)  # spans off; metrics are enough
        obs.enable()
        before = obs.metrics.snapshot()["histograms"].get(
            "serve.execute_seconds", {})
        res = run_bench(model=model, mode="closed", duration=duration,
                        clients=clients, max_batch_size=max_batch_size,
                        request_rows=request_rows, device=device)
        after = obs.metrics.snapshot()["histograms"].get(
            "serve.execute_seconds", {})
    finally:
        obs.disable()
        obs.context.set_sample_rate(prev_rate)
        if was_on:
            obs.enable(jsonl=prev_stream)
        else:
            obs.reset()
    n = max(res["completed"], 1)
    exec_s = after.get("sum", 0.0) - before.get("sum", 0.0)
    exec_ms_per_req = 1e3 * exec_s / n
    p50 = res["p50_ms"] or 0.0
    return {
        "model": model, "duration_s": duration, "clients": clients,
        "request_rows": request_rows, "completed": res["completed"],
        "qps": res["qps"], "p50_ms": p50, "p99_ms": res["p99_ms"],
        "execute_ms_per_request": round(exec_ms_per_req, 3),
        "hop_ms_p50": round(max(p50 - exec_ms_per_req, 0.0), 3),
        "bytes_copied_per_request": None,
        "serialize_calls_per_request": None,
        "host_syncs_per_request": None,
        "sync_sites": None,
        "bytes_copied_total": None,
    }


def run_prof_overhead(model="mlp", duration=4.0, hz=None, clients=4,
                      max_batch_size=8, request_rows=1, threshold_pct=5.0,
                      segments=5, device="gpu"):
    """What the black-box plane costs: closed-loop qps through the
    engine → batcher → socket stack in three interleaved configurations
    against one endpoint — ``off`` (no telemetry), ``plain`` (every
    request recorded durably, sample rate 1.0) and ``on`` (telemetry +
    tail-mode buffering with the verdict at root close + the sampling
    profiler at ``hz``). ``prof_overhead_pct`` is the plain → on delta,
    what the tail plane and the profiler add on top of recording;
    ``record_overhead_pct`` the off → plain one. The configurations'
    ``segments`` interleave round-robin and the best of each is compared,
    so host-load drift does not land on one side."""
    from .. import obs, serve

    net, arg, aux, feat = _build_model(model, device=device)
    engine = serve.InferenceEngine(net, arg, aux,
                                   max_batch_size=max_batch_size,
                                   lint="off", ctx=_ctx(device))
    engine.warmup(feat)
    srv = serve.ServeServer(engine, port=0, max_linger_ms=2.0)
    srv.start()
    addr = ("127.0.0.1", srv.port)
    rng = np.random.RandomState(1)
    payload = rng.rand(request_rows, *feat).astype(np.float32)

    def segment(seg_s: float) -> float:
        """Drive `clients` closed-loop threads for seg_s; return qps."""
        done = [0] * clients
        stop_at = time.perf_counter() + seg_s

        def worker(i):
            cli = serve.ServeClient(*addr)
            n = 0
            while time.perf_counter() < stop_at:
                cli.infer(payload)
                n += 1
            done[i] = n
            cli.close()

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        join_all(threads, seg_s + 60, "overhead clients")
        return sum(done) / (time.perf_counter() - t0)

    was_on = obs.enabled()
    prev_rate = obs.context.sample_rate()
    prev_stream = obs.trace.tracer.stream_path
    tail_was_on = obs.tail.enabled()
    prev_tail_buf = obs.tail.buffer()  # the caller's buffer and policy
    prof_was_on = obs.profile.enabled()
    prev_prof_hz = obs.profile.profiler.hz if prof_was_on else None
    if prof_was_on:
        # a caller's profiler sampling through the off/plain segments
        # would charge its cost to the wrong side
        obs.profile.stop()
    seg_s = duration / max(segments, 1)
    qps_off: list = []
    qps_plain: list = []
    qps_on: list = []
    prof_samples = 0
    prof_stacks = 0
    prof_hz = float(hz) if hz else None
    tail_buf = None

    def cfg_off():
        if obs.tail.enabled():
            obs.tail.disable()
        obs.disable()

    def cfg_plain():
        if obs.tail.enabled():
            obs.tail.disable()
        obs.context.set_sample_rate(1.0)
        obs.enable()

    def cfg_on():
        nonlocal tail_buf
        obs.enable()
        # one buffer across segments, so its counters accumulate
        if tail_buf is None:
            tail_buf = obs.tail.enable()
        else:
            obs.tail.set_buffer(tail_buf)
        return obs.profile.start(hz=hz)

    try:
        # warm all three paths once (connections, code paths, allocator)
        cfg_off()
        segment(min(seg_s, 1.0))
        cfg_plain()
        segment(min(seg_s, 1.0))
        cfg_on()
        segment(min(seg_s, 1.0))
        obs.profile.stop()
        for _ in range(max(segments, 1)):
            cfg_off()
            qps_off.append(segment(seg_s))
            cfg_plain()
            qps_plain.append(segment(seg_s))
            prof = cfg_on()
            qps_on.append(segment(seg_s))
            st = prof.stats()
            obs.profile.stop()
            prof_samples += st["samples"]
            prof_stacks = max(prof_stacks, st["distinct_stacks"])
            prof_hz = st["hz"]
        tail_stats = tail_buf.stats() if tail_buf is not None else {}
    finally:
        obs.profile.stop()
        if prof_was_on:
            obs.profile.start(hz=prev_prof_hz)
        if tail_was_on:
            obs.tail.set_buffer(prev_tail_buf)
        elif obs.tail.enabled():
            obs.tail.disable()
        obs.disable()
        obs.context.set_sample_rate(prev_rate)
        if was_on:
            obs.enable(jsonl=prev_stream)  # resume the caller's stream
        else:
            obs.reset()  # telemetry was off: leave no residue
        srv.stop()
    best_off, best_plain, best_on = max(qps_off), max(qps_plain), max(qps_on)
    pct = 100.0 * (best_plain - best_on) / best_plain if best_plain else 0.0
    rec_pct = 100.0 * (best_off - best_plain) / best_off if best_off else 0.0
    return {"model": model, "profiler_hz": prof_hz,
            "duration_s": duration, "clients": clients,
            "segments": len(qps_off),
            "qps_off": round(best_off, 2),
            "qps_plain": round(best_plain, 2),
            "qps_on": round(best_on, 2),
            "qps_off_segments": [round(q, 1) for q in qps_off],
            "qps_plain_segments": [round(q, 1) for q in qps_plain],
            "qps_on_segments": [round(q, 1) for q in qps_on],
            "prof_samples": prof_samples,
            "prof_distinct_stacks": prof_stacks,
            "tail_retained": tail_stats.get("retained", 0),
            "tail_dropped": tail_stats.get("dropped", 0),
            "record_overhead_pct": round(rec_pct, 2),
            "prof_overhead_pct": round(pct, 2),
            "threshold_pct": threshold_pct,
            "ok": bool(pct < threshold_pct)}


def run_chaos_bench(model="mlp", duration=12.0, qps=120.0, replicas=3,
                    max_batch_size=8, max_linger_ms=2.0, deadline_ms=500.0,
                    request_rows=1, hedge_ms=None, kill_replica=0,
                    device="gpu"):
    """Availability under replica death, measured: open-loop Poisson load
    through a FleetServer front over ``replicas`` supervised in-process
    replicas; at duration/3 one replica is hard-killed (its sockets sever
    mid-work) and the pool restarts it with backoff. Every request is
    timestamped and bucketed into before / during (kill to readiness
    recovered) / after windows. Returns the result dict."""
    from .. import serve
    from ..serve.fleet import FleetServer, ReplicaPool, Router

    net, arg, aux, feat = _build_model(model, device=device)
    ctx = _ctx(device)

    def factory():
        engine = serve.InferenceEngine(net, arg, aux,
                                       max_batch_size=max_batch_size,
                                       lint="off", ctx=ctx)
        engine.warmup(feat)
        srv = serve.ServeServer(engine, port=0,
                                max_linger_ms=max_linger_ms)
        srv.start()
        return srv

    pool = ReplicaPool.local(factory, replicas, probe_interval=0.15,
                             backoff_base=0.1, backoff_cap=1.0)
    pool.start()
    router = Router(pool, hedge_ms=hedge_ms, breaker_cooldown=0.3)
    front = FleetServer(router, port=0)
    front.start()
    addr = ("127.0.0.1", front.port)

    rng = np.random.RandomState(1)
    payload = rng.rand(request_rows, *feat).astype(np.float32)
    lock = threading.Lock()
    records = []  # (t_sent, outcome, latency)
    pool_clients = [serve.ServeClient(*addr) for _ in range(8)]
    free = list(range(len(pool_clients)))

    def fire(idx, t_sent):
        t0 = time.perf_counter()
        try:
            pool_clients[idx].infer(payload, deadline_ms=deadline_ms)
            outcome = "ok"
        except (serve.RequestRejected, serve.Draining):
            outcome = "shed"
        except serve.DeadlineExceeded:
            outcome = "deadline"
        except serve.ServeError:
            outcome = "error"
        with lock:
            records.append((t_sent, outcome, time.perf_counter() - t0))
            free.append(idx)

    t_start = time.perf_counter()
    kill_at = t_start + duration / 3.0
    t_kill = [None]
    t_recovered = [None]
    killed = [False]
    dipped = [False]  # readiness must visibly drop before "recovered"
    inflight = []
    while time.perf_counter() < t_start + duration:
        now = time.perf_counter()
        if not killed[0] and now >= kill_at:
            pool.kill(kill_replica)
            t_kill[0] = now
            killed[0] = True
        if killed[0] and t_recovered[0] is None:
            ready = len(pool.ready_members())
            if ready < replicas:
                dipped[0] = True
            elif dipped[0]:
                t_recovered[0] = now
        time.sleep(rng.exponential(1.0 / qps))
        with lock:
            if free:
                idx = free.pop()
            else:
                pool_clients.append(serve.ServeClient(*addr))
                idx = len(pool_clients) - 1
        th = threading.Thread(target=fire,
                              args=(idx, time.perf_counter() - t_start))
        th.start()
        inflight.append(th)
    join_all(inflight, 30, "chaos requests")
    if killed[0] and t_recovered[0] is None and dipped[0] \
            and len(pool.ready_members()) >= replicas:
        t_recovered[0] = time.perf_counter()
    fleet_stats = router.stats()
    front.stop()
    pool.stop()
    for cli in pool_clients:
        cli.close()

    kill_off = (t_kill[0] - t_start) if t_kill[0] else None
    rec_off = (t_recovered[0] - t_start) if t_recovered[0] else None

    def window(name, lo, hi):
        rows = [r for r in records if lo <= r[0] < hi]
        lat = sorted(r[2] for r in rows if r[1] == "ok")
        n = len(rows)
        bad = sum(1 for r in rows if r[1] == "error")
        shed = sum(1 for r in rows if r[1] in ("shed", "deadline"))
        return {"window": name, "sent": n, "ok": len(lat), "shed": shed,
                "errors": bad,
                "error_rate": round(bad / n, 4) if n else None,
                "p50_ms": round(_percentile(lat, 0.5) * 1e3, 2) if lat
                else None,
                "p99_ms": round(_percentile(lat, 0.99) * 1e3, 2) if lat
                else None}

    end = duration + 1e9
    return {
        "mode": "chaos", "model": model, "replicas": replicas,
        "offered_qps": qps, "duration_s": duration,
        "deadline_ms": deadline_ms, "hedge_ms": hedge_ms,
        "kill_at_s": round(kill_off, 2) if kill_off else None,
        "recovered_at_s": round(rec_off, 2) if rec_off else None,
        "recovery_s": round(rec_off - kill_off, 2)
        if (kill_off and rec_off) else None,
        "windows": [window("before", 0.0, kill_off or end),
                    window("during", kill_off or end, rec_off or end),
                    window("after", rec_off or end, end)],
        "failovers": fleet_stats["failovers"],
        "breaker_trips": fleet_stats["breaker_trips"],
        "hedges": fleet_stats["hedges"],
        "restarts": sum(r["restarts"]
                        for r in fleet_stats["replicas"].values()),
        "lost": sum(1 for r in records if r[1] == "error"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="closed/open-loop load generator for "
                    "mxnet_tpu_torch.serve")
    ap.add_argument("--model", default="mlp",
                    help="mlp or a model-zoo name (e.g. resnet18_v1)")
    ap.add_argument("--mode", default="both",
                    choices=("closed", "open", "both"))
    ap.add_argument("--device", default="gpu", choices=("gpu", "cpu"),
                    help="where every leg's engines run (default: the "
                         "card; without one, the engine raises)")
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--qps", type=float, default=200.0,
                    help="offered load for open-loop mode")
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--request-rows", type=int, default=1)
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--max-linger-ms", type=float, default=2.0)
    ap.add_argument("--connect", default=None,
                    help="host:port of an external endpoint (skips the "
                         "in-process server)")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per mode instead of the table")
    ap.add_argument("--chaos", action="store_true",
                    help="fleet availability bench: open-loop load over a "
                         "supervised replica fleet, hard-kill one replica "
                         "mid-run, report error rate and p99 before/during/"
                         "after (always prints JSON)")
    ap.add_argument("--replicas", type=int, default=3,
                    help="fleet size for --chaos")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="fleet tail-latency hedge threshold for --chaos")
    ap.add_argument("--cold", action="store_true",
                    help="spawn-to-ready of a ProcReplica child, twice "
                         "(always prints JSON; exits 1 on a retrace)")
    ap.add_argument("--decode", action="store_true",
                    help="autoregressive decode bench: concurrent token "
                         "streams with churn through the paged-KV engine "
                         "and the streaming wire (always prints JSON; "
                         "exits 1 on a program-bound break or a page leak)")
    ap.add_argument("--scale", action="store_true",
                    help="mesh-scaling bench: closed-loop qps through "
                         "tensor-parallel replica groups on dp 1/2/4 mesh "
                         "slices (always prints JSON)")
    ap.add_argument("--ramp", action="store_true",
                    help="open-loop load ramp against an SLO-autoscaled "
                         "sharded fleet: offered qps climbs --qps-lo → "
                         "--qps-hi over --duration; reports scale-out "
                         "events + shed count (always prints JSON)")
    ap.add_argument("--tp", type=int, default=2,
                    help="ranks per tensor-parallel replica group for "
                         "--scale/--ramp")
    ap.add_argument("--groups", type=int, default=4,
                    help="max data-parallel replica groups for --ramp")
    ap.add_argument("--qps-lo", type=float, default=30.0)
    ap.add_argument("--qps-hi", type=float, default=450.0)
    ap.add_argument("--obs-overhead", action="store_true",
                    help="telemetry cost: closed-loop qps with obs off vs "
                         "on at --sample (always prints JSON)")
    ap.add_argument("--sample", type=float, default=0.1,
                    help="head-sampling rate for --obs-overhead")
    ap.add_argument("--wire-hop", action="store_true",
                    help="client p50 minus execute time per request "
                         "(always prints JSON)")
    ap.add_argument("--prof-overhead", action="store_true",
                    help="tail buffering + sampling profiler cost on top "
                         "of recording (always prints JSON)")
    ap.add_argument("--hz", type=float, default=None,
                    help="profiler rate for --prof-overhead (default "
                         "MXNET_OBS_PROF_HZ, 67)")
    args = ap.parse_args(argv)

    if args.scale:
        res = run_scale_bench(model=args.model, tp=args.tp,
                              duration=args.duration,
                              clients=max(args.clients, 16),
                              max_batch_size=args.max_batch_size,
                              device=args.device)
        print(json.dumps(res, indent=1))
        return 0
    if args.ramp:
        res = run_ramp_bench(model=args.model,
                             duration=max(args.duration, 10.0),
                             qps_lo=args.qps_lo, qps_hi=args.qps_hi,
                             groups=args.groups, tp=args.tp,
                             max_batch_size=args.max_batch_size,
                             deadline_ms=args.deadline_ms or 2000.0,
                             device=args.device)
        print(json.dumps(res, indent=1))
        return 0
    if (args.obs_overhead or args.wire_hop or args.prof_overhead) \
            and args.connect:
        # these legs toggle THIS process's telemetry around an in-process
        # stack: a remote endpoint's cannot be flipped from here
        ap.error("--obs-overhead/--wire-hop/--prof-overhead measure an "
                 "in-process stack and cannot target --connect")
    if args.obs_overhead:
        res = run_obs_overhead(model=args.model, duration=args.duration,
                               sample=args.sample, clients=args.clients,
                               max_batch_size=args.max_batch_size,
                               request_rows=args.request_rows,
                               device=args.device)
        print(json.dumps(res, indent=1))
        return 0
    if args.wire_hop:
        res = run_wire_hop(model=args.model, duration=args.duration,
                           clients=args.clients,
                           max_batch_size=args.max_batch_size,
                           request_rows=args.request_rows,
                           device=args.device)
        print(json.dumps(res, indent=1))
        return 0
    if args.prof_overhead:
        res = run_prof_overhead(model=args.model, duration=args.duration,
                                hz=args.hz, clients=args.clients,
                                max_batch_size=args.max_batch_size,
                                request_rows=args.request_rows,
                                device=args.device)
        print(json.dumps(res, indent=1))
        return 0

    if args.cold:
        res = run_cold_bench(model=args.model,
                             max_batch_size=args.max_batch_size,
                             device=args.device)
        print(json.dumps(res, indent=1))
        if not res["ok"]:
            print(f"WARNING: the warm replica ran "
                  f"{res['fresh_compiles_warm']} fresh programs of "
                  f"{res['compiles_warm']} (cold: "
                  f"{res['fresh_compiles_cold']}) — the cache did not "
                  "serve it", file=sys.stderr)
            return 1
        return 0

    if args.decode:
        if args.connect:
            ap.error("--decode builds an in-process decode stack and "
                     "cannot target --connect")
        res = run_decode_bench(duration=args.duration,
                               clients=args.clients, device=args.device)
        print(json.dumps(res, indent=1))
        print(f"decode: {res['decode_tokens_per_s']} tok/s, "
              f"per-token p50 {res['decode_p50_per_token_ms']} ms / "
              f"p99 {res['decode_p99_per_token_ms']} ms, ttft p50 "
              f"{res['ttft_ms_p50']} ms, occupancy {res['occupancy']}, "
              f"{res['compiled_programs']} programs for "
              f"{len(res['buckets'])} buckets", file=sys.stderr)
        if not res["program_bound_ok"] or res["pages_leaked"]:
            print("WARNING: decode invariant broke — "
                  f"program_bound_ok={res['program_bound_ok']} "
                  f"pages_leaked={res['pages_leaked']}", file=sys.stderr)
            return 1
        return 0

    if args.chaos:
        res = run_chaos_bench(model=args.model, duration=args.duration,
                              qps=args.qps, replicas=args.replicas,
                              max_batch_size=args.max_batch_size,
                              max_linger_ms=args.max_linger_ms,
                              deadline_ms=args.deadline_ms or 500.0,
                              request_rows=args.request_rows,
                              hedge_ms=args.hedge_ms, device=args.device)
        print(json.dumps(res, indent=1))
        return 0

    modes = ("closed", "open") if args.mode == "both" else (args.mode,)
    results = []
    for mode in modes:
        res = run_bench(model=args.model, mode=mode, duration=args.duration,
                        clients=args.clients, qps=args.qps,
                        max_batch_size=args.max_batch_size,
                        max_linger_ms=args.max_linger_ms,
                        deadline_ms=args.deadline_ms,
                        request_rows=args.request_rows,
                        connect=args.connect, device=args.device)
        results.append(res)
        if args.json:
            print(json.dumps(res))
    if not args.json:
        cols = ("qps", "offered_qps", "p50_ms", "p95_ms", "p99_ms",
                "max_ms", "completed", "shed", "errors",
                "compiled_programs")
        print(f"{'metric':<18}" + "".join(f"{m:>14}" for m in modes))
        for c in cols:
            vals = [r.get(c, "-") for r in results]
            if all(v in ("-", None) for v in vals):
                continue
            print(f"{c:<18}" + "".join(
                f"{('-' if v is None else v):>14}" for v in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
