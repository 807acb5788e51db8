"""elastic_bench — the elastic training plane's bench (counterpart of the
reference's ``tools/elastic_bench.py``).

All legs run in one process (a ``PSServer`` and ``ElasticWorkerSession``s
on localhost), so no subprocess jitter enters the timings:

- ``run_elastic_bench``: ``elastic_recovery_s``, the wall time from a
  worker going silent (reduce contributions and heartbeats stop, the
  SIGKILL shape) to the survivors' next reduce round completed without
  it; ``rejoin_to_training_s``, a fresh worker's quarantined join to its
  activation at the next epoch boundary; ``elastic_overhead_pct``, the
  membership plane's idle cost (PS push+pull throughput against a server
  with no members vs a twin with ``workers`` heartbeating sessions,
  segments interleaved, best of each side).
- ``run_straggler_bench`` (``--straggler``): a lockstep compute+allreduce
  loop with per-rank fleet accounting on the heartbeats, the last rank's
  compute slowed after two clean windows: the detection latency in
  windows and the fleet's step-time skew.
- ``run_async_bench`` (``--async``): the same slowed fleet over lockstep
  allreduce and over the bounded-staleness wire; the step decoupling of
  each mode.
- ``run_train_obs_overhead`` (``--train-obs``): the fit-shaped step loop
  (every phase through ``fleetstats.phase``, as ``BaseModule.fit``) with
  spans on both sides and the fleet plane vetoed (``MXNET_OBS_FLEET=0``)
  or on, interleaved, best of each side; ``--device gpu`` runs the model
  on the card.

Usage: ``python -m mxnet_tpu_torch.tools.elastic_bench [--workers 3]
[--straggler | --async | --train-obs [--device cpu|gpu]]`` prints one JSON
object and exits 2 when a leg's check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from . import join_all


def _segment(cli, grad, ops: int) -> float:
    t0 = time.perf_counter()
    for _ in range(ops):
        cli.push("bench_w", grad)
        cli.pull("bench_w")
    return ops / (time.perf_counter() - t0)


def run_elastic_bench(workers: int = 3, ops: int = 200, segments: int = 5,
                      hb_interval: float = 0.2, miss_k: int = 3,
                      threshold_pct: float = 5.0) -> dict:
    import numpy as np

    from ..kvstore.elastic import ElasticWorkerSession
    from ..kvstore.ps_client import PSClient
    from ..kvstore.ps_server import PSServer

    srv_plain = PSServer(host="127.0.0.1", port=0, hb_interval=hb_interval,
                         miss_k=miss_k)
    srv_el = PSServer(host="127.0.0.1", port=0, hb_interval=hb_interval,
                      miss_k=miss_k)
    srv_plain.start()
    srv_el.start()
    sessions = []
    try:
        sessions = [ElasticWorkerSession("127.0.0.1", srv_el.port, rank=r,
                                         hb_interval=hb_interval)
                    for r in range(workers)]
        for s in sessions:
            s.ensure_joined(wait_for_expected=False)

        # -- idle overhead: interleaved segments, best-of each side ------
        grad = np.ones(256, np.float32)
        clis = {}
        for name, srv in (("off", srv_plain), ("on", srv_el)):
            clis[name] = PSClient("127.0.0.1", srv.port, timeout=10,
                                  retries=3, retry_interval=0.1)
            clis[name].init("bench_w", np.zeros(256, np.float32))
            _segment(clis[name], grad, ops // 4)  # warm both paths
        qps = {"off": [], "on": []}
        for _ in range(segments):
            for name in ("off", "on"):
                qps[name].append(_segment(clis[name], grad, ops))
        qps_off, qps_on = max(qps["off"]), max(qps["on"])
        overhead_pct = round((qps_off - qps_on) / qps_off * 100.0, 2)

        # -- steady reduce loop, then a SIGKILL-shaped death -------------
        arr = np.ones(1024, np.float32)
        stop = threading.Event()
        victim_stop = threading.Event()
        counts = [0] * workers
        stamps = [0.0] * workers

        def _loop(i):
            s = sessions[i]
            own_stop = victim_stop if i == workers - 1 else stop
            try:
                while not (stop.is_set() or own_stop.is_set()):
                    s.allreduce("bench_g", arr, timeout=30)
                    counts[i] += 1
                    stamps[i] = time.perf_counter()
            except Exception:
                pass  # a declared-dead victim's session errors out

        threads = [threading.Thread(target=_loop, args=(i,), daemon=True)
                   for i in range(workers)]
        for t in threads:
            t.start()
        time.sleep(max(1.0, hb_interval * 5))  # steady state
        t_kill = time.perf_counter()
        victim_stop.set()             # stops contributing...
        sessions[-1]._hb.stop()       # ...and heartbeating: SIGKILL shape
        kill_counts = list(counts)
        # recovery = every survivor completed 2 more rounds (the first may
        # already have held the victim's contribution; the second cannot)
        deadline = time.perf_counter() + 60
        recovery = None
        while time.perf_counter() < deadline:
            if all(counts[i] >= kill_counts[i] + 2
                   for i in range(workers - 1)):
                recovery = max(stamps[:workers - 1]) - t_kill
                break
            time.sleep(0.01)
        stop.set()
        join_all(threads, 30, "elastic workers")

        # -- rejoin: quarantined join → boundary activation --------------
        joiner = ElasticWorkerSession("127.0.0.1", srv_el.port,
                                      rank=workers, hb_interval=hb_interval)
        info = joiner.ensure_joined(wait_for_expected=False)
        t_join = time.perf_counter()
        got = {}

        def _wait():
            got["info"] = joiner.await_activation(timeout=60)
            got["t"] = time.perf_counter()

        wt = threading.Thread(target=_wait, daemon=True)
        wt.start()
        if info.active:  # fleet died down to 0 actives → instant takeover
            join_all([wt], 60, "rejoin wait")
            rejoin_s = 0.0
        else:
            time.sleep(hb_interval)
            enders = [threading.Thread(target=s.epoch_end, args=(0,),
                                       daemon=True) for s in sessions[:-1]]
            for t in enders:
                t.start()
            join_all([wt] + enders, 60, "epoch boundary")
            rejoin_s = got["t"] - t_join if "t" in got else None
        for s in sessions[:-1] + [joiner]:
            s.close()
        return {
            "workers": workers,
            "heartbeat_s": hb_interval,
            "miss_k": miss_k,
            "elastic_recovery_s": (round(recovery, 3)
                                   if recovery is not None else None),
            "rejoin_to_training_s": (round(rejoin_s, 3)
                                     if rejoin_s is not None else None),
            "ps_qps_baseline": round(qps_off, 1),
            "ps_qps_elastic": round(qps_on, 1),
            "elastic_overhead_pct": overhead_pct,
            "threshold_pct": threshold_pct,
            "ok": (recovery is not None and rejoin_s is not None
                   and overhead_pct < threshold_pct),
        }
    finally:
        srv_plain.stop()
        srv_el.stop()


def run_straggler_bench(workers: int = 3, window: int = 4, factor: float = 1.5,
                        k: int = 2, hb_interval: float = 0.05,
                        steps: int = 40, base_s: float = 0.01,
                        slow_s: float = 0.05) -> dict:
    """The straggler leg: ``workers`` in-process elastic sessions run a
    lockstep compute+allreduce step loop with per-rank fleet accounting
    on the heartbeats; the last rank's compute is slowed after two clean
    windows. Reports the detection latency in windows (the verdict's
    window minus the first slowed one, plus one) and the step-time skew."""
    from .. import obs
    from ..kvstore.elastic import ElasticWorkerSession
    from ..kvstore.ps_server import PSServer
    from ..obs import fleetstats

    import numpy as np

    was_enabled = obs.enabled()
    obs.enable()
    srv = PSServer(host="127.0.0.1", port=0, hb_interval=hb_interval,
                   miss_k=3)
    srv.fleet.detector = fleetstats.StragglerDetector(factor=factor, k=k)
    verdicts = []
    srv.fleet.on_straggler(verdicts.append)
    srv.start()
    slow_rank = workers - 1
    slow_from = window * 2 + 1  # two clean windows, then the lag begins
    accs = [fleetstats.StepAccounting(rank=r, window=window,
                                      own_spans=False,
                                      ship_interval_s=hb_interval / 2)
            for r in range(workers)]
    sessions = []
    try:
        sessions = [ElasticWorkerSession(
            "127.0.0.1", srv.port, rank=r, hb_interval=hb_interval,
            part_provider=accs[r].wire_part) for r in range(workers)]
        for s in sessions:
            s.ensure_joined(wait_for_expected=False)
        arr = np.ones(256, np.float32)

        def _loop(r):
            acc, s = accs[r], sessions[r]
            for step in range(1, steps + 1):
                with acc.phase("forward"):
                    time.sleep(slow_s if (r == slow_rank
                                          and step >= slow_from)
                               else base_s)
                with acc.phase("elastic.sync_grads"):
                    s.allreduce("bench_straggle", arr, timeout=60)
                acc.step_complete(step)
            acc.flush()

        threads = [threading.Thread(target=_loop, args=(r,), daemon=True)
                   for r in range(workers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        join_all(threads, 300, "straggler workers")
        time.sleep(max(0.3, hb_interval * 6))  # final ships + judging
        stats = srv.fleet.stats()
        ranks = stats["ranks"]
        med = sorted(v["step_time_avg"] for v in ranks.values())[
            len(ranks) // 2] if ranks else 0.0
        skew = {r: round(v["step_time_avg"] / max(med, 1e-9), 3)
                for r, v in ranks.items()}
        straggler_events = [v for v in verdicts if v["kind"] == "straggler"]
        first = straggler_events[0] if straggler_events else None
        first_slow_window = (slow_from - 1) // window
        detection_windows = (first["window"] - first_slow_window + 1
                             if first else None)
        return {
            "workers": workers,
            "window_steps": window,
            "factor": factor,
            "k": k,
            "flagged_rank": first["rank"] if first else None,
            "blame": first["blame"] if first else None,
            "detection_windows": detection_windows,
            "step_time_skew": skew,
            "wall_s": round(time.perf_counter() - t0, 3),
            "ok": (first is not None and first["rank"] == slow_rank
                   and first["blame"] == "compute"
                   and detection_windows <= k + 2),
        }
    finally:
        for s in sessions:
            try:
                s.close()
            except Exception:  # noqa: BLE001
                pass
        srv.stop()
        if not was_enabled:
            obs.disable()


def run_async_bench(workers: int = 3, steps: int = 24, staleness: int = 16,
                    base_s: float = 0.005, slow_s: float = 0.04,
                    hb_interval: float = 0.05) -> dict:
    """The async decoupling leg: the same fleet twice (``workers`` ranks,
    the last one's compute ``slow_s`` against everyone's ``base_s``),
    once over lockstep elastic allreduce and once over the
    bounded-staleness PS wire (push, committed clock, gated pull).
    ``step_decoupling`` is the slowest rank's median step time over the
    median rank's: ~1 under lockstep, where every rank pays the
    straggler's bill, and well above 1 under async, where only the
    straggler pays."""
    import numpy as np

    from ..kvstore.elastic import ElasticWorkerSession
    from ..kvstore.ps_client import PSClient
    from ..kvstore.ps_server import PSServer

    slow_rank = workers - 1
    grad = np.ones(256, np.float32)

    def _rank_medians(times):
        return [sorted(ts)[len(ts) // 2] if ts else 0.0 for ts in times]

    def _decoupling(times):
        med = _rank_medians(times)
        fleet_med = sorted(med)[len(med) // 2]
        return max(med) / max(fleet_med, 1e-9)

    t0 = time.perf_counter()

    # -- sync: lockstep allreduce — the straggler gates every rank -------
    srv = PSServer(host="127.0.0.1", port=0, hb_interval=hb_interval,
                   miss_k=3)
    srv.start()
    sessions = []
    sync_times = [[] for _ in range(workers)]
    try:
        sessions = [ElasticWorkerSession("127.0.0.1", srv.port, rank=r,
                                         hb_interval=hb_interval)
                    for r in range(workers)]
        for s in sessions:
            s.ensure_joined(wait_for_expected=False)

        def _sync_loop(r):
            for _ in range(steps):
                ts = time.perf_counter()
                time.sleep(slow_s if r == slow_rank else base_s)
                sessions[r].allreduce("bench_async", grad, timeout=60)
                sync_times[r].append(time.perf_counter() - ts)

        threads = [threading.Thread(target=_sync_loop, args=(r,),
                                    daemon=True) for r in range(workers)]
        for t in threads:
            t.start()
        join_all(threads, 300, "sync workers")
    finally:
        for s in sessions:
            try:
                s.close()
            except Exception:  # noqa: BLE001
                pass
        srv.stop()

    # -- async: push + clock + gated pull — only the straggler pays ------
    srv = PSServer(host="127.0.0.1", port=0, hb_interval=hb_interval,
                   miss_k=3, async_staleness=staleness)
    srv.start()
    async_times = [[] for _ in range(workers)]
    clis = []
    try:
        clis = [PSClient("127.0.0.1", srv.port, timeout=30, retries=3,
                         retry_interval=0.1) for _ in range(workers)]
        clis[0].init("bench_async", np.zeros(256, np.float32))

        def _async_loop(r):
            cli = clis[r]
            for step in range(1, steps + 1):
                ts = time.perf_counter()
                time.sleep(slow_s if r == slow_rank else base_s)
                cli.push("bench_async", grad)
                cli.push_clock(r, step)
                cli.pull_stale("bench_async", r, step, staleness,
                               timeout=60)
                async_times[r].append(time.perf_counter() - ts)

        threads = [threading.Thread(target=_async_loop, args=(r,),
                                    daemon=True) for r in range(workers)]
        for t in threads:
            t.start()
        join_all(threads, 300, "async workers")
    finally:
        for c in clis:
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        srv.stop()

    sync_dec = round(_decoupling(sync_times), 3)
    async_dec = round(_decoupling(async_times), 3)
    return {
        "workers": workers,
        "steps": steps,
        "staleness": staleness,
        "slow_rank": slow_rank,
        "base_s": base_s,
        "slow_s": slow_s,
        "sync_rank_median_s": [round(m, 4)
                               for m in _rank_medians(sync_times)],
        "async_rank_median_s": [round(m, 4)
                                for m in _rank_medians(async_times)],
        "sync_step_decoupling": sync_dec,
        "async_step_decoupling": async_dec,
        "wall_s": round(time.perf_counter() - t0, 3),
        # lockstep smears the straggler over the fleet (ratio ~1); the
        # gated wire must isolate it (>=2x, and strictly above sync)
        "ok": (async_dec >= 2.0 and sync_dec <= 1.5
               and async_dec > sync_dec),
    }


def run_train_obs_overhead(steps: int = 250, warmup: int = 30,
                           repeats: int = 7, batch: int = 64,
                           threshold_pct: float = 5.0,
                           device: str = "cpu") -> dict:
    """The train-telemetry overhead leg: the fit-shaped step loop (every
    phase through ``fleetstats.phase`` as ``BaseModule.fit`` does, with
    the backward's device sync) with span tracing on in both
    configurations and the fleet plane vetoed (``MXNET_OBS_FLEET=0``) or
    on: the delta is the plane's own cost (phase accumulation, window
    sealing, ``train.step.*`` histograms). Interleaved, best of each
    side. ``device`` is ``"cpu"`` or ``"gpu"`` (the card)."""
    import numpy as np

    from .. import context as ctx_mod
    from .. import metric as metric_mod
    from .. import obs
    from .. import random as mx_random
    from .. import symbol as sym
    from ..io import NDArrayIter
    from ..module import Module
    from ..obs import fleetstats

    ctx = ctx_mod.gpu() if device == "gpu" else ctx_mod.cpu()
    np.random.seed(17)
    mx_random.seed(17)
    rng = np.random.RandomState(17)
    X = rng.randn(batch * 4, 128).astype(np.float32)
    y = rng.randint(0, 8, batch * 4).astype(np.float32)
    with ctx:
        it = NDArrayIter(X, y, batch_size=batch,
                         label_name="softmax_label")
        batch0 = next(iter(it))
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=256, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=8, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    mod = Module(net, context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01})
    metric = metric_mod.create("ce")

    def _run(n, step0=0):
        t0 = time.perf_counter()
        for i in range(n):
            with fleetstats.phase("data_wait"):
                pass  # synthetic iterator: instant
            mod.forward_backward(batch0)
            with fleetstats.phase("update"):
                mod.update()
            with fleetstats.phase("metric"):
                mod.update_metric(metric, batch0.label)
            fleetstats.step_complete(step0 + i + 1)
        mod._sync_device()
        return time.perf_counter() - t0

    was_enabled = obs.enabled()
    stream = obs.trace.tracer.stream_path
    prev_veto = os.environ.get("MXNET_OBS_FLEET")

    def _veto(v):
        if v:
            os.environ["MXNET_OBS_FLEET"] = "0"
        elif "MXNET_OBS_FLEET" in os.environ:
            del os.environ["MXNET_OBS_FLEET"]

    try:
        obs.enable()  # spans on BOTH sides — the delta is the fleet plane
        _veto(True)
        _run(warmup)
        _veto(False)
        _run(warmup)
        dt_off = dt_on = float("inf")
        for _ in range(max(1, repeats)):
            _veto(True)
            dt_off = min(dt_off, _run(steps))
            _veto(False)
            dt_on = min(dt_on, _run(steps))
        ips_off = steps / dt_off
        ips_on = steps / dt_on
        overhead = (ips_off - ips_on) / ips_off * 100.0
        return {
            "steps": steps,
            "ips_off": round(ips_off, 1),
            "ips_on": round(ips_on, 1),
            "train_obs_overhead_pct": round(overhead, 2),
            "device": device,
            "threshold_pct": threshold_pct,
            "ok": overhead < threshold_pct,
        }
    finally:
        if prev_veto is None:
            os.environ.pop("MXNET_OBS_FLEET", None)
        else:
            os.environ["MXNET_OBS_FLEET"] = prev_veto
        obs.disable()
        if was_enabled:
            obs.enable(jsonl=stream)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--ops", type=int, default=200)
    ap.add_argument("--segments", type=int, default=5)
    ap.add_argument("--heartbeat", type=float, default=0.2)
    ap.add_argument("--miss-k", type=int, default=3)
    ap.add_argument("--straggler", action="store_true",
                    help="run ONLY the straggler-detection leg (one "
                         "slowed worker; detection latency in windows + "
                         "step-time skew)")
    ap.add_argument("--train-obs", action="store_true",
                    help="run ONLY the train-telemetry overhead leg "
                         "(fit-shaped loop, interleaved off/on, <5%% "
                         "gated)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "gpu"),
                    help="where --train-obs runs its model")
    ap.add_argument("--async", dest="async_leg", action="store_true",
                    help="run ONLY the bounded-staleness decoupling leg "
                         "(sync lockstep vs async gated-pull under one "
                         "slowed rank; reports step_decoupling per mode)")
    args = ap.parse_args(argv)
    if args.straggler:
        res = run_straggler_bench(workers=args.workers)
    elif args.async_leg:
        res = run_async_bench(workers=args.workers)
    elif args.train_obs:
        res = run_train_obs_overhead(device=args.device)
    else:
        res = run_elastic_bench(workers=args.workers, ops=args.ops,
                                segments=args.segments,
                                hb_interval=args.heartbeat,
                                miss_k=args.miss_k)
        res["straggler"] = run_straggler_bench(workers=args.workers)
        res["ok"] = res["ok"] and res["straggler"]["ok"]
    print(json.dumps(res, indent=2))
    return 0 if res["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
