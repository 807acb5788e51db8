#!/usr/bin/env python
"""Measured cost of the training-health plane (counterpart of
``tools/health_bench.py``): the number that says whether the divergence
sentinel can stay on.

Runs the same deterministic train-step loop twice — health plane off,
then a ``HealthMonitor`` attached at the sampling period — and reports
the throughput delta as ``health_overhead_pct``, against a 5% budget.
It isolates the plane's marginal cost (the stats computed beside the
update on sampled steps, the batched fetch, the detectors): span tracing
stays off in both. The loop runs on ``mx.gpu(0)``, or on the CPU with
``--device cpu``.

    python -m mxnet_tpu_torch.tools.health_bench [--steps 60] [--every 10]
        [--device gpu|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _build_module(ctx, seed: int, batch: int, in_dim: int, hidden: int,
                  classes: int):
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.module import Module

    np.random.seed(seed)
    mx.random.seed(seed)
    rng = np.random.RandomState(seed)
    X = rng.randn(batch * 4, in_dim).astype(np.float32)
    y = rng.randint(0, classes, batch * 4).astype(np.float32)
    with ctx:
        it = NDArrayIter(X, y, batch_size=batch, label_name="softmax_label")
        batch0 = next(iter(it))
    data = sym.Variable("data")
    net = sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=classes, name="fc2")
    net = sym.SoftmaxOutput(net, name="softmax")
    mod = Module(net, context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.01,
                                         "momentum": 0.9})
    return mod, batch0


def _run_steps(mod, batch0, metric, steps: int, monitor=None) -> float:
    """The fit-shaped hot loop: forward/backward/update/metric (+ the
    health hook when a monitor rides along). Returns wall seconds, the
    card's work included."""
    import torch

    from mxnet_tpu_torch.obs import health as health_mod

    def sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    for step in range(steps):
        mod.forward(batch0, is_train=True)
        mod.backward()
        if monitor is not None:
            health_mod.request_stats(monitor.will_sample())
        mod.update()
        mod.update_metric(metric, batch0.label)
        if monitor is not None:
            monitor.record_metric(metric)
            monitor.step(step, engine=mod._updater._engine)
    sync()
    return time.perf_counter() - t0


def run_health_overhead(steps: int = 60, warmup: int = 10, batch: int = 64,
                        in_dim: int = 256, hidden: int = 512,
                        classes: int = 8, every: int = None,
                        repeats: int = 5, threshold_pct: float = 5.0,
                        device: str = "gpu") -> dict:
    """Off-vs-on fit throughput at the health sampling period. The timed
    windows alternate (off/on/off/on/...) ``repeats`` times, and each
    configuration keeps its best window."""
    import torch

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import metric as metric_mod
    from mxnet_tpu_torch import obs

    ctx = mx.gpu(0) if device == "gpu" else mx.cpu()
    was_enabled = obs.enabled()
    stream = obs.trace.tracer.stream_path
    try:
        obs.disable()
        mod, b0 = _build_module(ctx, 11, batch, in_dim, hidden, classes)
        m = metric_mod.create("ce")
        _run_steps(mod, b0, m, warmup)

        mon = obs.health.HealthMonitor(every=every)
        obs.health.activate()
        try:
            mod2, b2 = _build_module(ctx, 11, batch, in_dim, hidden,
                                     classes)
            m2 = metric_mod.create("ce")
            _run_steps(mod2, b2, m2, warmup, monitor=mon)

            dt_off, dt_on = float("inf"), float("inf")
            for _ in range(max(1, repeats)):
                dt_off = min(dt_off, _run_steps(mod, b0, m, steps))
                dt_on = min(dt_on, _run_steps(mod2, b2, m2, steps,
                                              monitor=mon))
        finally:
            obs.health.request_stats(None)
            obs.health.deactivate()
    finally:
        # leave the caller's telemetry state exactly as found
        if was_enabled:
            obs.enable(jsonl=stream)
        else:
            obs.disable()

    ips_off = steps * batch / dt_off
    ips_on = steps * batch / dt_on
    pct = (ips_off - ips_on) / ips_off * 100.0 if ips_off > 0 else 0.0
    dev = torch.device("cuda", 0) if device == "gpu" else None
    return {"device": (torch.cuda.get_device_name(dev) if dev is not None
                       else "cpu"),
            "steps": steps, "batch": batch, "every": mon.every,
            "repeats": repeats,
            "ips_off": round(ips_off, 1), "ips_on": round(ips_on, 1),
            "health_overhead_pct": round(pct, 2),
            "threshold_pct": threshold_pct,
            "ok": pct < threshold_pct}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--every", type=int, default=None,
                    help="health sampling period (default: "
                         "MXNET_OBS_HEALTH_EVERY or 10)")
    ap.add_argument("--threshold-pct", type=float, default=5.0)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args(argv)
    res = run_health_overhead(steps=args.steps, warmup=args.warmup,
                              batch=args.batch, every=args.every,
                              threshold_pct=args.threshold_pct,
                              device=args.device)
    print(json.dumps(res, indent=2))
    return 0 if res["ok"] else 2


if __name__ == "__main__":
    sys.exit(main())
