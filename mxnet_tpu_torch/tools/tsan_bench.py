#!/usr/bin/env python
"""Measure the runtime lock-order sanitizer's overhead (counterpart of
``tools/tsan_bench.py``).

    python -m mxnet_tpu_torch.tools.tsan_bench [--iters N] [--cv-iters N]

Three workloads, each timed with plain ``threading`` primitives and with
the ``mxnet_tpu_torch.tsan`` instrumented ones:

1. uncontended acquire/release (the hot path every instrumented ``with``
   pays: bookkeeping + first-edge graph updates);
2. a 4-thread contended counter (lock handoff + waiting-table churn);
3. a producer/consumer Condition ping-pong (wait/notify through the
   watchdog registration path).

Prints per-op costs and the relative overhead, plus the sanitizer's own
accounting (edges recorded, violations — expected 0 on healthy code).
The numbers quantify what a ``MXNET_TSAN=1`` chaos run costs; the
sanitizer is not meant for the serving hot path in production. These are
host numbers: no device is touched. ``--json`` prints one JSON line (the
per-op nanoseconds and overheads) after the table.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from .. import tsan


def bench_uncontended(make_lock, n: int) -> float:
    lk = make_lock()
    t0 = time.perf_counter()
    for _ in range(n):
        with lk:
            pass
    return (time.perf_counter() - t0) / n


def bench_contended(make_lock, n: int, workers: int = 4) -> float:
    lk = make_lock()
    count = [0]

    def worker(iters):
        for _ in range(iters):
            with lk:
                count[0] += 1

    threads = [threading.Thread(target=worker, args=(n // workers,))
               for _ in range(workers)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise RuntimeError("contended bench wedged")
    elapsed = time.perf_counter() - t0
    assert count[0] == (n // workers) * workers
    return elapsed / count[0]


def bench_condition(make_cv, n: int) -> float:
    cv = make_cv()
    state = [0]  # 0: producer's turn, 1: consumer's turn

    def consumer():
        for _ in range(n):
            with cv:
                while state[0] == 0:
                    cv.wait(timeout=5)
                state[0] = 0
                cv.notify_all()

    t = threading.Thread(target=consumer)
    t.start()
    t0 = time.perf_counter()
    for _ in range(n):
        with cv:
            while state[0] == 1:
                cv.wait(timeout=5)
            state[0] = 1
            cv.notify_all()
    t.join(timeout=10)
    if t.is_alive():
        raise RuntimeError("condition bench wedged")
    return (time.perf_counter() - t0) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="lock-order sanitizer overhead report")
    ap.add_argument("--iters", type=int, default=200_000,
                    help="acquire/release iterations (default 200k)")
    ap.add_argument("--cv-iters", type=int, default=5_000,
                    help="condition ping-pong rounds (default 5k)")
    ap.add_argument("--json", action="store_true",
                    help="also print one JSON line of the results")
    args = ap.parse_args(argv)

    tsan.reset()
    tsan.set_strict(False)
    rows = []
    for name, plain, san, n in (
            ("uncontended lock", lambda: bench_uncontended(
                threading.Lock, args.iters),
             lambda: bench_uncontended(
                 lambda: tsan.SanLock("bench.lock"), args.iters),
             args.iters),
            ("contended lock (4 threads)", lambda: bench_contended(
                threading.Lock, args.iters),
             lambda: bench_contended(
                 lambda: tsan.SanLock("bench.contended"), args.iters),
             args.iters),
            ("condition ping-pong", lambda: bench_condition(
                threading.Condition, args.cv_iters),
             lambda: bench_condition(
                 lambda: tsan.SanCondition("bench.cv"), args.cv_iters),
             args.cv_iters)):
        base = plain()
        inst = san()
        rows.append((name, base, inst, n))

    print("lock-order sanitizer overhead (MXNET_TSAN=1 instrumented "
          "primitives vs plain threading):")
    print(f"{'workload':<30} {'plain/op':>12} {'tsan/op':>12} {'overhead':>10}")
    for name, base, inst, _n in rows:
        over = (inst / base - 1.0) * 100 if base > 0 else float("inf")
        print(f"{name:<30} {base * 1e9:>10.0f}ns {inst * 1e9:>10.0f}ns "
              f"{over:>9.0f}%")
    viols = tsan.violations()
    print(f"order-graph violations during bench: {len(viols)} (expect 0)")
    if args.json:
        print(json.dumps({"tsan_bench": [
            {"workload": name, "ops": n, "plain_ns": base * 1e9,
             "tsan_ns": inst * 1e9,
             "overhead_pct": (inst / base - 1.0) * 100 if base > 0 else None}
            for name, base, inst, n in rows],
            "violations": len(viols)}), flush=True)
    return 1 if viols else 0


if __name__ == "__main__":
    sys.exit(main())
