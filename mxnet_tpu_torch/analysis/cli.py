"""CLI for the static analyzer: ``python -m mxnet_tpu_torch.analysis``
(counterpart of ``mxnet_tpu/analysis/cli.py``).

Lints a serialized Symbol graph (``Symbol.tojson()`` / ``Symbol.save``)
without binding or compiling it::

    python -m mxnet_tpu_torch.analysis model-symbol.json --shape data=1,3,224,224
    python -m mxnet_tpu_torch.analysis --self-lint      # repo invariants
    python -m mxnet_tpu_torch.analysis concurrency      # lock/protocol lint
    python -m mxnet_tpu_torch.analysis dataplane        # copy/sync lint
    python -m mxnet_tpu_torch.analysis concurrency --list-rules
    python -m mxnet_tpu_torch.analysis --list-rules

Exit status: 0 clean, 1 findings at/above --fail-on (default: error).
"""
from __future__ import annotations

import argparse
import sys

from .findings import Severity

__all__ = ["main"]


def _parse_shapes(items):
    shapes = {}
    for item in items or ():
        if "=" not in item:
            raise SystemExit(f"--shape wants name=d0,d1,...; got {item!r}")
        name, dims = item.split("=", 1)
        shapes[name] = tuple(int(d) for d in dims.split(",") if d != "")
    return shapes


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # subcommand dispatch: `concurrency` is the lock/protocol linter,
    # `dataplane` the copy/sync/allocation linter (each has its own flags)
    if argv and argv[0] == "concurrency":
        from .concurrency import main as concurrency_main

        return concurrency_main(list(argv[1:]))
    if argv and argv[0] == "dataplane":
        from .dataplane import main as dataplane_main

        return dataplane_main(list(argv[1:]))
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis",
        description="Pre-flight lint for Symbol graphs (no compilation).")
    ap.add_argument("graph", nargs="?", help="path to a tojson() graph file")
    ap.add_argument("--shape", action="append", metavar="name=d0,d1,...",
                    help="input shape, repeatable (enables shape pre-flight)")
    ap.add_argument("--passes", help="comma-separated pass subset")
    ap.add_argument("--disable", help="comma-separated rule ids to drop")
    ap.add_argument("--fail-on", choices=[Severity.ERROR, Severity.WARNING,
                                          Severity.INFO],
                    default=Severity.ERROR,
                    help="lowest severity that makes the exit status 1")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--self-lint", action="store_true",
                    help="run the repo self-lint instead of a graph lint")
    ap.add_argument("--list-rules", action="store_true",
                    help="print pass names and their rule ids")
    args = ap.parse_args(argv)

    if args.self_lint:
        from .repo_lint import main as repo_main

        return repo_main((["--json"] if args.json else []))

    from .graph_passes import GraphLinter, list_passes

    if args.list_rules:
        for name, rules in sorted(list_passes().items()):
            print(f"{name}: {', '.join(rules)}")
        return 0
    if not args.graph:
        ap.error("a graph file is required (or --self-lint / --list-rules)")

    with open(args.graph, encoding="utf-8") as f:
        graph_json = f.read()
    options = {}
    if args.disable:
        options["disable"] = {r.strip() for r in args.disable.split(",")}
    passes = [p.strip() for p in args.passes.split(",")] if args.passes \
        else None
    linter = GraphLinter(passes=passes, **options)
    report = linter.lint(graph_json, shapes=_parse_shapes(args.shape))
    print(report.to_json() if args.json else report.format())

    threshold = Severity.rank(args.fail_on)
    worst = min((Severity.rank(f.severity) for f in report),
                default=len(Severity.ORDER))
    return 1 if worst <= threshold else 0


if __name__ == "__main__":
    sys.exit(main())
