"""Repo self-lint: framework invariants over the ``mxnet_tpu_torch/``
source (counterpart of the reference's ``tools/lint_repo.py``).

Runs all three source-level linters and merges their reports:

- ``analysis.repo_lint`` — op purity invariants (ndarray_inputs
  declared, no host calls on tensor inputs, no bare ``except:``);
- ``analysis.concurrency`` — lock-order cycles, blocking calls under
  locks, CV/thread discipline, wire-protocol registry checks;
- ``analysis.dataplane`` — hot-path copy/sync/allocation rules, resource
  lifetime, env-registry drift against ``runtime._ENV_REGISTRY``.

Exit status 1 on any unwaived finding (waived findings are reported at
info severity but never fail)::

    python -m mxnet_tpu_torch.tools.lint_repo           # lint mxnet_tpu_torch/
    python -m mxnet_tpu_torch.tools.lint_repo path/to/file.py --json
"""
import argparse
import sys

from ..analysis import concurrency, dataplane, repo_lint
from ..analysis.findings import Report


def lint(paths, exclude=()) -> Report:
    """The merged report of the three source linters over ``paths``."""
    report = Report()
    report.extend(repo_lint.lint_paths(paths, exclude=exclude))
    report.extend(concurrency.lint_paths(paths, exclude=exclude))
    report.extend(dataplane.lint_paths(paths, exclude=exclude))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.lint_repo",
        description="mxnet_tpu_torch repo self-lint (framework, "
                    "concurrency and data-plane invariants)")
    ap.add_argument("paths", nargs="*", default=["mxnet_tpu_torch"],
                    help="files or directories to lint (default: "
                         "mxnet_tpu_torch)")
    ap.add_argument("--exclude", action="append", default=[],
                    help="path substring to skip")
    ap.add_argument("--json", action="store_true", help="JSON output")
    args = ap.parse_args(argv)
    report = lint(args.paths or ["mxnet_tpu_torch"], exclude=args.exclude)
    print(report.to_json() if args.json else report.format())
    bad = concurrency.unwaived(report)
    if len(bad) != len(report):
        print(f"{len(bad)} unwaived finding(s), "
              f"{len(report) - len(bad)} waived")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
