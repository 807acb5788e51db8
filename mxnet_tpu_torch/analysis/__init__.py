"""``mxnet_tpu_torch.analysis`` — graph and trace static analysis
(pre-flight lint), the counterpart of ``mxnet_tpu/analysis/`` with the
same file layout, public names and rule ids.

The reference front-loads graph validation in C++ NNVM passes
(FInferShape/FInferType reject bad graphs before the Executor runs); this
package catches both late crashes and *silent* perf bugs before a graph
runs:

- :class:`GraphLinter` — pass-based lint over Symbol graphs (shape/dtype
  pre-flight on ``meta`` tensors with per-node attribution, dead nodes,
  duplicate names, non-differentiable ops on the gradient path, numeric
  idioms, fan-out);
- :class:`TraceLinter` — hybridize hygiene for HybridBlocks (retrace
  churn, host syncs in a forward, weak-dtype promotion) and the program
  bounds of the fused update, serve and decode engines;
- :class:`ShardingLinter` — PartitionSpec rule tables vs the mesh
  (unknown axes, indivisible dims, accidentally replicated large params);
- repo self-lint (``repo_lint``; ``python -m
  mxnet_tpu_torch.tools.lint_repo``) — framework invariants over the
  source tree itself;
- concurrency lint (``python -m mxnet_tpu_torch.analysis concurrency``) —
  lock-order cycles, blocking-under-lock, CV/thread discipline, and the
  wire-protocol registry checks over the threaded serve/PS planes;
- data-plane lint (``python -m mxnet_tpu_torch.analysis dataplane``) —
  hot-path host syncs and copies, unbounded growth, resource lifetime,
  and ``MXNET_*`` reads against ``runtime._ENV_REGISTRY``.

The findings datatypes (``findings.py``) also carry the training-health
plane's blame pass (``obs/health.py``).

User surfaces: ``Symbol.lint(...)``, ``HybridBlock.lint(...)``,
``bind(..., lint="warn"|"error")``, ``InferenceEngine(lint=)``,
``python -m mxnet_tpu_torch.analysis graph.json``.
"""
from . import concurrency  # noqa: F401  (the lock/protocol linter)
from . import dataplane  # noqa: F401  (the copy/sync/allocation linter)
from .findings import Finding, GraphAnalysisError, Report, Severity  # noqa: F401
from .graph import GraphView, NodeInfo  # noqa: F401
from .graph_passes import GraphLinter, LintContext, graph_pass, list_passes  # noqa: F401
from .shape_infer import InferResult, infer_graph  # noqa: F401
from .sharding import ShardingLinter  # noqa: F401
from .trace import TraceLinter  # noqa: F401

__all__ = [
    "Finding", "GraphAnalysisError", "Report", "Severity",
    "GraphView", "NodeInfo",
    "GraphLinter", "LintContext", "graph_pass", "list_passes",
    "ShardingLinter", "TraceLinter", "concurrency", "dataplane",
]
