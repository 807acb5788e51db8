"""ShardingLinter — static checks of PartitionSpec rule tables vs a mesh
(counterpart of ``mxnet_tpu/analysis/sharding.py``, same rule ids).

``parallel.ShardingRules`` deliberately *prunes* silently (axes missing
from the mesh or not dividing a dim collapse to replicated) so one rule
table serves every mesh. That tolerance hides real deployment bugs: a
typo'd axis name replicates a 30B-param matrix on every chip without a
peep. This linter surfaces exactly what pruning dropped and which large
parameters ended up fully replicated. It reads the port's
``parallel.ShardingRules`` (``rules``, ``default``) and ``parallel.Mesh``
(``axis_names``, ``devices``); building a mesh forms no process group, so
it runs anywhere.

Rule ids:

- ``spec-rank-mismatch``     spec has more axes than the param has dims (error)
- ``unknown-mesh-axis``      spec names an axis the mesh doesn't have (warning)
- ``indivisible-dim``        dim size not divisible by the mesh axis (warning)
- ``replicated-large-param`` big param left fully replicated on a >1-device
                             mesh (warning)
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .findings import Finding, Report, Severity

__all__ = ["ShardingLinter"]


class ShardingLinter:
    def __init__(self, mesh, rules, large_param_threshold: int = 1 << 20):
        self.mesh = mesh
        self.rules = rules
        self.large_param_threshold = int(large_param_threshold)

    def _raw_spec(self, name: str):
        for pat, spec in self.rules.rules:
            if pat.search(name):
                return spec
        return self.rules.default

    def lint(self, named_shapes: Dict[str, tuple]) -> Report:
        report = Report()
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        mesh_ndev = int(np.prod(self.mesh.devices.shape))
        for name, shape in named_shapes.items():
            shape = tuple(shape)
            spec = self._raw_spec(name)
            if len(spec) > len(shape):
                report.add(Finding(
                    "spec-rank-mismatch", Severity.ERROR,
                    f"param {name!r} has rank {len(shape)} {shape} but its "
                    f"rule spec {spec} names {len(spec)} dims",
                    node=name,
                    fix_hint="trim the PartitionSpec or fix the rule regex "
                             "so it matches the intended params"))
                continue
            any_sharded = False
            for i, ax in enumerate(spec):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                missing = [a for a in axes if a not in sizes]
                if missing:
                    report.add(Finding(
                        "unknown-mesh-axis", Severity.WARNING,
                        f"param {name!r} dim {i} spec {ax!r}: mesh has no "
                        f"axis {missing} (mesh axes: {sorted(sizes)}); the "
                        "dim silently replicates",
                        node=name,
                        fix_hint="add the axis to make_mesh(...) or drop it "
                                 "from the rule"))
                    continue
                total = 1
                for a in axes:
                    total *= sizes[a]
                if total > 1 and shape[i] % total != 0:
                    report.add(Finding(
                        "indivisible-dim", Severity.WARNING,
                        f"param {name!r} dim {i} (size {shape[i]}) is not "
                        f"divisible by mesh axis {ax!r} (size {total}); the "
                        "dim silently replicates",
                        node=name,
                        fix_hint="pad the dim to a multiple of the axis "
                                 "size, or reshape the mesh"))
                    continue
                if total > 1:
                    any_sharded = True
            n_elem = int(np.prod(shape)) if shape else 1
            if not any_sharded and mesh_ndev > 1 \
                    and n_elem >= self.large_param_threshold:
                mb = n_elem * 4 / 2**20
                report.add(Finding(
                    "replicated-large-param", Severity.WARNING,
                    f"param {name!r} ({n_elem:,} elems, ~{mb:.0f} MiB fp32) "
                    f"is fully replicated across {mesh_ndev} devices",
                    node=name,
                    fix_hint="add a sharding rule for it (e.g. shard the "
                             "output dim over 'tp')"))
        return report

    def lint_params(self, params) -> Report:
        """Convenience: accept an iterable of gluon Parameters."""
        shapes = {}
        for p in params:
            if getattr(p, "shape", None):
                shapes[p.name] = tuple(p.shape)
        return self.lint(shapes)
