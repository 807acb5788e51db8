"""Sharding rules: parameter-name regexes -> partition specs (counterpart
of ``mxnet_tpu/parallel/sharding.py``).

:class:`PartitionSpec` (``P``) names one mesh axis, a tuple of axes or
None per array dimension, as ``jax.sharding.PartitionSpec`` does, and a
:class:`NamedSharding` pairs a spec with its mesh. Specs are pruned
against the mesh as in the reference: an axis the mesh lacks, or whose
size does not divide the dimension, becomes None, so one rule table
serves every mesh. On the port's one-device meshes each spec therefore
places the whole array on the one device.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from .mesh import Mesh

__all__ = ["PartitionSpec", "P", "NamedSharding", "ShardingRules",
           "param_sharding", "batch_sharding", "replicated"]


class PartitionSpec(tuple):
    """One mesh axis (or tuple of axes, or None) per array dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A partition spec over a mesh."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def device(self):
        """The device that holds the array (the port's meshes have
        one)."""
        return self.mesh.devices.flat[0]

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


class ShardingRules:
    """Ordered (regex, PartitionSpec) table; first match wins.

    Specs may name mesh axes absent from the actual mesh: those collapse
    to None (replicated).
    """

    def __init__(self, rules: Optional[Sequence[Tuple[str, P]]] = None,
                 default: P = P()):
        self.rules: List[Tuple[re.Pattern, P]] = [
            (re.compile(pat), spec) for pat, spec in (rules or [])]
        self.default = default

    def add(self, pattern: str, spec: P) -> "ShardingRules":
        self.rules.append((re.compile(pattern), spec))
        return self

    def spec_for(self, name: str, shape=None,
                 mesh: Optional[Mesh] = None) -> P:
        for pat, spec in self.rules:
            if pat.search(name):
                return _prune(spec, mesh, shape)
        return _prune(self.default, mesh, shape)

    def sharding_for(self, name: str, mesh: Mesh,
                     shape=None) -> NamedSharding:
        return NamedSharding(mesh, self.spec_for(name, shape, mesh))

    def tree_shardings(self, mesh: Mesh, named_shapes: Dict[str, tuple]):
        return {name: self.sharding_for(name, mesh, shape)
                for name, shape in named_shapes.items()}


def _prune(spec: P, mesh: Optional[Mesh], shape=None) -> P:
    """Drop axes not present in the mesh or not dividing the dim size."""
    if mesh is None:
        return spec
    sizes = mesh.shape
    out = []
    for i, ax in enumerate(spec):
        keep = None
        if ax is not None:
            axs = ax if isinstance(ax, tuple) else (ax,)
            if all(a in sizes for a in axs):
                total = 1
                for a in axs:
                    total *= sizes[a]
                if shape is None or (i < len(shape)
                                     and shape[i] % total == 0):
                    keep = ax
        out.append(keep)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def param_sharding(mesh: Mesh, rules: ShardingRules,
                   named_shapes: Dict[str, tuple]):
    return rules.tree_shardings(mesh, named_shapes)


def batch_sharding(mesh: Mesh, spec: P = P("dp"),
                   shape=None) -> NamedSharding:
    """Sharding for a batch-leading array; ``shape`` prunes axes that do
    not divide the corresponding dim."""
    return NamedSharding(mesh, _prune(spec, mesh, shape))
