"""Sharding rules: parameter-name regexes -> partition specs (counterpart
of ``mxnet_tpu/parallel/sharding.py``).

:class:`PartitionSpec` (``P``) names one mesh axis, a tuple of axes or
None per array dimension, as ``jax.sharding.PartitionSpec`` does, and a
:class:`NamedSharding` pairs a spec with its mesh. Specs are pruned
against the mesh as in the reference: an axis the mesh lacks, or whose
size does not divide the dimension, becomes None, so one rule table
serves every mesh. A :class:`NamedSharding`'s ``placements`` are the
pruned spec as ``DTensor`` placements, one per mesh dimension:
``Shard(d)`` where the spec puts that axis on array dimension ``d``,
``Replicate()`` elsewhere.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

from .mesh import Mesh

__all__ = ["PartitionSpec", "P", "NamedSharding", "ShardingRules",
           "param_sharding", "batch_sharding", "replicated", "batch_local",
           "shard_local", "is_replicated"]


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
    def placements(self):
        """One ``DTensor`` placement per mesh dimension. Axes that share
        an array dimension shard it in mesh order, as a tuple of axes in
        the mesh's order does in the reference; another order raises."""
        from torch.distributed.tensor import Replicate, Shard

        dims = {}
        for i, part in enumerate(self.spec):
            axs = part if isinstance(part, tuple) else (part,)
            for a in axs:
                if a is not None:
                    dims[a] = i
            named = [a for a in axs if a is not None]
            if named != sorted(named, key=self.mesh.axis_names.index):
                raise ValueError(
                    f"{self.spec!r}: axes {tuple(named)} shard one dimension "
                    f"out of the mesh's order {self.mesh.axis_names}")
        return tuple(Shard(dims[a]) if a in dims else Replicate()
                     for a in self.mesh.axis_names)

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


def is_replicated(placements) -> bool:
    return all(p.is_replicate() for p in placements)


def shard_local(full, mesh: Mesh, placements):
    """This rank's piece of ``full`` (a tensor every rank of ``mesh``
    holds whole) as a ``DTensor`` with ``placements``."""
    from torch.distributed.tensor import DTensor

    dm = mesh.device_mesh
    coord = dm.get_coordinate()
    local = full
    for i, pl in enumerate(placements):
        if pl.is_shard():
            local = local.chunk(dm.size(i), dim=pl.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), dm, list(placements),
                              run_check=False, shape=full.shape,
                              stride=full.contiguous().stride())


def batch_local(fn, data, *params):
    """``fn(data, *params)`` for an op that treats each row of the batch
    (dim 0) on its own, such as a convolution or a pooling. When ``data``
    is a ``DTensor`` sharded over the batch dim only and ``params`` are
    replicated, each rank runs ``fn`` on its own rows (the parameters'
    gradients are partial sums over the batch's mesh dims) and the result
    keeps ``data``'s placements: DTensor's rule for strided, padded
    convolutions refuses a batch-sharded input on torch 2.11. Any other
    input goes to ``fn`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(data, DTensor):
        return fn(data, *params)
    pl = data.placements
    if any(p.is_partial() or (p.is_shard() and p.dim % data.ndim != 0)
           for p in pl) or any(
               isinstance(q, DTensor) and not all(r.is_replicate()
                                                  for r in q.placements)
               for q in params):
        return fn(data, *params)
    grads = [Partial() if p.is_shard() else Replicate() for p in pl]
    local = [q.to_local(grad_placements=grads) if isinstance(q, DTensor)
             else q for q in params]
    out = fn(data.to_local(), *local)
    return DTensor.from_local(out, data.device_mesh, pl, run_check=False)
