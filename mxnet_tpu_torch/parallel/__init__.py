"""Training over a device mesh (counterpart of ``mxnet_tpu/parallel/``),
the one-device subset: :mod:`mesh` (``make_mesh`` and the mesh scope),
:mod:`sharding` (rule tables of partition specs), :mod:`functional`
(``functionalize``: a Gluon block as a function of its parameters) and
:mod:`train_step` (``ShardedTrainer``: forward, backward and update of a
Gluon block). Meshes of several cards and ring attention are queue item
A14."""
from .mesh import (Mesh, make_mesh, mesh_axes, local_device_count,  # noqa: F401
                   mesh_scope, current_mesh)
from .sharding import (P, PartitionSpec, NamedSharding,  # noqa: F401
                       ShardingRules, param_sharding, batch_sharding,
                       replicated)
from .functional import functionalize  # noqa: F401
from .train_step import ShardedTrainer  # noqa: F401
