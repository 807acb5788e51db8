"""Training over a device mesh (counterpart of ``mxnet_tpu/parallel/``):
:mod:`mesh` (``make_mesh`` over the ranks of a job, ``mesh_slices`` and
the mesh scope), :mod:`sharding` (rule tables of partition specs and
their ``DTensor`` placements), :mod:`functional` (``functionalize``: a
Gluon block as a function of its parameters), :mod:`train_step`
(``ShardedTrainer``: forward, backward and update of a Gluon block on
``dp``/``sp``/``tp`` meshes) and :mod:`ring_attention` (sequence
parallelism over ``sp``). One process runs each mesh device; the serving
plane's sharded engines and replica groups are ``serve/engine.py``'s and
``serve/group.py``'s."""
from .mesh import (Mesh, make_mesh, mesh_axes,  # noqa: F401
                   local_device_count, mesh_scope, current_mesh,
                   mesh_slices)
from .sharding import (P, PartitionSpec, NamedSharding,  # noqa: F401
                       ShardingRules, param_sharding, batch_sharding,
                       replicated)
from .functional import functionalize  # noqa: F401
from .train_step import ShardedTrainer  # noqa: F401
from .ring_attention import (ring_attention,  # noqa: F401
                             sequence_sharded_attention)
