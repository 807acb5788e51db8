"""Training steps of the port. This slice holds ``ShardedTrainer`` on one
device; meshes, sharding rules and ring attention belong to a later
slice."""
from .train_step import ShardedTrainer  # noqa: F401
