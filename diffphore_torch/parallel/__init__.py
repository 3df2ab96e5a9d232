"""Scale-out over processes: data-parallel training on several cards and
striped or multi-card screening (the JAX package's ``parallel`` over a
``jax.sharding.Mesh``)."""

from .mesh import DataShard, init_process_group, shard_records, shard_rows  # noqa: F401
