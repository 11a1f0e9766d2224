"""Parallelism of the port: the column-sharded stencil launch
(``shard_columns``) and the parameter-spec dataclass (``sharding``)."""
