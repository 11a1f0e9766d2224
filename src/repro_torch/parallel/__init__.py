"""Parallelism of the port: the column-sharded stencil launch
(``shard_columns``) and the logical-axis sharding of the model stack
(``sharding``)."""

from .shard_columns import (  # noqa: F401
    column_launcher,
    pick_shard_axis,
    sharded_stencil_call,
)
from .sharding import (  # noqa: F401
    LOGICAL_RULES,
    ParamSpec,
    logical_sharding,
    sharded_struct,
    specs_to_shardings,
    specs_to_structs,
    pad_to_multiple,
)
