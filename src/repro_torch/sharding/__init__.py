"""Sharding stack of the port (``src/repro/sharding``): logical-axis rules
and their resolution against a mesh's shape, the parameter / batch / cache
layouts (parameters, batches and serving caches placed on a
``DeviceMesh``), the interconnect-aware layout ranking, int8 gradient
compression and the GPipe executor over ``torch.distributed``."""
from .annotate import (
    logical_axis_rules, shard, resolve_spec, current_mesh, current_rules,
    DEFAULT_RULES, LONG_CONTEXT_RULES, SERVING_RULES, MeshShape,
    PartitionSpec, as_mesh_shape, NamedSharding, placements,
)
from .rules import (param_specs, param_shardings, batch_specs, cache_specs,
                    distribute_params, distribute_batch, distribute_cache)

__all__ = [
    "logical_axis_rules", "shard", "resolve_spec", "current_mesh",
    "current_rules", "DEFAULT_RULES", "LONG_CONTEXT_RULES", "SERVING_RULES",
    "MeshShape", "PartitionSpec", "as_mesh_shape",
    "param_specs", "param_shardings", "batch_specs", "cache_specs",
    "NamedSharding", "placements", "distribute_params", "distribute_batch",
    "distribute_cache",
]
