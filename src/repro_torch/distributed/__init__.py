"""Distribution layer: divisibility-aware sharding rules, the explicit
:class:`ShardPolicy`, and the ambient serving mesh."""
from .autoshard import (get_mesh, get_shard_policy, in_manual, manual,
                        mesh_axis_size, set_mesh, use_mesh)
from .sharding import (ShardPolicy, batch_specs, cache_specs, local_slice,
                       param_specs, pick_spec)

__all__ = [
    "ShardPolicy", "param_specs", "batch_specs", "cache_specs",
    "local_slice", "pick_spec", "get_mesh", "get_shard_policy",
    "in_manual", "manual", "mesh_axis_size", "set_mesh", "use_mesh",
]
