"""Distribution layer: divisibility-aware sharding rules, the explicit
:class:`ShardPolicy`, the ambient serving mesh and the training step's
global-batch scope."""
from .autoshard import (BatchStats, batch_stats, gather, get_mesh,
                        get_shard_policy, global_batch, in_manual,
                        local_stats, manual, mesh_axis_size, mesh_tiles,
                        model_block, set_mesh, sum_grad, train_mesh,
                        use_mesh)
from .sharding import (ShardPolicy, batch_specs, cache_specs, expert_block,
                       gather_leaf, local_slice, param_specs, pick_spec,
                       shard_tree, state_specs, unshard_tree)

__all__ = [
    "ShardPolicy", "param_specs", "batch_specs", "cache_specs",
    "state_specs", "local_slice", "gather_leaf", "shard_tree",
    "unshard_tree", "pick_spec", "get_mesh", "get_shard_policy",
    "in_manual", "manual", "mesh_axis_size", "set_mesh", "use_mesh",
    "global_batch", "batch_stats", "BatchStats", "train_mesh",
    "local_stats", "gather", "sum_grad", "expert_block", "mesh_tiles",
    "model_block",
]
