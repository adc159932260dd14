from .sharding import (LOGICAL_RULES, OPT_RULES, STRATEGIES, MeshContext, Sharding,
                       batch_axes, current_mesh, current_rules, logical_to_sharding,
                       mesh_context, place, shard_activation, shard_params)
