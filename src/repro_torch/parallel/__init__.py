from .api import (activation_spec, constrain_activations,
                  implicit_replication, set_activation_spec,
                  set_state_rules, shard_state)
from .sharding import (MeshShape, ShardingRules, batch_spec, data_shardings,
                       default_rules, distribute, full_tensor, local_block,
                       local_shape, param_shardings, placements, spec_for,
                       tree_shardings)

__all__ = ["ShardingRules", "MeshShape", "default_rules", "spec_for",
           "param_shardings", "tree_shardings", "data_shardings",
           "batch_spec", "placements", "local_block", "local_shape",
           "distribute", "full_tensor", "set_activation_spec",
           "activation_spec", "constrain_activations",
           "implicit_replication", "set_state_rules", "shard_state"]
