from .adamw import (AdamWState, adamw_from_jax_numpy, adamw_init,
                    adamw_update, clip_by_global_norm, tree_leaves, tree_map)
from .schedule import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "AdamWState",
           "adamw_from_jax_numpy", "clip_by_global_norm", "cosine_schedule",
           "tree_leaves", "tree_map"]
