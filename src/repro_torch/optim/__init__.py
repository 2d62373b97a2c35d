from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, cosine_lr, global_norm,
    placed_like, tree_leaves, tree_map, tree_unflatten,
)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "placed_like", "tree_leaves", "tree_map", "tree_unflatten"]
