"""Optimizers of the port (counterpart of ``repro.optim``): plain
functions on parameter trees of tensors."""
from repro_torch.optim.optimizers import (OptState, adamw, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          init_opt_state, sgd, tree_leaves,
                                          tree_map)

__all__ = ["OptState", "adamw", "apply_updates", "clip_by_global_norm",
           "global_norm", "init_opt_state", "sgd", "tree_leaves",
           "tree_map"]
