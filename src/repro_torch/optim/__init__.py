"""Optimizers and learning-rate schedules of the port (counterpart of
``repro.optim``): plain functions on parameter trees of tensors."""
from repro_torch.optim.optimizers import (OptState, adamw, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          init_opt_state, sgd, tree_leaves,
                                          tree_map)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup

__all__ = ["OptState", "adamw", "apply_updates", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "init_opt_state",
           "linear_warmup", "sgd", "tree_leaves", "tree_map"]
