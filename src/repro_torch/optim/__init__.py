from repro_torch.optim.adamw import (OptimConfig, adamw_flat_update,
                                     adamw_tree_update, clip_factor,
                                     global_grad_norm, init_opt_state,
                                     init_opt_state_flat)
from repro_torch.optim.schedules import make_schedule

__all__ = ["OptimConfig", "adamw_flat_update", "adamw_tree_update",
           "clip_factor", "global_grad_norm", "init_opt_state",
           "init_opt_state_flat", "make_schedule"]
