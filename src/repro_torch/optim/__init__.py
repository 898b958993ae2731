from repro_torch.optim.adamw import (OptimConfig, adamw_tree_update,
                                     clip_factor, global_grad_norm,
                                     init_opt_state)
from repro_torch.optim.schedules import make_schedule

__all__ = ["OptimConfig", "adamw_tree_update", "clip_factor",
           "global_grad_norm", "init_opt_state", "make_schedule"]
