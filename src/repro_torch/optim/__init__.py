from .adamw import (AdamWConfig, init_opt_state, apply_updates,
                    global_norm, clip_by_global_norm, lr_schedule)

__all__ = ["AdamWConfig", "init_opt_state", "apply_updates", "global_norm",
           "clip_by_global_norm", "lr_schedule"]
