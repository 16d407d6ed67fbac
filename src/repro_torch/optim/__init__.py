from .adamw import (AdamWConfig, adamw_update, clip_by_global_norm,
                    cosine_lr, global_norm, init_opt_state, param_dict)

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "cosine_lr",
           "global_norm", "clip_by_global_norm", "param_dict"]
