from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     cosine_schedule, global_norm,
                                     init_opt_state)

__all__ = ["AdamWConfig", "adamw_update", "cosine_schedule", "global_norm",
           "init_opt_state"]
