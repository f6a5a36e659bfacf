from .adamw import (AdamWConfig, adamw_init, adamw_init_struct, adamw_update,
                    global_norm)
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_init_struct", "adamw_update",
           "cosine_schedule", "global_norm"]
