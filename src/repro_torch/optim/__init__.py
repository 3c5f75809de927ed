from .adamw import (AdamWState, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule, global_norm)
from .compression import compress_grads, compressed_bytes, ef_init

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "global_norm", "compress_grads",
           "compressed_bytes", "ef_init"]
