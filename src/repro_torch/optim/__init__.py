"""The optimizer of the port: AdamW, the cosine schedule, clipping and
gradient accumulation (port of ``src/repro/optim``)."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                     accumulated_grads, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     cosine_schedule, global_norm)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "global_norm",
           "accumulated_grads"]
