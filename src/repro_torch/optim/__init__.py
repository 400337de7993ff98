"""Optimizers and learning-rate schedules (mirror of ``src/repro/optim``)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim.schedules import cosine_schedule, linear_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup"]
