"""Optimizers (mirror of ``src/repro/optim``; schedules wait)."""
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm"]
