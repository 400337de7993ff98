"""Learning-rate schedules as step -> lr functions.

Mirror of ``src/repro/optim/schedules.py``. Each schedule takes the
``int32`` step tensor of :class:`~repro_torch.optim.adamw.AdamWState` and
returns a 0-dim fp32 tensor on its device, in the arithmetic the
reference runs: its ``train_loop`` calls a schedule inside the jitted
train step, and there XLA's CPU backend

* folds ``x / n`` into ``x * (1 / n)`` with the fp32 reciprocal of the
  constant ``n``;
* contracts ``min_frac + c * (1 + cos)`` into one fused multiply-add
  (the port: the exact product and the sum in float64, rounded to fp32);
* takes ``cos`` from the C library's ``cosf`` (the port: float64 ``cos``
  rounded to fp32, which differs from it by one ulp at some arguments).

Python-side constants such as ``(1 - min_frac) * 0.5`` are folded in
double first, as Python folds them in the reference, then rounded to
fp32 once, as JAX rounds a weakly typed scalar. Constants are built on
the step's device (``torch.full``: no host copy). Eager JAX divides
instead and rounds the product and the sum apart, so the reference's own
eager and jitted values differ (``tests/test_torch_schedules.py``).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _recip(n: int) -> float:
    """The fp32 reciprocal of ``n``, as XLA folds a division by it."""
    return float(np.float32(1) / np.float32(n))


def linear_warmup(base_lr: float, warmup_steps: int):
    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        frac = torch.minimum(s * _f32(_recip(max(warmup_steps, 1)), s), _f32(1.0, s))
        return _f32(base_lr, s) * frac

    return schedule


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_frac: float = 0.1):
    def schedule(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = torch.minimum(s * _f32(_recip(max(warmup_steps, 1)), s), _f32(1.0, s))
        prog = torch.clamp((s - _f32(warmup_steps, s))
                           * _f32(_recip(max(total_steps - warmup_steps, 1)), s), 0.0, 1.0)
        cos = torch.cos((_f32(math.pi, s) * prog).double()).float()
        half = (_f32(1.0, s) + cos).double() * _f32((1 - min_frac) * 0.5, s).double()
        cos = (half + _f32(min_frac, s).double()).float()
        return _f32(base_lr, s) * warm * cos

    return schedule
