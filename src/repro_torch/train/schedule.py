"""Learning-rate schedules: pure functions of the step counter, in float32
on the counter's device (the JAX package's ``train/schedule.py``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int,
                  total: int, floor: float = 0.1) -> torch.Tensor:
    """Linear warmup from 0 over ``warmup`` steps, then a cosine down to
    ``floor * peak_lr`` at ``total``.  ``step`` is the count of updates
    made before this one, so the first update has lr 0."""
    step = step.float()
    warm = peak_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(step, peak_lr, dtype=torch.float32)
