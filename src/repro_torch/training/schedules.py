"""Learning-rate schedules — the port of ``repro.training.schedules``.

A schedule maps a step (a Python int or a 0-d tensor) to the rate as a 0-d
f32 tensor, computed in f32 as the reference computes it; a tensor step
keeps its device.
"""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """Linear warmup from 0 to ``peak_lr`` over ``warmup_steps``, then a
    cosine down to ``floor * peak_lr`` at ``total_steps``, flat after it."""

    def schedule(step) -> torch.Tensor:
        step = _step_f32(step)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)
