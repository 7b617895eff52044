"""Learning-rate schedules (pure functions of the step).

The port of the JAX package's ``repro/optim/schedules.py``: each schedule
takes the step (an int or a tensor, which keeps it on its device) and
returns the rate as a 0-dim float32 tensor, computed in float32 as the
reference computes it.
"""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(value: float):
    def fn(step):
        return torch.full((), value, dtype=torch.float32, device=_f32(step).device)

    return fn


def linear_warmup(peak: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return peak * torch.clamp(s / max(1, warmup_steps), max=1.0)

    return fn


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    def fn(step):
        s = _f32(step)
        warm = peak * torch.clamp(s / max(1, warmup_steps), max=1.0)
        t = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, peak * cos)

    return fn
