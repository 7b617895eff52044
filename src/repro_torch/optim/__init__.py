"""repro_torch.optim — optimizers, schedules, clipping over named tensors."""

from .optimizers import (
    OptState,
    Optimizer,
    adamw,
    clip_by_global_norm,
    global_norm,
    lion,
)
from .schedules import constant, cosine_warmup, linear_warmup

__all__ = [
    "OptState",
    "Optimizer",
    "adamw",
    "clip_by_global_norm",
    "constant",
    "cosine_warmup",
    "global_norm",
    "linear_warmup",
    "lion",
]
