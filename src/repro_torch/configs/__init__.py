"""repro_torch.configs — the published architecture configs and the
(architecture x shape) grid."""

from .archs import FULL, SMOKE, get_config
from .base import ARCH_IDS, SHAPES, SUBQUADRATIC, Shape, all_cells, cells, skipped_cells

__all__ = [
    "ARCH_IDS",
    "FULL",
    "SHAPES",
    "SMOKE",
    "SUBQUADRATIC",
    "Shape",
    "all_cells",
    "cells",
    "get_config",
    "skipped_cells",
]
