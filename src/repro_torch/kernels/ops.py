"""Public wrappers over the port's kernels.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
kernel's plain PyTorch version.  Nothing falls back: a CUDA launch that
fails raises.
"""

from __future__ import annotations

import torch

from . import gemm as _gemm


def matmul(a: torch.Tensor, b: torch.Tensor, variant: str = "v02") -> torch.Tensor:
    """C = A·B through the GEMM ladder rung ``variant`` (v00, v01, v02)."""
    try:
        kernel = _gemm.KERNELS[variant]
    except KeyError:
        raise ValueError(
            f"unknown gemm variant {variant!r}; have {sorted(_gemm.KERNELS)}"
        ) from None
    return kernel(a, b)
