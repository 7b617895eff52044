"""PyTorch oracles for the port's kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``.  Each oracle is its kernel's
plain version, defined beside the kernel; oracles for the other kernels
come with their ports.
"""

from __future__ import annotations

from .gemm import gemm_plain as gemm_ref
from .gramschm import gramschm_k3_plain as gramschm_k3_ref
from .ttm import ttm_plain as ttm_ref

__all__ = ["gemm_ref", "gramschm_k3_ref", "ttm_ref"]
