"""PyTorch oracles for the port's kernels (the allclose ground truth).

Counterpart of ``repro/kernels/ref.py``.  Each oracle is its kernel's
plain version, defined beside the kernel; oracles for the other kernels
come with their ports.  ``hist_ref`` drops ids outside ``[0, n_bins)``,
as the Pallas histogram kernels and the port's kernels do; the JAX
package's ``hist_ref`` (``.at[cells].add``) wraps a negative id round to
the top bins instead.  ``spmv_csr_ref`` is the numpy CSR oracle.

``flash_ref`` aligns the causal mask top-left (key j <= query i), as the
Pallas flash kernel does; the JAX package's ``flash_ref`` aligns it
bottom-right (j <= i + Skv - Sq), so the two agree only when Sq = Skv.
``ssd_chunk_ref`` rounds as the Pallas SSD kernel does, which only
matters in bfloat16.  ``gmm_ragged_ref`` is ``jax.lax.ragged_dot``: groups
of contiguous rows, unpadded, each times its expert's weights.

``ragged_decode_ref`` and ``paged_decode_ref`` are one masked softmax over
the whole row (the paged one gathers its pages first), not the kernels'
tile-by-tile walk.  They give 0 for a sequence with no live position, as
the port's kernels do; the JAX package's ``ragged_decode_reference`` and
``paged_decode_reference`` give the mean of V there.
"""

from __future__ import annotations

import numpy as np
import torch

from .flash import flash_plain as flash_ref
from .gemm import gemm_plain as gemm_ref
from .gramschm import gramschm_k3_plain as gramschm_k3_ref
from .histogram import hist_plain as hist_ref
from .paged_attn import paged_decode_ref
from .ragged_flash import ragged_decode_ref
from .spmv import spmv_ell_plain as spmv_ref
from .ssd import ssd_plain as ssd_chunk_ref
from .ttm import ttm_plain as ttm_ref


def gmm_ragged_ref(x: torch.Tensor, w: torch.Tensor, group_sizes) -> torch.Tensor:
    """Rows of x in contiguous groups, group g times ``w[g]`` (float32
    products, output in x's type); rows past the groups are zero."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    start = 0
    for g, size in enumerate(int(s) for s in group_sizes):
        rows = slice(start, start + size)
        out[rows] = torch.matmul(x[rows].float(), w[g].float()).to(x.dtype)
        start += size
    return out


def spmv_csr_ref(row_offsets, col_indices, values, x) -> np.ndarray:
    """numpy CSR oracle: y[r] = values[s:e] · x[col_indices[s:e]].

    As the reference's, in float32 for float32 inputs; float64 inputs give
    a float64 y (the host product ``chip_smoke.py`` holds the card against).
    """
    n = len(row_offsets) - 1
    y = np.zeros(n, np.promote_types(np.result_type(values, x), np.float32))
    for r in range(n):
        s, e = row_offsets[r], row_offsets[r + 1]
        y[r] = np.dot(values[s:e], x[col_indices[s:e]])
    return y


__all__ = [
    "flash_ref", "gemm_ref", "gmm_ragged_ref", "gramschm_k3_ref", "hist_ref",
    "paged_decode_ref", "ragged_decode_ref", "spmv_csr_ref", "spmv_ref",
    "ssd_chunk_ref", "ttm_ref",
]
