"""Public wrappers over the port's kernels.

A CUDA tensor launches the hand-written kernel; a CPU tensor takes the
kernel's plain PyTorch version.  Nothing falls back: a CUDA launch that
fails raises.
"""

from __future__ import annotations

import torch

from . import flash as _flash
from . import gemm as _gemm
from . import gmm as _gmm
from . import gramschm as _gs
from . import histogram as _hist
from . import paged_attn as _paged
from . import ragged_flash as _ragged
from . import spmv as _spmv
from . import ssd as _ssd
from . import ttm as _ttm


def matmul(a: torch.Tensor, b: torch.Tensor, variant: str = "v02") -> torch.Tensor:
    """C = A·B through the GEMM ladder rung ``variant`` (v00, v01, v02)."""
    try:
        kernel = _gemm.KERNELS[variant]
    except KeyError:
        raise ValueError(
            f"unknown gemm variant {variant!r}; have {sorted(_gemm.KERNELS)}"
        ) from None
    return kernel(a, b)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
    bkv: int = 64,
) -> torch.Tensor:
    """Attention over (BH, S, D), KV heads broadcast to the query heads;
    causal mask top-left, KV tiles of ``bkv`` rows."""
    return _flash.flash_attention(q, k, v, causal=causal, bkv=bkv)


def ragged_decode_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, starts: torch.Tensor,
    ends: torch.Tensor, bkv: int = 128, dense: bool = False,
) -> torch.Tensor:
    """MQA decode attention of q (B, H, D) over k, v (B, S, D), sequence b
    live on [starts[b], ends[b]); ``dense`` reads every KV tile."""
    return _ragged.ragged_decode_attention(q, k, v, starts, ends, bkv=bkv, dense=dense)


def paged_decode_attention(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_tables: torch.Tensor, context_lens: torch.Tensor, dense: bool = False,
) -> torch.Tensor:
    """MQA decode attention of q (B, H, D) over the pages (1, P, page, D)
    that ``block_tables`` names, masked to ``context_lens``; ``dense`` reads
    every slot."""
    return _paged.paged_decode_attention(
        q, k_pages, v_pages, block_tables, context_lens, dense=dense
    )


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor):
    """(y_diag (BH, C, L, P), chunk_states (BH, C, P, N)) of the SSD chunks."""
    return _ssd.ssd_chunk(x, a, bmat, cmat)


def grouped_matmul(
    x: torch.Tensor, w: torch.Tensor, tile_expert_ids: torch.Tensor, bm: int = 128
) -> torch.Tensor:
    """O[tile i] = X[tile i]·W[tile_expert_ids[i]] over bm-row tiles."""
    return _gmm.gmm(x, w, tile_expert_ids, bm=bm)


def spmv(vals: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """ELL SpMV y[r] = Σₖ vals[r,k]·xg[r,k], x gathered beforehand (R, K)."""
    return _spmv.spmv_ell(vals, xg)


def ttm(vals: torch.Tensor, urows: torch.Tensor, use_scratch: bool = False) -> torch.Tensor:
    """Y = Σₙ vals[:, n]·urows[:, n, :], with the scratch (abuse) or fused kernel."""
    return (_ttm.ttm_scratch if use_scratch else _ttm.ttm_fused)(vals, urows)


def gramschm_k3(
    q_or_qt: torch.Tensor, a: torch.Tensor, k: int = 0, naive: bool = True
) -> torch.Tensor:
    """r = q[:, k]·a: ``naive`` reads q (NI, NK), else q transposed (NK, NI)."""
    fn = _gs.gramschm_k3_naive if naive else _gs.gramschm_k3_opt
    return fn(q_or_qt, a, k)


def histogram(cells: torch.Tensor, n_bins: int, naive: bool = False) -> torch.Tensor:
    """Counts of int32 ``cells`` in [0, n_bins): ``naive`` scatters into one
    global histogram, else per-block partial rows (``hist_opt``)."""
    fn = _hist.hist_naive if naive else _hist.hist_opt
    return fn(cells, n_bins)
