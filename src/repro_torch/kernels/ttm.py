"""Sparse TTM (PASTA) and cuSZp-style specs — the shared-memory abuse studies.

Two CUDA kernels in ``csrc/ttm.cu`` compute
``Y[f,c] = Σₙ vals[f,n]·urows[f,n,c]`` with PASTA's
``spt_TTMRankRBNnzKernelSM`` mapping (paper §VI-B): blocks of 32 lanes on
the rank axis × 8 warps on fibers, so a warp is one fiber.

  scratch  each thread accumulates in its own slice of a shared-memory
           buffer ``y_shr[8][R]`` that no other thread reads — the abuse.
  fused    the same mapping, accumulating in a register — the fix.

Each kernel has a wrapper (``ttm_scratch(vals, urows)``,
``ttm_fused(vals, urows)``) that checks its operands, launches on the
current stream and counts its launches in a plain integer attribute.  A
wrapper given CPU tensors computes the plain version (``ttm_plain``)
instead; given CUDA tensors it launches the kernel or raises.

The ``*_spec`` functions describe what each warp touches under the H100 sector
geometry.  ``cuszp_like_spec`` is spec-only, as in the JAX package: no
kernel exists for it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec, ScratchSpec

from . import _build

_INT_MAX = 2**31 - 1
#: The scratch kernel's 8 x R floats of shared memory stay within the 48 KB
#: a block gets without opting in.
MAX_SCRATCH_R = 48 * 1024 // (8 * 4)


def _check_operands(vals: torch.Tensor, urows: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if not isinstance(vals, torch.Tensor) or not isinstance(urows, torch.Tensor):
        raise TypeError("ttm operands vals and urows must be torch tensors")
    if vals.dim() != 2 or urows.dim() != 3:
        raise ValueError(
            f"ttm needs vals (F, NF) and urows (F, NF, R), got "
            f"{tuple(vals.shape)} and {tuple(urows.shape)}"
        )
    if vals.dtype != torch.float32 or urows.dtype != torch.float32:
        raise TypeError(
            f"ttm takes float32 operands, got {vals.dtype} and {urows.dtype}"
        )
    if tuple(urows.shape[:2]) != tuple(vals.shape):
        raise ValueError(
            f"urows {tuple(urows.shape)} does not match vals "
            f"{tuple(vals.shape)}: urows must be (F, NF, R)"
        )
    if vals.device != urows.device or not (vals.is_cuda or vals.is_cpu):
        raise ValueError(
            f"operands must share one cpu or cuda device, got {vals.device} "
            f"and {urows.device}"
        )
    if not (vals.is_contiguous() and urows.is_contiguous()):
        raise ValueError("ttm operands must be contiguous (row-major)")
    f, nf, r = urows.shape
    if min(f, nf, r) < 1 or max(f, nf, r) > _INT_MAX:
        raise ValueError(f"unsupported ttm shape f={f} nf={nf} r={r}")


def ttm_plain(vals: torch.Tensor, urows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: float32 Y (F, R)."""
    return (vals[..., None].float() * urows.float()).sum(1)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _launch(symbol: str, vals: torch.Tensor, urows: torch.Tensor) -> torch.Tensor:
    f, nf, r = urows.shape
    y = torch.empty((f, r), dtype=torch.float32, device=vals.device)
    _build.launch(
        "ttm", symbol, _ARGTYPES, vals,
        vals.data_ptr(), urows.data_ptr(), y.data_ptr(), f, nf, r,
    )
    return y


def ttm_scratch(vals: torch.Tensor, urows: torch.Tensor) -> torch.Tensor:
    """Y with partials parked in shared memory (PASTA's abuse); R <= 1536."""
    _check_operands(vals, urows)
    r = urows.shape[2]
    if r > MAX_SCRATCH_R:
        raise ValueError(
            f"ttm_scratch takes R <= {MAX_SCRATCH_R} (8 x R floats of shared "
            f"memory per block), got R = {r}"
        )
    if not vals.is_cuda:
        return ttm_plain(vals, urows)
    y = _launch("repro_ttm_scratch", vals, urows)
    ttm_scratch.launches += 1
    return y


def ttm_fused(vals: torch.Tensor, urows: torch.Tensor) -> torch.Tensor:
    """Y accumulated in registers (the paper's fix)."""
    _check_operands(vals, urows)
    if not vals.is_cuda:
        return ttm_plain(vals, urows)
    y = _launch("repro_ttm_fused", vals, urows)
    ttm_fused.launches += 1
    return y


ttm_scratch.launches = 0
ttm_fused.launches = 0

KERNELS = {"scratch": ttm_scratch, "fused": ttm_fused}


# ---------------------------------------------------------------------------
# profiler specs: what each warp of the CUDA kernels touches
# ---------------------------------------------------------------------------


def _ttm_operands(f: int, nf: int, r: int):
    return (
        OperandSpec("vals", (f, nf), np.float32, (1, nf), lambda i: (i, 0)),
        OperandSpec("Urows", (f, nf, r), np.float32, (1, nf, r), lambda i: (i, 0, 0)),
        OperandSpec("Y", (f, r), np.float32, (1, r), lambda i: (i, 0), kind="store"),
    )


def ttm_scratch_spec(f: int, nf: int, r: int) -> KernelSpec:
    """Warp footprints of ``ttm_scratch_kernel``.

    Program ``i`` is the warp that owns fiber ``i`` (grid ``(f,)``): it
    reads vals row ``i``, ``Urows[i]`` and stores ``Y[i]``.  Its partials
    live in row ``i`` of ``Y_shr``, modeled as one (F, R) buffer in which
    no other warp touches that row: the per-thread slices of the kernel's
    ``y_shr[8][R]``.  The region's space is named ``"vmem_scratch"`` (the
    JAX package's name, kept so artifacts read alike); here it means
    shared memory.
    """
    return KernelSpec(
        name="ttm_scratch",
        grid=(f,),
        operands=_ttm_operands(f, nf, r),
        scratch=(
            ScratchSpec(
                "Y_shr", (f, r), np.float32,
                access_model=lambda pid: [(pid[0], pid[0] + 1, 0, r)],
            ),
        ),
    )


def ttm_fused_spec(f: int, nf: int, r: int) -> KernelSpec:
    """Warp footprints of ``ttm_fused_kernel``: as the scratch kernel,
    without the shared-memory buffer."""
    return KernelSpec(name="ttm_fused", grid=(f,), operands=_ttm_operands(f, nf, r))


def cuszp_like_spec(n_blocks: int) -> KernelSpec:
    """cuSZp-style compression (paper §VI-C), spec only: no kernel.

    One warp per 1024-element block: it reads its block of ``data``,
    writes its 1024 bytes of ``cmp_bytes`` and parks one scalar each in
    ``exel_sum`` and ``base_idx`` (shared memory, ``"vmem_scratch"``):
    warp-local values broadcast through shared space.
    """
    return KernelSpec(
        name="cuszp_compress_like",
        grid=(n_blocks,),
        operands=(
            OperandSpec("data", (n_blocks * 1024,), np.float32, (1024,), lambda i: (i,)),
            OperandSpec(
                "cmp_bytes", (n_blocks * 1024,), np.int8, (1024,),
                lambda i: (i,), kind="store",
            ),
        ),
        scratch=(
            ScratchSpec(
                "exel_sum", (n_blocks, 128), np.float32,
                access_model=lambda pid: [(pid[0], pid[0] + 1, 0, 1)],
            ),
            ScratchSpec(
                "base_idx", (n_blocks, 128), np.int32,
                access_model=lambda pid: [(pid[0], pid[0] + 1, 0, 1)],
            ),
        ),
    )
