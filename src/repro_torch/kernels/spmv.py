"""SpMV — the paper's §VI-E misalignment case study.

One CUDA kernel in ``csrc/spmv.cu`` computes the ELL product
``y[r] = Σₖ vals[r,k]·xg[r,k]`` with x gathered at the column indices
beforehand (in PyTorch, outside the kernel, as XLA gathers it outside the
Pallas kernel): ``lanes_per_row(K)`` lanes a row reading float4s, several
row groups a warp in flight, a grid that strides over the rows, an
xor-shuffle sum (a scalar path where K % 4 != 0 or a base is off 16-byte
alignment).  Its wrapper ``spmv_ell(vals, xg)`` checks its operands,
launches on the current stream and counts its launches in a plain integer
attribute.  A wrapper given CPU tensors computes the plain version
(``spmv_ell_plain``) instead; given CUDA tensors it launches the kernel or
raises.  ``csr_to_ell`` builds the padded ELL arrays from CSR.

``spmv_csr_spec`` and ``spmv_zigzag_spec`` are spec-only, as in the JAX
package: they describe the paper's scalar CSR kernel (Fig. 7) and its
zigzag fix, for which no kernel exists in either package.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build

_INT_MAX = 2**31 - 1
_WARP = 32
# csrc/spmv.cu's kThreads and kRowGroups: threads a block, and row groups a
# warp loads before its first FMA
THREADS = 256
ROW_GROUPS = 4


def lanes_per_row(k: int) -> int:
    """Lanes of a warp that share one ELL row of width ``k``: the smallest
    power of two >= ceil(k / 4), at most 32, so that each lane reads at
    least one float4 (K = 16: 4 lanes, 8 rows a warp; K = 32: 8 and 4)."""
    return min(1 << (max(-(-k // 4), 1) - 1).bit_length(), _WARP)


def rows_per_block(lanes: int) -> int:
    """Rows one block of ``csrc/spmv.cu`` covers in one grid step."""
    return THREADS // _WARP * ROW_GROUPS * (_WARP // lanes)


def _check_operands(vals: torch.Tensor, xg: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if not isinstance(vals, torch.Tensor) or not isinstance(xg, torch.Tensor):
        raise TypeError("spmv operands vals and xg must be torch tensors")
    shape = vals.shape
    if len(shape) != 2 or xg.dim() != 2:
        raise ValueError(
            f"spmv needs 2-D vals and xg, got {tuple(shape)} and "
            f"{tuple(xg.shape)}"
        )
    if vals.dtype != torch.float32 or xg.dtype != torch.float32:
        raise TypeError(
            f"spmv takes float32 operands, got {vals.dtype} and {xg.dtype}"
        )
    if shape != xg.shape:
        raise ValueError(
            f"vals {tuple(shape)} and xg {tuple(xg.shape)} must have one "
            "(R, K) shape"
        )
    if xg.device != vals.device or not (vals.is_cuda or vals.is_cpu):
        raise ValueError(
            f"operands must share one cpu or cuda device, got {vals.device} "
            f"and {xg.device}"
        )
    if not (vals.is_contiguous() and xg.is_contiguous()):
        raise ValueError("spmv operands must be contiguous (row-major)")
    r, k = shape
    if min(r, k) < 1 or max(r, k) > _INT_MAX:
        raise ValueError(f"unsupported spmv shape r={r} k={k}")


def spmv_ell_plain(vals: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: float32 y (R,)."""
    return (vals.float() * xg.float()).sum(1)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def spmv_ell(vals: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """y[r] = Σₖ vals[r,k]·xg[r,k]: ``lanes_per_row(K)`` lanes a row; see
    ``csrc/spmv.cu``."""
    _check_operands(vals, xg)
    if not vals.is_cuda:
        return spmv_ell_plain(vals, xg)
    r, k = vals.shape
    y = vals.new_empty((r,))
    _build.launch(
        "spmv", "repro_spmv_ell", _ARGTYPES, vals,
        vals.data_ptr(), xg.data_ptr(), y.data_ptr(), r, k, lanes_per_row(k),
    )
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0

KERNELS = {"ell": spmv_ell}


def csr_to_ell(
    row_offsets: np.ndarray, col_indices: np.ndarray, values: np.ndarray, n_rows: int
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> padded ELL (indices, values); pad uses index 0 / value 0.

    The reference's row loop, vectorized: row ``r``'s entries
    ``[row_offsets[r], row_offsets[r+1])`` fill the front of ELL row ``r``.
    """
    starts = np.asarray(row_offsets[:n_rows], dtype=np.int64)
    counts = np.diff(np.asarray(row_offsets[: n_rows + 1], dtype=np.int64))
    k = max(1, int(counts.max()))
    idx = np.zeros((n_rows, k), np.int32)
    val = np.zeros((n_rows, k), values.dtype)
    rows = np.repeat(np.arange(n_rows), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    pos = np.arange(rows.size) - first  # slot within the row
    src = np.repeat(starts, counts) + pos
    idx[rows, pos] = col_indices[src]
    val[rows, pos] = values[src]
    return idx, val


# ---------------------------------------------------------------------------
# profiler specs (spec only): the paper's scalar CSR kernel, one thread a row
# ---------------------------------------------------------------------------


def _x_gather(pid, col_indices=None, **_):
    # warp w's 32 rows gather x at their column indices (one per row in the
    # registry's context)
    (w,) = pid
    if col_indices is None:
        return []
    return np.asarray(col_indices[_WARP * w : _WARP * (w + 1)], dtype=np.int64)


def _warps(n_rows: int) -> int:
    # a warp's offsets are one fixed (32,) or (64,) block, so whole warps only
    if n_rows < _WARP or n_rows % _WARP:
        raise ValueError(f"the SpMV specs take whole warps of rows, got n_rows={n_rows}")
    return n_rows // _WARP


def spmv_csr_spec(n_rows: int, n_cols: int, dtype=np.float32) -> KernelSpec:
    """The paper's scalar CSR kernel (Fig. 7), as warps; spec only.

    One thread per row, so warp ``w`` of the grid ``(n_rows/32,)`` reads
    ``rowOffsets[32w : 32w+32]`` (four aligned sectors) and the same view
    shifted by one element for ``rowOffsets[r+1]``: the 128 B load that
    straddles five sectors (``origin``).  It gathers ``x`` at its rows'
    column indices (Level 2).  ``n_rows`` is a multiple of 32.
    """
    return KernelSpec(
        name="spmv_csr",
        grid=(_warps(n_rows),),
        operands=(
            OperandSpec(
                "rowOffsets", (n_rows + 1,), np.int32, (_WARP,), lambda w: (w,),
            ),
            OperandSpec(
                "rowOffsets_shift1", (n_rows + 1,), np.int32, (_WARP,),
                lambda w: (w,), origin=(0, 1),  # the +1 misaligned view
            ),
            OperandSpec("x", (n_cols,), dtype, (n_cols,), lambda w: (0,)),
        ),
        dynamic=(("x", _x_gather),),
    )


def spmv_zigzag_spec(n_rows: int, n_cols: int, dtype=np.float32) -> KernelSpec:
    """The zigzag fix, as warps; spec only.

    The offsets are stored as (row_start, row_end) pairs, so warp ``w``
    reads its 32 rows' 64 int32 of ``rowPairs`` in one aligned 256 B load
    (the paper's ``ld.v2``), and gathers ``x`` as the CSR kernel does.
    """
    return KernelSpec(
        name="spmv_zigzag",
        grid=(_warps(n_rows),),
        operands=(
            OperandSpec(
                "rowPairs", (2 * n_rows,), np.int32, (2 * _WARP,), lambda w: (w,),
            ),
            OperandSpec("x", (n_cols,), dtype, (n_cols,), lambda w: (0,)),
        ),
        dynamic=(("x", _x_gather),),
    )
