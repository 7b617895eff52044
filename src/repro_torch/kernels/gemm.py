"""GEMM kernels — the paper's §VI-A ladder, hand-written for Hopper.

Three CUDA kernels in ``csrc/gemm.cu`` follow the paper's optimization
ladder (not the Pallas block structure of ``repro/kernels/gemm.py``):

  v00  one thread per element of C, a warp's lanes on 32 consecutive
       ROWS of one column: uncoalesced A, false sharing on C.
  v01  the thread indices swapped, a warp's lanes on 32 consecutive
       COLUMNS of one row: the coalescing fix.
  v02  shared-memory tiled (64, 64, 16) with a 4x4 register micro-tile
       per thread and the K loop inside the block.

Each kernel has a wrapper (``gemm_v00`` ...) that checks its operands,
launches on the current stream and counts its launches in a plain
integer attribute (``gemm_v00.launches``).  A wrapper given CPU tensors
computes the plain version instead (``gemm_plain``), which is what the
CPU tests exercise; given CUDA tensors it launches the kernel or raises.

The ``gemm_v0x_spec`` builders describe what each *warp* of the CUDA
kernel touches over its lifetime, as blocks and index maps under the
H100 sector geometry; the walker's "program" is the warp, so a sector's
temperature is the paper's distinct-warp count.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        raise TypeError("gemm operands must be torch tensors")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(
            f"gemm needs 2-D operands, got {tuple(a.shape)} and {tuple(b.shape)}"
        )
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(
            f"gemm takes float32 or bfloat16 operands of one dtype, got "
            f"{a.dtype} and {b.dtype}"
        )
    if a.shape[1] != b.shape[0]:
        raise ValueError(
            f"inner dims differ: A is {tuple(a.shape)}, B is {tuple(b.shape)}"
        )
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"operands must share one cpu or cuda device, got {a.device} "
            f"and {b.device}"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("gemm operands must be contiguous (row-major)")
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) < 1 or max(m, n, k) > _INT_MAX:
        raise ValueError(f"unsupported gemm shape m={m} n={n} k={k}")


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: full-f32 product, output in a's dtype.

    Compared against the kernels on the card with
    ``torch.backends.cuda.matmul.allow_tf32 = False``, so the float32
    product there is full precision too.
    """
    return torch.matmul(a.float(), b.float()).to(a.dtype)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _launch(symbol: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _build.call(
            "gemm", symbol, _ARGTYPES,
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
            _DTYPES[a.dtype], stream,
        )
    return c


def gemm_v00(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with the naive kernel (lanes on rows); see ``csrc/gemm.cu``."""
    _check_operands(a, b)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    c = _launch("repro_gemm_v00", a, b)
    gemm_v00.launches += 1
    return c


def gemm_v01(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with the coalesced kernel (lanes on columns)."""
    _check_operands(a, b)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    c = _launch("repro_gemm_v01", a, b)
    gemm_v01.launches += 1
    return c


def gemm_v02(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with the shared-memory tiled kernel (64x64x16 tiles)."""
    _check_operands(a, b)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    c = _launch("repro_gemm_v02", a, b)
    gemm_v02.launches += 1
    return c


gemm_v00.launches = 0
gemm_v01.launches = 0
gemm_v02.launches = 0

KERNELS = {"v00": gemm_v00, "v01": gemm_v01, "v02": gemm_v02}


def reset_launch_counts() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0


# ---------------------------------------------------------------------------
# profiler specs: what each warp of the CUDA kernel touches
# ---------------------------------------------------------------------------


def gemm_v00_spec(m: int, n: int, k: int, dtype=np.float32) -> KernelSpec:
    """Warp footprints of ``gemm_v00_kernel``.

    The kernel runs blocks of (32, 8) threads with threadIdx.x on rows,
    so warp ``w`` of block ``(bx, by)`` computes rows ``32*bx .. +31`` of
    column ``8*by + w``.  Program ``(i, j)`` here is that warp with
    ``i = bx`` and ``j = 8*by + w``, over a grid ``(ceil(m/32), n)``.
    Over the K loop it reads A rows ``32i .. +31`` in full (block
    ``(32, k)``), B column ``j`` in full (block ``(k, 1)``) and writes C
    rows ``32i .. +31`` of column ``j`` (block ``(32, 1)``).  Only the
    width of ``dtype`` matters (bf16 walks like any 2-byte type).
    """
    return KernelSpec(
        name="gemm_v00",
        grid=(math.ceil(m / 32), n),
        operands=(
            OperandSpec("A", (m, k), dtype, (32, k), lambda i, j: (i, 0)),
            OperandSpec("B", (k, n), dtype, (k, 1), lambda i, j: (0, j)),
            OperandSpec(
                "C", (m, n), dtype, (32, 1), lambda i, j: (i, j), kind="store"
            ),
        ),
    )


def gemm_v01_spec(m: int, n: int, k: int, dtype=np.float32) -> KernelSpec:
    """Warp footprints of ``gemm_v01_kernel``.

    Blocks of (32, 8) threads with threadIdx.x on columns: warp ``w`` of
    block ``(bx, by)`` computes columns ``32*bx .. +31`` of row
    ``8*by + w``.  Program ``(r, jb)`` is that warp with ``r = 8*by + w``
    and ``jb = bx``, over a grid ``(m, ceil(n/32))``.  It reads A row
    ``r`` (block ``(1, k)``), the B column strip ``32jb .. +31`` (block
    ``(k, 32)``) and writes that strip of C row ``r`` (block ``(1, 32)``).
    """
    return KernelSpec(
        name="gemm_v01",
        grid=(m, math.ceil(n / 32)),
        operands=(
            OperandSpec("A", (m, k), dtype, (1, k), lambda r, jb: (r, 0)),
            OperandSpec("B", (k, n), dtype, (k, 32), lambda r, jb: (0, jb)),
            OperandSpec(
                "C", (m, n), dtype, (1, 32), lambda r, jb: (r, jb),
                kind="store",
            ),
        ),
    )


def gemm_v02_spec(m: int, n: int, k: int, dtype=np.float32) -> KernelSpec:
    """Warp footprints of ``gemm_v02_kernel`` (64x64 block tile, BK = 16).

    Program ``(bm, bn, w)`` is warp ``w`` (0..7) of the block at
    ``blockIdx = (bn, bm)``, over a grid ``(ceil(m/64), ceil(n/64), 8)``.
    From device memory, across the whole K loop, warp ``w`` loads rows
    ``8w .. 8w+7`` of every A tile (block ``(8, k)`` at ``8*bm + w``) and
    columns ``8w .. 8w+7`` of every B tile (block ``(k, 8)`` at
    ``8*bn + w``), and stores the 32x16 piece of C it accumulated in
    registers: warp ``w = 4*wr + wc`` owns C rows ``64*bm + 32*wr .. +31``
    and columns ``64*bn + 16*wc .. +15`` (block ``(32, 16)``).  Shared
    memory is not modeled, as the reference does not model the Pallas
    pipeline's VMEM input buffers.
    """
    return KernelSpec(
        name="gemm_v02",
        grid=(math.ceil(m / 64), math.ceil(n / 64), 8),
        operands=(
            OperandSpec(
                "A", (m, k), dtype, (8, k), lambda bm, bn, w: (8 * bm + w, 0)
            ),
            OperandSpec(
                "B", (k, n), dtype, (k, 8), lambda bm, bn, w: (0, 8 * bn + w)
            ),
            OperandSpec(
                "C", (m, n), dtype, (32, 16),
                lambda bm, bn, w: (2 * bm + w // 4, 4 * bn + w % 4),
                kind="store",
            ),
        ),
    )
