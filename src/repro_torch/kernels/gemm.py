"""GEMM kernels — the paper's §VI-A ladder, hand-written for Hopper.

Three CUDA kernels in ``csrc/gemm.cu`` follow the paper's optimization
ladder (not the Pallas block structure of ``repro/kernels/gemm.py``):

  v00  one thread per element of C, a warp's lanes on 32 consecutive
       ROWS of one column: uncoalesced A, false sharing on C.
  v01  the thread indices swapped, a warp's lanes on 32 consecutive
       COLUMNS of one row: the coalescing fix.
  v02  the tiled rung (replaces ``_gemm_v02_kernel``): a block owns a
       BM x 128 tile of C (:func:`block_rows`: in bfloat16 128 rows when
       that grid fills the card's 132 SMs, else 64; in float32 64) and
       loops over K itself.
       bfloat16 runs on the tensor cores (``mma.sync`` m16n8k16 fed by a
       three-stage ``cp.async`` ring of swizzled tiles, 4 warps);
       float32 on the CUDA cores (an 8 x 8 register micro-tile a thread,
       the A tile k-major in shared memory so both operands are read
       with float4, two buffers).  Bound on an H100: the operations, 2
       M N K over 67 TFLOP/s in float32 and 989 in bfloat16.

Each kernel has a wrapper (``gemm_v00`` ...) that checks its operands,
launches on the current stream and counts its launches in a plain
integer attribute (``gemm_v00.launches``).  A wrapper given CPU tensors
computes the plain version instead (``gemm_plain``), which is what the
CPU tests exercise; given CUDA tensors it launches the kernel or raises.

The ``gemm_v0x_spec`` builders describe what each *warp* of the CUDA
kernel touches over its lifetime, as blocks and index maps under the
H100 sector geometry; the walker's "program" is the warp, so a sector's
temperature is the paper's distinct-warp count.  ``gemm_v02_spec``
describes the kernel of the given dtype's route.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build
from .flash import BF16_STORAGE, chunk_elems, is_bf16, staged_chunks

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1
#: v02's block tile: columns of C a block, and the card's SMs that the
#: bfloat16 tile rule fills (an H100 SXM has 132).
BN = 128
SMS = 132
#: v02's bfloat16 route: depth of a staged step, and warps a block.
TC_BK = 64
TC_WARPS = 4
#: v02's float32 route: rows of C a block (4 warps).
F32_BM = 64


def block_rows(m: int, n: int, dtype=torch.float32) -> int:
    """Rows of C a block of ``gemm_v02`` owns.  bfloat16: 128 when the
    128 x 128 grid has a block for each of the card's 132 SMs, else 64
    (more, smaller blocks where the larger tile leaves SMs idle).
    float32: 64 (``csrc/gemm.cu`` says why)."""
    if not is_bf16(dtype):
        return F32_BM
    return 128 if math.ceil(m / 128) * math.ceil(n / BN) >= SMS else 64


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
    if a.device != b.device or not (a.is_cuda or a.is_cpu):
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
_V02_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _launch(symbol: str, a: torch.Tensor, b: torch.Tensor, *bm: int) -> torch.Tensor:
    """Launch ``symbol`` on checked CUDA operands (v02 takes its tile height
    ``bm`` too); counts nothing."""
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _build.launch(
        "gemm", symbol, _V02_ARGTYPES if bm else _ARGTYPES, a,
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        _DTYPES[a.dtype], *bm,
    )
    return c


def gemm_v00(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with the naive kernel (lanes on rows); see ``csrc/gemm.cu``."""
    _check_operands(a, b)
    if not a.is_cuda:
        return gemm_plain(a, b)
    c = _launch("repro_gemm_v00", a, b)
    gemm_v00.launches += 1
    return c


def gemm_v01(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with the coalesced kernel (lanes on columns)."""
    _check_operands(a, b)
    if not a.is_cuda:
        return gemm_plain(a, b)
    c = _launch("repro_gemm_v01", a, b)
    gemm_v01.launches += 1
    return c


def gemm_v02(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with the tiled kernel: BM x 128 block tiles, bfloat16 on the
    tensor cores, float32 on the CUDA cores with 8 x 8 register tiles."""
    _check_operands(a, b)
    if not a.is_cuda:
        return gemm_plain(a, b)
    c = _launch("repro_gemm_v02", a, b, block_rows(a.shape[0], b.shape[1], a.dtype))
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
    """Warp footprints of the ``gemm_v02`` kernel of ``dtype``'s route:
    ``gemm_v02_tc_kernel`` for bfloat16 (:func:`_v02_tc_spec`), else
    ``gemm_v02_kernel`` (:func:`_v02_f32_spec`).  Both own BM x 128 tiles
    of C, BM from :func:`block_rows`; program ``(rt, ct, w)`` is warp ``w``
    of the block of row tile ``rt`` and column tile ``ct`` (the grouped
    raster that orders the blocks on the card changes no footprint).
    Shared memory is not modeled, as the reference does not model the
    Pallas pipeline's VMEM input buffers."""
    if is_bf16(dtype):
        return _v02_tc_spec(m, n, k)
    return _v02_f32_spec(m, n, k, dtype)


def _v02_f32_spec(m: int, n: int, k: int, dtype=np.float32) -> KernelSpec:
    """``gemm_v02_kernel``, the float32 route: 64 x 128 tiles, 128 threads
    (4 warps) a block, over a grid ``(ceil(m/64), ceil(n/128), 4)``.
    Thread t loads row t / 2 of every (64, 8) A tile, so warp ``w`` reads
    A rows ``64 rt + 16w .. +15`` in full (block ``(16, k)``); it loads
    float4 items t and t + 128 (row i / 32) of every (8, 128) B tile, so
    warp ``w`` reads the K rows ``kk`` with ``kk % 4 == w`` of the tile's
    128 columns (an exact index walk); thread (t / 16, t % 16) stores rows
    8 (t / 16) .. +7 of C, so warp ``w`` stores C rows ``64 rt + 16w ..
    +15`` of the tile (block ``(16, 128)``)."""
    bm = F32_BM
    warps = bm // 16

    def b_walk(pid, **_):
        _rt, ct, w = pid
        rows = np.arange(w, k, warps, dtype=np.int64)
        cols = np.arange(ct * BN, min(ct * BN + BN, n), dtype=np.int64)
        return (rows[:, None] * n + cols).reshape(-1)

    return KernelSpec(
        name="gemm_v02",
        grid=(math.ceil(m / bm), math.ceil(n / BN), warps),
        operands=(
            OperandSpec(
                "A", (m, k), dtype, (16, k), lambda rt, ct, w: (warps * rt + w, 0)
            ),
            OperandSpec("B", (k, n), dtype, (k, n), lambda rt, ct, w: (0, 0)),
            OperandSpec(
                "C", (m, n), dtype, (16, BN), lambda rt, ct, w: (warps * rt + w, ct),
                kind="store",
            ),
        ),
        dynamic=(("B", b_walk),),
    )


def _v02_tc_spec(m: int, n: int, k: int) -> KernelSpec:
    """``gemm_v02_tc_kernel<BM>``, the bfloat16 route on the tensor cores:
    4 warps a block over a grid ``(ceil(m/BM), ceil(n/128), 4)``.  Thread
    t of the block's 128 copies 16-byte chunks t, t + 128, ...
    (``staged_chunks``) of every staged (BM, 64) A tile and (64, 128) B
    tile, the elements inside M, K and N.  Warp ``w`` stores rows
    ``(BM/4) w .. (BM/4)(w+1) - 1`` of the C tile.  Exact index walks."""
    bm = block_rows(m, n, torch.bfloat16)
    nk = math.ceil(k / TC_BK)
    ca, cb = TC_BK // 8, BN // 8

    def a_walk(pid, **_):
        rt, _ct, w = pid
        r, ch = staged_chunks(w, bm, ca)
        live = rt * bm + r < m
        rr, cc = rt * bm + r[live], ch[live]
        return np.concatenate([chunk_elems(rr, kt * ca + cc, k, k) for kt in range(nk)])

    def b_walk(pid, **_):
        _rt, ct, w = pid
        r, ch = staged_chunks(w, TC_BK, cb)
        parts = [np.empty(0, np.int64)]
        for kt in range(nk):
            live = kt * TC_BK + r < k
            parts.append(chunk_elems(kt * TC_BK + r[live], ct * cb + ch[live], n, n))
        return np.concatenate(parts)

    def c_walk(pid, **_):
        rt, ct, w = pid
        per = bm // TC_WARPS
        rows = np.arange(rt * bm + per * w, min(rt * bm + per * (w + 1), m), dtype=np.int64)
        cols = np.arange(ct * BN, min(ct * BN + BN, n), dtype=np.int64)
        return (rows[:, None] * n + cols).reshape(-1)

    dt = BF16_STORAGE
    return KernelSpec(
        name="gemm_v02",
        grid=(math.ceil(m / bm), math.ceil(n / BN), TC_WARPS),
        operands=(
            OperandSpec("A", (m, k), dt, (m, k), lambda rt, ct, w: (0, 0)),
            OperandSpec("B", (k, n), dt, (k, n), lambda rt, ct, w: (0, 0)),
            OperandSpec("C", (m, n), dt, (m, n), lambda rt, ct, w: (0, 0), kind="store"),
        ),
        dynamic=(("A", a_walk), ("B", b_walk), ("C", c_walk)),
    )
