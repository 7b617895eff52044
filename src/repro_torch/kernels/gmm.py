"""Grouped matmul (the MoE expert FFN), hand-written for Hopper.

Dropless MoE sorts tokens by expert and multiplies each contiguous group by
its expert's weights.  As in the JAX package (``repro/kernels/gmm.py``),
``plan_groups`` pads every group to a multiple of the m-tile ``bm`` and
names the expert of each tile; ``csrc/gmm.cu`` then computes, for every
``bm``-row tile ``i``, ``O[i] = X[i] · W[tile_expert_ids[i]]`` with float32
accumulation and O in x's type.  Each block reads its tiles' ids, where
the Pallas kernel prefetches the ids as scalars for its W index map.
float32 runs on the CUDA cores (a block of 32 or 64 rows of one expert
tile by 128 columns, or 64 where 128 would leave SMs idle, 32 x 32 of O a
warp in register tiles fed by 16-byte shared loads, a three-stage
``cp.async`` ring, and a raster that keeps one expert's row blocks next to
each other on each W slice); bfloat16 on the tensor cores: a first kernel
cuts each run of tiles with one expert into chunks of up to 128 rows
(``expert_chunks``), then 128-column blocks of 4 warps take one chunk
each, ``mma.sync`` fed by a three-stage ``cp.async`` ring.

The wrapper ``gmm(x, w, tile_expert_ids, bm=128)`` checks its operands,
launches on the current stream and counts its launches in
``gmm.launches``.  Given CPU tensors it computes the plain version
(``gmm_plain``) instead; given CUDA tensors it launches the kernel or
raises.  ``gmm_spec`` describes what each warp of the CUDA kernel of the
given dtype touches under the H100 sector geometry.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build
from .flash import BF16_STORAGE, chunk_elems, is_bf16, staged_chunks
from .gemm import SMS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Rows of O per block (one expert's): 64 when bm allows, else 32.
BLOCK_M = 32
#: Columns of O per block of the float32 kernel (``block_cols``), and the
#: rows and columns of its warps' sub-tiles.
BLOCK_N = 128
WARP_M = WARP_N = 32
#: The bfloat16 kernel's block: rows and columns of O, depth of a staged
#: step, and warps.
TC_BM = 128
TC_BN = 128
TC_BK = 64
TC_WARPS = 4
_GRID_MAX = 2**31 - 1  # blocks of a one-dimensional grid


def block_rows(bm: int) -> int:
    """Rows of O per block of the float32 kernel for expert tiles of ``bm``
    rows: 64 when ``bm`` is a multiple of 64, else 32."""
    return 64 if bm % 64 == 0 else BLOCK_M


def block_cols(m: int, n: int, bm: int) -> int:
    """Columns of O per block of the float32 kernel: 128 when the grid of
    ``block_rows(bm)`` x 128 blocks has a block for each of the card's 132
    SMs, else 64 (twice the blocks, each of half the warps)."""
    return BLOCK_N if m // block_rows(bm) * math.ceil(n / BLOCK_N) >= SMS else BLOCK_N // 2


def plan_groups(group_sizes: np.ndarray, bm: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad groups to bm multiples.

    Returns (row_map, tile_expert_ids, padded_rows): ``row_map[padded_i]``
    is the source row (or -1 for padding); ``tile_expert_ids[t]`` is the
    expert owning m-tile t.
    """
    row_map = []
    tile_ids = []
    src = 0
    for e, g in enumerate(group_sizes):
        g = int(g)
        rows = list(range(src, src + g))
        pad = (-g) % bm
        rows += [-1] * pad
        row_map += rows
        tile_ids += [e] * ((g + pad) // bm)
        src += g
    return np.asarray(row_map, np.int32), np.asarray(tile_ids, np.int32), len(row_map)


def _check_operands(x, w, ids, bm: int) -> None:
    """Raise on anything the kernel does not take."""
    if not all(isinstance(t, torch.Tensor) for t in (x, w, ids)):
        raise TypeError("gmm operands x, w, tile_expert_ids must be torch tensors")
    if x.dim() != 2 or w.dim() != 3 or ids.dim() != 1:
        raise ValueError(
            f"gmm needs x (M, K), w (E, K, N) and tile_expert_ids (M/bm,), got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(ids.shape)}"
        )
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(
            f"gmm takes float32 or bfloat16 x and w of one dtype, got "
            f"{x.dtype} and {w.dtype}"
        )
    if ids.dtype != torch.int32:
        raise TypeError(f"tile_expert_ids must be int32, got {ids.dtype}")
    if not (x.device == w.device == ids.device) or not (x.is_cuda or x.is_cpu):
        raise ValueError(
            f"operands must share one cpu or cuda device, got {x.device}, "
            f"{w.device}, {ids.device}"
        )
    if not (x.is_contiguous() and w.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gmm operands must be contiguous (row-major)")
    m, k = x.shape
    e, kw, n = w.shape
    if kw != k:
        raise ValueError(f"inner dims differ: x is {tuple(x.shape)}, w is {tuple(w.shape)}")
    if bm < BLOCK_M or bm % BLOCK_M:
        raise ValueError(f"bm must be a positive multiple of {BLOCK_M}, got {bm}")
    if m % bm:
        raise ValueError(f"M = {m} is not a multiple of bm = {bm} (pad with plan_groups)")
    if ids.shape[0] != m // bm:
        raise ValueError(
            f"tile_expert_ids has {ids.shape[0]} entries for {m // bm} tiles"
        )
    if min(m, k, n, e) < 1 or m // block_rows(bm) * math.ceil(n / (BLOCK_N // 2)) > _GRID_MAX:
        raise ValueError(f"unsupported gmm shape m={m} k={k} n={n} e={e}")


def gmm_plain(x: torch.Tensor, w: torch.Tensor, tile_expert_ids: torch.Tensor,
              bm: int = 128) -> torch.Tensor:
    """The plain PyTorch version, one float32 product per run of tiles
    with the same expert (never the gathered ``w[ids]``, which at Jamba's
    widths would be tens of GB); O in x's type.  A tile whose id lies
    outside [0, E) gets zeros, as in the kernel."""
    n_exp = w.shape[0]
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype, device=x.device)
    ids = tile_expert_ids.tolist()
    i = 0
    while i < len(ids):
        j = i
        while j < len(ids) and ids[j] == ids[i]:
            j += 1
        if 0 <= ids[i] < n_exp:
            rows = slice(i * bm, j * bm)
            out[rows] = torch.matmul(x[rows].float(), w[ids[i]].float()).to(x.dtype)
        i = j
    return out


def tolerance(want: torch.Tensor, x: torch.Tensor, *_) -> float:
    """The largest |kernel - plain| accepted on N(0, 1) inputs, for
    ``want`` the plain version's output for ``x``: float32 sums of K
    products in another order (1e-6 per term, as the GEMM's); bfloat16 one
    rounding of the output, at most 2^-8 of max|O|.
    """
    if x.dtype == torch.float32:
        return 1e-6 * x.shape[1]
    return 1e-2 * float(want.float().abs().max())


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def plan_ints(m: int, bm: int) -> int:
    """int32 scratch of the bfloat16 route's chunk plan: a count and
    (first row, id) per chunk, at most ceil(m / 128) + m / bm chunks."""
    return 1 + 2 * (math.ceil(m / TC_BM) + m // bm)


def gmm(x: torch.Tensor, w: torch.Tensor, tile_expert_ids: torch.Tensor,
        bm: int = 128) -> torch.Tensor:
    """O[tile i] = X[tile i] · W[tile_expert_ids[i]] with ``csrc/gmm.cu``."""
    _check_operands(x, w, tile_expert_ids, bm)
    if not x.is_cuda:
        return gmm_plain(x, w, tile_expert_ids, bm)
    m, k = x.shape
    e, _, n = w.shape
    o = torch.empty((m, n), dtype=x.dtype, device=x.device)
    plan = None
    if x.dtype == torch.bfloat16:
        plan = torch.empty(plan_ints(m, bm), dtype=torch.int32, device=x.device)
    _build.launch(
        "gmm", "repro_gmm", _ARGTYPES, x,
        x.data_ptr(), w.data_ptr(), tile_expert_ids.data_ptr(),
        None if plan is None else plan.data_ptr(), o.data_ptr(),
        m, k, n, e, bm, block_cols(m, n, bm), _DTYPES[x.dtype],
    )
    gmm.launches += 1
    return o


gmm.launches = 0

KERNELS = {"gmm": gmm}


# ---------------------------------------------------------------------------
# profiler spec: what each warp of the CUDA kernel touches
# ---------------------------------------------------------------------------


def _tile_ids(m: int, bm: int, tile_expert_ids) -> np.ndarray:
    """The ids as int64, after the checks both specs need."""
    ids = np.asarray(tile_expert_ids, dtype=np.int64)
    if m % bm or bm % BLOCK_M or ids.shape != (m // bm,):
        raise ValueError(
            f"gmm_spec needs m % bm == 0, bm % {BLOCK_M} == 0 and one id per "
            f"tile (m={m}, bm={bm}, {ids.shape[0]} ids)"
        )
    return ids


def gmm_spec(
    m: int, k: int, n: int, e: int, tile_expert_ids: np.ndarray, bm: int = 128,
    dtype=np.float32,
) -> KernelSpec:
    """Warp footprints of the kernel ``csrc/gmm.cu`` launches for
    ``dtype``: ``gmm_tc_kernel`` for bfloat16 (``_tc_spec``), else
    ``gmm_kernel`` (``cuda_core_spec``)."""
    if is_bf16(dtype):
        return _tc_spec(m, k, n, e, tile_expert_ids, bm)
    return cuda_core_spec(m, k, n, e, tile_expert_ids, bm, dtype)


def cuda_core_spec(
    m: int, k: int, n: int, e: int, tile_expert_ids: np.ndarray, bm: int = 128,
    dtype=np.float32,
) -> KernelSpec:
    """Warp footprints of ``gmm_kernel`` (``csrc/gmm.cu``), the float32
    route on the CUDA cores.

    The kernel's blocks own ``BM`` rows (``block_rows(bm)``: 64 when ``bm``
    is a multiple of 64, else 32) and ``BN`` columns of O (``block_cols``:
    128, or 64 on a grid too small for the card), with ``W = BM BN / 1024``
    warps of 32 x 32.  Program ``(by, bx, w)`` is warp ``w`` of the block at
    rows ``BM*by``, columns ``BN*bx``, over a grid ``(m/BM, ceil(n/BN),
    W)`` (the kernel's raster launches them in another order, which moves
    no footprint).  Across the K loop it stages X rows ``BM*by + (BM/W)w ..
    +BM/W-1`` in full (block ``(BM/W, k)``) and columns ``BN*bx + (BN/W)w ..
    +BN/W-1`` of its expert's weights in full (block ``(1, k, BN/W)`` at the
    expert of bm-tile ``BM*by // bm``), and stores its 32 x 32 sub-tile of
    O, rows ``32(w // (BN/32))``, columns ``32(w % (BN/32))`` of the block's
    (block ``(32, 32)``).  The kernel's 16-byte chunks and its 4-byte words
    off alignment touch the same elements.
    """
    ids = _tile_ids(m, bm, tile_expert_ids)
    if ids.size and (ids.min() < 0 or ids.max() >= e):
        raise ValueError(f"tile_expert_ids must lie in [0, {e})")
    rows = block_rows(bm)
    cols = block_cols(m, n, bm)
    wn = cols // WARP_N
    warps = rows // WARP_M * wn
    xrows, wcols = rows // warps, cols // warps
    expert = ids[np.arange(m // rows) * rows // bm]
    return KernelSpec(
        name="gmm",
        grid=(m // rows, math.ceil(n / cols), warps),
        operands=(
            OperandSpec(
                "X", (m, k), dtype, (xrows, k), lambda by, bx, w: (warps * by + w, 0)
            ),
            OperandSpec(
                "W", (e, k, n), dtype, (1, k, wcols),
                lambda by, bx, w: (expert[by], 0, warps * bx + w),
            ),
            OperandSpec(
                "O", (m, n), dtype, (WARP_M, WARP_N),
                lambda by, bx, w: (rows // WARP_M * by + w // wn, wn * bx + w % wn),
                kind="store",
            ),
        ),
    )


def expert_chunks(ids: np.ndarray, bm: int, m: int):
    """The chunks the bfloat16 kernel's plan cuts (``gmm_plan_kernel``):
    every run of consecutive bm-row tiles with one id, in 128-row pieces
    from its first row, as ``(first row, rows, id)`` in row order."""
    chunks = []
    t, n_tiles = 0, m // bm
    while t < n_tiles:
        u = t + 1
        while u < n_tiles and ids[u] == ids[t]:
            u += 1
        for row in range(t * bm, u * bm, TC_BM):
            chunks.append((row, min(TC_BM, u * bm - row), int(ids[t])))
        t = u
    return chunks


def _tc_spec(m: int, k: int, n: int, e: int, tile_expert_ids, bm: int) -> KernelSpec:
    """Warp footprints of ``gmm_tc_kernel`` (``csrc/gmm.cu``), the bfloat16
    route on the tensor cores.

    Program ``(c, bx, w)`` is warp ``w`` (0..3) of the block of chunk ``c``
    (``expert_chunks``) and O columns ``128bx ..``, over a grid
    ``(chunks, ceil(n/128), 4)``; a block that the launch gives more than
    one chunk walks them one after the other, a program each.  Thread t of
    the block's 128 copies 16-byte chunks t, t + 128, ...
    (``staged_chunks``) of every staged (128, 64) X tile and (64, 128) W
    tile, the elements inside the chunk's rows, K and N; a chunk whose id
    is out of [0, E) stages nothing.  Warp w stores rows ``32w .. 32w+31``
    of the chunk.  Exact index walks; an id out of range is allowed (its
    rows are zero), and shared memory is not modeled.
    """
    ids = _tile_ids(m, bm, tile_expert_ids)
    chunks = expert_chunks(ids, bm, m)
    nk = math.ceil(k / TC_BK)
    cx, cw = TC_BK // 8, TC_BN // 8

    def x_walk(pid, **_):
        c, bx, w = pid
        row0, rows, ex = chunks[c]
        if not 0 <= ex < e:
            return np.empty(0, np.int64)
        r, ch = staged_chunks(w, TC_BM, cx)
        live = r < rows
        rr, cc = row0 + r[live], ch[live]
        return np.concatenate([chunk_elems(rr, kt * cx + cc, k, k) for kt in range(nk)])

    def w_walk(pid, **_):
        c, bx, w = pid
        ex = chunks[c][2]
        if not 0 <= ex < e:
            return np.empty(0, np.int64)
        r, ch = staged_chunks(w, TC_BK, cw)
        parts = [np.empty(0, np.int64)]
        for kt in range(nk):
            live = kt * TC_BK + r < k
            parts.append(chunk_elems(ex * k + kt * TC_BK + r[live], bx * cw + ch[live], n, n))
        return np.concatenate(parts)

    def o_walk(pid, **_):
        c, bx, w = pid
        row0, rows, _ = chunks[c]
        r = np.arange(32 * w, min(32 * w + 32, rows), dtype=np.int64)
        cols = np.arange(bx * TC_BN, min(bx * TC_BN + TC_BN, n), dtype=np.int64)
        return ((row0 + r)[:, None] * n + cols).reshape(-1)

    dt = BF16_STORAGE
    return KernelSpec(
        name="gmm",
        grid=(len(chunks), math.ceil(n / TC_BN), TC_WARPS),
        operands=(
            OperandSpec("X", (m, k), dt, (m, k), lambda c, bx, w: (0, 0)),
            OperandSpec("W", (e, k, n), dt, (e, k, n), lambda c, bx, w: (0, 0, 0)),
            OperandSpec("O", (m, n), dt, (m, n), lambda c, bx, w: (0, 0), kind="store"),
        ),
        dynamic=(("X", x_walk), ("W", w_walk), ("O", o_walk)),
    )
