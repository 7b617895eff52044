"""Cell-count histogram (GPUMD ``find_cell_counts``) — the false-sharing
and contention case study (paper §V, Table I).

Three CUDA kernels in ``csrc/histogram.cu`` count int32 cell ids into a
float32 histogram of ``n_bins`` bins, one thread per cell in blocks of
1024 threads:

  naive   every thread atomically adds one into the single global
          histogram: all warps scatter into the same bins.
  opt     each block adds into its own row of ``partials`` (n_blocks,
          n_bins); the wrapper sums the rows afterwards.
  opt2    each block counts into a privatized histogram of unsigned
          counters in shared memory, reading the cells as int4 and striding
          over them by the grid, and flushes it once per block.

Ids outside ``[0, n_bins)`` are dropped, as the Pallas kernels drop them.
(``repro.kernels.ref.hist_ref`` wraps a negative id round to the top
bins instead; the port's plain version follows the kernels.)

Each kernel has a wrapper (``hist_naive(cells, n_bins)`` ...) that checks
its operands, launches on the current stream and counts its launches in a
plain integer attribute.  A wrapper given a CPU tensor computes the plain
version instead; given a CUDA tensor it launches the kernel or raises.

The ``*_spec`` functions describe what each *warp* of the CUDA kernels
touches under the H100 sector geometry; the walker's "program" is the warp.
"""

from __future__ import annotations

import ctypes
import math
import operator

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec, ScratchSpec

from . import _build

_INT_MAX = 2**31 - 1
_WARP = 32
#: Threads (and cells) per block, the Pallas kernels' ``block``.
BLOCK = 1024
_WARPS = BLOCK // _WARP
#: ``hist_opt2``'s grid is at most this many blocks (2 x 132 SMs, the
#: most threads an SM holds), as in ``csrc/histogram.cu``; the blocks
#: stride over the cells.
OPT2_MAX_BLOCKS = 264
#: Ids an opt2 thread counts at least (one int4): below the cap the grid is
#: ``ceil(n / (1024 * OPT2_MIN_IDS))`` blocks.
OPT2_MIN_IDS = 4
#: ``hist_opt2``'s shared histogram of n_bins floats stays within the
#: 48 KB a block gets without opting in.
MAX_OPT2_BINS = 48 * 1024 // 4


def _check_operands(cells: torch.Tensor, n_bins) -> int:
    """Raise on anything the kernels do not take; returns ``n_bins``."""
    if not isinstance(cells, torch.Tensor):
        raise TypeError("histogram cells must be a torch tensor")
    if cells.dim() != 1:
        raise ValueError(f"histogram needs 1-D cells, got {tuple(cells.shape)}")
    if cells.dtype != torch.int32:
        raise TypeError(f"histogram takes int32 cell ids, got {cells.dtype}")
    if not (cells.is_cuda or cells.is_cpu):
        raise ValueError(f"cells must lie on a cpu or cuda device, got {cells.device}")
    if not cells.is_contiguous():
        raise ValueError("histogram cells must be contiguous")
    n_bins = operator.index(n_bins)
    n = cells.shape[0]
    if min(n, n_bins) < 1 or max(n, n_bins) > _INT_MAX:
        raise ValueError(f"unsupported histogram shape n={n} n_bins={n_bins}")
    return n_bins


def hist_plain(cells: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The plain PyTorch version: float32 counts of the ids in [0, n_bins)."""
    cells = cells.long()
    kept = cells[(cells >= 0) & (cells < n_bins)]
    return torch.bincount(kept, minlength=n_bins).float()


_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def _launch(symbol: str, cells: torch.Tensor, out: torch.Tensor, n_bins: int) -> None:
    _build.launch(
        "histogram", symbol, _ARGTYPES, cells,
        cells.data_ptr(), out.data_ptr(), cells.shape[0], n_bins,
    )


def hist_naive(cells: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Counts with every thread adding into one global histogram."""
    n_bins = _check_operands(cells, n_bins)
    if not cells.is_cuda:
        return hist_plain(cells, n_bins)
    out = torch.zeros((n_bins,), dtype=torch.float32, device=cells.device)
    _launch("repro_hist_naive", cells, out, n_bins)
    hist_naive.launches += 1
    return out


def hist_opt(cells: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Counts from a private partial row per block, summed afterwards."""
    n_bins = _check_operands(cells, n_bins)
    if not cells.is_cuda:
        return hist_plain(cells, n_bins)
    n_blocks = math.ceil(cells.shape[0] / BLOCK)
    partials = torch.zeros(
        (n_blocks, n_bins), dtype=torch.float32, device=cells.device
    )
    _launch("repro_hist_opt", cells, partials, n_bins)
    hist_opt.launches += 1
    # the reduction over blocks stays outside the kernel, as XLA's does
    return partials.sum(0)


def hist_opt2(cells: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Counts from a shared-memory histogram per block; n_bins <= 12288."""
    n_bins = _check_operands(cells, n_bins)
    if n_bins > MAX_OPT2_BINS:
        raise ValueError(
            f"hist_opt2 takes n_bins <= {MAX_OPT2_BINS} (n_bins floats of "
            f"shared memory per block), got n_bins = {n_bins}"
        )
    if not cells.is_cuda:
        return hist_plain(cells, n_bins)
    out = torch.zeros((n_bins,), dtype=torch.float32, device=cells.device)
    _launch("repro_hist_opt2", cells, out, n_bins)
    hist_opt2.launches += 1
    return out


hist_naive.launches = 0
hist_opt.launches = 0
hist_opt2.launches = 0

KERNELS = {"naive": hist_naive, "partials": hist_opt, "scratch": hist_opt2}
PLAIN = {name: hist_plain for name in KERNELS}


# ---------------------------------------------------------------------------
# profiler specs: what each warp of the CUDA kernels touches
# ---------------------------------------------------------------------------


def _warp_ids(cells, lo: int, hi: int, n_bins: int) -> np.ndarray:
    """The in-range ids of ``cells[lo:hi]`` (out-of-range ids are dropped)."""
    ids = np.asarray(cells[lo:hi], dtype=np.int64)
    return ids[(ids >= 0) & (ids < n_bins)]


def _cells_operand(n: int) -> OperandSpec:
    # warp w of the one-thread-per-cell grid reads cells[32w : 32w + 32]
    return OperandSpec("cells", (n,), np.int32, (_WARP,), lambda w: (w,))


def hist_naive_spec(n: int, n_bins: int) -> KernelSpec:
    """Warp footprints of ``hist_naive_kernel`` (Level-2 scatter walk).

    Blocks of 1024 threads, one per cell, so warp ``w`` of the grid
    ``(ceil(n/32),)`` reads ``cells[32w : 32w+32]`` and adds one into
    ``cell_count`` at each of those ids: the walk below is the warp's
    exact scatter, read from the dynamic context's ``cells``.
    """

    def scatter_walk(pid, cells=None, **_):
        (w,) = pid
        if cells is None:
            return []
        return _warp_ids(cells, _WARP * w, _WARP * (w + 1), n_bins)

    return KernelSpec(
        name="find_cell_counts",
        grid=(math.ceil(n / _WARP),),
        operands=(
            _cells_operand(n),
            OperandSpec(
                "cell_count", (n_bins,), np.float32, (n_bins,), lambda w: (0,),
                kind="store",
            ),
        ),
        dynamic=(("cell_count", scatter_walk),),
    )


def hist_opt_spec(n: int, n_bins: int) -> KernelSpec:
    """Warp footprints of ``hist_opt_kernel``: the naive warps, but warp
    ``w`` belongs to block ``w // 32`` and scatters into that block's row
    of ``partials`` (n_blocks, n_bins).

    The reference's partials rung stores a whole dense row per program and
    needs no context.  The CUDA kernel adds only into the bins its cells
    hit, so this spec walks the dynamic context's ``cells`` too.
    """
    n_blocks = math.ceil(n / BLOCK)

    def scatter_walk(pid, cells=None, **_):
        (w,) = pid
        if cells is None:
            return []
        ids = _warp_ids(cells, _WARP * w, _WARP * (w + 1), n_bins)
        return (w // _WARPS) * n_bins + ids

    return KernelSpec(
        name="find_cell_counts_opt",
        grid=(math.ceil(n / _WARP),),
        operands=(
            _cells_operand(n),
            OperandSpec(
                "partials", (n_blocks, n_bins), np.float32, (1, n_bins),
                lambda w: (w // _WARPS, 0), kind="store",
            ),
        ),
        dynamic=(("partials", scatter_walk),),
    )


def opt2_blocks(n: int, max_blocks: int = OPT2_MAX_BLOCKS) -> int:
    """Blocks of ``hist_opt2_kernel``'s grid for ``n`` cells."""
    return min(math.ceil(n / (BLOCK * OPT2_MIN_IDS)), max_blocks)


def opt2_cells(g: int, n: int, threads: int) -> np.ndarray:
    """Cells that thread ``g`` of a grid of ``threads`` threads counts, for
    16-byte-aligned cells: int4s ``g, g + threads, ...`` of the ``n // 4``
    whole ones, and, for ``g < n % 4``, the tail cell ``4 (n // 4) + g``."""
    v = np.arange(g, n // 4, threads, dtype=np.int64)
    idx = (4 * v[:, None] + np.arange(4, dtype=np.int64)).reshape(-1)
    if g < n % 4:
        idx = np.append(idx, 4 * (n // 4) + g)
    return idx


def hist_opt2_spec(n: int, n_bins: int, max_blocks: int = OPT2_MAX_BLOCKS) -> KernelSpec:
    """Warp footprints of ``hist_opt2_kernel``.

    The grid is ``opt2_blocks(n, max_blocks)`` blocks of 32 warps; program
    ``p`` is warp ``p % 32`` of block ``p // 32``.  Thread ``t`` of block
    ``b`` is thread ``g = 1024 b + t`` of the grid and reads the cells of
    ``opt2_cells(g, n, 1024 * blocks)``, so a warp reads one 512-byte run
    of int4s per stride of the grid (the cells are taken 16-byte aligned;
    an unaligned slice moves up to three cells from the vector body to
    threads 0 .. 2).  ``acc`` is the block's shared histogram, modeled as
    one (G, n_bins) buffer whose row ``b`` only block ``b``'s warps touch:
    each warp zeroes and flushes its contiguous chunk of bins and scatters
    its cells' ids.  The region's space is named ``"vmem_scratch"`` (the
    JAX package's name, kept so artifacts read alike); here it means
    shared memory.  The flush stores that chunk of ``cell_count`` once per
    block.
    """
    blocks = opt2_blocks(n, max_blocks)
    chunk = _WARP * math.ceil(n_bins / BLOCK)  # bins zeroed and flushed per warp

    def cell_index(p: int) -> np.ndarray:
        b, w = divmod(p, _WARPS)
        g0 = b * BLOCK + _WARP * w
        return np.concatenate(
            [opt2_cells(g, n, blocks * BLOCK) for g in range(g0, g0 + _WARP)]
        )

    def cells_walk(pid, **_):
        return cell_index(pid[0])

    def acc_walk(pid, cells=None, **_):
        b, w = divmod(pid[0], _WARPS)
        own = np.arange(w * chunk, min((w + 1) * chunk, n_bins), dtype=np.int64)
        if cells is not None:
            ids = np.asarray(cells, dtype=np.int64)[cell_index(pid[0])]
            own = np.concatenate([own, ids[(ids >= 0) & (ids < n_bins)]])
        return b * n_bins + own

    return KernelSpec(
        name="find_cell_counts_opt2",
        grid=(blocks * _WARPS,),
        operands=(
            OperandSpec("cells", (n,), np.int32, (n,), lambda p: (0,)),
            OperandSpec(
                "cell_count", (n_bins,), np.float32, (chunk,),
                lambda p: (p % _WARPS,), kind="store",
            ),
        ),
        scratch=(ScratchSpec("acc", (blocks, n_bins), np.uint32, kind="accum"),),
        dynamic=(("cells", cells_walk), ("acc", acc_walk)),
    )
