"""Gram-Schmidt kernel3 (PolyBench/GPU GRAMSCHM) — the strided case study.

Two CUDA kernels in ``csrc/gramschm.cu`` compute ``r[j] = Σᵢ q[i,k]·a[i,j]``
with PolyBench/GPU's ``gramschmidt_kernel3`` mapping: one thread per
column ``j``, a loop over ``i``, ``r[j]`` stored once (paper §VI-B):

  naive  reads ``q[i*NK + k]``: every step touches a new 32 B sector of
         ``q`` for one 4 B word — the strided walk.
  opt    reads ``qt[k*NI + i]`` from the transposed ``q``: contiguous; and
         splits the i loop over blocks (:func:`opt_split`), each storing
         a row of partial sums that a second kernel adds in a fixed order.

Each kernel has a wrapper (``gramschm_k3_naive(q, a, k)``,
``gramschm_k3_opt(qt, a, k)``) that checks its operands, launches on the
current stream and counts its launches in a plain integer attribute.  A
wrapper given CPU tensors computes the plain version instead; given CUDA
tensors it launches the kernel or raises.

The ``*_spec`` functions describe what each *warp* of the CUDA kernels touches,
under the H100 sector geometry; the walker's "program" is the warp.
"""

from __future__ import annotations

import ctypes
import math
import operator

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build

_INT_MAX = 2**31 - 1
_WARP = 32
#: The opt kernel's blocks: 8 warps over a strip of 128 columns (a float4
#: a lane), the sum kernel's blocks 256 threads, one column each.
OPT_WARPS = 8
OPT_STRIP = 128
SUM_THREADS = 256
#: Blocks the split aims at: ~8 on each of an H100's 132 SMs.
OPT_TARGET_BLOCKS = 1024


def opt_split(ni: int, nj: int):
    """(strips, slices, rows a warp) of the opt kernel's grid, a function of
    the shape alone: strips of 128 columns, and rows a warp the least
    multiple of 8 (at most 32) that keeps strips x slices near
    ``OPT_TARGET_BLOCKS``; slices = ceil(NI / (8 x rows a warp))."""
    strips = math.ceil(nj / OPT_STRIP)
    want = math.ceil(ni * strips / (OPT_WARPS * OPT_TARGET_BLOCKS))
    rpw = min(32, 8 * max(1, math.ceil(want / 8)))
    return strips, math.ceil(ni / (OPT_WARPS * rpw)), rpw


def _check_operands(q: torch.Tensor, a: torch.Tensor, k, transposed: bool) -> int:
    """Raise on anything the kernels do not take; returns ``k`` as an int."""
    name = "qt" if transposed else "q"
    if not isinstance(q, torch.Tensor) or not isinstance(a, torch.Tensor):
        raise TypeError(f"gramschm operands {name} and a must be torch tensors")
    if q.dim() != 2 or a.dim() != 2:
        raise ValueError(
            f"gramschm needs 2-D {name} and a, got {tuple(q.shape)} and "
            f"{tuple(a.shape)}"
        )
    if q.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(
            f"gramschm takes float32 operands, got {q.dtype} and {a.dtype}"
        )
    nk, ni = q.shape if transposed else q.shape[::-1]
    if ni != a.shape[0]:
        raise ValueError(
            f"{name} {tuple(q.shape)} does not match a {tuple(a.shape)}: "
            f"both need NI = {a.shape[0]} rows of q"
        )
    if q.device != a.device or not (q.is_cuda or q.is_cpu):
        raise ValueError(
            f"operands must share one cpu or cuda device, got {q.device} "
            f"and {a.device}"
        )
    if not (q.is_contiguous() and a.is_contiguous()):
        raise ValueError("gramschm operands must be contiguous (row-major)")
    k = operator.index(k)
    if not 0 <= k < nk:
        raise ValueError(f"column k={k} is outside 0 <= k < NK = {nk}")
    nj = a.shape[1]
    if min(ni, nj, nk) < 1 or max(ni, nj, nk) > _INT_MAX:
        raise ValueError(f"unsupported gramschm shape ni={ni} nj={nj} nk={nk}")
    return k


def gramschm_k3_plain(q: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """The plain PyTorch version: ``r = q[:, k] · a`` in float32, shape (NJ,)."""
    return (q[:, k, None].float() * a.float()).sum(0)


def gramschm_k3_opt_plain(qt: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version from the transposed ``qt`` (NK, NI): row k of qt."""
    return gramschm_k3_plain(qt.t(), a, k)


_ARGTYPES = {
    "repro_gramschm_k3_naive": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "repro_gramschm_k3_opt": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def _launch(symbol: str, q: torch.Tensor, a: torch.Tensor, *ints: int,
            scratch: tuple = ()) -> torch.Tensor:
    r = torch.empty((a.shape[1],), dtype=torch.float32, device=a.device)
    _build.launch(
        "gramschm", symbol, _ARGTYPES[symbol], a,
        q.data_ptr(), a.data_ptr(), *(t.data_ptr() for t in scratch),
        r.data_ptr(), *ints,
    )
    return r


def gramschm_k3_naive(q: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """r[j] = Σᵢ q[i,k]·a[i,j] reading q's column k (strided); q is (NI, NK)."""
    k = _check_operands(q, a, k, transposed=False)
    if not a.is_cuda:
        return gramschm_k3_plain(q, a, k)
    ni, nk = q.shape
    r = _launch("repro_gramschm_k3_naive", q, a, ni, a.shape[1], nk, k)
    gramschm_k3_naive.launches += 1
    return r


def gramschm_k3_opt(qt: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """The same r reading row k of ``qt`` = q transposed, (NK, NI), split
    over i-slices: two device kernels, one launch on the count."""
    k = _check_operands(qt, a, k, transposed=True)
    if not a.is_cuda:
        return gramschm_k3_opt_plain(qt, a, k)
    ni, nj = a.shape
    _, slices, rpw = opt_split(ni, nj)
    partials = torch.empty((slices, nj), dtype=torch.float32, device=a.device)
    r = _launch("repro_gramschm_k3_opt", qt, a, ni, nj, k, rpw, scratch=(partials,))
    gramschm_k3_opt.launches += 1
    return r


gramschm_k3_naive.launches = 0
gramschm_k3_opt.launches = 0

KERNELS = {"naive": gramschm_k3_naive, "opt": gramschm_k3_opt}
PLAIN = {"naive": gramschm_k3_plain, "opt": gramschm_k3_opt_plain}


# ---------------------------------------------------------------------------
# profiler specs: what each warp of the CUDA kernels touches
# ---------------------------------------------------------------------------


def k3_naive_spec(ni: int, nj: int, nk: int, k: int = 0) -> KernelSpec:
    """Warp footprints of ``gramschm_k3_naive_kernel`` (Level-2 q walk).

    Blocks of 256 threads with one thread per column, so warp ``w``
    computes columns ``32w .. 32w+31`` over a grid ``(ceil(nj/32),)``
    (warps wholly past ``nj`` return at once and touch nothing).  At
    step ``i`` all its lanes read ``q[i*NK + k]``: the flat walk below
    is the kernel's exact address stream.  It reads the ``a`` column
    strip ``32w .. +31`` (block ``(ni, 32)``) and stores that strip of
    ``r`` (block ``(32,)``).
    """

    def q_stride_walk(pid, **_):
        return np.arange(ni, dtype=np.int64) * nk + k

    return KernelSpec(
        name="gramschm_k3_naive",
        grid=(math.ceil(nj / _WARP),),
        operands=(
            OperandSpec("q", (ni, nk), np.float32, (ni, nk), lambda w: (0, 0)),
            OperandSpec("a", (ni, nj), np.float32, (ni, _WARP), lambda w: (0, w)),
            OperandSpec("r", (nj,), np.float32, (_WARP,), lambda w: (w,), kind="store"),
        ),
        dynamic=(("q", q_stride_walk),),
    )


def k3_naive_block_spec(ni: int, nj: int, nk: int, k: int = 0) -> KernelSpec:
    """The naive kernel's warps as 2-D blocks: q column k is block
    ``(ni, 1)`` at ``(0, k)``.  The same sectors as :func:`k3_naive_spec`,
    walked by the Level-1 block walker instead of the address stream."""
    return KernelSpec(
        name="gramschm_k3_naive_blocks",
        grid=(math.ceil(nj / _WARP),),
        operands=(
            OperandSpec("q", (ni, nk), np.float32, (ni, 1), lambda w: (0, k)),
            OperandSpec("a", (ni, nj), np.float32, (ni, _WARP), lambda w: (0, w)),
            OperandSpec("r", (nj,), np.float32, (_WARP,), lambda w: (w,), kind="store"),
        ),
    )


def opt_warps(ni: int, nj: int):
    """Every warp the opt route launches, in the spec's grid order: first
    the opt kernel's (strip, slice, warp) -- blockIdx.x strip + strips slice --
    then the sum kernel's (block, warp).  Yields ("opt", strip, slice, w)
    and ("sum", block, None, w)."""
    strips, slices, _ = opt_split(ni, nj)
    for sl in range(slices):
        for st in range(strips):
            for w in range(OPT_WARPS):
                yield "opt", st, sl, w
    for blk in range(math.ceil(nj / SUM_THREADS)):
        for w in range(SUM_THREADS // _WARP):
            yield "sum", blk, None, w


def k3_opt_spec(ni: int, nj: int, nk: int, k: int = 0) -> KernelSpec:
    """Warp footprints of the opt route (``gramschm_k3_opt_kernel`` then
    ``gramschm_k3_sum_kernel``), program ``p`` the p-th warp of
    :func:`opt_warps`.  Opt warp ``w`` of block (strip, slice) reads words
    ``row0 .. row0 + n - 1`` of row k of ``qT`` (row0 = (8 slice + w) RPW,
    n its rows below NI, one word a lane) and those rows of ``a`` over the
    strip's columns ``128 strip .. +127`` below NJ; warp 0 of the block
    stores those columns of row ``slice`` of ``partials`` (slices, NJ).  Sum
    warp ``w`` of block ``blk`` reads its 32 columns of every row of
    ``partials`` and stores them to ``r``; a warp past NJ touches nothing."""
    strips, slices, rpw = opt_split(ni, nj)
    warps = list(opt_warps(ni, nj))

    def cols_of(pid):
        kind, a0, _, w = warps[pid[0]]
        if kind == "opt":
            c = a0 * OPT_STRIP + np.arange(OPT_STRIP, dtype=np.int64)
        else:
            c = (a0 * SUM_THREADS // _WARP + w) * _WARP + np.arange(_WARP, dtype=np.int64)
        return c[c < nj]

    def rows_of(pid):
        kind, _, sl, w = warps[pid[0]]
        if kind != "opt":
            return np.empty(0, np.int64)
        row0 = (sl * OPT_WARPS + w) * rpw
        return np.arange(row0, min(row0 + rpw, ni), dtype=np.int64)

    def qt_walk(pid, **_):
        return k * ni + rows_of(pid)

    def a_walk(pid, **_):
        return (rows_of(pid)[:, None] * nj + cols_of(pid)).reshape(-1)

    def partials_walk(pid, **_):
        kind, _, sl, w = warps[pid[0]]
        if kind == "opt":
            return sl * nj + cols_of(pid) if w == 0 else np.empty(0, np.int64)
        return (np.arange(slices, dtype=np.int64)[:, None] * nj + cols_of(pid)).reshape(-1)

    def r_walk(pid, **_):
        return cols_of(pid) if warps[pid[0]][0] == "sum" else np.empty(0, np.int64)

    def whole(name, shape, kind="load"):
        return OperandSpec(name, shape, np.float32, shape, lambda p: (0,) * len(shape), kind=kind)

    return KernelSpec(
        name="gramschm_k3_opt",
        grid=(len(warps),),
        operands=(
            whole("qT", (nk, ni)),
            whole("a", (ni, nj)),
            whole("partials", (slices, nj), kind="store"),
            whole("r", (nj,), kind="store"),
        ),
        dynamic=(("qT", qt_walk), ("a", a_walk), ("partials", partials_walk), ("r", r_walk)),
    )
