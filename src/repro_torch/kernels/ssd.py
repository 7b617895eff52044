"""The Mamba-2 SSD intra-chunk term, hand-written for Hopper.

``csrc/ssd.cu`` computes, for every (batch*head, chunk) cell with x
(L, P), log-decays a (L,), B and C (L, N), the diagonal-block term and the
chunk's end state of the SSD dual form (``repro/kernels/ssd.py``)::

    y = ((C Bᵀ) ∘ L) x        L[i, j] = exp(cum[i] - cum[j]) for j <= i, else 0
    s = xᵀ (decay ∘ B)        decay[t] = exp(cum[L-1] - cum[t])

with ``cum = cumsum(a)``, float32 sums and both outputs float32.  A cell
is cut into row tiles of 64 rows of y and state units of 64 x 64 elements
of s, one block each in one launch (``roles``); a row tile walks the
64-row tiles of B and x up to its diagonal through a ring of ``cp.async``
stages (two, or for float32 one where two would keep a second block off
the SM: ``f32_stages``), a state unit walks all of them.  float32 runs on
the CUDA cores with register micro-tiles (``ssd_chunk_kernel``), bfloat16
on the tensor cores (``ssd_tc_kernel``, ``mma.sync`` with float32
accumulators, rounding the scores and the decayed x where the Pallas
kernel rounds them).  The decay is masked before the exponential, so a
long chunk cannot overflow into NaN.  ``a`` must hold log-decays (<= 0):
a positive ``a`` makes the end-state decay grow without bound.

The wrapper ``ssd_chunk(x, a, bmat, cmat)`` returns ``(y, s)``, checks its
operands (and that the chunk fits the 227 KB of shared memory a block can
have: it raises rather than launch a kernel the card would refuse),
launches on the current stream and counts its launches in
``ssd_chunk.launches``.  Given CPU tensors it computes the plain version
(``ssd_plain``) instead; given CUDA tensors it launches the kernel or
raises.  ``ssd_chunk_spec`` describes what each warp of the kernel that
its ``dtype`` takes touches under the H100 sector geometry.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build
from .flash import BF16_STORAGE, is_bf16

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Rows of a row tile, and keys (or steps) of a staged tile of B and x.
TILE = 64
#: A state unit's extent in p and in n.
UNIT = 64
#: Threads of a float32 block (16 x 16) and of a bfloat16 block (4 warps).
F32_THREADS = 256
TC_THREADS = 128
#: The widest head the kernels take.
MAX_P = 128
#: Shared memory a block can opt in to on an H100 (227 KB).
MAX_SMEM = 232448
_MAX_BLOCKS = 2**31 - 1


def tiles_of(l: int) -> int:
    """Row tiles of a chunk of ``l`` rows (and staged tiles of B and x)."""
    return -(-l // TILE)


def units_of(p: int, n: int) -> int:
    """State units of a (P, N) end state."""
    return -(-p // UNIT) * -(-n // UNIT)


def roles(l: int, p: int, n: int) -> List[Tuple[bool, int]]:
    """What block ``b`` of a cell serves, in block order: ``(True, u)``
    for state unit ``u`` (the units first), then ``(False, r)`` for row
    tile ``r``, last tile first."""
    t = tiles_of(l)
    return [(True, u) for u in range(units_of(p, n))] + [(False, t - 1 - r) for r in range(t)]


def f32_ldn(n: int) -> int:
    """float32 row stride of staged B and C: N rounded up to 4, with an
    odd count of 16-byte chunks."""
    n4 = -(-n // 4) * 4
    return n4 if n4 % 8 else n4 + 4


def y_cols(p: int) -> int:
    """float32: the y columns a thread holds (P <= 16 of them x 16 threads)."""
    return next(c for c in (1, 2, 4, 8) if p <= 16 * c)


def padded_p(p: int) -> int:
    """bfloat16: P zero-filled up to 16, 32, 64 or 128."""
    return next(w for w in (16, 32, 64, 128) if p <= w)


#: The most shared memory a block may take for two to share an SM: 2 x
#: (bytes + the 1 KB the runtime reserves a block) <= the SM's 228 KB.
TWO_BLOCKS_SMEM = 115712


def _f32_smem(l: int, p: int, n: int, stages: int) -> int:
    lpad = TILE * tiles_of(l)
    ldn = f32_ldn(n)
    return 4 * ((stages + 1) * TILE * ldn + stages * TILE * 16 * y_cols(p)
                + TILE * (TILE + 4) + 2 * lpad)


def f32_stages(l: int, p: int, n: int) -> int:
    """Stages of the float32 kernel's ring: two where two blocks an SM
    still fit beside them, else one (``csrc/ssd.cu:f32_stages``)."""
    return 2 if _f32_smem(l, p, n, 2) <= TWO_BLOCKS_SMEM else 1


def smem_bytes(l: int, p: int, n: int, dtype=torch.float32) -> int:
    """Shared memory of one block of the kernel ``dtype`` takes
    (``csrc/ssd.cu``).  float32: the ring's ``f32_stages`` tiles of B
    (``f32_ldn`` floats a row) and of x (16 ``y_cols(p)``), the row tile's
    C, the key-major scores (64 x 68) and cum and the end-state decays (64
    ``tiles_of(l)`` each).  bfloat16: the ring's two tiles of B and x and
    C's rows, each row padded by 8 bf16 (N zero-filled to a multiple of 16,
    P to ``padded_p``), and cum and the decays in float32."""
    if is_bf16(dtype):
        lpad = TILE * tiles_of(l)
        ldn = -(-n // 16) * 16 + 8
        return 2 * (3 * TILE * ldn + 2 * TILE * (padded_p(p) + 8)) + 4 * 2 * lpad
    return _f32_smem(l, p, n, f32_stages(l, p, n))


def _check_operands(x, a, bmat, cmat) -> None:
    """Raise on anything the kernel does not take."""
    if not all(isinstance(t, torch.Tensor) for t in (x, a, bmat, cmat)):
        raise TypeError("ssd operands x, a, bmat, cmat must be torch tensors")
    if x.dim() != 4 or a.dim() != 3 or bmat.dim() != 4 or bmat.shape != cmat.shape:
        raise ValueError(
            f"ssd needs x (BH, C, L, P), a (BH, C, L) and bmat, cmat "
            f"(BH, C, L, N), got {tuple(x.shape)}, {tuple(a.shape)}, "
            f"{tuple(bmat.shape)}, {tuple(cmat.shape)}"
        )
    if tuple(a.shape) != tuple(x.shape[:3]) or tuple(bmat.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(
            f"a {tuple(a.shape)} and bmat {tuple(bmat.shape)} do not match "
            f"x {tuple(x.shape)}"
        )
    if not (x.dtype == a.dtype == bmat.dtype == cmat.dtype) or x.dtype not in _DTYPES:
        raise TypeError(
            f"ssd takes float32 or bfloat16 operands of one dtype, got "
            f"{x.dtype}, {a.dtype}, {bmat.dtype}, {cmat.dtype}"
        )
    if not (x.device == a.device == bmat.device == cmat.device) or not (x.is_cuda or x.is_cpu):
        raise ValueError("ssd operands must share one cpu or cuda device")
    if not all(t.is_contiguous() for t in (x, a, bmat, cmat)):
        raise ValueError("ssd operands must be contiguous (row-major)")
    bh, c, l, p = x.shape
    n = bmat.shape[-1]
    blocks = bh * c * (units_of(p, n) + tiles_of(l))
    if min(bh, c, l, p, n) < 1 or p > MAX_P or blocks > _MAX_BLOCKS:
        raise ValueError(
            f"unsupported ssd shape bh={bh} c={c} l={l} p={p} n={n} "
            f"(p <= {MAX_P}, at most {_MAX_BLOCKS} blocks)"
        )
    need = smem_bytes(l, p, n, x.dtype)
    if need > MAX_SMEM:
        raise ValueError(
            f"an ssd chunk of L={l}, P={p}, N={n} in {x.dtype} needs {need} bytes of "
            f"shared memory (smem_bytes), above the limit of {MAX_SMEM} a block can have"
        )


def ssd_plain(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (y (BH, C, L, P), s (BH, C, P, N)), float32.

    As the Pallas kernel, the scores and the decayed x are rounded to x's
    type before their products (a no-op in float32; the JAX oracle
    ``ssd_chunk_ref`` does not round).  The decay is masked before the
    exponential.
    """
    cum = torch.cumsum(a.float(), dim=-1)
    l = a.shape[-1]
    seg = cum[..., :, None] - cum[..., None, :]
    keep = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    # masked to 0 before the exp (no overflow above the diagonal) and to 0
    # after it; a process's first exp on the CPU is set up by cpu_math
    dec = torch.exp(seg.masked_fill(~keep, 0.0)).masked_fill(~keep, 0.0)
    scores = torch.matmul(cmat.float(), bmat.float().transpose(-1, -2)) * dec
    y = torch.matmul(scores.to(x.dtype).float(), x.float())
    decay = torch.exp(cum[..., -1:] - cum)
    xw = (x.float() * decay[..., None]).to(x.dtype).float()
    s = torch.matmul(xw.transpose(-1, -2), bmat.float())
    return y, s


def tolerance(want: torch.Tensor, x: torch.Tensor, *_) -> float:
    """The largest |kernel - plain| accepted on ``want``, either output of
    the plain version for ``x``, as a share of its largest value.  float32:
    each decay is the exp of a difference of two cumulative sums of up to L
    log-decays, each rounded to float32 at |cum| (~0.3 L on the seeded
    inputs), so the decays agree to ~1e-5 at L = 256; bfloat16: a score or
    a decayed x rounded on the other side of a bf16 step.
    """
    share = 3e-5 if x.dtype == torch.float32 else 1e-2
    return share * float(want.float().abs().max())


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, s) of every (batch*head, chunk) cell with ``csrc/ssd.cu``."""
    _check_operands(x, a, bmat, cmat)
    if not x.is_cuda:
        return ssd_plain(x, a, bmat, cmat)
    bh, c, l, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty((bh, c, l, p), dtype=torch.float32, device=x.device)
    s = torch.empty((bh, c, p, n), dtype=torch.float32, device=x.device)
    _build.launch(
        "ssd", "repro_ssd_chunk", _ARGTYPES, x,
        x.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        y.data_ptr(), s.data_ptr(), bh, c, l, p, n, _DTYPES[x.dtype],
    )
    ssd_chunk.launches += 1
    return y, s


ssd_chunk.launches = 0

KERNELS = {"ssd": ssd_chunk}


# ---------------------------------------------------------------------------
# profiler spec: what each warp of the CUDA kernels touches
# ---------------------------------------------------------------------------


def staged_elems(w: int, threads: int, rows: int, width: int, per: int, valid_rows: int,
                 valid_cols: int, row_len: int) -> np.ndarray:
    """Flat indices, from the tile's first element in a row-major array of
    ``row_len`` columns, that warp ``w`` reads when a block of ``threads``
    stages a ``rows`` x ``width`` tile in chunks of ``per`` elements:
    thread t copies chunks t, t + threads, ... (chunk k is row k //
    (width / per)), the elements of rows below ``valid_rows`` and columns
    below ``valid_cols``."""
    cpr = width // per
    starts = np.arange(32 * w, rows * cpr, threads, dtype=np.int64)
    k = (starts[:, None] + np.arange(32, dtype=np.int64)).reshape(-1)
    k = k[k < rows * cpr]
    r, col = k // cpr, (k % cpr) * per
    c = col[:, None] + np.arange(per, dtype=np.int64)
    keep = (r[:, None] < valid_rows) & (c < valid_cols)
    return (r[:, None] * row_len + c)[keep]


def _row_block(rows: np.ndarray, cols: np.ndarray, row_len: int) -> np.ndarray:
    return (rows[:, None] * row_len + cols[None, :]).reshape(-1)


def ssd_chunk_spec(
    bh: int, c: int, l: int, p: int, n: int, dtype=np.float32
) -> KernelSpec:
    """Warp footprints of the kernel ``csrc/ssd.cu`` launches for ``dtype``:
    ``ssd_tc_kernel`` for bfloat16, else ``ssd_chunk_kernel``.

    Program ``(h, ch, b, w)`` is warp ``w`` of block ``b`` of cell ``(h,
    ch)``, over a grid ``(bh, c, units + tiles, warps)`` with 8 warps
    (float32) or 4 (bfloat16); block ``b`` serves ``roles(l, p, n)[b]``.
    Warp 0 of every block reads the cell's ``a``.  A block stages 16-byte
    chunks (4 floats or 8 bf16) of its tiles, chunk ``k`` by thread ``k mod
    threads`` (``staged_elems``): a row tile ``r`` the rows ``64r ..
    64r+63`` of C, then the 64-row tiles ``0 .. r`` of B and x; a state unit
    every tile of B and x.  B and C rows are staged to N rounded up to 4
    (float32) or 16 (bfloat16), x rows to ``16 y_cols(p)`` or
    ``padded_p(p)``; only elements inside the chunk are read.  Stores: a
    float32 row tile's thread ``(ty, tx) = (t // 16, t % 16)`` stores rows
    ``4ty .. 4ty+3`` of y at its columns (``4tx + 64g + 0..3``, or ``2tx,
    2tx+1``, or ``tx`` where P <= 32); a bfloat16 warp ``w`` stores rows
    ``16w .. 16w+15``.  A float32 state unit (``p0, n0``) of ``T`` 4 x 4
    micro-tiles stores micro-tile ``t`` from thread ``t < T`` (rows ``p0 +
    4(t // tn)``, columns ``n0 + 4(t % tn)``, ``tn`` = ceil(unit width / 4));
    a bfloat16 one stores rows ``p0 + 16w .. +15`` of the unit's columns from
    warp ``w``.  Exact index walks; shared memory is not modeled.
    """
    bf16 = is_bf16(dtype)
    threads = TC_THREADS if bf16 else F32_THREADS
    warps = threads // 32
    per = 8 if bf16 else 4
    b_width = -(-n // 16) * 16 if bf16 else -(-n // 4) * 4
    x_width = padded_p(p) if bf16 else 16 * y_cols(p)
    units_n = -(-n // UNIT)
    plan = roles(l, p, n)
    tiles = tiles_of(l)
    empty = np.empty(0, np.int64)

    def cell(pid) -> int:
        return pid[0] * c + pid[1]

    def walked(pid) -> range:
        state, idx = plan[pid[2]]
        return range(tiles if state else idx + 1)

    def tile_walk(pid, width, cols):
        parts = [empty]
        for t in walked(pid):
            idx = staged_elems(pid[3], threads, TILE, width, per, l - t * TILE, cols, cols)
            parts.append((cell(pid) * l + t * TILE) * cols + idx)
        return np.concatenate(parts)

    def x_walk(pid, **_):
        return tile_walk(pid, x_width, p)

    def b_walk(pid, **_):
        return tile_walk(pid, b_width, n)

    def c_walk(pid, **_):
        state, r = plan[pid[2]]
        if state:
            return empty
        idx = staged_elems(pid[3], threads, TILE, b_width, per, l - r * TILE, n, n)
        return (cell(pid) * l + r * TILE) * n + idx

    def a_walk(pid, **_):
        if pid[3] != 0:
            return empty
        return cell(pid) * l + np.arange(l, dtype=np.int64)

    def y_walk(pid, **_):
        state, r = plan[pid[2]]
        w = pid[3]
        if state:
            return empty
        i0 = r * TILE
        if bf16:
            rows = np.arange(i0 + 16 * w, min(i0 + 16 * w + 16, l), dtype=np.int64)
            return cell(pid) * l * p + _row_block(rows, np.arange(p, dtype=np.int64), p)
        pc = y_cols(p)
        parts = [empty]
        for tid in range(32 * w, 32 * w + 32):
            ty, tx = divmod(tid, 16)
            rows = np.arange(i0 + 4 * ty, min(i0 + 4 * ty + 4, l), dtype=np.int64)
            q = np.arange(pc, dtype=np.int64)
            cols = 4 * tx + 64 * (q // 4) + q % 4 if pc >= 4 else pc * tx + q
            parts.append(cell(pid) * l * p + _row_block(rows, cols[cols < p], p))
        return np.concatenate(parts)

    def s_walk(pid, **_):
        state, u = plan[pid[2]]
        w = pid[3]
        if not state:
            return empty
        p0, n0 = (u // units_n) * UNIT, (u % units_n) * UNIT
        base = cell(pid) * p * n
        if bf16:
            rows = np.arange(p0 + 16 * w, min(p0 + 16 * w + 16, p), dtype=np.int64)
            cols = np.arange(n0, min(n0 + UNIT, n), dtype=np.int64)
            return base + _row_block(rows, cols, n)
        tn = -(-min(UNIT, n - n0) // 4)
        tp = -(-min(UNIT, p - p0) // 4)
        parts = [empty]
        for tid in range(32 * w, min(32 * w + 32, tp * tn)):
            pa, nb = p0 + 4 * (tid // tn), n0 + 4 * (tid % tn)
            rows = np.arange(pa, min(pa + 4, p), dtype=np.int64)
            cols = np.arange(nb, min(nb + 4, n), dtype=np.int64)
            parts.append(base + _row_block(rows, cols, n))
        return np.concatenate(parts)

    in_dtype = BF16_STORAGE if bf16 else dtype

    def spec_of(name, shape, dt, kind="load"):
        return OperandSpec(name, shape, dt, shape, lambda *pid: (0,) * len(shape), kind=kind)

    return KernelSpec(
        name="ssd_chunk",
        grid=(bh, c, len(plan), warps),
        operands=(
            spec_of("X", (bh, c, l, p), in_dtype),
            spec_of("A", (bh, c, l), in_dtype),
            spec_of("B", (bh, c, l, n), in_dtype),
            spec_of("C", (bh, c, l, n), in_dtype),
            spec_of("Y", (bh, c, l, p), np.float32, kind="store"),
            spec_of("S", (bh, c, p, n), np.float32, kind="store"),
        ),
        dynamic=(("X", x_walk), ("A", a_walk), ("B", b_walk), ("C", c_walk),
                 ("Y", y_walk), ("S", s_walk)),
    )
