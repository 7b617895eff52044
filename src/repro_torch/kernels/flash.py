"""Flash attention — the model path's attention kernel, hand-written for Hopper.

``csrc/flash.cu`` computes ``O = softmax(Q Kᵀ / sqrt(D)) V`` for q
(BH, Sq, D) and k, v (BH, Skv, D), with KV heads already broadcast to the
query heads: one block per 64-query tile walks the KV tiles of ``bkv``
rows (32, 64 or 128) with the online softmax, float32 sums and the output
in q's type.  float32 runs on the CUDA cores (4 warps a block, 16 query
rows a warp, register tiles fed by 16-byte shared loads, K and V in
32-row stages through a two-stage ``cp.async`` ring); bfloat16 on the
tensor cores (4 warps a block, ``mma.sync`` with K and V staged as bf16 in
a two-stage ``cp.async`` ring).  The causal mask is aligned
top-left, as the Pallas kernel's (``repro/kernels/flash.py``): query row
i sees keys j <= i.  (The
JAX package's oracle ``flash_ref`` aligns it bottom-right, ``j <= i + Skv -
Sq``; the two agree only when Sq = Skv.  The port's plain version follows
the kernel.)

The wrapper ``flash_attention(q, k, v, causal=True, bkv=64)`` checks its
operands, launches on the current stream and counts its launches in
``flash_attention.launches``.  Given CPU tensors it computes the plain
version (``flash_plain``) instead; given CUDA tensors it launches the
kernel or raises.

``flash_spec`` describes what each warp of the CUDA kernel of the given
dtype reads and writes under the H100 sector geometry.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: KV tile widths the kernel is built for.
BKV_CHOICES = (32, 64, 128)
#: Query rows per block, and warps per block of the float32 kernel and of
#: the bfloat16 one (each warp of either owns 16 query rows).
BQ = 64
WARPS = 4
TC_WARPS = 4
#: Keys a ring stage of the float32 kernel holds; each of its warps copies
#: 8 rows of every K and V stage.
KV_STAGE = 32
MAX_D = 128
#: The Pallas kernel's masked score (``-inf`` would give NaN rows).
NEG_INF = -1e30
_GRID_Y_MAX = 65535  # bh of the bfloat16 grid, query tiles of the float32 one


def _check_operands(q, k, v, bkv: int) -> None:
    """Raise on anything the kernel does not take."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("flash operands q, k, v must be torch tensors")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(
            f"flash needs q (BH, Sq, D) and k, v (BH, Skv, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape != v.shape or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"k and v must be (BH, Skv, D) for q {tuple(q.shape)}, got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"flash takes float32 or bfloat16 operands of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device) or not (q.is_cuda or q.is_cpu):
        raise ValueError(
            f"operands must share one cpu or cuda device, got {q.device}, "
            f"{k.device}, {v.device}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash operands must be contiguous (row-major)")
    bh, sq, d = q.shape
    skv = k.shape[1]
    if min(bh, sq, skv, d) < 1 or d > MAX_D or max(bh, math.ceil(sq / BQ)) > _GRID_Y_MAX:
        raise ValueError(
            f"unsupported flash shape bh={bh} sq={sq} skv={skv} d={d} "
            f"(d <= {MAX_D}, bh and sq/{BQ} <= {_GRID_Y_MAX})"
        )
    if bkv not in BKV_CHOICES:
        raise ValueError(f"bkv must be one of {BKV_CHOICES}, got {bkv}")


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool = True, bkv: int = 64) -> torch.Tensor:
    """The plain PyTorch version: float32 scores and softmax, the
    probabilities rounded to v's type before the product with V (as the
    Pallas kernel does), the output in q's type; causal mask top-left.
    ``bkv`` is the kernel's tile width, taken so that both share one set
    of arguments; the whole-row softmax has no tiles."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sq, skv = s.shape[-2:]
        keep = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def tolerance(want: torch.Tensor, q: torch.Tensor, *_) -> torch.Tensor:
    """The largest |kernel - plain| accepted at each element of ``want``,
    the plain version's output for ``q``: a share of the largest |O| in the
    element's row.  Rows of a causal output shrink as they see more keys
    (|O| ~ sqrt(e / (i + 1)) on N(0, 1) inputs), so a bound from the whole
    output's largest value would pass wrong late rows.  float32: the two
    sum in other orders, which leaves a late row of a 4096-key causal
    output ~6e-6 of its largest |O| apart; bfloat16: one rounding of the
    output and of each probability, at most 2^-8 of the row each.
    """
    share = 2e-5 if q.dtype == torch.float32 else 2e-2
    return share * want.float().abs().amax(-1, keepdim=True)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, bkv: int = 64) -> torch.Tensor:
    """O = softmax(Q Kᵀ / sqrt(D)) V with the CUDA kernel (``csrc/flash.cu``)."""
    _check_operands(q, k, v, bkv)
    if not q.is_cuda:
        return flash_plain(q, k, v, causal)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    _build.launch(
        "flash", "repro_flash", _ARGTYPES, q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        bh, sq, k.shape[1], d, bkv, int(bool(causal)), _DTYPES[q.dtype],
    )
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

KERNELS = {"flash": flash_attention}


# ---------------------------------------------------------------------------
# profiler spec: what each warp of the CUDA kernel touches
# ---------------------------------------------------------------------------


def n_kv_tiles(qt: int, sq: int, skv: int, bkv: int, causal: bool) -> int:
    """KV tiles the block of query tile ``qt`` walks (causal stops at the
    last tile holding a key <= its last query row)."""
    n = math.ceil(skv / bkv)
    if causal:
        last_q = min((qt + 1) * BQ, sq) - 1
        n = min(n, last_q // bkv + 1)
    return n


def kv_walk_end(qt: int, sq: int, skv: int, bkv: int, causal: bool) -> int:
    """One past the last K and V row the block of query tile ``qt`` stages:
    its ``n_kv_tiles`` tiles of ``bkv`` rows, cut at ``skv``."""
    return min(skv, n_kv_tiles(qt, sq, skv, bkv, causal) * bkv)


def stage_rows(w: int) -> np.ndarray:
    """Rows of a 32-row K or V stage that warp ``w`` of ``flash_kernel``
    (the float32 route) copies: ``8w .. 8w+7``."""
    per = KV_STAGE // WARPS
    return np.arange(w * per, (w + 1) * per, dtype=np.int64)


def _row_elems(rows: np.ndarray, d: int) -> np.ndarray:
    return (rows[:, None] * d + np.arange(d, dtype=np.int64)).reshape(-1)


def is_bf16(dtype) -> bool:
    """Whether ``dtype`` (a torch or numpy dtype, a numpy extension type,
    or a name) is bfloat16: the type whose kernels run on the tensor cores."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    name = getattr(dtype, "__name__", None) or str(dtype)
    return name.replace("torch.", "") == "bfloat16"


#: The dtype a bfloat16 spec gives its operands: the engine reads only the
#: itemsize, and numpy has no bfloat16.
BF16_STORAGE = np.dtype(np.uint16)


def padded_d(d: int) -> int:
    """Columns the bfloat16 kernel stages a row of Q, K and V with: the
    least of 16, 32, 64 and 128 that holds ``d`` (the rest zero-filled)."""
    return next(p for p in (16, 32, 64, 128) if d <= p)


def staged_chunks(w: int, rows: int, chunks: int, threads: int = 32 * TC_WARPS):
    """(row, chunk) of each 16-byte chunk that warp ``w`` copies of a
    ``rows`` x ``chunks`` tile, when thread t of the block copies chunks
    t, t + threads, ... (chunk i is row i // chunks, chunk i % chunks)."""
    starts = np.arange(32 * w, rows * chunks, threads, dtype=np.int64)
    i = (starts[:, None] + np.arange(32, dtype=np.int64)).reshape(-1)
    i = i[i < rows * chunks]
    return i // chunks, i % chunks


def chunk_elems(rows: np.ndarray, chunks: np.ndarray, row_len: int, cols: int) -> np.ndarray:
    """Flat indices, in a row-major array of ``row_len`` columns, of the
    elements below column ``cols`` of 8-element chunk ``chunks[i]`` of row
    ``rows[i]``."""
    c = chunks[:, None] * 8 + np.arange(8, dtype=np.int64)
    return (rows[:, None] * row_len + c)[c < cols]


def flash_spec(
    bh: int, sq: int, skv: int, d: int, bkv: int = 64, causal: bool = True,
    dtype=np.float32,
) -> KernelSpec:
    """Warp footprints of the kernel ``csrc/flash.cu`` launches for
    ``dtype``: ``flash_tc_kernel`` for bfloat16 (``_tc_spec``), else
    ``flash_kernel`` (``cuda_core_spec``)."""
    if is_bf16(dtype):
        return _tc_spec(bh, sq, skv, d, bkv, causal)
    return cuda_core_spec(bh, sq, skv, d, bkv, causal, dtype)


def cuda_core_spec(
    bh: int, sq: int, skv: int, d: int, bkv: int = 64, causal: bool = True,
    dtype=np.float32,
) -> KernelSpec:
    """Warp footprints of ``flash_kernel`` (``csrc/flash.cu``), the float32
    route on the CUDA cores.

    Program ``(h, qt, w)`` is warp ``w`` (0..3) of the block of query tile
    ``qt`` (64 rows) of head ``h``, over a grid ``(bh, ceil(sq/64), 4)``
    (the kernel launches the tiles last first, which moves no footprint).
    Warp w owns query rows ``64qt + 16w .. +15``: it stages them (those
    below ``sq``), and stores them as rows of O.  Its block walks the K and
    V rows below ``kv_walk_end`` (``n_kv_tiles`` tiles of ``bkv`` rows,
    causal blocks stopping at the diagonal) as stages of 32 rows, and the
    warp copies rows ``8w .. 8w+7`` of every stage (``stage_rows``).  Every row
    is read or stored whole, its ``d`` columns; the kernel's 16-byte
    chunks and its 4-byte words off alignment touch the same elements.  The
    footprints are exact index walks: a causal block walks as many tiles
    as its diagonal allows, which no fixed block shape describes.  Shared
    memory and registers are not modeled, as the reference does not model
    the Pallas pipeline's VMEM buffers.
    """

    def q_rows(pid) -> np.ndarray:
        h, qt, w = pid
        per = BQ // WARPS
        lo = qt * BQ + per * w
        return h * sq + np.arange(lo, min(lo + per, sq), dtype=np.int64)

    def kv_rows(pid) -> np.ndarray:
        h, qt, w = pid
        end = kv_walk_end(qt, sq, skv, bkv, causal)
        starts = np.arange(0, end, KV_STAGE, dtype=np.int64)
        rows = (starts[:, None] + stage_rows(w)).reshape(-1)
        return h * skv + rows[rows < end]

    def q_walk(pid, **_):
        return _row_elems(q_rows(pid), d)

    def kv_walk(pid, **_):
        return _row_elems(kv_rows(pid), d)

    def spec_of(name, rows, kind="load"):
        return OperandSpec(name, (bh, rows, d), dtype, (1, rows, d),
                           lambda h, qt, w: (h, 0, 0), kind=kind)

    return KernelSpec(
        name="flash_attention",
        grid=(bh, math.ceil(sq / BQ), WARPS),
        operands=(
            spec_of("Q", sq), spec_of("K", skv), spec_of("V", skv),
            spec_of("O", sq, kind="store"),
        ),
        dynamic=(("Q", q_walk), ("K", kv_walk), ("V", kv_walk), ("O", q_walk)),
    )


def _tc_spec(bh: int, sq: int, skv: int, d: int, bkv: int, causal: bool) -> KernelSpec:
    """Warp footprints of ``flash_tc_kernel`` (``csrc/flash.cu``), the
    bfloat16 route on the tensor cores.

    Program ``(h, qt, w)`` is warp ``w`` (0..3) of the block of query tile
    ``qt`` (64 rows) of head ``h``, over a grid ``(bh, ceil(sq/64), 4)``.
    Rows are staged in 16-byte chunks of 8 elements, ``padded_d(d) / 8`` a
    row, and thread t of the block's 128 copies chunks t, t + 128, ... of
    each staged tile (``staged_chunks``): of the Q tile, and of every K and
    V tile its block walks (``n_kv_tiles``), the elements below ``sq`` or
    ``skv`` and column ``d``.  Warp w stores rows ``16w .. 16w+15`` of the
    O tile.  Exact index walks; shared memory is not modeled.
    """
    chunks = padded_d(d) // 8

    def q_walk(pid, **_):
        h, qt, w = pid
        r, c = staged_chunks(w, BQ, chunks)
        live = qt * BQ + r < sq
        return chunk_elems(h * sq + qt * BQ + r[live], c[live], d, d)

    def kv_walk(pid, **_):
        h, qt, w = pid
        r, c = staged_chunks(w, bkv, chunks)
        parts = [np.empty(0, np.int64)]
        for t in range(n_kv_tiles(qt, sq, skv, bkv, causal)):
            live = t * bkv + r < skv
            parts.append(chunk_elems(h * skv + t * bkv + r[live], c[live], d, d))
        return np.concatenate(parts)

    def o_walk(pid, **_):
        h, qt, w = pid
        lo = qt * BQ + 16 * w
        return _row_elems(h * sq + np.arange(lo, min(lo + 16, sq), dtype=np.int64), d)

    def spec_of(name, rows, kind="load"):
        return OperandSpec(name, (bh, rows, d), BF16_STORAGE,
                           (1, rows, d), lambda h, qt, w: (h, 0, 0), kind=kind)

    return KernelSpec(
        name="flash_attention",
        grid=(bh, math.ceil(sq / BQ), TC_WARPS),
        operands=(
            spec_of("Q", sq), spec_of("K", skv), spec_of("V", skv),
            spec_of("O", sq, kind="store"),
        ),
        dynamic=(("Q", q_walk), ("K", kv_walk), ("V", kv_walk), ("O", o_walk)),
    )
