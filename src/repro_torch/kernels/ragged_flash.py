"""Ragged MQA decode attention — the serving kernel, hand-written for Hopper.

A decode batch packs sequences of very different lengths: sequence ``b``
attends only to KV positions in ``[starts[b], ends[b])``.  Q is ``(B, H,
D)``, one query per sequence, and K, V are ``(B, S, D)``: one KV head shared
by all H query heads (MQA).  ``csrc/ragged_decode.cu`` splits each
sequence's KV axis into splits of :func:`split_len` positions at absolute
places (flash-decoding): one block per (split, sequence) holds all H
heads, stages each live K/V row in shared memory once for all of them and
stores its softmax state to a float32 workspace; a combine kernel merges
the live splits of each sequence in split order.  A split wholly outside
the range is never read (the Pallas kernel's ``pl.when`` gate in
``repro/kernels/ragged_flash.py``).  With ``dense=True`` the gate is off:
every row is read and masked, which gives the same bits and is the
registry's baseline rung.

The wrapper ``ragged_decode_attention(q, k, v, starts, ends, bkv=128,
dense=False)`` checks its operands, launches on the current stream and
counts its launches in ``ragged_decode_attention.launches``.  Given CPU
tensors it computes the plain version (``ragged_decode_plain``) instead;
given CUDA tensors it launches the kernel or raises.  Bounds are clamped
to ``[0, S)``.

A fact of the reference: for a sequence with ``starts[b] == ends[b]`` the
Pallas kernel returns the mean of V over the one tile its gate still
admits (all its scores are NEG_INF, so each weighs ``exp(0) = 1``), which
depends on the tile width, and ``ragged_decode_reference`` the mean of V
over all S.  The port returns 0 there, in kernel, plain version and
oracle alike, as the Pallas paged kernel does for an empty context.

The spec builders describe what each warp of the CUDA kernel reads and
writes under the H100 sector geometry; the prefill specs have no kernel
in either package and describe ``csrc/flash.cu``'s walk of a causal
prefill, without and with the ragged gate.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build
from .flash import BF16_STORAGE, cuda_core_spec, is_bf16, padded_d, staged_chunks

NEG_INF = -1e30

# registry default shapes (CI-sized; see ragged_context for the bounds)
DEF_B, DEF_H, DEF_S, DEF_D, DEF_BKV = 4, 8, 512, 128, 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: KV tile widths the kernel is built for.
BKV_CHOICES = (32, 64, 128)
MAX_H = 64
MAX_D = 128
_INT32_MAX = 2**31 - 1
#: Splits a sequence at most (``csrc/split_decode.cuh``, the ragged and the
#: paged kernel alike).
MAX_SPLITS = 32
#: The split kernels' threads and chunk rows: float32 on the CUDA cores,
#: bfloat16 on the tensor cores; the combine kernel runs the same threads.
SPLIT_THREADS = {"float32": 256, "bfloat16": 128}
SPLIT_CHUNK = {"float32": 32, "bfloat16": 64}


def split_len(s: int, bkv: int = DEF_BKV) -> int:
    """Positions a split covers: a multiple of ``bkv``, at least two tiles,
    and long enough that a sequence has at most 32 splits.  A function of
    (S, bkv) alone.  The paged kernel takes ``split_len(slots * page,
    page)``: splits of whole pages."""
    tiles = -(-s // bkv)
    return bkv * max(2, -(-tiles // MAX_SPLITS))


def n_splits(s: int, bkv: int = DEF_BKV) -> int:
    return -(-s // split_len(s, bkv))


def ragged_context(b: int = DEF_B, s: int = DEF_S) -> Dict[str, np.ndarray]:
    """Deterministic ragged bounds: starts near 0, ends well short of S
    (the reference's draw, array for array)."""
    rng = np.random.default_rng(0)
    starts = rng.integers(0, s // 8, size=b).astype(np.int32)
    ends = (starts + rng.integers(s // 8, s // 2, size=b)).astype(np.int32)
    return {"starts": starts, "ends": np.minimum(ends, s).astype(np.int32)}


def _check_bounds(name: str, t, b: int, device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 or tuple(t.shape) != (b,):
        raise TypeError(f"{name} must be an int32 tensor of shape ({b},)")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on {device}, got {t.device}")


def _check_operands(q, k, v, starts, ends, bkv: int) -> None:
    """Raise on anything the kernel does not take."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("ragged decode operands q, k, v must be torch tensors")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"ragged decode needs q (B, H, D) and k, v (B, S, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"k and v must be (B, S, D) for q {tuple(q.shape)}, got {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"ragged decode takes float32 or bfloat16 operands of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device) or not (q.is_cuda or q.is_cpu):
        raise ValueError(
            f"operands must share one cpu or cuda device, got {q.device}, {k.device}, {v.device}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("ragged decode operands must be contiguous (row-major)")
    _check_bounds("starts", starts, b, q.device)
    _check_bounds("ends", ends, b, q.device)
    s = k.shape[1]
    if min(b, h, s, d) < 1 or h > MAX_H or d > MAX_D or k.numel() > _INT32_MAX:
        raise ValueError(
            f"unsupported ragged decode shape b={b} h={h} s={s} d={d} "
            f"(h <= {MAX_H}, d <= {MAX_D})"
        )
    if bkv not in BKV_CHOICES:
        raise ValueError(f"bkv must be one of {BKV_CHOICES}, got {bkv}")


def ragged_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        starts: torch.Tensor, ends: torch.Tensor,
                        bkv: int = DEF_BKV, dense: bool = False) -> torch.Tensor:
    """The plain PyTorch version: the kernel's online softmax over tiles of
    ``bkv`` positions, float32 scores and sums, masked keys at probability
    0, the probabilities rounded to v's type before the product with V (as
    the Pallas kernel does, which ties the bfloat16 answer to the tiling),
    the output in q's type.  ``dense`` only says which tiles the kernel
    reads; the answer is the same."""
    b, h, d = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    lo = starts.long().clamp(0, s)[:, None]
    hi = ends.long().clamp(0, s)[:, None]
    qf = q.float()
    m = torch.full((b, h, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, 1), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    for k0 in range(0, s, bkv):
        kt, vt = k[:, k0:k0 + bkv], v[:, k0:k0 + bkv]
        pos = torch.arange(k0, k0 + kt.shape[1], device=q.device)
        live = ((pos >= lo) & (pos < hi))[:, None, :]
        sc = torch.matmul(qf, kt.float().transpose(1, 2)) * scale
        sc = sc.masked_fill(~live, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(sc - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def ragged_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Oracle: one masked softmax over all S positions, in float32 (float64
    for float64 inputs); a sequence with no live position gets 0."""
    work = torch.promote_types(q.dtype, torch.float32)
    s = k.shape[1]
    pos = torch.arange(s, device=q.device)
    live = (pos >= starts.long()[:, None]) & (pos < ends.long()[:, None])  # (B, S)
    sc = torch.matmul(q.to(work), k.to(work).transpose(1, 2)) / math.sqrt(q.shape[-1])
    p = torch.softmax(sc.masked_fill(~live[:, None, :], NEG_INF), dim=-1)
    p = p * live.any(-1)[:, None, None]
    return torch.matmul(p, v.to(work)).to(q.dtype)


def tolerance(want: torch.Tensor, q: torch.Tensor, *_) -> torch.Tensor:
    """The largest |kernel - plain| accepted at each element of ``want``,
    the plain version's output for ``q``: a share of the largest |O| in the
    element's (sequence, head) row.  float32: the two sum the D-long dot
    products and the probabilities in other orders, a few ulps of the row;
    bfloat16: one rounding of the output and of each probability, at most
    2^-8 of the row each.  An empty row is 0 in both, exactly."""
    share = 2e-5 if q.dtype == torch.float32 else 2e-2
    return share * want.float().abs().amax(-1, keepdim=True)


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def ragged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            starts: torch.Tensor, ends: torch.Tensor,
                            bkv: int = DEF_BKV, dense: bool = False) -> torch.Tensor:
    """O[b] = softmax(q[b] K[b]ᵀ / sqrt(D)) V[b] over [starts[b], ends[b])
    with the CUDA kernels (``csrc/ragged_decode.cu``): the split kernel and
    the combine, one launch on the count."""
    _check_operands(q, k, v, starts, ends, bkv)
    if not q.is_cuda:
        return ragged_decode_plain(q, k, v, starts, ends, bkv, dense)
    b, h, d = q.shape
    s = k.shape[1]
    length = split_len(s, bkv)
    o = torch.empty_like(q)
    ws = torch.empty((b, n_splits(s, bkv), h * (d + 2)), dtype=torch.float32, device=q.device)
    _build.launch(
        "ragged_decode", "repro_ragged_decode", _ARGTYPES, q,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), starts.data_ptr(),
        ends.data_ptr(), ws.data_ptr(), o.data_ptr(), b, h, s, d, length,
        int(bool(dense)), _DTYPES[q.dtype],
    )
    ragged_decode_attention.launches += 1
    return o


ragged_decode_attention.launches = 0

KERNELS = {"ragged_decode": ragged_decode_attention}


# ---------------------------------------------------------------------------
# profiler specs: what each warp of the CUDA kernel touches
# ---------------------------------------------------------------------------


def live_range(bi: int, s: int, starts, ends):
    """Sequence ``bi``'s live positions ``[lo, hi)``, clamped to [0, s)."""
    return max(int(starts[bi]), 0), min(int(ends[bi]), s)


def _bounds_operands(b: int) -> tuple:
    # every warp reads its sequence's two bounds
    return tuple(
        OperandSpec(name, (b,), np.int32, (1,), lambda bi, *_: (bi,))
        for name in ("starts", "ends")
    )


def _gate(walk, s: int, d: int):
    """``walk`` (flat indices of a (B, S, D) operand) cut to the rows inside
    sequence b's ``[starts[b], ends[b])``: the Level-2 model of the gate."""

    def gated(pid, starts=None, ends=None, **_):
        if starts is None or ends is None:
            return np.empty(0, np.int64)
        lo, hi = live_range(pid[0], s, starts, ends)
        idx = walk(pid)
        row = idx // d % s
        return idx[(row >= lo) & (row < hi)]

    return gated


def split_route(dtype):
    """(route, storage dtype) of a split-decode spec: ``bfloat16`` names the
    tensor-core kernels (2-byte storage), anything else the float32 ones."""
    if is_bf16(dtype):
        return "bfloat16", BF16_STORAGE
    return "float32", (np.float32 if isinstance(dtype, torch.dtype) else dtype)


def split_chunks(lo: int, hi: int, g0: int, g1: int, ch: int, gated: bool):
    """The chunks a block walks over split ``[g0, g1)`` for live positions
    ``[lo, hi)`` (``split_decode.cuh:SplitWalk``): ``(c0, n, (r_lo, r_hi),
    (l_lo, l_hi))``, the chunk at position c0 with n rows, the rows it
    stages and the rows that are live.  Gated: the chunks that hold a live
    row, their live rows staged; dense: every chunk, every row staged."""
    out = []
    for c0 in range(g0, g1, ch):
        n = min(ch, g1 - c0)
        live = (max(lo - c0, 0), min(hi - c0, n))
        if gated and live[0] >= live[1]:
            continue
        out.append((c0, n, live if gated else (0, n), live))
    return out


def split_spec(name: str, b: int, h: int, s: int, d: int, length: int, dtype, gated: bool,
               live, rows, walked: tuple, scalars: tuple) -> KernelSpec:
    """The split kernel and the combine of ``csrc/split_decode.cuh`` as one
    grid ``(B, G + Y, W)``: program ``(b, j, w)`` is warp w of split j's
    block for j < G, else of combine block j - G (G = ceil(S / length)
    splits, Y = ceil(H D / 4T) combine blocks, W = T / 32 for the route's
    T threads).  Split warp ``(b, j, w)`` reads the scalars, stages its
    16-byte chunks of sequence b's Q rows and of the staged rows of each
    chunk of split j it walks (``split_chunks``; thread t copies chunks t,
    t + T, ... of each tile), and stores its floats t, t + T, ... of the
    split's workspace record; a gated split with no live key reads only
    the scalars.  Combine warp ``(b, G + y, w)`` reads the scalars, its
    floats of the live splits' m and l and its elements of their
    accumulators, and stores those elements of O.

    ``live(b, ctx)`` is sequence b's live range ``[lo, hi)`` clamped to
    [0, S), or None without the context.  ``rows(b, c0, r, c, elems, lo,
    hi, ctx)`` gives a warp's reads when it stages the items ``(r, c)`` of
    the chunk at position c0 (row r is position c0 + r, item c its
    columns ``elems c ..``), and ``(lo, hi)`` the chunk's live rows that
    every warp checks for its presence mask: ``{operand: flat indices}``.
    ``walked`` are the operands read by those index walks (Q, the cache,
    a table)."""
    route, storage = split_route(dtype)
    threads, chunk = SPLIT_THREADS[route], SPLIT_CHUNK[route]
    elems = 16 // np.dtype(storage).itemsize
    per_row = padded_d(d) // 8 if route == "bfloat16" else -(-d // 4)
    mp = -(-h // 16) * 16 if route == "bfloat16" else h
    g_n = -(-s // length)
    hd, rec = h * d, h * (d + 2)
    y_n = -(-hd // (4 * threads))
    empty = np.empty(0, np.int64)

    def lanes(w, n):
        """Elements t, t + threads, ... below n of warp w's threads."""
        e = (np.arange(0, n, threads, dtype=np.int64)[:, None]
             + 32 * w + np.arange(32, dtype=np.int64)).reshape(-1)
        return e[e < n]

    def out_elems(y, w):
        e = ((4 * y + np.arange(4, dtype=np.int64))[:, None] * threads
             + 32 * w + np.arange(32, dtype=np.int64)).reshape(-1)
        return e[e < hd]

    def program(pid, ctx):
        """{operand: flat indices} of program pid."""
        bi, j, w = pid
        rng = live(bi, ctx)
        if rng is None:
            return {}
        lo, hi = rng
        out = {}

        def add(reads):
            for op, idx in reads.items():
                out.setdefault(op, []).append(idx)

        if j < g_n:
            g0, g1 = j * length, min((j + 1) * length, s)
            if gated and max(lo, g0) >= min(hi, g1):
                return out  # returns after reading the scalars
            r, c = staged_chunks(w, mp, per_row, threads)
            r, c = r[r < h], c[r < h]
            col = c[:, None] * elems + np.arange(elems, dtype=np.int64)
            add({"Q": ((bi * h + r[:, None]) * d + col)[col < d]})
            for c0, n, (r_lo, r_hi), (l_lo, l_hi) in split_chunks(lo, hi, g0, g1, chunk, gated):
                r, c = staged_chunks(w, chunk, per_row, threads)
                keep = (r >= r_lo) & (r < r_hi)
                add(rows(bi, c0, r[keep], c[keep], elems, l_lo, l_hi, ctx))
            add({"ws": (bi * g_n + j) * rec + lanes(w, rec)})
            return out
        e = out_elems(j - g_n, w)
        add({"O": bi * hd + e})  # an empty row stores its zeros too
        if lo < hi:
            first = lo // length
            nlive = (hi - 1) // length - first + 1
            f = lanes(w, nlive * 2 * h)
            recs = (bi * g_n + first + np.arange(nlive, dtype=np.int64)) * rec
            add({"ws": np.concatenate([recs[f // (2 * h)] + hd + f % (2 * h),
                                       (recs[:, None] + e).reshape(-1)])})
        return out

    def walk_of(op):
        def walk(pid, **ctx):
            parts = program(pid, ctx).get(op)
            return np.concatenate(parts) if parts else empty

        return walk

    ops = (*walked, *scalars,
           OperandSpec("ws", (b, g_n, rec), np.float32, (1, g_n, rec),
                       lambda bi, *_: (bi, 0, 0), kind="store"),
           OperandSpec("O", (b, h, d), storage, (1, h, d), lambda bi, *_: (bi, 0, 0),
                       kind="store"))
    dynamic = tuple((op, walk_of(op)) for op in (*(o.name for o in walked), "ws", "O"))
    return KernelSpec(name=name, grid=(b, g_n + y_n, threads // 32), operands=ops,
                      dynamic=dynamic)


def _decode_spec(name, b, h, s, d, bkv, dtype, gated) -> KernelSpec:
    """The split kernel and the combine of ``csrc/ragged_decode.cu``
    (``split_spec`` over the contiguous cache: row p of sequence b at
    flat row b S + p)."""
    storage = split_route(dtype)[1]

    def live(bi, ctx):
        if ctx.get("starts") is None or ctx.get("ends") is None:
            return None
        return live_range(bi, s, ctx["starts"], ctx["ends"])

    def rows(bi, c0, r, c, elems, _lo, _hi, _ctx):
        col = c[:, None] * elems + np.arange(elems, dtype=np.int64)
        flat = ((bi * s + c0 + r)[:, None] * d + col)[col < d]
        return {"K": flat, "V": flat}

    def spec_of(op, n_rows):
        return OperandSpec(op, (b, n_rows, d), storage, (1, n_rows, d),
                           lambda bi, *_: (bi, 0, 0))

    return split_spec(
        name, b, h, s, d, split_len(s, bkv), dtype, gated, live, rows,
        (spec_of("Q", h), spec_of("K", s), spec_of("V", s)), _bounds_operands(b),
    )


def ragged_decode_spec(
    b: int = DEF_B, h: int = DEF_H, s: int = DEF_S, d: int = DEF_D,
    bkv: int = DEF_BKV, dtype=np.float32,
) -> KernelSpec:
    """BASELINE: the dense sweep (``dense=True``).  Split warp ``(b, g, w)``
    stages its 16-byte chunks of sequence b's Q rows and of every row of
    split g's chunks, reads ``starts[b]`` and ``ends[b]``, and stores its
    floats of the split's workspace record; combine warp ``(b, G + y, w)``
    reads the bounds, its floats of the live splits' m and l, its elements
    of their accumulators, and stores those elements of O.  ``dtype``
    bfloat16 describes the tensor-core route (4 warps, chunks of 64)."""
    return _decode_spec("ragged_decode_dense", b, h, s, d, bkv, dtype, gated=False)


def ragged_decode_ragged_spec(
    b: int = DEF_B, h: int = DEF_H, s: int = DEF_S, d: int = DEF_D,
    bkv: int = DEF_BKV, dtype=np.float32,
) -> KernelSpec:
    """OPTIMIZED: the gate -- as the dense sweep, but a split with no live
    key touches nothing past the bounds, and the others stage only their
    live rows (Level 2, over the context)."""
    return _decode_spec("ragged_decode", b, h, s, d, bkv, dtype, gated=True)


def _prefill_spec(name, b, sq, s, d, bkv, dtype, gated) -> KernelSpec:
    """``csrc/flash.cu``'s walk of a causal prefill over the (B, S, D) cache,
    as its 4-warp kernel walks it (``cuda_core_spec``, whatever ``dtype``:
    program ``(b, qt, w)`` is warp w of the block of 64-query
    tile qt), with the bounds; with the gate, K and V only inside
    ``[starts[b], ends[b])``."""
    base = cuda_core_spec(b, sq, s, d, bkv=bkv, causal=True, dtype=dtype)
    walks = dict(base.dynamic)
    if gated:
        walks["K"] = walks["V"] = _gate(walks["K"], s, d)
    q, k, v, o = base.operands
    return KernelSpec(
        name=name,
        grid=base.grid,
        operands=(q, k, v, *_bounds_operands(b), o),
        dynamic=tuple(walks.items()),
    )


def ragged_prefill_spec(
    b: int = DEF_B, sq: int = DEF_S, s: int = DEF_S, d: int = DEF_D,
    bkv: int = DEF_BKV, dtype=np.float32,
) -> KernelSpec:
    """BASELINE prefill (spec only): flash.cu's causal walk, every row."""
    return _prefill_spec("ragged_prefill_dense", b, sq, s, d, bkv, dtype, gated=False)


def ragged_prefill_ragged_spec(
    b: int = DEF_B, sq: int = DEF_S, s: int = DEF_S, d: int = DEF_D,
    bkv: int = DEF_BKV, dtype=np.float32,
) -> KernelSpec:
    """OPTIMIZED prefill (spec only): the causal walk with the ragged gate."""
    return _prefill_spec("ragged_prefill", b, sq, s, d, bkv, dtype, gated=True)
