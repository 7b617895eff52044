"""Paged-KV MQA decode attention — the serving kernel, hand-written for Hopper.

Serving engines keep the KV cache in fixed-size pages shared across a
batch: ``k_pages``/``v_pages`` of shape ``(1, P, page, D)`` (one KV head
shared by all H query heads), a per-sequence ``block_tables`` ``(B,
slots)`` mapping logical slots to physical pages, and ``context_lens``
``(B,)`` bounding each sequence's live prefix (vLLM's layout, as in
``repro/kernels/paged_attn.py``).  ``csrc/paged_decode.cu`` runs one block
of 8 warps per sequence: for each slot below the live prefix it reads the
table, stages that physical page's live rows of K and V in shared memory
once for all H heads, and masks positions at or past ``context_lens[b]``.
With ``dense=True`` it walks every slot and stages every row, still
masked: the registry's baseline rung, run on a contiguous per-row cache
viewed as pages under the identity table ``b * slots + j``
(:func:`contiguous_pages`).

The wrapper ``paged_decode_attention(q, k_pages, v_pages, block_tables,
context_lens, dense=False)`` checks its operands, launches on the current
stream and counts its launches in ``paged_decode_attention.launches``.
Given CPU tensors it computes the plain version (``paged_decode_plain``);
given CUDA tensors it launches the kernel or raises.  Context lengths are
clamped to ``[0, slots * page]``; a slot whose page id lies outside
``[0, P)`` adds nothing, in kernel and plain version alike.

A fact of the reference: for ``context_lens[b] == 0`` its Pallas kernel
returns 0 and ``paged_decode_reference`` the mean of the gathered pages.
The port returns 0 in kernel, plain version and oracle.

The spec builders describe what each warp of the CUDA kernel reads and
writes under the H100 sector geometry; the prefill specs have no kernel
in either package and describe ``csrc/flash.cu``'s causal walk over the
pages, without and with the table gather and the context clamp.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build
from .flash import BQ, _row_elems, cuda_core_spec
from .ragged_flash import (
    _DTYPES,
    _INT32_MAX,
    MAX_D,
    MAX_H,
    NEG_INF,
    WARPS,
    _check_bounds,
    _head_walk,
    tolerance,  # the decode tolerance, one for both kernels
    warp_chunk_rows,
)

# registry default shapes (CI-sized): 4 sequences of up to 8 pages x 64
# tokens over a 64-page physical pool, MQA (one KV head)
DEF_B, DEF_H, DEF_D = 4, 8, 128
DEF_PAGE, DEF_PAGES, DEF_SLOTS = 64, 64, 8

MAX_PAGE = 128


def paged_context(
    b: int = DEF_B, pages: int = DEF_PAGES, slots: int = DEF_SLOTS,
    page: int = DEF_PAGE,
) -> Dict[str, np.ndarray]:
    """Deterministic page tables: distinct physical pages per slot, and
    context lengths landing strictly inside the max ``slots * page`` (the
    reference's draw, array for array)."""
    rng = np.random.default_rng(0)
    perm = rng.permutation(pages)[: b * slots]
    tables = perm.reshape(b, slots).astype(np.int32)
    lens = rng.integers(page + 1, slots * page // 2, size=b).astype(np.int32)
    return {"block_tables": tables, "context_lens": lens}


def contiguous_pages(cache: torch.Tensor, page: int):
    """A contiguous per-row cache ``(B, slots * page, D)`` viewed as pages:
    ``(1, B * slots, page, D)`` and the identity table ``b * slots + j``."""
    b, s, d = cache.shape
    slots = s // page
    table = torch.arange(b * slots, dtype=torch.int32, device=cache.device)
    return cache.reshape(1, b * slots, page, d), table.reshape(b, slots)


def _check_operands(q, k_pages, v_pages, block_tables, context_lens) -> None:
    """Raise on anything the kernel does not take."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k_pages, v_pages)):
        raise TypeError("paged decode operands q, k_pages, v_pages must be torch tensors")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged decode needs q (B, H, D) and k_pages, v_pages (1, P, page, D), "
            f"got {tuple(q.shape)}, {tuple(k_pages.shape)}, {tuple(v_pages.shape)}"
        )
    b, h, d = q.shape
    kv_heads, n_pages, page, dk = k_pages.shape
    if kv_heads != 1 or dk != d:
        raise ValueError(
            f"k_pages and v_pages must be (1, P, page, D) for q {tuple(q.shape)}, "
            f"got {tuple(k_pages.shape)}"
        )
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"paged decode takes float32 or bfloat16 operands of one dtype, got "
            f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}"
        )
    if not (q.device == k_pages.device == v_pages.device) or q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"operands must share one cpu or cuda device, got {q.device}, "
            f"{k_pages.device}, {v_pages.device}"
        )
    if not (q.is_contiguous() and k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged decode operands must be contiguous (row-major)")
    if (
        not isinstance(block_tables, torch.Tensor) or block_tables.dtype != torch.int32
        or block_tables.dim() != 2 or block_tables.shape[0] != b
    ):
        raise TypeError(f"block_tables must be an int32 tensor of shape ({b}, slots)")
    if block_tables.device != q.device or not block_tables.is_contiguous():
        raise ValueError(f"block_tables must be contiguous and on {q.device}")
    _check_bounds("context_lens", context_lens, b, q.device)
    slots = block_tables.shape[1]
    if (
        min(b, h, d, n_pages, page, slots) < 1 or h > MAX_H or d > MAX_D
        or page > MAX_PAGE or k_pages.numel() > _INT32_MAX or slots * page > _INT32_MAX
    ):
        raise ValueError(
            f"unsupported paged decode shape b={b} h={h} d={d} pages={n_pages} "
            f"page={page} slots={slots} (h <= {MAX_H}, d <= {MAX_D}, page <= {MAX_PAGE})"
        )


def paged_decode_plain(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                       block_tables: torch.Tensor, context_lens: torch.Tensor,
                       dense: bool = False) -> torch.Tensor:
    """The plain PyTorch version: the kernel's online softmax page by page,
    float32 scores and sums, masked keys at probability 0, the
    probabilities rounded to v's type before the product with V (as the
    Pallas kernel does), the output in q's type.  ``dense`` only says which
    slots the kernel reads; the answer is the same."""
    b, h, d = q.shape
    n_pages, page = k_pages.shape[1:3]
    slots = block_tables.shape[1]
    scale = 1.0 / math.sqrt(d)
    ctx = context_lens.long().clamp(0, slots * page)[:, None]
    qf = q.float()
    m = torch.full((b, h, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, 1), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    for j in range(slots):
        phys = block_tables[:, j].long()
        valid = (phys >= 0) & (phys < n_pages)
        idx = torch.where(valid, phys, 0)
        kt, vt = k_pages[0, idx].float(), v_pages[0, idx]
        pos = j * page + torch.arange(page, device=q.device)
        live = ((pos < ctx) & valid[:, None])[:, None, :]
        sc = torch.matmul(qf, kt.transpose(1, 2)) * scale
        sc = sc.masked_fill(~live, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(sc - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = torch.matmul(p.to(v_pages.dtype).float(), vt.float())
        acc = acc * corr + torch.where(valid[:, None, None], pv, 0.0)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def paged_decode_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                     block_tables: torch.Tensor, context_lens: torch.Tensor) -> torch.Tensor:
    """Oracle: gather each sequence's pages, one masked softmax over its
    ``slots * page`` positions, in float32 (float64 for float64 inputs); a
    sequence with no live position gets 0."""
    work = torch.promote_types(q.dtype, torch.float32)
    b, h, d = q.shape
    page = k_pages.shape[2]
    slots = block_tables.shape[1]
    tables = block_tables.long()
    k = k_pages[0][tables].reshape(b, slots * page, d).to(work)
    v = v_pages[0][tables].reshape(b, slots * page, d).to(work)
    live = torch.arange(slots * page, device=q.device) < context_lens.long()[:, None]
    sc = torch.matmul(q.to(work), k.transpose(1, 2)) / math.sqrt(d)
    p = torch.softmax(sc.masked_fill(~live[:, None, :], NEG_INF), dim=-1)
    p = p * live.any(-1)[:, None, None]
    return torch.matmul(p, v).to(q.dtype)


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor, context_lens: torch.Tensor,
                           dense: bool = False) -> torch.Tensor:
    """O[b] = softmax(q[b] Kᵀ / sqrt(D)) V over sequence b's pages, masked to
    ``context_lens[b]``, with the CUDA kernel (``csrc/paged_decode.cu``)."""
    _check_operands(q, k_pages, v_pages, block_tables, context_lens)
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_tables, context_lens, dense)
    b, h, d = q.shape
    n_pages, page = k_pages.shape[1:3]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.call(
            "paged_decode", "repro_paged_decode", _ARGTYPES,
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), o.data_ptr(),
            b, h, d, n_pages, page, block_tables.shape[1], int(bool(dense)),
            _DTYPES[q.dtype], stream,
        )
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0

KERNELS = {"paged_decode": paged_decode_attention}


# ---------------------------------------------------------------------------
# profiler specs: what each warp of the CUDA kernel touches
# ---------------------------------------------------------------------------


def _ctx_operands(b: int, slots: int) -> tuple:
    return (
        OperandSpec("block_tables", (b, slots), np.int32, (1, slots),
                    lambda bi, *_: (bi, 0)),
        # every warp reads its sequence's context length
        OperandSpec("context_lens", (b,), np.int32, (1,), lambda bi, *_: (bi,)),
    )


def _ctx(bi: int, context_lens, slots: int, page: int) -> int:
    return min(max(int(context_lens[bi]), 0), slots * page)


def _contiguous_walk(bi: int, w: int, n: int, page: int, s: int, d: int) -> np.ndarray:
    """Warp w's rows of the first n pages of sequence bi's contiguous cache."""
    pos = (np.arange(n, dtype=np.int64)[:, None] * page + warp_chunk_rows(w, page)).reshape(-1)
    return _row_elems(bi * s + pos, d)


def _page_walk(bi: int, w: int, n: int, ctx: int, block_tables, page: int,
               pages: int, d: int) -> np.ndarray:
    """Warp w's live rows of the physical pages of sequence bi's first n
    slots (a page id outside [0, pages) is skipped, as the kernel does)."""
    rows = warp_chunk_rows(w, page)
    parts = [np.empty(0, np.int64)]
    for j in range(n):
        phys = int(block_tables[bi, j])
        if 0 <= phys < pages:
            parts.append(_row_elems(phys * page + rows[rows < ctx - j * page], d))
    return np.concatenate(parts)


def paged_decode_spec(
    b: int = DEF_B, h: int = DEF_H, d: int = DEF_D, page: int = DEF_PAGE,
    slots: int = DEF_SLOTS, dtype=np.float32,
) -> KernelSpec:
    """BASELINE: the dense slot sweep (``dense=True``) over a contiguous
    per-row cache ``(B, slots * page, D)`` under the identity table.
    Program ``(b, w)`` is warp w of sequence b's block: it stages its heads'
    rows of Q, reads every ``block_tables[b, j]`` and ``context_lens[b]``,
    stages rows ``w*ceil(page/8) ..`` of every page, and stores its heads'
    rows of O."""
    s = slots * page

    def kv_walk(pid, **_):
        bi, w = pid
        return _contiguous_walk(bi, w, slots, page, s, d)

    def spec_of(op, rows, kind="load"):
        return OperandSpec(op, (b, rows, d), dtype, (1, rows, d),
                           lambda bi, w: (bi, 0, 0), kind=kind)

    heads = _head_walk(h, d)
    return KernelSpec(
        name="paged_decode_dense",
        grid=(b, WARPS),
        operands=(
            spec_of("Q", h), spec_of("Kcache", s), spec_of("Vcache", s),
            *_ctx_operands(b, slots), spec_of("O", h, kind="store"),
        ),
        dynamic=(("Q", heads), ("Kcache", kv_walk), ("Vcache", kv_walk), ("O", heads)),
    )


def paged_decode_paged_spec(
    b: int = DEF_B, h: int = DEF_H, d: int = DEF_D, page: int = DEF_PAGE,
    pages: int = DEF_PAGES, slots: int = DEF_SLOTS, dtype=np.float32,
) -> KernelSpec:
    """OPTIMIZED: the paged gather.  Warp w of sequence b's block reads
    ``block_tables[b, j]`` for each slot j below ``ceil(ctx / page)`` and
    stages its rows of that physical page below the live prefix (Level 2,
    over the context)."""

    def kv_walk(pid, block_tables=None, context_lens=None, **_):
        bi, w = pid
        if block_tables is None or context_lens is None:
            return np.empty(0, np.int64)
        ctx = _ctx(bi, context_lens, slots, page)
        return _page_walk(bi, w, -(-ctx // page), ctx, block_tables, page, pages, d)

    def table_walk(pid, block_tables=None, context_lens=None, **_):
        bi, _w = pid
        if block_tables is None or context_lens is None:
            return np.empty(0, np.int64)
        return bi * slots + np.arange(-(-_ctx(bi, context_lens, slots, page) // page))

    heads = _head_walk(h, d)
    return KernelSpec(
        name="paged_decode",
        grid=(b, WARPS),
        operands=(
            OperandSpec("Q", (b, h, d), dtype, (1, h, d), lambda bi, w: (bi, 0, 0)),
            OperandSpec("Kcache", (pages, page, d), dtype, (1, page, d), lambda bi, w: (0, 0, 0)),
            OperandSpec("Vcache", (pages, page, d), dtype, (1, page, d), lambda bi, w: (0, 0, 0)),
            *_ctx_operands(b, slots),
            OperandSpec("O", (b, h, d), dtype, (1, h, d), lambda bi, w: (bi, 0, 0), kind="store"),
        ),
        dynamic=(
            ("Q", heads), ("Kcache", kv_walk), ("Vcache", kv_walk),
            ("block_tables", table_walk), ("O", heads),
        ),
    )


def _causal_slots(qt: int, sq: int, page: int, slots: int) -> int:
    """Slots the block of query tile qt walks: up to the page that holds its
    last query row (``csrc/flash.cu``'s causal stop, pages as KV tiles)."""
    last_q = min((qt + 1) * BQ, sq) - 1
    return min(slots, last_q // page + 1)


def paged_prefill_spec(
    b: int = DEF_B, sq: int = DEF_SLOTS * DEF_PAGE, d: int = DEF_D,
    page: int = DEF_PAGE, slots: int = DEF_SLOTS, dtype=np.float32,
) -> KernelSpec:
    """BASELINE prefill (spec only): flash.cu's causal walk over the
    contiguous cache, pages as KV tiles.  Program ``(b, qt, w)`` is warp w of
    the block of 64-query tile qt: its 8 query rows, rows ``w*ceil(page/8)
    ..`` of every page up to the diagonal, every table entry, its 8 rows of O."""
    s = slots * page
    base = cuda_core_spec(b, sq, s, d, bkv=page, causal=True, dtype=dtype)
    q, _, _, o = base.operands
    walks = dict(base.dynamic)

    def kv_walk(pid, **_):
        bi, qt, w = pid
        return _contiguous_walk(bi, w, _causal_slots(qt, sq, page, slots), page, s, d)

    def cache(op):
        return OperandSpec(op, (b, s, d), dtype, (1, s, d), lambda bi, qt, w: (bi, 0, 0))

    return KernelSpec(
        name="paged_prefill_dense",
        grid=base.grid,
        operands=(q, cache("Kcache"), cache("Vcache"), *_ctx_operands(b, slots), o),
        dynamic=(("Q", walks["Q"]), ("Kcache", kv_walk), ("Vcache", kv_walk), ("O", walks["O"])),
    )


def paged_prefill_paged_spec(
    b: int = DEF_B, sq: int = DEF_SLOTS * DEF_PAGE, d: int = DEF_D,
    page: int = DEF_PAGE, pages: int = DEF_PAGES, slots: int = DEF_SLOTS,
    dtype=np.float32,
) -> KernelSpec:
    """OPTIMIZED prefill (spec only): the causal walk through the block
    table, stopping at ``context_lens[b]``: slot j is walked when it lies
    below both the diagonal and the live prefix, and only its live rows
    are staged."""
    base = cuda_core_spec(b, sq, slots * page, d, bkv=page, causal=True, dtype=dtype)
    q, _, _, o = base.operands
    walks = dict(base.dynamic)

    def walked(bi, qt, context_lens):
        ctx = _ctx(bi, context_lens, slots, page)
        return ctx, min(_causal_slots(qt, sq, page, slots), -(-ctx // page))

    def kv_walk(pid, block_tables=None, context_lens=None, **_):
        bi, qt, w = pid
        if block_tables is None or context_lens is None:
            return np.empty(0, np.int64)
        ctx, n = walked(bi, qt, context_lens)
        return _page_walk(bi, w, n, ctx, block_tables, page, pages, d)

    def table_walk(pid, block_tables=None, context_lens=None, **_):
        bi, qt, _w = pid
        if block_tables is None or context_lens is None:
            return np.empty(0, np.int64)
        return bi * slots + np.arange(walked(bi, qt, context_lens)[1])

    def cache(op):
        return OperandSpec(op, (pages, page, d), dtype, (1, page, d), lambda bi, qt, w: (0, 0, 0))

    return KernelSpec(
        name="paged_prefill",
        grid=base.grid,
        operands=(q, cache("Kcache"), cache("Vcache"), *_ctx_operands(b, slots), o),
        dynamic=(
            ("Q", walks["Q"]), ("Kcache", kv_walk), ("Vcache", kv_walk),
            ("block_tables", table_walk), ("O", walks["O"]),
        ),
    )
