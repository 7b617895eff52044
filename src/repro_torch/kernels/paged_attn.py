"""Paged-KV MQA decode attention — the serving kernel, hand-written for Hopper.

Serving engines keep the KV cache in fixed-size pages shared across a
batch: ``k_pages``/``v_pages`` of shape ``(1, P, page, D)`` (one KV head
shared by all H query heads), a per-sequence ``block_tables`` ``(B,
slots)`` mapping logical slots to physical pages, and ``context_lens``
``(B,)`` bounding each sequence's live prefix (vLLM's layout, as in
``repro/kernels/paged_attn.py``, whose ``_paged_decode_kernel`` this
replaces).  ``csrc/paged_decode.cu`` splits each sequence's logical
positions into splits of ``split_len(slots * page, page)`` positions
(whole pages, at most 32 splits; flash-decoding): one block per (split,
sequence) holds all H heads, stages each live K/V row once for all of
them, finding each row's page in the table, and stores its softmax state
to a float32 workspace; a combine kernel merges the live splits in split
order.  A split past ``context_lens[b]`` is never read (the Pallas
kernel's gate); a row whose page id lies outside ``[0, P)`` is not read
and adds nothing.  bfloat16 runs on the tensor cores, float32 on the CUDA
cores.  Bound on an H100 at Granite-20B's decode step: the live K and V
bytes in bfloat16, the operations in float32.  With ``dense=True`` every
row of every split is read, which gives the same bits: the registry's
baseline rung, run on a contiguous per-row cache viewed as pages under
the identity table ``b * slots + j`` (:func:`contiguous_pages`).

The wrapper ``paged_decode_attention(q, k_pages, v_pages, block_tables,
context_lens, dense=False)`` checks its operands, launches on the current
stream and counts its launches in ``paged_decode_attention.launches`` (the
split kernel and the combine: one launch on the count).  Given CPU
tensors it computes the plain version (``paged_decode_plain``); given CUDA
tensors it launches the kernels or raises.  Context lengths are clamped
to ``[0, slots * page]``.

A fact of the reference: for ``context_lens[b] == 0`` its Pallas kernel
returns 0 and ``paged_decode_reference`` the mean of the gathered pages.
The port returns 0 in kernel, plain version and oracle.

The spec builders describe what each warp of the CUDA kernels reads and
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
from .flash import BQ, WARPS, _row_elems, cuda_core_spec
from .ragged_flash import (
    _DTYPES,
    _INT32_MAX,
    MAX_D,
    MAX_H,
    NEG_INF,
    _check_bounds,
    n_splits,
    split_len,
    split_route,
    split_spec,
    tolerance,  # the decode tolerance, one for both kernels
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
    if not (q.device == k_pages.device == v_pages.device) or not (q.is_cuda or q.is_cpu):
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


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor, context_lens: torch.Tensor,
                           dense: bool = False) -> torch.Tensor:
    """O[b] = softmax(q[b] Kᵀ / sqrt(D)) V over sequence b's pages, masked to
    ``context_lens[b]``, with the CUDA kernels (``csrc/paged_decode.cu``):
    the split kernel and the combine, one launch on the count."""
    _check_operands(q, k_pages, v_pages, block_tables, context_lens)
    if not q.is_cuda:
        return paged_decode_plain(q, k_pages, v_pages, block_tables, context_lens, dense)
    b, h, d = q.shape
    n_pages, page = k_pages.shape[1:3]
    slots = block_tables.shape[1]
    s = slots * page
    o = torch.empty_like(q)
    ws = torch.empty((b, n_splits(s, page), h * (d + 2)), dtype=torch.float32, device=q.device)
    _build.launch(
        "paged_decode", "repro_paged_decode", _ARGTYPES, q,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), ws.data_ptr(), o.data_ptr(),
        b, h, d, n_pages, page, slots, split_len(s, page), int(bool(dense)),
        _DTYPES[q.dtype],
    )
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0

KERNELS = {"paged_decode": paged_decode_attention}


# ---------------------------------------------------------------------------
# profiler specs: what each warp of the CUDA kernels touches
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


def _page_rows(w: int, page: int) -> np.ndarray:
    """Rows of a page that warp ``w`` of a prefill block stages: the page's
    rows split over the block's warps (``flash.WARPS``), ``ceil(page/4)``
    a warp."""
    per = -(-page // WARPS)
    return np.arange(w * per, min((w + 1) * per, page), dtype=np.int64)


def _contiguous_walk(bi: int, w: int, n: int, page: int, s: int, d: int) -> np.ndarray:
    """Warp w's rows of the first n pages of sequence bi's contiguous cache,
    pages as the prefill's KV tiles (``_page_rows``)."""
    pos = (np.arange(n, dtype=np.int64)[:, None] * page + _page_rows(w, page)).reshape(-1)
    return _row_elems(bi * s + pos, d)


def _page_walk(bi: int, w: int, n: int, ctx: int, block_tables, page: int,
               pages: int, d: int) -> np.ndarray:
    """Warp w's live rows of the physical pages of sequence bi's first n
    slots, pages as the prefill's KV tiles (a page id outside [0, pages) is
    skipped)."""
    rows = _page_rows(w, page)
    parts = [np.empty(0, np.int64)]
    for j in range(n):
        phys = int(block_tables[bi, j])
        if 0 <= phys < pages:
            parts.append(_row_elems(phys * page + rows[rows < ctx - j * page], d))
    return np.concatenate(parts)


def _decode_spec(name, b, h, d, page, pages, slots, dtype, paged) -> KernelSpec:
    """The split kernel and the combine of ``csrc/paged_decode.cu``
    (``ragged_flash.split_spec``: splits of ``split_len(slots * page,
    page)`` positions, live range ``[0, ctx)``).  A warp that stages a row
    reads the table entry of the row's slot, and the row's 16-byte chunks
    when the page id lies in ``[0, pages)``; every warp of a block reads
    the entries of the live rows of each chunk it computes (the presence
    mask), and every warp reads ``context_lens[b]``.  ``paged``: the pool
    ``(pages, page, D)`` through the context's table, gated; else the
    dense sweep of a contiguous ``(B, slots * page, D)`` cache under the
    identity table."""
    s = slots * page
    storage = split_route(dtype)[1]

    def live(bi, ctx):
        lens, tables = ctx.get("context_lens"), ctx.get("block_tables")
        if lens is None or (paged and tables is None):
            return None
        return 0, _ctx(bi, lens, slots, page)

    def rows(bi, c0, r, c, elems, lo, hi, ctx):
        pos = c0 + r
        slot = pos // page
        if paged:
            phys = np.asarray(ctx["block_tables"])[bi, slot].astype(np.int64)
            there = (phys >= 0) & (phys < pages)
            flat_row = phys * page + pos % page
        else:  # the identity table over the contiguous cache
            there = np.ones(pos.shape, bool)
            flat_row = bi * s + pos
        col = c[there][:, None] * elems + np.arange(elems, dtype=np.int64)
        kv = (flat_row[there][:, None] * d + col)[col < d]
        checked = (c0 + np.arange(lo, hi, dtype=np.int64)) // page
        table = bi * slots + np.concatenate([slot, checked])
        return {"Kcache": kv, "Vcache": kv, "block_tables": table}

    cache = (pages, page, d) if paged else (b, s, d)
    return split_spec(
        name, b, h, s, d, split_len(s, page), dtype, paged, live, rows,
        (
            OperandSpec("Q", (b, h, d), storage, (1, h, d), lambda bi, *_: (bi, 0, 0)),
            OperandSpec("Kcache", cache, storage, cache, lambda bi, *_: (0, 0, 0)),
            OperandSpec("Vcache", cache, storage, cache, lambda bi, *_: (0, 0, 0)),
            OperandSpec("block_tables", (b, slots), np.int32, (1, slots),
                        lambda bi, *_: (bi, 0)),
        ),
        # every warp reads its sequence's context length
        (OperandSpec("context_lens", (b,), np.int32, (1,), lambda bi, *_: (bi,)),),
    )


def paged_decode_spec(
    b: int = DEF_B, h: int = DEF_H, d: int = DEF_D, page: int = DEF_PAGE,
    slots: int = DEF_SLOTS, dtype=np.float32,
) -> KernelSpec:
    """BASELINE: the dense sweep (``dense=True``) over a contiguous per-row
    cache ``(B, slots * page, D)`` under the identity table: every split
    block stages every row of every chunk of its split (``_decode_spec``).
    ``dtype`` bfloat16 describes the tensor-core route (4 warps, chunks of
    64 rows), else the float32 one (8 warps, chunks of 32)."""
    return _decode_spec("paged_decode_dense", b, h, d, page, b * slots, slots, dtype,
                        paged=False)


def paged_decode_paged_spec(
    b: int = DEF_B, h: int = DEF_H, d: int = DEF_D, page: int = DEF_PAGE,
    pages: int = DEF_PAGES, slots: int = DEF_SLOTS, dtype=np.float32,
) -> KernelSpec:
    """OPTIMIZED: the paged gather, gated: a split with no position below
    ``ctx`` reads only the length, the others stage only their live rows,
    each through the table (Level 2, over the context)."""
    return _decode_spec("paged_decode", b, h, d, page, pages, slots, dtype, paged=True)


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
    the block of 64-query tile qt: its 16 query rows, rows
    ``w*ceil(page/4) ..`` of every page up to the diagonal (``_page_rows``),
    every table entry, its 16 rows of O."""
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
