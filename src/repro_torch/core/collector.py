"""Trace collectors: Level 1 (block walker) and Level 2 (index traces).

Level 1.  A kernel is described by a :class:`KernelSpec`: a grid of
visitors ("programs") and, per operand, the block each visitor touches
(``block_shape`` and ``index_map``, the BlockSpec form).  For a CUDA
kernel the visitor is a *warp* and the block is that warp's footprint
over the kernel's lifetime, so a sector's temperature is the paper's
distinct-warp count; for a Pallas kernel it is a grid program and its
BlockSpec block.  The collector "instruments" the kernel by evaluating
every operand's ``index_map`` for every sampled visitor, an exact
reconstruction of the accesses the spec describes.

The walk is columnar: the sampled grid is one (P, ndim) coordinate
array, each ``index_map`` is evaluated for the whole batch (vectorized
when the map is arithmetic, per-program fallback otherwise), programs
are grouped by distinct block key with ``np.unique``, and ONE broadcast
``TraceChunk`` is emitted per key.

Each operand carries its geometry (``geometry_kind``): ``"h100-sector"``
(32 B sectors of 4 B words, the port's own kernels) or ``"tpu-tile"``
(the JAX package's tile, for parity on the reference's specs).

Level 2.  For data-dependent addressing, ``drain_dynamic`` converts a
concrete (programs x slots) index trace into records via bulk
``divmod`` / ``np.unique``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, ClassVar, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .heatmap import Analyzer, Heatmap
from .tiles import Geometry, block_to_2d, make_geometry
from .trace import (
    GridSampler,
    RegionInfo,
    SiteInfo,
    TraceBuffer,
    linearize_array,
    sampled_grid_array,
    unique_pairs,
)

IndexMap = Callable[..., Tuple[int, ...]]

#: The geometry of the port's own (CUDA) kernel specs.
DEFAULT_GEOMETRY = "h100-sector"

#: Exception types an index map / access model is *expected* to raise
#: when it cannot evaluate a probe (non-broadcastable arithmetic, bad
#: arity, piecewise maps indexing out of range, ...).  The evaluation
#: fallbacks below catch exactly these; anything else propagates.
_MAP_EVAL_ERRORS = (
    TypeError,
    ValueError,
    IndexError,
    KeyError,
    AttributeError,
    OverflowError,
    ZeroDivisionError,
    FloatingPointError,
)


@dataclasses.dataclass(frozen=True)
class OperandSpec:
    """One kernel operand as the Level-1 walker sees it."""

    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    block_shape: Tuple[int, ...]
    index_map: IndexMap
    kind: str = "load"  # 'load' | 'store' | 'accum'
    space: str = "hbm"  # 'hbm' (device memory) | 'vmem_scratch'
    # element offset of the array's origin inside its backing buffer —
    # models misaligned sub-array views (SpMV rowOffsets[r+1] analogue)
    origin: Tuple[int, int] = (0, 0)
    # True when the kernel touches this operand from ONE program only
    # (e.g. a guarded final store of a scratch accumulator)
    once: bool = False
    geometry_kind: str = DEFAULT_GEOMETRY

    @property
    def geometry(self) -> Geometry:
        return make_geometry(
            self.geometry_kind, self.shape, np.dtype(self.dtype).itemsize,
            self.name,
        )


@dataclasses.dataclass(frozen=True)
class ScratchSpec:
    """User-managed scratch (shared memory) with an access model.

    ``access_model(program_id)`` returns (row_start, row_stop, col_start,
    col_stop) slices the program touches, or None for "whole buffer".  A
    scratch buffer named in ``KernelSpec.dynamic`` is walked from its
    concrete indices instead, as a dynamic operand is (a shared-memory
    histogram scattered by data).
    """

    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    access_model: Optional[Callable[..., Iterable[Tuple[int, int, int, int]]]] = None
    kind: str = "accum"
    geometry_kind: str = DEFAULT_GEOMETRY
    space: ClassVar[str] = "vmem_scratch"
    origin: ClassVar[Tuple[int, int]] = (0, 0)

    @property
    def geometry(self) -> Geometry:
        return make_geometry(
            self.geometry_kind, self.shape, np.dtype(self.dtype).itemsize,
            self.name,
        )


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Everything the Level-1 walker needs about one kernel launch."""

    name: str
    grid: Tuple[int, ...]
    operands: Tuple[OperandSpec, ...]
    scratch: Tuple[ScratchSpec, ...] = ()
    # optional dynamic access models keyed by operand or scratch name:
    # fn(program_id, **context_arrays) -> iterable of flat element indices
    dynamic: Tuple[Tuple[str, Callable[..., Iterable[int]]], ...] = ()
    # where the spec came from: a registry ref ("name:variant") or a
    # ("module:function", args, kwargs) builder triple (whole-model
    # profiling stamps its kernels); provenance only, never walked
    source: Optional[object] = None


@dataclasses.dataclass
class CollectStats:
    records: int = 0
    programs: int = 0
    wall_s: float = 0.0
    touch_events: int = 0  # logical (record, touch) events represented


def _normalize_index(idx) -> Tuple:
    if isinstance(idx, tuple):
        return idx
    return (idx,)


def _eval_index_map_batch(
    index_map: IndexMap, pids: np.ndarray
) -> np.ndarray:
    """Evaluate an index_map for a (P, ndim) batch of program coords.

    Tries one vectorized call with array arguments, validated against
    scalar evaluation at the batch's first, middle, and last program (a
    piecewise map that agrees only at the ends must not miscollect the
    interior); falls back to the per-program loop for maps that don't
    broadcast.  Returns (P, k) int64 block coordinates.
    """
    p, ndim = pids.shape

    def _scalar(row: np.ndarray) -> Tuple[int, ...]:
        idx = _normalize_index(index_map(*[int(x) for x in row]))
        return tuple(int(i) for i in idx)

    if p > 1:
        try:
            out = _normalize_index(index_map(*[pids[:, d] for d in range(ndim)]))
            cols = [
                np.broadcast_to(np.asarray(o, dtype=np.int64), (p,))
                for o in out
            ]
            arr = np.stack(cols, axis=1)
            ok = True
            for i in sorted({0, p // 2, p - 1}):
                want = _scalar(pids[i])
                if (
                    len(want) != arr.shape[1]
                    or tuple(arr[i].tolist()) != want
                ):
                    ok = False
                    break
            if ok:
                return arr
        except _MAP_EVAL_ERRORS:
            pass  # map doesn't broadcast: take the per-program loop
    rows = [_scalar(pids[i]) for i in range(p)]
    return np.asarray(rows, dtype=np.int64).reshape(p, -1)


@dataclasses.dataclass(frozen=True)
class AffineModel:
    """Affine index-map model ``f(pid)[c] = base[c] + Σ_a coeffs[c][a]·pid[a]``.

    Extracted by :func:`probe_affine_map`: the coefficient matrix says how
    the block key moves when one grid coordinate advances by one.
    """

    base: Tuple[int, ...]
    coeffs: Tuple[Tuple[int, ...], ...]  # coeffs[c][a]: d out[c] / d pid[a]

    @property
    def n_out(self) -> int:
        """Number of output components (the block-key arity)."""
        return len(self.base)

    def predict(self, pid: Sequence[int]) -> Tuple[int, ...]:
        """Evaluate the model at one program coordinate."""
        return tuple(
            b + sum(c * int(x) for c, x in zip(row, pid))
            for b, row in zip(self.base, self.coeffs)
        )

    def predict_batch(self, pids: np.ndarray) -> np.ndarray:
        """(P, n_out) model predictions for a (P, ndim) coordinate batch."""
        base = np.asarray(self.base, dtype=np.int64)
        coef = np.asarray(self.coeffs, dtype=np.int64)
        return base[None, :] + np.asarray(pids, dtype=np.int64) @ coef.T


def _affine_probe_points(grid: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    """Sparse corner/edge/middle validation points of one grid."""
    ndim = len(grid)
    origin = (0,) * ndim
    last = tuple(g - 1 for g in grid)
    mid = tuple(g // 2 for g in grid)
    points = {origin, last, mid}
    for a in range(ndim):
        for v in (grid[a] - 1, grid[a] // 2):
            lo = list(origin)
            lo[a] = v
            points.add(tuple(lo))
            hi = list(last)
            hi[a] = v
            points.add(tuple(hi))
    return sorted(points)


def probe_affine_map(
    index_map: IndexMap, grid: Sequence[int]
) -> Optional[AffineModel]:
    """Extract an affine model of ``index_map`` over ``grid``, or ``None``.

    Reads the base off ``f(0, ..., 0)`` and each axis coefficient off the
    unit-vector probe ``f(e_a) - f(0)``, then validates the model by
    scalar evaluation at sparse corner, edge, and middle points.  Maps
    that raise, change output arity, or disagree anywhere probed are
    non-affine (``None``).  Axes of extent 1 contribute coefficient 0.
    """
    grid = tuple(int(g) for g in grid)
    ndim = len(grid)

    def at(pid: Sequence[int]) -> Tuple[int, ...]:
        idx = _normalize_index(index_map(*[int(x) for x in pid]))
        return tuple(int(i) for i in idx)

    try:
        base = at((0,) * ndim)
        coeffs = [[0] * ndim for _ in base]
        for a in range(ndim):
            if grid[a] < 2:
                continue
            probe = [0] * ndim
            probe[a] = 1
            out = at(probe)
            if len(out) != len(base):
                return None
            for c in range(len(base)):
                coeffs[c][a] = out[c] - base[c]
        model = AffineModel(
            base=base, coeffs=tuple(tuple(row) for row in coeffs)
        )
        for pt in _affine_probe_points(grid):
            if at(pt) != model.predict(pt):
                return None
    except _MAP_EVAL_ERRORS:
        return None
    return model


def _touch_arrays_for_key(
    spec: OperandSpec, geom: Geometry, idx: Tuple[int, ...]
) -> Tuple[np.ndarray, np.ndarray]:
    """(tags, words) touched by one block key (vectorized geometry walk)."""
    if len(spec.shape) == 1:
        # 1-D operand: a contiguous element run; origin[1] models a
        # misaligned view (e.g. rowOffsets shifted by +1)
        start = int(idx[0]) * int(spec.block_shape[-1]) + spec.origin[1]
        return geom.run_to_touch_arrays(start, start + int(spec.block_shape[-1]))
    r0, r1, c0, c1 = block_to_2d(spec.shape, idx, spec.block_shape)
    orow, ocol = spec.origin
    return geom.slice_to_touch_arrays(r0 + orow, r1 + orow, c0 + ocol, c1 + ocol)


def _dedupe_touches(
    tags: np.ndarray, words: np.ndarray, words_per_sector: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Unique (tag, word) pairs in ascending (tag, word) order."""
    key = np.unique(tags * words_per_sector + words)
    return key // words_per_sector, key % words_per_sector


def collect(
    kernel: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
    max_records: int = 2_000_000,
) -> Tuple[TraceBuffer, CollectStats]:
    """Level-1 collection: walk the sampled grid and record every access."""
    sampler = sampler or GridSampler()
    buf = TraceBuffer(max_records=max_records)
    stats = CollectStats()
    t0 = time.perf_counter()

    for op in kernel.operands:
        buf.register_region(RegionInfo(op.name, op.geometry, space=op.space))
    for sc in kernel.scratch:
        buf.register_region(
            RegionInfo(sc.name, sc.geometry, space="vmem_scratch")
        )
    dyn_fns = dict(kernel.dynamic)

    pids = sampled_grid_array(kernel.grid, sampler)
    n_programs = int(pids.shape[0])
    stats.programs = n_programs
    if n_programs == 0:
        stats.wall_s = time.perf_counter() - t0
        return buf, stats

    # -- static operands: group programs by distinct block key ---------------
    for op in kernel.operands:
        if op.name in dyn_fns:
            continue  # handled below with concrete indices
        site = SiteInfo(op.name, f"{kernel.name}/{op.name}", op.space, op.kind)
        group = TraceBuffer.new_group()
        geom = op.geometry
        sel = pids[:1] if op.once else pids
        keys = _eval_index_map_batch(op.index_map, sel)
        ukeys, inverse = np.unique(keys, axis=0, return_inverse=True)
        inverse = inverse.reshape(-1)
        order = np.argsort(inverse, kind="stable")
        counts = np.bincount(inverse, minlength=len(ukeys))
        bounds = np.zeros(len(ukeys) + 1, dtype=np.int64)
        np.cumsum(counts, out=bounds[1:])
        for g in range(len(ukeys)):
            gsel = sel[order[bounds[g] : bounds[g + 1]]]
            tags, words = _touch_arrays_for_key(
                op, geom, tuple(int(x) for x in ukeys[g])
            )
            buf.append_block(site, gsel, tags, words, group=group)

    # -- scratch: group programs by their access-model slice set -------------
    for sc in kernel.scratch:
        if sc.name in dyn_fns:
            continue  # handled below with concrete indices
        site = SiteInfo(sc.name, f"{kernel.name}/{sc.name}", "vmem_scratch",
                        sc.kind)
        group = TraceBuffer.new_group()
        geom = sc.geometry
        if sc.access_model is None:
            r, c = geom.shape2d
            tags, words = geom.slice_to_touch_arrays(0, r, 0, c)
            buf.append_block(site, pids, tags, words, group=group)
            continue
        by_slices: Dict[Tuple, List[int]] = {}
        for i in range(n_programs):
            pid = tuple(int(x) for x in pids[i])
            key = tuple(
                tuple(int(v) for v in s) for s in sc.access_model(pid)
            )
            by_slices.setdefault(key, []).append(i)
        for slices, idxs in by_slices.items():
            parts = [
                geom.slice_to_touch_arrays(r0, r1, c0, c1)
                for r0, r1, c0, c1 in slices
            ]
            if parts:
                tags = np.concatenate([t for t, _ in parts])
                words = np.concatenate([w for _, w in parts])
            else:
                tags = np.empty(0, np.int64)
                words = np.empty(0, np.int64)
            tags, words = _dedupe_touches(tags, words, geom.words_per_sector)
            buf.append_block(site, pids[idxs], tags, words, group=group)

    # -- dynamic operands and scratch: concrete per-program indices (CSR chunk)
    for op in (*kernel.operands, *kernel.scratch):
        fn = dyn_fns.get(op.name)
        if fn is None:
            continue
        site = SiteInfo(op.name, f"{kernel.name}/{op.name}", op.space, op.kind)
        group = TraceBuffer.new_group()
        geom = op.geometry
        ctx = dynamic_context or {}
        tag_parts: List[np.ndarray] = []
        word_parts: List[np.ndarray] = []
        ptr = np.zeros(n_programs + 1, dtype=np.int64)
        for i in range(n_programs):
            pid = tuple(int(x) for x in pids[i])
            flat = np.asarray(list(fn(pid, **ctx)), dtype=np.int64)
            tags, words = geom.flat_to_touch_arrays(flat, op.origin)
            tags, words = _dedupe_touches(tags, words, geom.words_per_sector)
            tag_parts.append(tags)
            word_parts.append(words)
            ptr[i + 1] = ptr[i] + tags.shape[0]
        buf.append_block(
            site,
            pids,
            np.concatenate(tag_parts) if tag_parts else np.empty(0, np.int64),
            np.concatenate(word_parts) if word_parts else np.empty(0, np.int64),
            ptr=ptr,
            group=group,
        )

    stats.records = len(buf)
    stats.touch_events = buf.n_touch_events
    stats.wall_s = time.perf_counter() - t0
    return buf, stats


def analyze(
    kernel: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
) -> Heatmap:
    """collect + drain + flush in one call (the common path)."""
    sampler = sampler or GridSampler()
    buf, _ = collect(kernel, sampler, dynamic_context)
    an = Analyzer(kernel.name, kernel.grid, sampler.describe())
    an.ingest(buf)
    return an.flush()


def drain_dynamic(
    kernel_name: str,
    grid: Sequence[int],
    operand: OperandSpec,
    index_trace: np.ndarray,
    sampler: Optional[GridSampler] = None,
    valid_mask: Optional[np.ndarray] = None,
) -> TraceBuffer:
    """Convert an index trace into records.

    ``index_trace`` has shape (n_programs, k): flat element indices (one
    row per grid program, row-major grid order); negative entries (or
    masked-out ones) are padding.  The whole matrix is converted in one
    vectorized pass (bulk divmod + per-program dedup via lexsort).
    """
    sampler = sampler or GridSampler()
    grid = tuple(int(g) for g in grid)
    buf = TraceBuffer()
    buf.register_region(
        RegionInfo(operand.name, operand.geometry, space=operand.space)
    )
    geom = operand.geometry
    wps = geom.words_per_sector
    pids = sampled_grid_array(grid, sampler)
    p = int(pids.shape[0])
    if p == 0:
        return buf
    lin = linearize_array(pids, grid)
    index_trace = np.asarray(index_trace)
    rows = index_trace[lin].reshape(p, -1)
    keep = rows >= 0
    if valid_mask is not None:
        keep &= np.asarray(valid_mask)[lin].reshape(p, -1).astype(bool)
    rec = np.broadcast_to(
        np.arange(p, dtype=np.int64)[:, None], rows.shape
    )[keep]
    flat = rows[keep]
    tags, words = geom.flat_to_touch_arrays(flat)
    # an element wider than a word yields several touches per entry
    rec = np.repeat(rec, tags.shape[0] // max(1, flat.shape[0]))
    key = tags * wps + words
    rs, ks = unique_pairs(rec, key)
    counts = np.bincount(rs, minlength=p)
    ptr = np.zeros(p + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    buf.append_block(
        SiteInfo(
            operand.name,
            f"{kernel_name}/{operand.name}#trace",
            operand.space,
            operand.kind,
        ),
        pids,
        ks // wps,
        ks % wps,
        ptr=ptr,
        group=TraceBuffer.new_group(),
    )
    return buf
