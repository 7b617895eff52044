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

Sharded collection.  Heat maps are a merge monoid (distinct-visitor
counts are set unions, see :mod:`repro_torch.core.heatmap`), so the
sampled grid can be partitioned into contiguous program runs, walked by
independent workers and merged exactly.  ``ShardedCollector`` runs the
shards on a spawn process pool: a worker rebuilds the spec from its
``KernelSpec.source`` (a registry ``name:variant`` ref or a builder
triple; the spec itself holds index-map lambdas and cannot cross a
process boundary), walks its ``sampled[lo:hi]`` slice under each
operand's own geometry into a shard-stamped ``TraceBuffer``, and ships
the columnar chunks back.  The parent re-keys the worker-local
disjointness tokens and flushes ONE Analyzer over the union of chunks,
bit-identical to the serial walk.  Workers only walk: they import the
kernel registry to rebuild specs, but never touch the card, so a pool
started after the parent made its CUDA context (spawn, never fork) is
safe.  Recovery from crashed or hung workers is governed by a
:class:`~repro_torch.core.resilience.ResiliencePolicy`.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, ClassVar, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .heatmap import Analyzer, Heatmap
from .resilience import DEFAULT_POLICY, FaultEvent, ResiliencePolicy
from .tiles import Geometry, block_to_2d, make_geometry
from .trace import (
    GridSampler,
    RegionInfo,
    ShardInfo,
    SiteInfo,
    TraceBuffer,
    linearize_array,
    sampled_grid_array,
    sampled_grid_size,
    sampled_grid_slice,
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


class ShardError(RuntimeError):
    """A shard worker failed; the message carries shard + spec context.

    Raised in the worker, so it crosses the process boundary as a
    picklable exception.  Rebuild guard violations (a stale source) keep
    their own types: they are usage errors, not transient faults.
    """


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
    # how to rebuild this spec in another process: a registry ref
    # ("gemm:v01", which also rebuilds the seeded dynamic context) or a
    # ("module:function", args, kwargs) builder triple (see
    # ``sourced_spec``).  A ShardedCollector worker rebuilds from it;
    # specs without one are sharded in process.
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
    *,
    pids: Optional[np.ndarray] = None,
    owns_once: bool = True,
    shard_id: Optional[int] = None,
) -> Tuple[TraceBuffer, CollectStats]:
    """Level-1 collection: walk the sampled grid and record every access.

    ``pids`` overrides the walked program set (a ``(P, ndim)`` slice of
    ``sampled_grid_array``: how a shard walks only its partition);
    ``owns_once`` says whether this walk owns ``once=True`` operands
    (exactly one shard, the one holding the first sampled program, must
    emit them); ``shard_id`` stamps every emitted chunk.
    """
    sampler = sampler or GridSampler()
    buf = TraceBuffer(max_records=max_records, shard_id=shard_id)
    stats = CollectStats()
    t0 = time.perf_counter()

    for op in kernel.operands:
        buf.register_region(RegionInfo(op.name, op.geometry, space=op.space))
    for sc in kernel.scratch:
        buf.register_region(
            RegionInfo(sc.name, sc.geometry, space="vmem_scratch")
        )
    dyn_fns = dict(kernel.dynamic)

    if pids is None:
        pids = sampled_grid_array(kernel.grid, sampler)
    else:
        pids = np.asarray(pids, dtype=np.int64)
    n_programs = int(pids.shape[0])
    stats.programs = n_programs
    if n_programs == 0:
        stats.wall_s = time.perf_counter() - t0
        return buf, stats

    # -- static operands: group programs by distinct block key ---------------
    for op in kernel.operands:
        if op.name in dyn_fns:
            continue  # handled below with concrete indices
        if op.once and not owns_once:
            continue  # another shard owns the single-program operand
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


# ---------------------------------------------------------------------------
# sharded collection: partition the sampled grid, collect on a process pool,
# merge exactly (the heat-map algebra makes the merge a set union)
# ---------------------------------------------------------------------------


def split_budget(total: int, shards: int) -> List[int]:
    """Split a global record budget into near-equal per-shard budgets.

    Sums exactly to ``total``, so a sharded collection admits at most as
    many records as the serial cap.  When the cap bites, the records
    admitted differ from serial, so bit-identity holds for traces within
    the cap (``ShardedCollector.analyze`` warns when a shard dropped).
    """
    shards = max(1, int(shards))
    base, extra = divmod(int(total), shards)
    return [base + (1 if i < extra else 0) for i in range(shards)]


def shard_bounds(total: int, shards: int) -> List[Tuple[int, int]]:
    """Contiguous, near-equal [lo, hi) partitions of ``total`` programs.

    Never returns empty shards: the count is clipped to ``total`` (a
    3-program grid sharded 8 ways is 3 shards of one program).  ``total
    == 0`` yields one empty shard, so bookkeeping still sees a shard.
    """
    shards = max(1, min(int(shards), max(total, 1)))
    edges = np.linspace(0, total, shards + 1).astype(np.int64)
    return [(int(edges[i]), int(edges[i + 1])) for i in range(shards)]


def collect_shard(
    kernel: KernelSpec,
    sampler: GridSampler,
    dynamic_context: Optional[Dict[str, np.ndarray]],
    lo: int,
    hi: int,
    shard: int,
    max_records: int = 2_000_000,
) -> Tuple[TraceBuffer, ShardInfo]:
    """Collect one contiguous sampled-grid shard ``sampled[lo:hi]``.

    A pure function of its arguments: the unit both the in-process path
    and the pool workers execute.  The shard holding the first sampled
    program (``lo == 0``) owns ``once=True`` operands.  Each operand is
    walked under its own ``geometry_kind``.
    """
    t0 = time.perf_counter()
    pids = sampled_grid_slice(kernel.grid, sampler, lo, hi)
    buf, _ = collect(
        kernel,
        sampler,
        dynamic_context,
        max_records,
        pids=pids,
        owns_once=(lo == 0),
        shard_id=shard,
    )
    # pack one-chunk-per-key runs before the buffer crosses a process
    # boundary: per-chunk pickle and flush costs would dominate otherwise
    buf.consolidate()
    info = ShardInfo(
        shard=shard,
        lo=int(lo),
        hi=int(hi),
        programs=int(pids.shape[0]),
        records=len(buf),
        dropped=buf.dropped,
        wall_s=time.perf_counter() - t0,
    )
    return buf, info


def _warm_worker(_: int) -> bool:
    """Pool warm-up: pay the kernel-registry import once per worker.

    The import brings in ``torch`` (specs of the registry's families are
    built next to their kernels' wrappers); nothing here or in a shard
    touches ``torch.cuda`` or builds a kernel.
    """
    from repro_torch import kernels  # noqa: F401  (the import is the work)

    return True


def _worker_state(_: int) -> Dict[str, int]:
    """What this process has done to the card: whether it holds a CUDA
    context, how many kernel libraries it loaded and how many kernels it
    launched.  A pool worker must report zeros (:meth:`ShardedCollector.
    worker_states`)."""
    import os
    import sys

    time.sleep(0.05)  # let every idle worker take a probe
    torch = sys.modules.get("torch")
    build = sys.modules.get("repro_torch.kernels._build")
    launches = sum(
        fn.launches
        for name, module in list(sys.modules.items())
        if name.startswith("repro_torch.kernels.")
        for fn in getattr(module, "KERNELS", {}).values()
    )
    return {
        "pid": os.getpid(),
        "cuda_initialized": int(torch is not None and torch.cuda.is_initialized()),
        "libraries": len(build._LOADED) if build is not None else 0,
        "launches": launches,
    }


def sourced_spec(fn_ref: str, *args, **kwargs) -> KernelSpec:
    """Build a spec from a ``"module:function"`` ref and stamp its source.

    The ref plus plain arguments is picklable, so the spec can be
    collected by a ``ShardedCollector`` pool at any shape::

        sourced_spec("repro_torch.kernels.gemm:gemm_v01_spec", 4096, 4096, 4096)
    """
    spec = _build_from_ref(fn_ref, args, kwargs)
    return dataclasses.replace(spec, source=(fn_ref, args, kwargs))


def _build_from_ref(fn_ref: str, args, kwargs) -> KernelSpec:
    import importlib

    mod_name, _, fn_name = fn_ref.partition(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(*args, **(kwargs or {}))


def _rebuild_spec(source) -> Tuple[KernelSpec, Optional[Dict[str, np.ndarray]]]:
    """Worker-side spec reconstruction from either source form."""
    if isinstance(source, str):
        from repro_torch import kernels as kreg

        return kreg.build(source)
    fn_ref, args, kwargs = source
    return _build_from_ref(fn_ref, args, kwargs), None


def _spec_fingerprint(spec: KernelSpec) -> Tuple:
    """Cheap picklable structural identity of a spec.

    Guards the source round trip: a parent spec whose structure was
    changed after stamping (shapes, blocks, operand set, geometry) must
    be rejected, not silently replaced by the pristine rebuild.  Index-map
    *code* cannot be fingerprinted; that one hole stays open.
    """
    return (
        spec.name,
        tuple(spec.grid),
        tuple(
            (op.name, tuple(op.shape), np.dtype(op.dtype).str,
             tuple(op.block_shape), op.kind, op.space,
             tuple(op.origin), op.once, op.geometry_kind)
            for op in spec.operands
        ),
        tuple(
            (sc.name, tuple(sc.shape), np.dtype(sc.dtype).str, sc.kind,
             sc.access_model is None, sc.geometry_kind)
            for sc in spec.scratch
        ),
        tuple(name for name, _ in spec.dynamic),
    )


#: Worker-process memo of rebuilt (spec, seeded context) pairs, keyed by
#: the pickled (source, fingerprint) pair, so a warm worker collecting
#: one kernel across tune steps rebuilds it once.  Entries are stored only
#: after the fingerprint guard passes.
_REBUILD_MEMO: Dict[bytes, Tuple[KernelSpec, Optional[Dict[str, np.ndarray]]]] = {}

_REBUILD_MEMO_MAX = 16


def _rebuild_spec_cached(
    source, fingerprint: Tuple
) -> Tuple[KernelSpec, Optional[Dict[str, np.ndarray]]]:
    """Fingerprint-guarded :func:`_rebuild_spec` with a per-process memo."""
    import pickle

    try:
        key = pickle.dumps((source, fingerprint))
    except Exception:  # noqa: BLE001 — unpicklable key: just don't memoize
        key = None
    if key is not None:
        hit = _REBUILD_MEMO.get(key)
        if hit is not None:
            return hit
    spec, ctx = _rebuild_spec(source)
    if _spec_fingerprint(spec) != fingerprint:
        raise ValueError(
            f"shard worker rebuilt {source!r} into a spec that does not "
            "structurally match the parent's (grid, operand, scratch or "
            "geometry layout differs); the parent spec was modified after "
            "source stamping — collect it serially instead"
        )
    if key is not None:
        if len(_REBUILD_MEMO) >= _REBUILD_MEMO_MAX:
            _REBUILD_MEMO.pop(next(iter(_REBUILD_MEMO)))
        _REBUILD_MEMO[key] = (spec, ctx)
    return spec, ctx


def _collect_shard_task(task: dict) -> Tuple[TraceBuffer, ShardInfo]:
    """Pool entry point: rebuild the spec from its source ref, collect.

    Nothing unpicklable crosses the process boundary.  The task's
    fingerprint carries each operand's geometry kind from the parent, and
    the rebuilt spec, walked as is, must match it: a worker never walks an
    ``h100-sector`` operand as a TPU tile.  An explicit dynamic context
    overrides the seeded one.  ``task['inject']`` is an optional
    fault-injection directive run before the walk
    (:mod:`repro_torch.core.faultinject`); walk failures are re-raised as
    :class:`ShardError` with shard and spec context.
    """
    if task.get("inject"):
        from .faultinject import apply_worker_directive

        apply_worker_directive(task["inject"])
    spec, ctx = _rebuild_spec_cached(task["source"], task["fingerprint"])
    if task["dynamic_context"] is not None:
        ctx = task["dynamic_context"]
    try:
        return collect_shard(
            spec,
            task["sampler"],
            ctx,
            task["lo"],
            task["hi"],
            task["shard"],
            task["max_records"],
        )
    except ShardError:
        raise
    except Exception as e:
        raise ShardError(
            f"shard {task['shard']} [{task['lo']}:{task['hi']}) of "
            f"{spec.name!r} (source {task['source']!r}): "
            f"{type(e).__name__}: {e}"
        ) from e


def _unify_shard_groups(bufs: Sequence[TraceBuffer]) -> None:
    """Re-key worker-local disjointness tokens across shard buffers.

    Each worker numbers its tokens from 1, so tokens of different shards
    collide without meaning anything.  Every chunk of one *site* gets one
    fresh parent token across all shards: sound because the shards
    partition the sampled grid, which keeps pids pairwise disjoint per
    site and lets the Analyzer keep its weighted fast path.
    """
    tokens: Dict[SiteInfo, int] = {}
    for buf in bufs:
        for chunk in buf.chunks:
            if chunk.group is None:
                continue
            token = tokens.get(chunk.site)
            if token is None:
                token = tokens[chunk.site] = TraceBuffer.new_group()
            chunk.group = token


#: Seconds to wait for each terminated worker of a killed pool to exit.
KILL_JOIN_S = 5.0


class ShardedCollector:
    """Partition a sampled grid and collect it on a process pool.

    The pool is lazy and persistent: it spins up on first use (``spawn``
    by default: the parent holds a CUDA context once a kernel has run,
    and fork after CUDA initialization is not safe) and is reused across
    calls until :meth:`close`.  Use as a context manager, or call
    :meth:`close` yourself.

    Specs without a ``source`` cannot cross the process boundary (their
    index maps are lambdas); those are sharded and merged **in process**:
    the same algebra, no parallelism.

    Collection is fault tolerant under ``policy``:

    * a shard that fails cleanly is resubmitted with exponential backoff,
      up to ``policy.attempts`` deliveries;
    * a dead worker (``BrokenProcessPool``) tears the pool down, respawns
      it and resubmits every unfinished shard; after
      ``policy.max_pool_failures`` consecutive broken rounds the
      collector degrades to serial in-process collection
      (``serial-fallback``, recorded);
    * a shard still running ``policy.shard_timeout_s`` after its round
      started is declared hung: its worker is killed and the shard re-runs
      in process, re-split into ``policy.resplit`` smaller pid runs.

    Every recovery is a :class:`~repro_torch.core.resilience.FaultEvent`
    that :meth:`analyze` attaches to ``Heatmap.faults``.  Only the walk is
    recovered: the collector never runs a kernel.  ``fault_plan`` (a
    :class:`~repro_torch.core.faultinject.FaultPlan`) deterministically
    injects worker crashes and hangs.
    """

    def __init__(
        self,
        workers: int,
        *,
        max_records: int = 2_000_000,
        start_method: str = "spawn",
        policy: Optional[ResiliencePolicy] = None,
        fault_plan=None,
    ):
        self.workers = max(1, int(workers))
        self.max_records = max_records
        self.start_method = start_method
        self.fault_plan = fault_plan
        if policy is not None:
            self.policy = policy
        elif fault_plan is not None:
            # injected hangs must expire in test time, not production time
            self.policy = fault_plan.policy()
        else:
            self.policy = DEFAULT_POLICY
        self._pool = None
        # tune_all's threads share one collector: pool creation must be
        # race-free, and fault events are per thread
        self._pool_lock = threading.Lock()
        self._tls = threading.local()

    @property
    def last_fault_events(self) -> Tuple[FaultEvent, ...]:
        """Recovery events of this thread's most recent :meth:`collect`."""
        return getattr(self._tls, "events", ())

    # -- pool lifecycle -----------------------------------------------------
    def _ensure_pool(self):
        with self._pool_lock:
            if self._pool is None:
                import concurrent.futures
                import multiprocessing

                self._pool = concurrent.futures.ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=multiprocessing.get_context(self.start_method),
                )
            return self._pool

    def _warm(self, pool) -> None:
        """Pay worker spawn + imports BEFORE a watchdog-timed round.

        The watchdog times shard execution; on a cold pool the first round
        would also absorb process spawn and the registry import (torch's
        among it), and a tight watchdog would declare booting workers
        hung.  Idempotent per pool instance.
        """
        if getattr(pool, "_cuthermo_warm", False):
            return
        list(pool.map(_warm_worker, range(self.workers)))
        pool._cuthermo_warm = True

    def warmup(self) -> float:
        """Start the pool and import the registry in every worker, outside
        any timed section; returns the wall time in seconds."""
        t0 = time.perf_counter()
        self._warm(self._ensure_pool())
        return time.perf_counter() - t0

    def worker_states(self) -> List[Dict[str, int]]:
        """Probe the pool's workers (:func:`_worker_state`), one answer per
        worker that took a probe, by pid.  Workers only walk: each should
        hold no CUDA context, no kernel library and no launch."""
        pool = self._ensure_pool()
        self._warm(pool)
        states = pool.map(_worker_state, range(4 * self.workers))
        return sorted({s["pid"]: s for s in states}.values(), key=lambda s: s["pid"])

    def close(self) -> None:
        """Shut the pool down (idempotent)."""
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None

    def _kill_pool(self) -> None:
        """Tear the pool down the hard way (hung or broken workers).

        ``shutdown`` alone would block behind a hung worker, so worker
        processes are terminated first; the next :meth:`_ensure_pool`
        spins a fresh pool up.
        """
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is None:
            return
        procs = list(getattr(pool, "_processes", {}).values() or [])
        for p in procs:
            try:
                if p.is_alive():
                    p.terminate()
            except (OSError, ValueError, AttributeError):
                pass  # already dead / already closed
        for p in procs:
            try:
                p.join(KILL_JOIN_S)
            except (OSError, ValueError, AttributeError):
                pass
        # A worker killed while it sent a result leaves half of it in the
        # result pipe, and the pool's manager thread waits in ``recv`` for
        # the rest.  The parent holds the pipe's write end too (it never
        # writes there), so that wait would last until the interpreter's
        # exit joins the thread, and block the exit.  With the workers gone
        # and this end closed, the thread reads EOF and ends.
        writer = getattr(getattr(pool, "_result_queue", None), "_writer", None)
        if writer is not None:
            writer.close()
        try:
            pool.shutdown(wait=False, cancel_futures=True)
        except (OSError, RuntimeError):
            pass

    def __enter__(self) -> "ShardedCollector":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- collection ---------------------------------------------------------
    def collect(
        self,
        kernel: KernelSpec,
        sampler: Optional[GridSampler] = None,
        dynamic_context: Optional[Dict[str, np.ndarray]] = None,
    ) -> Tuple[List[TraceBuffer], Tuple[ShardInfo, ...]]:
        """Collect every shard; returns (shard buffers, shard infos).

        The buffers' group tokens are already unified: ingesting them all
        into one Analyzer flushes the exact single-pass heat map.  The
        call's recovery events are :attr:`last_fault_events`; a shard
        re-split by the watchdog contributes one buffer and one
        ``ShardInfo`` per sub-run, all under its shard id.
        """
        sampler = sampler or GridSampler()
        total = sampled_grid_size(kernel.grid, sampler)
        bounds = shard_bounds(total, self.workers)
        # the GLOBAL record cap is divided across shards
        budgets = split_budget(self.max_records, len(bounds))
        events: List[FaultEvent] = []
        if kernel.source is None or len(bounds) == 1:
            results = {
                i: [collect_shard(
                    kernel, sampler, dynamic_context, lo, hi, i, budgets[i]
                )]
                for i, (lo, hi) in enumerate(bounds)
            }
        else:
            results = self._collect_resilient(
                kernel, sampler, dynamic_context, bounds, budgets, events
            )
        pairs = [pair for i in sorted(results) for pair in results[i]]
        bufs = [b for b, _ in pairs]
        infos = tuple(i for _, i in pairs)
        self._tls.events = tuple(events)
        _unify_shard_groups(bufs)
        return bufs, infos

    def _collect_resilient(
        self,
        kernel: KernelSpec,
        sampler: GridSampler,
        dynamic_context: Optional[Dict[str, np.ndarray]],
        bounds: List[Tuple[int, int]],
        budgets: List[int],
        events: List[FaultEvent],
    ) -> Dict[int, List[Tuple[TraceBuffer, ShardInfo]]]:
        """The recovery loop: submit rounds of shards until all complete.

        Each round submits every unfinished shard and waits under the hang
        watchdog.  Clean failures retry with backoff (``policy.attempts``);
        a broken pool is rebuilt and the round repeated (up to
        ``policy.max_pool_failures``, then serial fallback); hung shards
        are expired and re-run in process, which always terminates.
        """
        import concurrent.futures
        from concurrent.futures.process import BrokenProcessPool

        policy = self.policy
        plan = self.fault_plan
        fingerprint = _spec_fingerprint(kernel)
        n = len(bounds)

        def task_for(i: int, attempt: int) -> dict:
            lo, hi = bounds[i]
            inject = (
                plan.directive(kernel.name, n, i, attempt)
                if plan is not None
                else None
            )
            return {
                "source": kernel.source,
                "fingerprint": fingerprint,
                "sampler": sampler,
                "dynamic_context": dynamic_context,
                "lo": lo,
                "hi": hi,
                "shard": i,
                "max_records": budgets[i],
                "inject": inject,
            }

        results: Dict[int, List[Tuple[TraceBuffer, ShardInfo]]] = {}
        attempts = {i: 0 for i in range(n)}
        pool_failures = 0
        remaining = set(range(n))
        while remaining:
            if pool_failures >= policy.max_pool_failures:
                # graceful degradation: no parallelism, same heat map
                events.append(
                    FaultEvent(
                        kind="serial-fallback",
                        where="collector",
                        detail=(
                            f"{len(remaining)} shard(s) collected serially "
                            f"after {pool_failures} consecutive pool failures"
                        ),
                    )
                )
                for i in sorted(remaining):
                    results[i] = self._run_shard_local(
                        kernel, sampler, dynamic_context, bounds[i],
                        budgets[i], i, events,
                    )
                remaining.clear()
                break
            pool = self._ensure_pool()
            try:
                self._warm(pool)
            except BrokenProcessPool:
                # a worker died while booting (injection never targets
                # warm-up): count it against the pool-failure budget
                pool_failures += 1
                self._kill_pool()
                events.append(
                    FaultEvent(
                        kind="worker-crash",
                        where="collector",
                        detail="process pool broke during warm-up",
                    )
                )
                continue
            round_start = time.monotonic()
            futs = {}
            for i in sorted(remaining):
                futs[pool.submit(_collect_shard_task,
                                 task_for(i, attempts[i]))] = i
                attempts[i] += 1
            done, not_done = concurrent.futures.wait(
                futs, timeout=policy.shard_timeout_s
            )
            broken = False
            retry_backoff = 0.0
            for fut in sorted(done, key=lambda f: futs[f]):
                i = futs[fut]
                try:
                    results[i] = [fut.result()]
                    remaining.discard(i)
                except BrokenProcessPool:
                    # one dead worker fails every pending future: record
                    # the crash once, rebuild below, resubmit next round
                    if not broken:
                        events.append(
                            FaultEvent(
                                kind="worker-crash",
                                where="collector",
                                shard=i,
                                attempt=attempts[i] - 1,
                                wall_s=time.monotonic() - round_start,
                                detail="process pool broke (worker died)",
                            )
                        )
                    broken = True
                except Exception as e:
                    if attempts[i] >= policy.attempts:
                        raise
                    events.append(
                        FaultEvent(
                            kind="shard-retry",
                            where="collector",
                            shard=i,
                            attempt=attempts[i] - 1,
                            detail=f"{type(e).__name__}: {e}"[:200],
                        )
                    )
                    retry_backoff = max(
                        retry_backoff, policy.backoff_s(attempts[i])
                    )
            if not_done:
                # the hang watchdog: kill the wedged workers, re-run the
                # hung shards in process (re-split into smaller pid runs)
                hung = sorted(futs[f] for f in not_done)
                for f in not_done:
                    f.cancel()
                self._kill_pool()
                for i in hung:
                    events.append(
                        FaultEvent(
                            kind="shard-timeout",
                            where="collector",
                            shard=i,
                            attempt=attempts[i] - 1,
                            wall_s=time.monotonic() - round_start,
                            detail=(
                                f"no result within "
                                f"{policy.shard_timeout_s:.1f}s; "
                                "worker killed, shard re-run in process"
                            ),
                        )
                    )
                    results[i] = self._run_shard_local(
                        kernel, sampler, dynamic_context, bounds[i],
                        budgets[i], i, events, resplit=policy.resplit,
                    )
                    remaining.discard(i)
            if broken:
                pool_failures += 1
                self._kill_pool()
                if remaining and pool_failures < policy.max_pool_failures:
                    events.append(
                        FaultEvent(
                            kind="pool-rebuild",
                            where="collector",
                            detail=(
                                f"respawning {self.workers} workers "
                                f"(consecutive failure {pool_failures})"
                            ),
                        )
                    )
                    time.sleep(policy.backoff_s(pool_failures))
            else:
                if retry_backoff:
                    time.sleep(retry_backoff)
                if remaining:
                    pool_failures = 0  # progress without breakage: reset
        return results

    def _run_shard_local(
        self,
        kernel: KernelSpec,
        sampler: GridSampler,
        dynamic_context: Optional[Dict[str, np.ndarray]],
        bound: Tuple[int, int],
        budget: int,
        shard: int,
        events: List[FaultEvent],
        resplit: int = 1,
    ) -> List[Tuple[TraceBuffer, ShardInfo]]:
        """Re-run one shard in process, optionally re-split.

        Sub-runs keep the shard's id and partition its ``[lo, hi)``, so
        token unification and the merge algebra are unaffected; the
        globally first sub-run owns ``once=`` operands (``collect_shard``
        derives ownership from the global ``lo``).  Injected directives
        never reach this path: the in-process re-run is the recovery.
        """
        from repro_torch.runtime.fault import retry as _retry

        lo, hi = bound
        k = max(1, min(int(resplit), max(hi - lo, 1)))
        pieces = [(lo + a, lo + b) for a, b in shard_bounds(hi - lo, k)]
        if len(pieces) > 1:
            events.append(
                FaultEvent(
                    kind="shard-resplit",
                    where="collector",
                    shard=shard,
                    detail=(
                        f"re-running [{lo}:{hi}) in process as "
                        f"{len(pieces)} smaller runs"
                    ),
                )
            )
        sub_budgets = split_budget(budget, len(pieces))
        out: List[Tuple[TraceBuffer, ShardInfo]] = []
        for j, (plo, phi) in enumerate(pieces):
            def _run(plo=plo, phi=phi, j=j):
                return collect_shard(
                    kernel, sampler, dynamic_context, plo, phi, shard,
                    sub_budgets[j],
                )

            def _note(attempt, exc):
                events.append(
                    FaultEvent(
                        kind="shard-retry",
                        where="collector",
                        shard=shard,
                        attempt=attempt,
                        detail=(
                            f"in-process re-run: "
                            f"{type(exc).__name__}: {exc}"
                        )[:200],
                    )
                )

            out.append(
                _retry(
                    _run,
                    attempts=self.policy.attempts,
                    base_delay=self.policy.base_delay,
                    retryable=(Exception,),
                    on_retry=_note,
                )()
            )
        return out

    def analyze(
        self,
        kernel: KernelSpec,
        sampler: Optional[GridSampler] = None,
        dynamic_context: Optional[Dict[str, np.ndarray]] = None,
    ) -> Heatmap:
        """Sharded collect + merge + flush: the parallel :func:`analyze`.

        Bit-identical to :func:`analyze` on the same arguments for any
        trace within the record cap, with per-shard provenance in
        ``Heatmap.shards`` and recovery provenance in ``Heatmap.faults``.
        When the cap bites, drop totals stay exact but the surviving
        records differ from serial truncation, and a RuntimeWarning says
        so.
        """
        sampler = sampler or GridSampler()
        bufs, infos = self.collect(kernel, sampler, dynamic_context)
        dropped = sum(i.dropped for i in infos)
        if dropped:
            import warnings

            warnings.warn(
                f"{kernel.name}: {dropped} records dropped at the "
                f"max_records={self.max_records} cap; a truncated "
                "sharded heat map is not bit-identical to the serial "
                "build (raise max_records or sample a window)",
                RuntimeWarning,
                stacklevel=2,
            )
        an = Analyzer(kernel.name, kernel.grid, sampler.describe())
        for buf in bufs:
            an.ingest(buf)
        return dataclasses.replace(
            an.flush(), shards=infos, faults=self.last_fault_events
        )


def analyze_sharded(
    kernel: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
    workers: int = 2,
) -> Heatmap:
    """One-shot sharded :func:`analyze` (owns a pool for the call)."""
    with ShardedCollector(workers) as sc:
        return sc.analyze(kernel, sampler, dynamic_context)


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
