"""The seed per-record profiling engine: the golden reference.

One ``AccessRecord`` object per (visitor x operand), per-word Python-int
bitmasks updated one touch at a time (the paper's literal ``mask |= 1 <<
id``).  The golden-equivalence tests hold the columnar engine of
``collector.py`` / ``heatmap.py`` to it, bit for bit, under both
geometries.

The engine is generic over an operand's geometry, and independent of the
vectorized geometry code it checks: every touch is computed element by
element from the element's position (:func:`element_touches`), never
through ``slice_to_touch_arrays`` / ``run_to_touch_arrays`` /
``flat_to_touch_arrays``.  Under ``h100-sector`` an element's bytes are
split into 4 B words, each word into (sector tag, word) by ``divmod(word,
8)``; under ``tpu-tile`` an element's tile and sublane row come from its
(row, col).

Do not optimize this module: its slowness is the point.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from .collector import CollectStats, KernelSpec, OperandSpec
from .heatmap import (
    Heatmap,
    HeatRow,
    RegionHeatmap,
    SectorHistory,
    fallback_region,
)
from .tiles import block_to_2d
from .trace import (
    AccessRecord,
    GridSampler,
    RegionInfo,
    linearize,
    sampled_grid,
)

Touch = Tuple[int, int]

#: Bytes per word and words per sector of the NVIDIA sector geometry.
H100_WORD_BYTES = 4
H100_SECTOR_WORDS = 8

#: Lanes per TPU tile, and sublanes per tile by dtype itemsize.
TPU_LANES = 128
TPU_SUBLANES = {8: 4, 4: 8, 2: 16, 1: 32}


def _shape2d(kind: str, shape: Tuple[int, ...]) -> Tuple[int, int]:
    """The (rows, cols) view each geometry addresses elements in."""
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        if kind == "tpu-tile":
            return (max(1, math.ceil(shape[0] / TPU_LANES)), TPU_LANES)
        return (1, int(shape[0]))
    rows = 1
    for d in shape[:-1]:
        rows *= int(d)
    return (rows, int(shape[-1]))


def element_touches(
    kind: str, shape: Tuple[int, ...], itemsize: int, row: int, col: int
) -> List[Touch]:
    """The (sector tag, word) touches of element (row, col), one by one."""
    rows, cols = _shape2d(kind, shape)
    if kind == "h100-sector":
        first = (row * cols + col) * itemsize
        last = first + itemsize - 1
        return [
            divmod(word, H100_SECTOR_WORDS)
            for word in range(first // H100_WORD_BYTES,
                              last // H100_WORD_BYTES + 1)
        ]
    if kind == "tpu-tile":
        sublanes = TPU_SUBLANES[itemsize]
        lane_tiles = max(1, math.ceil(cols / TPU_LANES))
        tag = (row // sublanes) * lane_tiles + col // TPU_LANES
        return [(tag, row % sublanes)]
    raise ValueError(f"unknown geometry {kind!r}")


class _Region:
    """What the seed needs of one operand or scratch buffer."""

    def __init__(self, spec) -> None:
        self.kind = spec.geometry_kind
        self.shape = tuple(int(s) for s in spec.shape)
        self.itemsize = int(np.dtype(spec.dtype).itemsize)
        self.rows, self.cols = _shape2d(self.kind, self.shape)

    def touches(self, row: int, col: int) -> List[Touch]:
        return element_touches(self.kind, self.shape, self.itemsize, row, col)

    def slice_touches(self, r0: int, r1: int, c0: int, c1: int) -> Set[Touch]:
        """Every element of a clipped 2-D slice."""
        out: Set[Touch] = set()
        for r in range(max(0, r0), min(self.rows, r1)):
            for c in range(max(0, c0), min(self.cols, c1)):
                out.update(self.touches(r, c))
        return out

    def run_touches(self, start: int, stop: int) -> Set[Touch]:
        """Every element of a contiguous run of flat elements."""
        n = 1
        for d in self.shape:
            n *= d
        out: Set[Touch] = set()
        for e in range(max(0, start), min(n, stop)):
            r, c = divmod(e, self.cols)
            out.update(self.touches(r, c))
        return out

    def flat_touches(
        self, flat: Iterable[int], origin: Tuple[int, int]
    ) -> Set[Touch]:
        """Touches of flat element indices (no clipping), shifted."""
        out: Set[Touch] = set()
        for fi in flat:
            r, c = divmod(int(fi), self.cols) if self.cols else (0, 0)
            out.update(self.touches(r + origin[0], c + origin[1]))
        return out


class ReferenceTraceBuffer:
    """Seed append-only record-object buffer (one AccessRecord per event)."""

    def __init__(self, max_records: int = 2_000_000):
        self.records: List[AccessRecord] = []
        self.regions: Dict[str, RegionInfo] = {}
        self.max_records = max_records
        self.dropped = 0

    def register_region(self, region: RegionInfo) -> None:
        self.regions[region.name] = region

    def append(self, rec: AccessRecord) -> None:
        if len(self.records) >= self.max_records:
            self.dropped += 1
            return
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)


def _touches_for_block(
    spec: OperandSpec, program_id: Tuple[int, ...]
) -> Tuple[Touch, ...]:
    idx = spec.index_map(*program_id)
    if isinstance(idx, int):
        idx = (idx,)
    region = _Region(spec)
    if len(spec.shape) == 1:
        start = int(idx[0]) * int(spec.block_shape[-1]) + spec.origin[1]
        touches = region.run_touches(start, start + int(spec.block_shape[-1]))
    else:
        r0, r1, c0, c1 = block_to_2d(spec.shape, idx, spec.block_shape)
        orow, ocol = spec.origin
        touches = region.slice_touches(
            r0 + orow, r1 + orow, c0 + ocol, c1 + ocol
        )
    return tuple(sorted(touches))


def collect_reference(
    kernel: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
    max_records: int = 2_000_000,
) -> Tuple[ReferenceTraceBuffer, CollectStats]:
    """Seed Level-1 collection: one Python loop iteration per visitor."""
    sampler = sampler or GridSampler()
    buf = ReferenceTraceBuffer(max_records=max_records)
    stats = CollectStats()
    t0 = time.perf_counter()

    for op in kernel.operands:
        buf.register_region(RegionInfo(op.name, op.geometry, space=op.space))
    for sc in kernel.scratch:
        buf.register_region(
            RegionInfo(sc.name, sc.geometry, space="vmem_scratch")
        )
    dyn_fns = dict(kernel.dynamic)

    touch_cache: Dict[Tuple[str, Tuple[int, ...]], Tuple[Touch, ...]] = {}

    first_pid = True
    for pid in sampled_grid(kernel.grid, sampler):
        stats.programs += 1
        for op in kernel.operands:
            if op.name in dyn_fns:
                continue
            if op.once and not first_pid:
                continue
            idx = op.index_map(*pid)
            if isinstance(idx, int):
                idx = (idx,)
            key = (op.name, tuple(int(i) for i in idx))
            touches = touch_cache.get(key)
            if touches is None:
                touches = _touches_for_block(op, pid)
                touch_cache[key] = touches
            buf.append(
                AccessRecord(
                    array=op.name,
                    site=f"{kernel.name}/{op.name}",
                    space=op.space,
                    kind=op.kind,
                    program_id=pid,
                    touches=touches,
                )
            )
        for sc in kernel.scratch:
            if sc.name in dyn_fns:
                continue
            region = _Region(sc)
            if sc.access_model is None:
                slices: Iterable = [(0, region.rows, 0, region.cols)]
            else:
                slices = sc.access_model(pid)
            touches_set: Set[Touch] = set()
            for r0, r1, c0, c1 in slices:
                touches_set |= region.slice_touches(r0, r1, c0, c1)
            buf.append(
                AccessRecord(
                    array=sc.name,
                    site=f"{kernel.name}/{sc.name}",
                    space="vmem_scratch",
                    kind=sc.kind,
                    program_id=pid,
                    touches=tuple(sorted(touches_set)),
                )
            )
        for op in (*kernel.operands, *kernel.scratch):
            fn = dyn_fns.get(op.name)
            if fn is None:
                continue
            ctx = dynamic_context or {}
            flat_idx = np.asarray(list(fn(pid, **ctx)), dtype=np.int64)
            touches_set = _Region(op).flat_touches(flat_idx, op.origin)
            buf.append(
                AccessRecord(
                    array=op.name,
                    site=f"{kernel.name}/{op.name}",
                    space=op.space,
                    kind=op.kind,
                    program_id=pid,
                    touches=tuple(sorted(touches_set)),
                )
            )
        first_pid = False
    stats.records = len(buf)
    stats.wall_s = time.perf_counter() - t0
    return buf, stats


class ReferenceAnalyzer:
    """Seed Analyzer: per-touch bitmask updates, object-row flush."""

    def __init__(self, kernel: str, grid, sampler_desc: str):
        self.kernel = kernel
        self.grid = tuple(int(g) for g in grid)
        self.sampler_desc = sampler_desc
        self._maps: Dict[str, Dict[int, SectorHistory]] = {}
        self._regions: Dict[str, RegionInfo] = {}
        self._contributors: Dict[str, set] = {}
        self._n_records = 0
        self._dropped = 0

    def ingest(self, buf: ReferenceTraceBuffer) -> None:
        for region in buf.regions.values():
            self._regions.setdefault(region.name, region)
            self._maps.setdefault(region.name, {})
            self._contributors.setdefault(region.name, set())
        for rec in buf.records:
            self._ingest_record(rec)
        self._dropped += buf.dropped

    def _region(self, name: str) -> RegionInfo:
        region = self._regions.get(name)
        return region if region is not None else fallback_region(name)

    def _ingest_record(self, rec: AccessRecord) -> None:
        self._n_records += 1
        smap = self._maps.setdefault(rec.array, {})
        words = self._region(rec.array).geometry.words_per_sector
        pid = linearize(rec.program_id, self.grid)
        self._contributors.setdefault(rec.array, set()).add(pid)
        for tag, woff in rec.touches:
            hist = smap.get(tag)
            if hist is None:
                hist = SectorHistory(words=words)
                smap[tag] = hist
            hist.update(woff, pid)

    def flush(self) -> Heatmap:
        region_maps: List[RegionHeatmap] = []
        for name, smap in sorted(self._maps.items()):
            rows = tuple(
                HeatRow(
                    region=name,
                    tag=tag,
                    word_temps=tuple(h.word_temps()),
                    sector_temp=h.sector_temp(),
                )
                for tag, h in sorted(smap.items())
            )
            region_maps.append(
                RegionHeatmap(
                    region=self._region(name),
                    rows=rows,
                    n_programs=len(self._contributors.get(name, ())),
                )
            )
        return Heatmap(
            kernel=self.kernel,
            grid=self.grid,
            sampler=self.sampler_desc,
            regions=tuple(region_maps),
            n_records=self._n_records,
            dropped=self._dropped,
        )


def analyze_reference(
    kernel: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
) -> Heatmap:
    """Seed collect + ingest + flush (the golden path)."""
    sampler = sampler or GridSampler()
    buf, _ = collect_reference(kernel, sampler, dynamic_context)
    an = ReferenceAnalyzer(kernel.name, kernel.grid, sampler.describe())
    an.ingest(buf)
    return an.flush()


def drain_dynamic_reference(
    kernel_name: str,
    grid,
    operand: OperandSpec,
    index_trace: np.ndarray,
    sampler: Optional[GridSampler] = None,
    valid_mask: Optional[np.ndarray] = None,
) -> ReferenceTraceBuffer:
    """Seed Level-2 drain: a per-index Python loop."""
    sampler = sampler or GridSampler()
    grid = tuple(int(g) for g in grid)
    buf = ReferenceTraceBuffer()
    buf.register_region(
        RegionInfo(operand.name, operand.geometry, space=operand.space)
    )
    region = _Region(operand)
    for pid in sampled_grid(grid, sampler):
        lin = int(np.ravel_multi_index(pid, grid)) if grid else 0
        row = np.asarray(index_trace[lin])
        if valid_mask is not None:
            row = row[np.asarray(valid_mask[lin])]
        row = row[row >= 0]
        touches = region.flat_touches(row, (0, 0))
        buf.append(
            AccessRecord(
                array=operand.name,
                site=f"{kernel_name}/{operand.name}#trace",
                space=operand.space,
                kind=operand.kind,
                program_id=pid,
                touches=tuple(sorted(touches)),
            )
        )
    return buf


__all__ = [
    "ReferenceAnalyzer",
    "ReferenceTraceBuffer",
    "analyze_reference",
    "collect_reference",
    "drain_dynamic_reference",
    "element_touches",
]
