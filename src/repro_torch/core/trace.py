"""Trace records and sampling — the CUTHERMO trace-collector data model.

CUTHERMO's NVBit injection captures, per issued memory instruction:
``pc, address[32], size, active_mask, access_flags, warp_id, block_id``.
Here a record is one access *site* of one visitor ("program"): a warp of
a CUDA kernel under the H100 geometry, or a grid program of a Pallas
kernel under the TPU geometry.  A record carries:

    site        "pc": stable id of the access site (operand name or an
                explicit trace-site label)
    space       memory space ('hbm' for device-memory operands,
                'vmem_scratch' for user-managed scratch, the shared-
                memory analogue; names kept for artifact compatibility)
    kind        'load' | 'store' | 'accum'
    program_id  the visitor's grid coordinates ("warp id")
    touches     list of (sector_tag, word_offset) in the target array

Block-sampling (CUTHERMO §IV-B): ``GridSampler`` admits a window of the
grid, the analogue of tracing one thread block.

Columnar buffer layout
----------------------
Records are packed into ``TraceChunk`` structured-array chunks, appended
in bulk by the collector:

    site    one ``SiteInfo`` (array, site, space, kind) per chunk
    pids    (P, ndim) int64 — grid coordinates of the P records
    tags    (T,) int64 — sector tags of the chunk's touches
    words   (T,) int64 — word offsets, parallel to ``tags``
    ptr     (P+1,) int64 CSR offsets into tags/words (record i touches
            ``tags[ptr[i]:ptr[i+1]]``), or ``None`` for a *broadcast*
            chunk in which every one of the P records touches all T
            touches (many visitors mapping to the same block share one
            touch set)
    group   provenance token.  All chunks of one (collect call, site)
            share a token, which guarantees (a) record pids are pairwise
            disjoint across the token's chunks and (b) touches are
            unique within each record.  The Analyzer exploits this to
            count distinct contributors with weighted sums instead of
            per-bit set union; chunks without a token (record-at-a-time
            appends) take the exact dedup path.

``ShardInfo`` is the per-shard provenance that sharded collections
record in artifacts (v2 onward); the port loads and writes it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .tiles import Geometry

ProgramId = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class AccessRecord:
    """One sampled memory access (site x grid-program x touched words)."""

    array: str
    site: str
    space: str  # 'hbm' | 'vmem_scratch'
    kind: str  # 'load' | 'store' | 'accum'
    program_id: ProgramId
    touches: Tuple[Tuple[int, int], ...]  # (sector_tag, word_offset)


@dataclasses.dataclass(frozen=True)
class SiteInfo:
    """Per-chunk record metadata (everything but pid and touches)."""

    array: str
    site: str
    space: str
    kind: str


@dataclasses.dataclass
class TraceChunk:
    """One columnar run of records sharing a SiteInfo (see module doc)."""

    site: SiteInfo
    pids: np.ndarray  # (P, ndim) int64
    tags: np.ndarray  # (T,) int64
    words: np.ndarray  # (T,) int64
    ptr: Optional[np.ndarray] = None  # (P+1,) int64 CSR; None = broadcast
    group: Optional[int] = None  # disjointness token; None = compat/exact

    @property
    def n_records(self) -> int:
        return int(self.pids.shape[0])

    @property
    def n_touch_events(self) -> int:
        """Logical (record, touch) event count this chunk represents."""
        if self.ptr is None:
            return self.n_records * int(self.tags.shape[0])
        return int(self.tags.shape[0])

    def record_touches(self, i: int) -> Tuple[Tuple[int, int], ...]:
        if self.ptr is None:
            t0, t1 = 0, self.tags.shape[0]
        else:
            t0, t1 = int(self.ptr[i]), int(self.ptr[i + 1])
        return tuple(
            zip(self.tags[t0:t1].tolist(), self.words[t0:t1].tolist())
        )

    def record(self, i: int) -> AccessRecord:
        return AccessRecord(
            array=self.site.array,
            site=self.site.site,
            space=self.site.space,
            kind=self.site.kind,
            program_id=tuple(int(x) for x in self.pids[i]),
            touches=self.record_touches(i),
        )


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Provenance of one collection shard (a contiguous sampled-grid run).

    ``lo``/``hi`` index into the row-major *sampled* grid (the rows of
    ``sampled_grid_array``), not the raw grid — a shard owns programs
    ``sampled[lo:hi]``.  Persisted verbatim into session artifacts so a
    later process can audit exactly which worker produced which records
    (and which shard dropped what).
    """

    shard: int
    lo: int
    hi: int
    programs: int
    records: int
    dropped: int
    wall_s: float = 0.0

    def as_dict(self) -> dict:
        """JSON-ready form (session manifests, report bundles)."""
        return {
            "shard": self.shard,
            "lo": self.lo,
            "hi": self.hi,
            "programs": self.programs,
            "records": self.records,
            "dropped": self.dropped,
            "wall_s": self.wall_s,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ShardInfo":
        """Inverse of :meth:`as_dict` (artifact loaders)."""
        return cls(
            shard=int(d["shard"]),
            lo=int(d["lo"]),
            hi=int(d["hi"]),
            programs=int(d["programs"]),
            records=int(d["records"]),
            dropped=int(d["dropped"]),
            wall_s=float(d.get("wall_s", 0.0)),
        )


@dataclasses.dataclass(frozen=True)
class RegionInfo:
    """A registered memory region (CUTHERMO's cudaMalloc callback analogue)."""

    name: str
    geometry: Geometry
    space: str = "hbm"


class GridSampler:
    """Thread-block-sampling analogue: admit only a window of grid programs.

    ``target`` pins leading grid coordinates; e.g. target=(0,) with a
    3-D grid admits programs (0, *, *).  target=None admits everything
    (full trace — expensive, used by the overhead benchmark).

    ``window`` widens the LAST pinned coordinate to a contiguous run of
    ``window`` programs — the analogue of one thread block containing 32
    warps (essential for 1-D grids, where pinning a single coordinate
    would admit a single program and hide all inter-program sharing).
    """

    def __init__(self, target: Optional[Sequence[int]] = (0,), window: int = 1):
        self.target = None if target is None else tuple(int(t) for t in target)
        self.window = max(1, int(window))

    def admits(self, program_id: ProgramId) -> bool:
        if self.target is None:
            return True
        k = min(len(self.target), len(program_id))
        if k == 0:
            return True
        if tuple(program_id[: k - 1]) != self.target[: k - 1]:
            return False
        lo = self.target[k - 1] * self.window
        return lo <= program_id[k - 1] < lo + self.window

    def describe(self) -> str:
        if self.target is None:
            return "full-grid"
        w = f"x{self.window}" if self.window > 1 else ""
        return f"grid[{','.join(map(str, self.target))}{w},...]"


class RecordView(Sequence[AccessRecord]):
    """Lazy sequence view over a TraceBuffer's records.

    Materializes ``AccessRecord`` objects on demand so legacy consumers
    (tests, ad-hoc scripts) keep working against the columnar store.
    """

    def __init__(self, buf: "TraceBuffer"):
        self._buf = buf

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self) -> Iterator[AccessRecord]:
        self._buf._flush_pending()
        for chunk in self._buf.chunks:
            site = chunk.site
            if chunk.ptr is None:
                touches = tuple(
                    zip(chunk.tags.tolist(), chunk.words.tolist())
                )
                for row in chunk.pids:
                    yield AccessRecord(
                        array=site.array,
                        site=site.site,
                        space=site.space,
                        kind=site.kind,
                        program_id=tuple(int(x) for x in row),
                        touches=touches,
                    )
            else:
                for i in range(chunk.n_records):
                    yield chunk.record(i)

    def __getitem__(self, i):  # pragma: no cover - convenience only
        if isinstance(i, slice):
            return list(self)[i]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        self._buf._flush_pending()
        for chunk in self._buf.chunks:
            if i < chunk.n_records:
                return chunk.record(i)
            i -= chunk.n_records
        raise IndexError(i)


class TraceBuffer:
    """Append-only columnar record buffer with region registry.

    Mirrors CUTHERMO's GPU-queue + memory-registration callbacks: the
    collector appends chunks of records; the Analyzer drains them into
    the sector_history_map.  ``max_records`` guards runaway full-grid
    traces (the cap counts *records* — (site, program) events — exactly
    as the seed per-object buffer did, and overflow is surfaced once in
    ``dropped``).
    """

    _group_counter = itertools.count(1)

    def __init__(self, max_records: int = 2_000_000):
        self.chunks: List[TraceChunk] = []
        self.regions: dict[str, RegionInfo] = {}
        self.max_records = max_records
        self.dropped = 0
        self._n_records = 0
        self._pending: List[AccessRecord] = []

    # -- registration ------------------------------------------------------
    def register_region(self, region: RegionInfo) -> None:
        self.regions[region.name] = region

    @classmethod
    def new_group(cls) -> int:
        """A fresh disjointness token (one per collect-call x site)."""
        return next(cls._group_counter)

    # -- record-at-a-time compat path --------------------------------------
    def append(self, rec: AccessRecord) -> None:
        if self._n_records >= self.max_records:
            self.dropped += 1
            return
        self._pending.append(rec)
        self._n_records += 1

    def extend(self, recs: Iterable[AccessRecord]) -> None:
        for r in recs:
            self.append(r)

    def _flush_pending(self) -> None:
        """Pack buffered per-record appends into columnar chunks."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        # group consecutive records sharing (site, pid-ndim) into one chunk
        run: List[AccessRecord] = []

        def _pack(run: List[AccessRecord]) -> None:
            first = run[0]
            site = SiteInfo(first.array, first.site, first.space, first.kind)
            ndim = len(first.program_id)
            pids = np.asarray(
                [r.program_id for r in run], dtype=np.int64
            ).reshape(len(run), ndim)
            counts = np.asarray([len(r.touches) for r in run], dtype=np.int64)
            ptr = np.zeros(len(run) + 1, dtype=np.int64)
            np.cumsum(counts, out=ptr[1:])
            flat = [t for r in run for t in r.touches]
            if flat:
                pairs = np.asarray(flat, dtype=np.int64).reshape(-1, 2)
                tags, words = pairs[:, 0].copy(), pairs[:, 1].copy()
            else:
                tags = np.empty(0, dtype=np.int64)
                words = np.empty(0, dtype=np.int64)
            self.chunks.append(
                TraceChunk(site=site, pids=pids, tags=tags, words=words,
                           ptr=ptr, group=None)
            )

        for rec in pending:
            if run and (
                rec.array != run[0].array
                or rec.site != run[0].site
                or rec.space != run[0].space
                or rec.kind != run[0].kind
                or len(rec.program_id) != len(run[0].program_id)
            ):
                _pack(run)
                run = []
            run.append(rec)
        if run:
            _pack(run)

    # -- bulk columnar path ------------------------------------------------
    def append_block(
        self,
        site: SiteInfo,
        pids: np.ndarray,
        tags: np.ndarray,
        words: np.ndarray,
        ptr: Optional[np.ndarray] = None,
        group: Optional[int] = None,
    ) -> None:
        """Append P records in one call (broadcast or CSR — see TraceChunk).

        Enforces ``max_records`` at record granularity: a block that
        overflows the cap is truncated and the overflow is counted in
        ``dropped`` exactly once.
        """
        pids = np.asarray(pids, dtype=np.int64)
        if pids.ndim == 1:
            pids = pids[:, None]
        p = int(pids.shape[0])
        if p == 0:
            return
        admit = self.max_records - self._n_records
        if admit <= 0:
            self.dropped += p
            return
        if p > admit:
            self.dropped += p - admit
            pids = pids[:admit]
            if ptr is not None:
                cut = int(ptr[admit])
                tags = tags[:cut]
                words = words[:cut]
                ptr = ptr[: admit + 1]
            p = admit
        self._flush_pending()
        self.chunks.append(
            TraceChunk(
                site=site,
                pids=pids,
                tags=np.asarray(tags, dtype=np.int64),
                words=np.asarray(words, dtype=np.int64),
                ptr=None if ptr is None else np.asarray(ptr, dtype=np.int64),
                group=group,
            )
        )
        self._n_records += p

    # -- views -------------------------------------------------------------
    @property
    def records(self) -> RecordView:
        return RecordView(self)

    def iter_chunks(self) -> Iterator[TraceChunk]:
        self._flush_pending()
        return iter(self.chunks)

    @property
    def n_touch_events(self) -> int:
        self._flush_pending()
        return sum(c.n_touch_events for c in self.chunks)

    def __len__(self) -> int:
        return self._n_records

    def clear(self) -> None:
        self.chunks.clear()
        self._pending.clear()
        self._n_records = 0
        self.dropped = 0


def unique_pairs(
    primary: np.ndarray, secondary: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Distinct (primary, secondary) pairs, sorted by (primary, secondary).

    The shared dedup idiom of the columnar engine (per-record touch sets,
    distinct (key, pid) events): lexsort + first-occurrence mask.
    """
    order = np.lexsort((secondary, primary))
    a, b = primary[order], secondary[order]
    keep = np.ones(a.shape, bool)
    keep[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    return a[keep], b[keep]


def linearize_array(pids: np.ndarray, grid: Sequence[int]) -> np.ndarray:
    """Vectorized ``linearize``: (P, ndim) coords -> (P,) int64 linear ids."""
    pids = np.asarray(pids, dtype=np.int64)
    if pids.ndim != 2:
        pids = pids.reshape(len(pids), -1)
    if pids.shape[1] == 0:
        return np.zeros(pids.shape[0], dtype=np.int64)
    grid = tuple(int(g) for g in grid)
    return np.asarray(
        np.ravel_multi_index(tuple(pids.T), grid), dtype=np.int64
    ).reshape(-1)


def _sampled_axes(
    grid: Tuple[int, ...], sampler: GridSampler
) -> List[np.ndarray]:
    """Per-dimension admitted coordinates (the sampled grid is their
    row-major cross product)."""
    if sampler.target is None or min(len(sampler.target), len(grid)) == 0:
        return [np.arange(g, dtype=np.int64) for g in grid]
    k = min(len(sampler.target), len(grid))
    lo = sampler.target[k - 1] * sampler.window
    hi = min(lo + sampler.window, grid[k - 1])
    axes = [
        np.asarray([sampler.target[d]], dtype=np.int64) for d in range(k - 1)
    ]
    axes.append(np.arange(lo, hi, dtype=np.int64))
    axes.extend(np.arange(g, dtype=np.int64) for g in grid[k:])
    return axes


def sampled_grid_array(
    grid: Sequence[int], sampler: GridSampler
) -> np.ndarray:
    """Vectorized ``sampled_grid``: (P, ndim) int64 coords, row-major order."""
    grid = tuple(int(g) for g in grid)
    if len(grid) == 0:
        return np.zeros((1, 0), dtype=np.int64)
    mesh = np.meshgrid(*_sampled_axes(grid, sampler), indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=1)
