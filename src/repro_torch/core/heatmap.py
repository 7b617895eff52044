"""Analyzer: builds the word-sector heat map from trace records.

This is a faithful port of CUTHERMO's Analyzer (§IV-B2), vectorized:

* The seed implementation kept a ``sector_history_map`` of per-word
  Python-int bitmasks and executed the paper's ``mask |= 1 << id`` once
  per touch.  The columnar engine reaches the identical temperatures
  without materializing masks: chunks whose provenance ``group``
  guarantees pairwise-disjoint program ids (everything the Level-1/2
  collectors emit) contribute *weighted sums* of distinct-contributor
  counts, and everything else (record-at-a-time compat appends) takes an
  exact ``np.unique``-style dedup over packed ``(tag, word, pid)`` keys.
* ``flush`` produces array-backed ``RegionHeatmap``s: per-region sector
  tags, an (S, words) word-temperature matrix and an (S,) sector-
  temperature vector.  ``HeatRow`` objects are materialized lazily for
  existing row-oriented consumers.
* Word and sector granularity come from each region's geometry
  (:mod:`repro_torch.core.tiles`): 32 B sectors of 4 B words on the
  H100, or the TPU tile for parity with the JAX package.

Invariants (property-tested):
  * sector mask == OR of its word masks (sector temp >= every word temp)
  * temperatures are bounded by the number of sampled programs
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .resilience import FaultEvent
from .tiles import TPUTile
from .trace import (
    RegionInfo,
    ShardInfo,
    TraceBuffer,
    TraceChunk,
    linearize_array,
    unique_pairs,
)


@dataclasses.dataclass(frozen=True)
class HeatRow:
    """One flushed heat-map row: a sector and its temperatures."""

    region: str
    tag: int
    word_temps: Tuple[int, ...]
    sector_temp: int

    @property
    def signature(self) -> Tuple[int, ...]:
        """Pattern signature used for row compression (Fig. 4)."""
        return self.word_temps + (self.sector_temp,)


@dataclasses.dataclass(frozen=True)
class HeatKeys:
    """The packed key-set state behind one region's temperatures.

    Temperatures are *distinct-contributor counts*; the sets being
    counted are exactly the set bits of the paper's bitmasks:

        (word_keys, word_pids)      distinct (tag*words + word, pid)
                                    pairs — one per set word-mask bit
        (sector_tags, sector_pids)  distinct (tag, pid) pairs — one per
                                    set sector-mask bit
        pids                        distinct contributor (linearized
                                    program) ids, including zero-touch
                                    contributors

    Because these are sets, heat maps form a merge monoid (the union of
    two key sets is the key set of the combined trace), which sharded
    collection relies on.

    All arrays are int64 and kept in the canonical ``unique_pairs``
    order (ascending primary, then secondary), so equal states compare
    equal array-wise.
    """

    word_keys: np.ndarray  # (N,) packed tag * words_per_sector + word
    word_pids: np.ndarray  # (N,) linearized program ids, parallel
    sector_tags: np.ndarray  # (M,) sector tags
    sector_pids: np.ndarray  # (M,) linearized program ids, parallel
    pids: np.ndarray  # (P,) distinct contributor ids, ascending


def _temps_from_keys(
    keys: HeatKeys, words: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Derive (tags, word_temps, sector_temps, n_programs) from key sets
    (the counting step of the Analyzer's exact path)."""
    n_programs = int(keys.pids.shape[0])
    if keys.word_keys.size == 0:
        return (
            np.empty(0, np.int64),
            np.empty((0, words), np.int64),
            np.empty(0, np.int64),
            n_programs,
        )
    ukeys, word_counts = np.unique(keys.word_keys, return_counts=True)
    utags, sector_counts = np.unique(keys.sector_tags, return_counts=True)
    key_tags = ukeys // words
    key_words = ukeys % words
    word_temps = np.zeros((utags.shape[0], words), dtype=np.int64)
    rows_idx = np.searchsorted(utags, key_tags)
    word_temps[rows_idx, key_words] = word_counts
    return utags, word_temps, sector_counts.astype(np.int64), n_programs


class RegionHeatmap:
    """Flushed heat map of one memory region, array-backed.

    Canonical storage is three arrays (ascending sector tag):

        tags_array           (S,)        int64 sector tags
        word_temps_matrix    (S, words)  int64 distinct-contributor counts
        sector_temps_array   (S,)        int64 whole-sector counts

    ``rows`` materializes the legacy ``HeatRow`` tuple lazily (cached);
    constructing from ``rows=`` is still supported for the reference
    path and hand-built fixtures.

    """

    def __init__(
        self,
        region: RegionInfo,
        rows: Optional[Sequence[HeatRow]] = None,
        n_programs: int = 0,
        *,
        tags: Optional[np.ndarray] = None,
        word_temps: Optional[np.ndarray] = None,
        sector_temps: Optional[np.ndarray] = None,
    ):
        self.region = region
        self.n_programs = int(n_programs)
        if rows is not None:
            rows = tuple(rows)
            self._rows: Optional[Tuple[HeatRow, ...]] = rows
            wps = self.words_per_sector()
            self._tags = np.asarray([r.tag for r in rows], dtype=np.int64)
            self._word_temps = np.asarray(
                [r.word_temps for r in rows], dtype=np.int64
            ).reshape(len(rows), wps if rows == () else -1)
            if self._word_temps.size == 0:
                self._word_temps = self._word_temps.reshape(0, wps)
            self._sector_temps = np.asarray(
                [r.sector_temp for r in rows], dtype=np.int64
            )
        else:
            self._rows = None
            wps = self.words_per_sector()
            self._tags = (
                np.empty(0, np.int64) if tags is None else np.asarray(tags)
            )
            self._word_temps = (
                np.empty((0, wps), np.int64)
                if word_temps is None
                else np.asarray(word_temps)
            )
            self._sector_temps = (
                np.empty(0, np.int64)
                if sector_temps is None
                else np.asarray(sector_temps)
            )

    # -- array views --------------------------------------------------------
    @property
    def tags_array(self) -> np.ndarray:
        return self._tags

    @property
    def word_temps_matrix(self) -> np.ndarray:
        return self._word_temps

    @property
    def sector_temps_array(self) -> np.ndarray:
        return self._sector_temps

    # -- legacy row view ----------------------------------------------------
    @property
    def rows(self) -> Tuple[HeatRow, ...]:
        if self._rows is None:
            name = self.region.name
            self._rows = tuple(
                HeatRow(
                    region=name,
                    tag=int(t),
                    word_temps=tuple(int(x) for x in wt),
                    sector_temp=int(s),
                )
                for t, wt, s in zip(
                    self._tags.tolist(),
                    self._word_temps.tolist(),
                    self._sector_temps.tolist(),
                )
            )
        return self._rows

    def row(self, i: int) -> HeatRow:
        """Materialize a single row (cheap evidence extraction)."""
        if self._rows is not None:
            return self._rows[i]
        return HeatRow(
            region=self.region.name,
            tag=int(self._tags[i]),
            word_temps=tuple(int(x) for x in self._word_temps[i]),
            sector_temp=int(self._sector_temps[i]),
        )

    @property
    def max_sector_temp(self) -> int:
        if self._sector_temps.size == 0:
            return 0
        return int(self._sector_temps.max())

    @property
    def touched_sectors(self) -> int:
        return int(self._tags.shape[0])

    def words_per_sector(self) -> int:
        return self.region.geometry.words_per_sector

    def valid_words_array(self) -> np.ndarray:
        """Words of each flushed sector that actually exist (edge sectors
        of a region that does not fill its last sector have fewer)."""
        return self.region.geometry.valid_words_array(self._tags)

    def touched_word_fraction(self) -> float:
        """Fraction of words touched inside touched sectors (waste gauge)."""
        if self.touched_sectors == 0:
            return 0.0
        total = self.touched_sectors * self.words_per_sector()
        touched = int((self._word_temps > 0).sum())
        return touched / total


@dataclasses.dataclass(frozen=True)
class Heatmap:
    """The full heat map of one profiled kernel.

    ``shards`` is collection provenance: one :class:`ShardInfo` per
    worker shard of a sharded collection, empty for a single-pass build.
    ``faults`` is recovery provenance: one :class:`FaultEvent` per
    recovery action the collection survived.  Both are loaded from and
    written to artifacts and are excluded from heat-map equality
    (`heatmaps_equal`).
    """

    kernel: str
    grid: Tuple[int, ...]
    sampler: str
    regions: Tuple[RegionHeatmap, ...]
    n_records: int
    dropped: int
    shards: Tuple[ShardInfo, ...] = ()
    faults: Tuple[FaultEvent, ...] = ()

    def region(self, name: str) -> RegionHeatmap:
        for r in self.regions:
            if r.region.name == name:
                return r
        raise KeyError(name)

    def region_names(self) -> List[str]:
        return [r.region.name for r in self.regions]

    # -- transaction model --------------------------------------------------
    def _tx_regions(self, region: Optional[str]) -> Tuple[RegionHeatmap, ...]:
        if region is not None:
            return (self.region(region),)
        # only device-memory regions move across the device-memory boundary
        return tuple(r for r in self.regions if r.region.space == "hbm")

    def sector_transactions(self, region: Optional[str] = None) -> int:
        """Modeled device-memory transactions: sum of sector temps.

        Each distinct visitor (warp) of a sector moves that sector once,
        absent cache reuse.  This is the paper's "8 sector transactions
        for false sharing vs 1 for coalesced" arithmetic, generalized.
        Scratch (shared-memory) regions are excluded: they never cross
        the device-memory boundary.
        """
        regs = self._tx_regions(region)
        return int(sum(int(rh.sector_temps_array.sum()) for rh in regs))

    def useful_word_transactions(self, region: Optional[str] = None) -> int:
        """Word-granularity demand: sum of word temps (what software asked)."""
        regs = self._tx_regions(region)
        return int(sum(int(rh.word_temps_matrix.sum()) for rh in regs))

    def waste_ratio(self, region: Optional[str] = None) -> float:
        """Moved words / demanded words (>= 1; 1.0 is perfect)."""
        demanded = self.useful_word_transactions(region)
        if demanded == 0:
            return 1.0
        regs = self._tx_regions(region)
        moved = sum(
            int(rh.sector_temps_array.sum()) * rh.words_per_sector()
            for rh in regs
        )
        return moved / demanded

    def scratch_words(self) -> int:
        """Word touches on scratch regions (the scratch-cost gauge).

        Scratch never crosses the device-memory boundary, so it is
        excluded from :meth:`sector_transactions`; it still costs
        capacity and bandwidth, so artifacts track it separately.
        """
        return int(
            sum(
                int(rh.word_temps_matrix.sum())
                for rh in self.regions
                if rh.region.space == "vmem_scratch"
            )
        )

    def summary_stats(self) -> Dict[str, object]:
        """JSON-ready profile summary (session manifests, report digests).

        Everything here is derived from the columnar temperature state:
        the modeled transaction totals plus per-region sector/program
        counts — the numbers a dashboard wants without loading arrays.
        """
        return {
            "kernel": self.kernel,
            "grid": list(self.grid),
            "sampler": self.sampler,
            "n_records": self.n_records,
            "dropped": self.dropped,
            "shards": [s.as_dict() for s in self.shards],
            "faults": [e.as_dict() for e in self.faults],
            "transactions": self.sector_transactions(),
            "demanded_words": self.useful_word_transactions(),
            "waste_ratio": self.waste_ratio(),
            "scratch_words": self.scratch_words(),
            "regions": {
                rh.region.name: {
                    "space": rh.region.space,
                    "touched_sectors": rh.touched_sectors,
                    "n_programs": rh.n_programs,
                    "max_sector_temp": rh.max_sector_temp,
                }
                for rh in self.regions
            },
        }


@dataclasses.dataclass
class _IngestedChunk:
    chunk: TraceChunk
    lin: np.ndarray  # (P,) linearized program ids


class Analyzer:
    """Drains TraceBuffers into columnar per-region state and flushes
    array-backed heat maps (bit-identical to the JAX package's)."""

    def __init__(self, kernel: str, grid: Sequence[int], sampler_desc: str):
        self.kernel = kernel
        self.grid = tuple(int(g) for g in grid)
        self.sampler_desc = sampler_desc
        self._chunk_map: Dict[str, List[_IngestedChunk]] = {}
        self._regions: Dict[str, RegionInfo] = {}
        self._n_records = 0
        self._dropped = 0
        # drop/record accounting per source buffer: holding the buffer
        # object keeps ids stable and makes re-ingesting the same buffer
        # an incremental drain instead of a double count.
        self._sources: Dict[
            int, Tuple[TraceBuffer, int, int, Optional[TraceChunk]]
        ] = {}

    # -- ingestion -----------------------------------------------------------
    def ingest(self, buf: TraceBuffer) -> None:
        buf._flush_pending()
        for region in buf.regions.values():
            self._regions.setdefault(region.name, region)
            self._chunk_map.setdefault(region.name, [])
        chunks_seen, dropped_seen = 0, 0
        src = self._sources.get(id(buf))
        if src is not None:
            _, chunks_seen, dropped_seen, last_chunk = src
            stale = (
                len(buf.chunks) < chunks_seen
                or buf.dropped < dropped_seen
                or (
                    chunks_seen > 0
                    and buf.chunks[chunks_seen - 1] is not last_chunk
                )
            )
            if stale:
                # buffer was clear()ed and refilled: everything is new again
                chunks_seen, dropped_seen = 0, 0
        for chunk in buf.chunks[chunks_seen:]:
            lin = linearize_array(chunk.pids, self.grid)
            self._chunk_map.setdefault(chunk.site.array, []).append(
                _IngestedChunk(chunk, lin)
            )
            self._n_records += chunk.n_records
        # drops are surfaced exactly once per buffer, even across repeated
        # or multi-buffer ingests (the seed double-counted re-ingests)
        self._dropped += buf.dropped - dropped_seen
        self._sources[id(buf)] = (
            buf,
            len(buf.chunks),
            buf.dropped,
            buf.chunks[-1] if buf.chunks else None,
        )

    # -- flush ----------------------------------------------------------------
    @staticmethod
    def _check_words(name: str, chunk: TraceChunk, words: int) -> None:
        """Guard the packed-key invariant word < words (out-of-range offsets
        would alias into the next tag's slot)."""
        wmax = int(chunk.words.max())
        if wmax >= words:
            raise IndexError(
                f"word offset {wmax} out of range for region {name!r} "
                f"with {words} words/sector"
            )

    def _flush_region(
        self, name: str, words: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """(tags, word_temps (S, words), sector_temps, n_programs)."""
        entries = self._chunk_map.get(name, [])
        if not entries:
            return (
                np.empty(0, np.int64),
                np.empty((0, words), np.int64),
                np.empty(0, np.int64),
                0,
            )
        all_lins = np.unique(np.concatenate([e.lin for e in entries]))
        n_programs = int(all_lins.shape[0])
        groups = {e.chunk.group for e in entries}
        if len(groups) == 1 and None not in groups:
            key_parts: List[np.ndarray] = []
            keyw_parts: List[np.ndarray] = []
            tag_parts: List[np.ndarray] = []
            tagw_parts: List[np.ndarray] = []
            for e in entries:
                chunk = e.chunk
                if chunk.tags.size == 0:
                    continue
                self._check_words(name, chunk, words)
                keys = chunk.tags * words + chunk.words
                if chunk.ptr is None:
                    w = float(chunk.n_records)
                    key_parts.append(keys)
                    keyw_parts.append(np.full(keys.shape, w))
                    utags = np.unique(chunk.tags)
                    tag_parts.append(utags)
                    tagw_parts.append(np.full(utags.shape, w))
                else:
                    counts = np.diff(chunk.ptr)
                    rec = np.repeat(
                        np.arange(chunk.n_records, dtype=np.int64), counts
                    )
                    key_parts.append(keys)
                    keyw_parts.append(np.ones(keys.shape))
                    _, rec_tags = unique_pairs(rec, chunk.tags)
                    tag_parts.append(rec_tags)
                    tagw_parts.append(np.ones(rec_tags.shape))
            if not key_parts:
                return (
                    np.empty(0, np.int64),
                    np.empty((0, words), np.int64),
                    np.empty(0, np.int64),
                    n_programs,
                )
            all_keys = np.concatenate(key_parts)
            all_kw = np.concatenate(keyw_parts)
            ukeys, inv = np.unique(all_keys, return_inverse=True)
            word_counts = np.bincount(inv, weights=all_kw).astype(np.int64)
            all_tags = np.concatenate(tag_parts)
            all_tw = np.concatenate(tagw_parts)
            utags, tinv = np.unique(all_tags, return_inverse=True)
            sector_counts = np.bincount(tinv, weights=all_tw).astype(np.int64)
            # scatter packed word keys into the (S, words) matrix
            key_tags = ukeys // words
            key_words = ukeys % words
            word_temps = np.zeros((utags.shape[0], words), dtype=np.int64)
            rows_idx = np.searchsorted(utags, key_tags)
            word_temps[rows_idx, key_words] = word_counts
            return (
                utags,
                word_temps,
                sector_counts.astype(np.int64),
                n_programs,
            )
        # exact path: expand to (key, pid) events, dedupe into the packed
        # key-set state, and count through _temps_from_keys
        ev_keys: List[np.ndarray] = []
        ev_pids: List[np.ndarray] = []
        for e in entries:
            chunk = e.chunk
            if chunk.tags.size == 0:
                continue
            self._check_words(name, chunk, words)
            keys = chunk.tags * words + chunk.words
            if chunk.ptr is None:
                ev_keys.append(np.tile(keys, chunk.n_records))
                ev_pids.append(np.repeat(e.lin, keys.shape[0]))
            else:
                ev_keys.append(keys)
                ev_pids.append(np.repeat(e.lin, np.diff(chunk.ptr)))
        empty = np.empty(0, np.int64)
        keys = np.concatenate(ev_keys) if ev_keys else empty
        pids = np.concatenate(ev_pids) if ev_pids else empty
        # distinct (tag, word, pid) triples, then distinct (tag, pid)
        ks, ps = unique_pairs(keys, pids)
        stags, spids = unique_pairs(ks // words, ps)
        keys_state = HeatKeys(
            word_keys=ks,
            word_pids=ps,
            sector_tags=stags,
            sector_pids=spids,
            pids=all_lins,
        )
        return _temps_from_keys(keys_state, words)

    def flush(self) -> Heatmap:
        """Flush the ingested state into a :class:`Heatmap`."""
        region_maps: List[RegionHeatmap] = []
        for name in sorted(set(self._regions) | set(self._chunk_map)):
            region = self._regions.get(name)
            if region is None:
                # unregistered region: synthesize a geometry stub
                region = RegionInfo(
                    name=name,
                    geometry=TPUTile(shape=(8, 128), itemsize=4, name=name),
                )
            words = region.geometry.words_per_sector
            tags, word_temps, sector_temps, n_programs = self._flush_region(
                name, words
            )
            region_maps.append(
                RegionHeatmap(
                    region=region,
                    n_programs=n_programs,
                    tags=tags,
                    word_temps=word_temps,
                    sector_temps=sector_temps,
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


def compress_rows(
    rows: Sequence[HeatRow],
) -> List[Tuple[HeatRow, int]]:
    """Group consecutive rows with identical signatures (Fig. 4 compression).

    Returns (representative_row, repetition_count) pairs; consecutive means
    consecutive sector tags AND identical temperature signatures.  Lossless
    for rendering: sum of counts == len(rows).
    """
    out: List[Tuple[HeatRow, int]] = []
    for row in rows:
        if (
            out
            and out[-1][0].signature == row.signature
            and out[-1][0].region == row.region
            and row.tag == out[-1][0].tag + out[-1][1]
        ):
            out[-1] = (out[-1][0], out[-1][1] + 1)
        else:
            out.append((row, 1))
    return out


def compress_region(rh: RegionHeatmap) -> List[Tuple[HeatRow, int]]:
    """Vectorized ``compress_rows`` over an array-backed region: find runs
    of consecutive tags with identical temperature signatures without
    materializing every HeatRow (only run representatives are built)."""
    s = rh.touched_sectors
    if s == 0:
        return []
    tags = rh.tags_array
    wt = rh.word_temps_matrix
    st = rh.sector_temps_array
    same = (
        (tags[1:] == tags[:-1] + 1)
        & (st[1:] == st[:-1])
        & np.all(wt[1:] == wt[:-1], axis=1)
    )
    starts = np.flatnonzero(np.concatenate(([True], ~same)))
    counts = np.diff(np.concatenate((starts, [s])))
    return [
        (rh.row(int(i)), int(c)) for i, c in zip(starts, counts)
    ]
