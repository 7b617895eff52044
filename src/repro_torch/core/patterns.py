"""The five CUTHERMO inefficiency patterns, detected on heat maps.

Each detector consumes a RegionHeatmap and emits PatternReports with
evidence rows and a severity in [0, 1].  Thresholds follow the paper's
qualitative definitions (§IV-C):

  HOT_SPOT        sector temps high AND word temps ~= sector temp
                  (uniform -> 'hot', irregular -> 'hot-random')
  SCRATCH_ABUSE   shared memory (scratch) whose words have temp == 1:
                  warp-local data parked in shared space
  FALSE_SHARING   sector temp >> max word temp: distinct warps own
                  distinct words of the same sector -> one transfer per
                  warp instead of one per sector
  MISALIGNMENT    boundary sectors partially covered because block
                  origins are not sector-aligned -> extra transfer per row
  STRIDED         the same word offset touched across many sectors while
                  other words stay cold -> 1/words of each transfer useful

Detectors run on the Analyzer's array-backed regions: row classification
is a handful of boolean masks over the (S, words) temperature matrix,
and ``HeatRow`` objects are only materialized for the <=8 evidence rows
each report carries.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .heatmap import Heatmap, HeatRow, RegionHeatmap

HOT = "hot"
HOT_RANDOM = "hot-random"
SCRATCH_ABUSE = "scratch-abuse"
FALSE_SHARING = "false-sharing"
MISALIGNMENT = "misalignment"
STRIDED = "strided"

ALL_PATTERNS = (HOT, HOT_RANDOM, SCRATCH_ABUSE, FALSE_SHARING, MISALIGNMENT, STRIDED)


@dataclasses.dataclass(frozen=True)
class PatternReport:
    pattern: str
    region: str
    kernel: str
    severity: float  # 0..1
    evidence: Tuple[str, ...]
    rows: Tuple[HeatRow, ...] = ()
    details: Tuple[Tuple[str, float], ...] = ()

    def detail(self, key: str, default: float = 0.0) -> float:
        for k, v in self.details:
            if k == key:
                return v
        return default

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready view (evidence rows elided to the text strings)."""
        return {
            "pattern": self.pattern,
            "region": self.region,
            "kernel": self.kernel,
            "severity": self.severity,
            "evidence": list(self.evidence),
            "details": {k: v for k, v in self.details},
        }


def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def _rows_of(rh: RegionHeatmap, mask: np.ndarray, limit: int = 8) -> Tuple[HeatRow, ...]:
    """Materialize the first ``limit`` evidence rows selected by ``mask``."""
    return tuple(rh.row(int(i)) for i in np.flatnonzero(mask)[:limit])


# --------------------------------------------------------------------------
# individual detectors
# --------------------------------------------------------------------------

def detect_hot(
    rh: RegionHeatmap, kernel: str, min_temp: int = 4
) -> Optional[PatternReport]:
    """Hot / random-hot sectors: heavily shared data (Fig. 6 e/f)."""
    if rh.region.space != "hbm" or rh.touched_sectors == 0:
        return None
    wt = rh.word_temps_matrix
    st = rh.sector_temps_array
    n_rows = rh.touched_sectors
    wps = wt.shape[1]
    hot = st >= min_temp
    if not hot.any():
        return None
    touched_cnt = (wt > 0).sum(axis=1)
    pos_min = np.where(wt > 0, wt, np.iinfo(np.int64).max).min(axis=1)
    # "hot": word temps close to sector temp (everything shared by everyone)
    uniform = (
        hot
        & (touched_cnt > 0)
        & (2 * pos_min >= st)
        & (touched_cnt >= wps // 2)
    )
    random_ = hot & (touched_cnt > 0) & ~uniform
    # Strided regions also have high sector temps but only one warm word;
    # hot requires multiple warm words per sector (handled by the split
    # above: single-word rows land in random_ with low evidence).
    n_uniform = int(uniform.sum())
    if n_uniform >= max(1, n_rows // 16):
        frac = n_uniform / n_rows
        temp = _mean(st[uniform].tolist())
        return PatternReport(
            pattern=HOT,
            region=rh.region.name,
            kernel=kernel,
            severity=min(1.0, frac * temp / max(1, rh.n_programs)),
            evidence=(
                f"{n_uniform}/{n_rows} sectors have sector temp >= {min_temp} "
                f"with uniformly warm words (mean sector temp {temp:.1f}, "
                f"{rh.n_programs} sampled warps)",
                "shared across many warps -> stage it once per thread block "
                "in shared memory (larger BLOCK_M/BLOCK_N tiles) instead of "
                "re-fetching it from device memory",
            ),
            rows=_rows_of(rh, uniform),
            details=(("mean_temp", temp), ("fraction", frac)),
        )
    if int(random_.sum()) >= max(1, n_rows // 8):
        multiword = random_ & (touched_cnt >= 2)
        n_multi = int(multiword.sum())
        if not n_multi:
            return None
        temp = _mean(st[multiword].tolist())
        return PatternReport(
            pattern=HOT_RANDOM,
            region=rh.region.name,
            kernel=kernel,
            severity=min(1.0, 0.5 * n_multi / n_rows),
            evidence=(
                f"{n_multi}/{n_rows} sectors irregularly hot "
                f"(mean sector temp {temp:.1f}); data-dependent sharing",
            ),
            rows=_rows_of(rh, multiword),
            details=(("mean_temp", temp),),
        )
    return None


def detect_scratch_abuse(
    rh: RegionHeatmap, kernel: str
) -> Optional[PatternReport]:
    """Shared-memory abuse: scratch holding warp-local data (Fig. 6 a)."""
    if rh.region.space != "vmem_scratch" or rh.touched_sectors == 0:
        return None
    wt = rh.word_temps_matrix
    # program-local: NO word is shared by two programs (sector temp may
    # exceed 1 when distinct programs own distinct words — still local)
    local = (wt <= 1).all(axis=1) & (wt == 1).any(axis=1)
    n_local = int(local.sum())
    frac = n_local / rh.touched_sectors
    if frac < 0.75:
        return None
    return PatternReport(
        pattern=SCRATCH_ABUSE,
        region=rh.region.name,
        kernel=kernel,
        severity=frac,
        evidence=(
            f"{n_local}/{rh.touched_sectors} scratch sectors are touched by "
            "exactly one warp per word: the data is warp-local",
            "shared memory buys nothing here and costs occupancy -> keep "
            "the value in a register accumulator and drop the shared-memory "
            "buffer and its barriers",
        ),
        rows=_rows_of(rh, local),
        details=(("local_fraction", frac),),
    )


def detect_false_sharing(
    rh: RegionHeatmap, kernel: str, ratio: float = 3.0
) -> Optional[PatternReport]:
    """Sector temp >> word temps: each warp owns a different word (Fig. 6 b)."""
    if rh.region.space != "hbm" or rh.touched_sectors == 0:
        return None
    wt = rh.word_temps_matrix
    st = rh.sector_temps_array
    n_rows = rh.touched_sectors
    max_word = wt.max(axis=1) if wt.shape[1] else np.zeros(n_rows, np.int64)
    touched_cnt = (wt > 0).sum(axis=1)
    fs = (max_word >= 1) & (touched_cnt >= 2) & (st >= ratio * max_word)
    n_fs = int(fs.sum())
    if n_fs < max(2, n_rows // 8):
        return None
    mean_ratio = _mean(
        (st[fs] / np.maximum(1, max_word[fs])).tolist()
    )
    wps = rh.words_per_sector()
    return PatternReport(
        pattern=FALSE_SHARING,
        region=rh.region.name,
        kernel=kernel,
        severity=min(1.0, (mean_ratio - 1) / (wps - 1)) if wps > 1 else 1.0,
        evidence=(
            f"{n_fs}/{n_rows} sectors: sector temp is "
            f"{mean_ratio:.1f}x the hottest word -> ~{mean_ratio:.0f} sector "
            "transfers where 1 would do",
            "distinct warps own distinct words of the same sector -> swap "
            "the thread indices so a warp's lanes cover whole sectors",
        ),
        rows=_rows_of(rh, fs),
        details=(("mean_ratio", mean_ratio), ("n_rows", float(n_fs))),
    )


def _head_tail_overlap_mask(
    wt: np.ndarray, st: np.ndarray
) -> np.ndarray:
    """Rows where a strict head (or tail) run of words is exactly one
    contributor hotter than the rest — the signature of every block
    straddling one tile boundary."""
    n_rows, wps = wt.shape
    if wps < 2:
        return np.zeros(n_rows, bool)
    lo = wt.min(axis=1)
    hi = wt.max(axis=1)
    cand = (lo > 0) & (hi == lo + 1) & (st == hi)
    hot = wt == hi[:, None]
    # hot run is a strict prefix iff hot is monotone non-increasing along
    # the row; a strict tail iff monotone non-decreasing (k in (0, wps) is
    # implied by lo < hi under cand)
    prefix = np.all(hot[:, 1:] <= hot[:, :-1], axis=1)
    suffix = np.all(hot[:, 1:] >= hot[:, :-1], axis=1)
    return cand & (prefix | suffix)


def detect_misalignment(
    rh: RegionHeatmap, kernel: str
) -> Optional[PatternReport]:
    """Block origins straddling sector boundaries (Fig. 7).

    Two observable signatures:
      A. *periodic overlap*: every block is misaligned by the same k words,
         so each tile's head (or tail) k words are touched by one extra
         program: head temps == lo+1, rest == lo, sector temp == lo+1.
      B. *boundary sectors*: partially-touched sectors (head/tail words
         cold, or sector temp above all words) adjacent to fully-covered
         interior sectors — the classic 5-transfers-where-4-would-do.
    """
    if rh.region.space != "hbm" or rh.touched_sectors < 3:
        return None
    wt = rh.word_temps_matrix
    st = rh.sector_temps_array
    n_rows = rh.touched_sectors
    wps = rh.words_per_sector()
    touched_cnt = (wt > 0).sum(axis=1)
    max_word = wt.max(axis=1)
    valid = rh.valid_words_array()
    nonempty = touched_cnt > 0
    overlap = _head_tail_overlap_mask(wt, st) & nonempty
    full_cover = nonempty & ~overlap & (touched_cnt >= valid) & (max_word == st)
    above = nonempty & ~overlap & ~full_cover & (st > max_word)
    partial = (
        nonempty & ~overlap & ~full_cover & ~above
        & (touched_cnt < valid) & (st == max_word)
    )
    boundary = above | partial
    # everything nonempty that is neither overlap nor boundary (the seed's
    # first interior branch plus its trailing else)
    interior = nonempty & ~overlap & ~boundary

    # Signature A: majority of sectors show the same-k overlap.
    n_overlap = int(overlap.sum())
    frac_a = n_overlap / n_rows
    if frac_a >= 0.5:
        actual_tx = int(st[overlap].sum())
        ideal_tx = int(wt[overlap].sum()) / wps
        overhead = max(0.0, actual_tx / max(ideal_tx, 1e-9) - 1.0)
        return PatternReport(
            pattern=MISALIGNMENT,
            region=rh.region.name,
            kernel=kernel,
            severity=min(1.0, overhead),
            evidence=(
                f"{n_overlap}/{n_rows} sectors show a head/tail "
                "word run one contributor hotter than the rest: every block "
                "origin straddles a sector boundary by the same offset",
                f"~{100*overhead:.0f}% extra sector transfers -> pad the "
                "array (or shift the block origin) to a sector boundary, or "
                "duplicate boundary words (paper's zigzag fix)",
            ),
            rows=_rows_of(rh, overlap),
            details=(("overhead", overhead), ("boundary_fraction", frac_a)),
        )

    # Signature C: EVERY interior block straddles a boundary — all words
    # covered, uniform word temps, sector temp exactly 2x (two programs
    # split each tile head/tail), with partially-covered run-edge tiles.
    pos_min = np.where(wt > 0, wt, np.iinfo(np.int64).max).min(axis=1)
    two_way = (
        nonempty
        & (pos_min == max_word)
        & (touched_cnt >= valid)
        & (st == 2 * max_word)
    )
    edge_partial = (touched_cnt > 0) & (touched_cnt < valid)
    n_two_way = int(two_way.sum())
    if edge_partial.any() and n_two_way >= 0.5 * n_rows:
        overhead = 1.0  # ~2x transfers on the straddled tiles
        return PatternReport(
            pattern=MISALIGNMENT,
            region=rh.region.name,
            kernel=kernel,
            severity=min(1.0, n_two_way / n_rows),
            evidence=(
                f"{n_two_way}/{n_rows} sectors are split between "
                "exactly two programs (uniform words, sector temp 2x) with "
                f"{int(edge_partial.sum())} half-covered run-edge sectors: "
                "every block origin straddles a sector boundary",
                "pad the array or shift the block origin to a sector "
                "boundary; or duplicate boundary words (zigzag)",
            ),
            rows=_rows_of(rh, two_way),
            details=(("overhead", overhead),
                     ("boundary_fraction", n_two_way / n_rows)),
        )

    # Signature B: minority boundary sectors between fully-used interiors.
    n_boundary = int(boundary.sum())
    n_interior = int(interior.sum())
    if not n_boundary or not n_interior:
        return None
    frac = n_boundary / n_rows
    if frac < 0.02 or frac > 0.6:
        return None
    overhead = n_boundary / max(1, n_interior)
    return PatternReport(
        pattern=MISALIGNMENT,
        region=rh.region.name,
        kernel=kernel,
        severity=min(1.0, overhead),
        evidence=(
            f"{n_boundary} boundary sectors are split/partially used next "
            f"to {n_interior} fully-used interior sectors: block origins "
            "are not sector-aligned",
            f"~{100*overhead:.0f}% extra sector transfers + wasted words "
            "-> pad the array (or shift block origin) to a sector "
            "boundary, or duplicate boundary elements (paper's zigzag fix)",
        ),
        rows=_rows_of(rh, boundary),
        details=(("overhead", overhead), ("boundary_fraction", frac)),
    )


def detect_strided(
    rh: RegionHeatmap, kernel: str
) -> Optional[PatternReport]:
    """Same word offset warm across many sectors, others cold (Fig. 6 d)."""
    if rh.region.space != "hbm" or rh.touched_sectors < 4:
        return None
    wps = rh.words_per_sector()
    if wps < 2:
        return None
    wt = rh.word_temps_matrix
    n_rows = rh.touched_sectors
    valid = rh.valid_words_array()
    touched_cnt = (wt > 0).sum(axis=1)
    # edge tiles with one real word can't be "sparse"
    sparse = (
        (valid >= 2)
        & (touched_cnt > 0)
        & (touched_cnt <= np.maximum(1, valid // 4))
    )
    if not sparse.any():
        return None
    # word offsets of every touch in sparse rows, row-major order
    offsets = np.nonzero(wt[sparse] > 0)[1].tolist()
    if not offsets:
        return None
    n_sparse = int(sparse.sum())
    frac = n_sparse / n_rows
    if frac < 0.6:
        return None
    # offsets should be concentrated (same word position across sectors)
    try:
        mode_off = statistics.mode(offsets)
    except statistics.StatisticsError:
        mode_off = offsets[0]
    concentration = offsets.count(mode_off) / len(offsets)
    waste = 1.0 - _mean((touched_cnt[sparse] / wps).tolist())
    tags = rh.tags_array[sparse].tolist()
    stride = statistics.mode([b - a for a, b in zip(tags, tags[1:])]) if len(tags) > 1 else 1
    return PatternReport(
        pattern=STRIDED,
        region=rh.region.name,
        kernel=kernel,
        severity=min(1.0, waste),
        evidence=(
            f"{n_sparse}/{n_rows} sectors have <= {wps//4} of "
            f"{wps} words touched; word offset {mode_off} recurs in "
            f"{100*concentration:.0f}% of touches, sector stride {stride}",
            f"{100*waste:.0f}% of every transferred sector is dead -> "
            "transpose the layout so the strided axis is contiguous, or "
            "stage the column once in shared memory and reuse it",
        ),
        rows=_rows_of(rh, sparse),
        details=(
            ("waste", waste),
            ("stride", float(stride)),
            ("word_offset", float(mode_off)),
        ),
    )


DETECTORS = (
    detect_scratch_abuse,
    detect_false_sharing,
    detect_strided,
    detect_misalignment,
    detect_hot,
)


def detect_all(heatmap: Heatmap) -> List[PatternReport]:
    """Run every detector on every region; sort by severity.

    Precedence: false-sharing and strided are *more specific* diagnoses
    than (random-)hot — their heat signatures are supersets — so when one
    of them fires for a region, the hot-random report there is dropped
    (the paper distinguishes them by the sector-vs-word temperature gap).
    """
    reports: List[PatternReport] = []
    for rh in heatmap.regions:
        region_reports = [
            rep for det in DETECTORS if (rep := det(rh, heatmap.kernel))
        ]
        specific = {r.pattern for r in region_reports}
        if FALSE_SHARING in specific or STRIDED in specific:
            region_reports = [
                r for r in region_reports if r.pattern != HOT_RANDOM
            ]
        reports.extend(region_reports)
    reports.sort(key=lambda r: -r.severity)
    return reports


def patterns_by_region(heatmap: Heatmap) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for rep in detect_all(heatmap):
        out.setdefault(rep.region, []).append(rep.pattern)
    return out
