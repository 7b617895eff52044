"""Static KernelSpec linter: predict heat-map patterns with zero traces.

Most of CUTHERMO's five memory-access patterns are *structural*
properties of a ``KernelSpec`` — misaligned origins, strided layouts,
inter-program block overlap, whole-buffer scratch abuse are all decided
by (grid, block_shape, index_map, origin) geometry alone, without ever
materializing a trace.  This module is that decision procedure:

1. **Affine extraction** — each operand's ``index_map`` is probed with
   :func:`repro_torch.core.collector.probe_affine_map` (base at the grid
   origin, one unit-vector probe per axis, validated at sparse
   corner/edge/middle points).  Maps the model cannot reproduce get an
   explicit ``nonaffine`` verdict; operands served by a Level-2 dynamic
   walker are ``dynamic`` and the linter stays silent about them (the
   static view cannot see data-dependent gathers).

2. **Rule engine** — geometric rules over the affine coefficients and
   block footprints predict pattern classes and bounds.  Each rule reads
   the operand's own geometry.  Under ``TPUTile`` (the JAX package's
   tile) every rule is the reference's, verdict for verdict; under
   ``H100Sector`` a rule is stated in 32 B sectors of eight 4 B words of
   the region's row-major bytes, and a rule with no meaning for flat
   sectors stays silent (its docstring says why):

   - ``overlap-false-sharing``: adjacent programs along some grid axis
     land inside the same sector row band (0 < row delta < sublanes)
     with blocks short enough not to overlap — several programs own
     distinct words of one tile (paper Fig. 6 b).
   - ``redundant-fetch``: grid axes with all-zero coefficients re-fetch
     the identical block ``prod(grid[axis])`` times -> a hot region.
   - ``misaligned-origin``: the operand origin is not (sublane, lane)
     tile aligned, so every block straddles a tile boundary (Fig. 7).
   - ``word-sparse-stride`` / ``lane-minor-stride``: blocks touch a
     small fraction of each fetched tile's words (row jumps >= one
     sector) or lanes (tall, narrow column reads) — Fig. 6 d.
   - ``scratch-local``: a ``ScratchSpec`` whose access model gives every
     program a pairwise-disjoint word set — program-local data parked
     in shared VMEM scratch (Fig. 6 a).

   plus purely-static checks the dynamic profiler cannot express:
   ``oob-origin`` (block origins outside the array — an error),
   ``dead-operand`` (no block ever touches the array — an error) and
   ``coverage-gap`` (a grid that leaves >1/8 of an operand's sectors
   unreachable).

3. **Modeled transfers** — ``static_transactions`` replays the
   collector's static walk arithmetic exactly (same vectorized
   index-map evaluation, same geometry clipping, same once-operand
   handling), so for fully-static specs the modeled total equals the
   traced total bit-for-bit; per-operand totals and a distinct-sector
   floor land in each :class:`OperandVerdict`.

Findings are :class:`LintFinding` objects sharing the
``PatternReport`` surface (``pattern`` / ``region`` / ``severity`` /
``detail()``), so ``advisor.advise_static`` turns them into the same
ranked `Action` plans the dynamic pipeline produces, and the tuner's
pre-screen (`repro_torch.core.tuner`) can skip profiling candidates whose
modeled transfer total is strictly worse than the incumbent's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .collector import (
    AffineModel,
    KernelSpec,
    OperandSpec,
    ScratchSpec,
    _eval_index_map_batch,
    _touch_arrays_for_key,
    probe_affine_map,
)
from .patterns import (
    FALSE_SHARING,
    HOT,
    MISALIGNMENT,
    SCRATCH_ABUSE,
    STRIDED,
    PatternReport,
)
from .tiles import LANES, TPUTile, block_to_2d
from .trace import GridSampler, sampled_grid_array

LINT_FORMAT = "cuthermo-lint"
LINT_SCHEMA_VERSION = 1

# static-only pattern classes: checks the dynamic profiler cannot
# express (no trace ever shows "this sector is unreachable")
COVERAGE_GAP = "coverage-gap"
OUT_OF_BOUNDS = "out-of-bounds"
DEAD_OPERAND = "dead-operand"

STATIC_ONLY_PATTERNS = (COVERAGE_GAP, OUT_OF_BOUNDS, DEAD_OPERAND)


class LintError(RuntimeError):
    """A lint invocation that cannot produce a verdict (usage error)."""


@dataclasses.dataclass(frozen=True)
class LintFinding:
    """One static prediction, shaped like a ``patterns.PatternReport``.

    ``pattern``/``region``/``severity``/``detail()`` are the surface
    ``advisor`` consumes; ``rule`` names the static rule that fired and
    ``level`` separates gate-worthy errors (``oob-origin``,
    ``dead-operand``) from advisory warnings.
    """

    pattern: str
    region: str
    kernel: str
    severity: float  # 0..1
    evidence: Tuple[str, ...]
    rule: str
    level: str = "warning"  # 'warning' | 'error'
    details: Tuple[Tuple[str, float], ...] = ()

    def detail(self, key: str, default: float = 0.0) -> float:
        """Look up one detail value (PatternReport-compatible)."""
        for k, v in self.details:
            if k == key:
                return v
        return default

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready view, a superset of ``PatternReport.as_dict``."""
        return {
            "pattern": self.pattern,
            "region": self.region,
            "kernel": self.kernel,
            "severity": self.severity,
            "evidence": list(self.evidence),
            "details": {k: v for k, v in self.details},
            "rule": self.rule,
            "level": self.level,
        }


@dataclasses.dataclass(frozen=True)
class OperandVerdict:
    """Per-operand static summary: model status + modeled transfer bounds.

    ``modeled_transactions`` is the exact collector-replay total for
    static operands (None for dynamic ones); ``floor_transactions`` is
    the distinct-sector count — the cheapest possible schedule that
    still touches every sector the spec touches.
    """

    region: str
    space: str  # 'hbm' | 'vmem_scratch'
    status: str  # 'affine' | 'nonaffine' | 'dynamic' | 'scratch'
    modeled_transactions: Optional[int] = None
    floor_transactions: Optional[int] = None

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready view."""
        return {
            "region": self.region,
            "space": self.space,
            "status": self.status,
            "modeled_transactions": self.modeled_transactions,
            "floor_transactions": self.floor_transactions,
        }


@dataclasses.dataclass(frozen=True)
class LintReport:
    """The static verdict for one KernelSpec."""

    kernel: str
    grid: Tuple[int, ...]
    sampler: str
    findings: Tuple[LintFinding, ...]
    operands: Tuple[OperandVerdict, ...]
    static_transactions: Optional[int]  # None when any hbm operand is dynamic

    @property
    def errors(self) -> Tuple[LintFinding, ...]:
        """Findings at level ``error`` (gate the exit code)."""
        return tuple(f for f in self.findings if f.level == "error")

    @property
    def warnings(self) -> Tuple[LintFinding, ...]:
        """Findings at level ``warning``."""
        return tuple(f for f in self.findings if f.level == "warning")

    def verdict(self) -> str:
        """'error' | 'dirty' (warnings only) | 'clean'."""
        if self.errors:
            return "error"
        return "dirty" if self.findings else "clean"

    def patterns(self) -> Tuple[str, ...]:
        """Distinct predicted pattern classes, stable order."""
        seen: List[str] = []
        for f in self.findings:
            if f.pattern not in seen:
                seen.append(f.pattern)
        return tuple(seen)

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready view (the per-report unit of the lint JSON doc)."""
        return {
            "kernel": self.kernel,
            "grid": list(self.grid),
            "sampler": self.sampler,
            "verdict": self.verdict(),
            "static_transactions": self.static_transactions,
            "findings": [f.as_dict() for f in self.findings],
            "operands": [o.as_dict() for o in self.operands],
        }

    def summary(self) -> str:
        """Human-readable lint table for one spec."""
        lines = [f"== lint: {self.kernel} (grid {self.grid}, {self.sampler}) =="]
        tx = (
            f"{self.static_transactions}"
            if self.static_transactions is not None
            else "n/a (dynamic operands)"
        )
        lines.append(f"  modeled transfers: {tx}")
        for ov in self.operands:
            bound = (
                f"{ov.modeled_transactions} (floor {ov.floor_transactions})"
                if ov.modeled_transactions is not None
                else "-"
            )
            lines.append(
                f"  {ov.region:<16} {ov.space:<12} {ov.status:<9} {bound}"
            )
        for f in self.findings:
            lines.append(
                f"  [{f.level}] {f.pattern} @ {f.region} "
                f"(severity {f.severity:.2f}, rule {f.rule})"
            )
            lines.append(f"      {f.evidence[0]}")
        lines.append(f"  verdict: {self.verdict()}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# exact static-transfer replay (the collector's arithmetic, no TraceBuffer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Walk:
    """One static operand's collector-replay footprint."""

    keys: np.ndarray  # (U, k) unique block keys
    counts: np.ndarray  # programs per key
    tag_sets: Tuple[np.ndarray, ...]  # unique sector tags per key

    @property
    def transactions(self) -> int:
        """Exact modeled transfer total (count * distinct sectors per key)."""
        return int(
            sum(
                int(c) * len(t)
                for c, t in zip(self.counts.tolist(), self.tag_sets)
            )
        )

    @property
    def touched_tags(self) -> np.ndarray:
        """Union of all touched sector tags."""
        if not self.tag_sets:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(self.tag_sets))


def _walk_operand(op: OperandSpec, pids: np.ndarray) -> _Walk:
    """Replay the collector's static walk for one operand (no buffer)."""
    sel = pids[:1] if op.once else pids
    keys = _eval_index_map_batch(op.index_map, sel)
    ukeys, inverse = np.unique(keys, axis=0, return_inverse=True)
    counts = np.bincount(inverse, minlength=len(ukeys))
    geom = op.geometry
    tag_sets = []
    for g in range(len(ukeys)):
        tags, _ = _touch_arrays_for_key(op, geom, tuple(int(x) for x in ukeys[g]))
        tag_sets.append(np.unique(tags))
    return _Walk(keys=ukeys, counts=counts, tag_sets=tuple(tag_sets))


def static_transactions(
    spec: KernelSpec, sampler: Optional[GridSampler] = None
) -> Optional[int]:
    """Exact modeled HBM transfer total for a spec, or None if dynamic.

    Replays ``collector.collect``'s static walk arithmetic — same
    vectorized index-map evaluation, same geometry clipping, same
    ``once`` handling — so for specs whose HBM operands are all static
    the result equals the traced heat map's transaction total exactly.
    Specs with any dynamically-walked HBM operand return None: the
    static view cannot price a data-dependent gather.
    """
    dynamic_names = {name for name, _ in spec.dynamic}
    for op in spec.operands:
        if op.space == "hbm" and op.name in dynamic_names:
            return None
    pids = sampled_grid_array(spec.grid, sampler or GridSampler())
    if pids.shape[0] == 0:
        return 0
    total = 0
    for op in spec.operands:
        if op.space != "hbm" or op.name in dynamic_names:
            continue
        total += _walk_operand(op, pids).transactions
    return total


# ---------------------------------------------------------------------------
# geometric helpers
# ---------------------------------------------------------------------------

#: Bytes of one H100 sector and of one of its words.
_SECTOR, _WORD = 32, 4


def _tpu(op) -> bool:
    """True when the operand is laid out in the JAX package's TPU tiles."""
    return op.geometry_kind == TPUTile.kind


def _row_run_bytes(op: OperandSpec, h: int, w: int) -> int:
    """Contiguous bytes of one row of an (h, w) block in flat row-major
    memory: the whole block when it spans full rows."""
    cols = op.geometry.shape2d[1]
    isz = int(np.dtype(op.dtype).itemsize)
    return (h * cols if w >= cols else w) * isz


def _byte_delta(op: OperandSpec, ext0, ext1) -> int:
    """Flat byte distance between the start corners of two block extents."""
    cols = op.geometry.shape2d[1]
    isz = int(np.dtype(op.dtype).itemsize)
    return abs((ext1[0] - ext0[0]) * cols + (ext1[2] - ext0[2])) * isz


def _block_extent(
    op: OperandSpec, key: Sequence[int]
) -> Optional[Tuple[int, int, int, int]]:
    """Unclipped (r0, r1, c0, c1) extent of one block key, origin applied.

    Under ``TPUTile`` 1-D operands are mapped to their (row, lane) layout
    (element i lives at row i // 128); under ``H100Sector`` a 1-D operand
    is one row.  Returns None when the leading block layout is not
    contiguous (the collector enumerates those per-element).
    """
    if len(op.shape) == 1:
        b = int(op.block_shape[-1])
        start = int(key[0]) * b + op.origin[1]
        if not _tpu(op):
            return (0, 1, start, start + b)
        r0, r1 = start // LANES, (start + b - 1) // LANES + 1
        return (r0, r1, 0, LANES)
    try:
        r0, r1, c0, c1 = block_to_2d(op.shape, key, op.block_shape)
    except ValueError:
        return None
    orow, ocol = op.origin
    return (r0 + orow, r1 + orow, c0 + ocol, c1 + ocol)


def _origin_in_bounds(op: OperandSpec, key: Sequence[int]) -> bool:
    """True iff the block's start corner lies inside the array."""
    if len(op.shape) == 1:
        n = int(op.shape[0])
        start = int(key[0]) * int(op.block_shape[-1]) + op.origin[1]
        return 0 <= start < max(1, n)
    ext = _block_extent(op, key)
    if ext is None:
        return True
    r0, _, c0, _ = ext
    rows, cols = op.geometry.shape2d
    return 0 <= r0 < rows and 0 <= c0 < cols


def _zero_axes(model: AffineModel, grid: Tuple[int, ...]) -> List[int]:
    """Grid axes that never move any output component of the model."""
    return [
        a
        for a in range(len(grid))
        if grid[a] > 1 and all(row[a] == 0 for row in model.coeffs)
    ]


# ---------------------------------------------------------------------------
# rule engine
# ---------------------------------------------------------------------------


def _rule_oob_and_dead(
    op: OperandSpec, walk: _Walk, kernel: str
) -> List[LintFinding]:
    """Error-level checks: out-of-bounds block origins, dead operands."""
    out: List[LintFinding] = []
    oob = [
        tuple(int(x) for x in k)
        for k in walk.keys
        if not _origin_in_bounds(op, tuple(int(x) for x in k))
    ]
    if oob:
        out.append(
            LintFinding(
                pattern=OUT_OF_BOUNDS,
                region=op.name,
                kernel=kernel,
                severity=min(1.0, len(oob) / max(1, len(walk.keys))),
                evidence=(
                    f"{len(oob)}/{len(walk.keys)} block origins fall outside "
                    f"the {op.shape} array (first: {oob[0]}); the walker "
                    "clips them to nothing — the index_map or origin is wrong",
                ),
                rule="oob-origin",
                level="error",
                details=(("oob_keys", float(len(oob))),),
            )
        )
    if walk.tag_sets and all(len(t) == 0 for t in walk.tag_sets):
        out.append(
            LintFinding(
                pattern=DEAD_OPERAND,
                region=op.name,
                kernel=kernel,
                severity=1.0,
                evidence=(
                    f"no sampled program touches any sector of {op.name}: "
                    "every block clips to an empty footprint",
                ),
                rule="dead-operand",
                level="error",
            )
        )
    return out


def _rule_misaligned_origin(
    op: OperandSpec, kernel: str
) -> Optional[LintFinding]:
    """Origins off the (sublane, lane) tile, or under ``H100Sector`` off a
    32 B sector boundary: every block straddles (Fig. 7)."""
    if not _tpu(op):
        return _rule_misaligned_origin_sector(op, kernel)
    geom = op.geometry
    if len(op.shape) == 1:
        off = op.origin[1] % LANES
        if off == 0:
            return None
        block = int(op.block_shape[-1])
        ideal = max(1.0, block / LANES)
        overhead = min(1.0, 1.0 / ideal)
        return LintFinding(
            pattern=MISALIGNMENT,
            region=op.name,
            kernel=kernel,
            severity=min(1.0, max(overhead, 0.25)),
            evidence=(
                f"origin offset {op.origin[1]} is {off} elements past a "
                f"(1,{LANES}) word boundary: every {block}-element run "
                "straddles one extra word per block",
                "pad the array (or shift the view) to the tile, or duplicate "
                "boundary words (the paper's zigzag fix)",
            ),
            rule="misaligned-origin",
            details=(("overhead", overhead), ("origin_offset", float(off))),
        )
    orow, ocol = op.origin
    mis_r = orow % geom.sublanes
    mis_c = ocol % LANES
    if mis_r == 0 and mis_c == 0:
        return None
    h = int(op.block_shape[-2]) if len(op.block_shape) >= 2 else 1
    overhead = min(1.0, geom.sublanes / max(1, h)) if mis_r else min(
        1.0, LANES / max(1, int(op.block_shape[-1]))
    )
    return LintFinding(
        pattern=MISALIGNMENT,
        region=op.name,
        kernel=kernel,
        severity=min(1.0, max(overhead, 0.25)),
        evidence=(
            f"origin {op.origin} is off the ({geom.sublanes},{LANES}) tile "
            f"by ({mis_r},{mis_c}): every block straddles a tile boundary",
            "pad the array or shift the block origin to the tile",
        ),
        rule="misaligned-origin",
        details=(("overhead", overhead),),
    )


def _rule_misaligned_origin_sector(
    op: OperandSpec, kernel: str
) -> Optional[LintFinding]:
    """``misaligned-origin`` in sectors: the origin's byte offset is not a
    multiple of 32, so every block's run straddles one extra sector."""
    cols = op.geometry.shape2d[1]
    isz = int(np.dtype(op.dtype).itemsize)
    orow, ocol = op.origin
    off = ((orow * cols + ocol) * isz) % _SECTOR
    if off == 0:
        return None
    if len(op.shape) == 1:
        run = int(op.block_shape[-1]) * isz
    else:
        h = int(op.block_shape[-2]) if len(op.block_shape) >= 2 else 1
        run = _row_run_bytes(op, h, int(op.block_shape[-1]))
    overhead = min(1.0, _SECTOR / max(1, run))
    return LintFinding(
        pattern=MISALIGNMENT,
        region=op.name,
        kernel=kernel,
        severity=min(1.0, max(overhead, 0.25)),
        evidence=(
            f"origin {op.origin} is {off} bytes past a {_SECTOR} B sector "
            f"boundary: every {run}-byte run straddles one extra sector",
            "pad the array (or shift the view) to a sector boundary, or load "
            "boundary pairs with one vector load (the paper's zigzag fix)",
        ),
        rule="misaligned-origin",
        details=(("overhead", overhead), ("origin_offset", float(off))),
    )


def _rule_redundant_fetch(
    op: OperandSpec,
    model: AffineModel,
    grid: Tuple[int, ...],
    n_programs: int,
    kernel: str,
) -> Optional[LintFinding]:
    """Zero-coefficient grid axes re-fetch the identical block (hot).

    Under ``H100Sector`` the same count of warps re-fetches each word of
    the block; :func:`lint_spec` keeps the finding beside a false-sharing
    one (the hot detector reads sharing on words) and drops it where a
    strided finding says most of each sector's words are cold.
    """
    if op.once:
        return None
    axes = _zero_axes(model, grid)
    if not axes:
        return None
    m = 1
    for a in axes:
        m *= grid[a]
    if m < 4:  # matches detect_hot's min_temp
        return None
    return LintFinding(
        pattern=HOT,
        region=op.name,
        kernel=kernel,
        severity=min(1.0, m / max(1, n_programs)),
        evidence=(
            f"grid axes {axes} never move {op.name}'s block key: the same "
            f"block is re-fetched {m}x across the grid",
            "keep the block resident in VMEM (reorder grid / "
            "dimension_semantics) instead of re-fetching"
            if _tpu(op)
            else "stage the block once per thread block in shared memory "
            "and reuse it from there",
        ),
        rule="redundant-fetch",
        details=(("mean_temp", float(m)),),
    )


def _rule_overlap(
    op: OperandSpec,
    model: AffineModel,
    grid: Tuple[int, ...],
    kernel: str,
) -> Optional[LintFinding]:
    """Adjacent programs inside one sector row band: false sharing."""
    if len(op.shape) == 1 or op.once:
        return None
    if not _tpu(op):
        return _rule_overlap_sector(op, model, grid, kernel)
    geom = op.geometry
    sub = geom.sublanes
    zero = (0,) * len(grid)
    ext0 = _block_extent(op, model.predict(zero))
    if ext0 is None:
        return None
    h = ext0[1] - ext0[0]
    if h >= sub:
        return None
    best_ratio = 0
    best_axis = -1
    for a in range(len(grid)):
        if grid[a] < 2:
            continue
        probe = [0] * len(grid)
        probe[a] = 1
        ext_a = _block_extent(op, model.predict(probe))
        if ext_a is None:
            continue
        delta = abs(ext_a[0] - ext0[0])
        if delta == 0 or delta >= sub or h > delta:
            continue
        ratio = sub // delta
        if ratio >= 2 and ratio > best_ratio:
            best_ratio, best_axis = ratio, a
    if best_ratio < 2:
        return None
    return LintFinding(
        pattern=FALSE_SHARING,
        region=op.name,
        kernel=kernel,
        severity=1.0 - 1.0 / best_ratio,
        evidence=(
            f"adjacent programs along grid axis {best_axis} advance "
            f"{op.name}'s block by {sub // best_ratio} row(s) inside one "
            f"{sub}-sublane sector: ~{best_ratio} programs own distinct "
            "words of each tile -> one transfer per program where 1 would do",
            "swap grid axes / re-tile so one program covers whole tiles",
        ),
        rule="overlap-false-sharing",
        details=(("mean_ratio", float(best_ratio)),),
    )


def _rule_overlap_sector(
    op: OperandSpec,
    model: AffineModel,
    grid: Tuple[int, ...],
    kernel: str,
) -> Optional[LintFinding]:
    """``overlap-false-sharing`` in sectors: a block's row run is shorter
    than a sector, and the block of the next program along some grid axis
    starts one or more words (but less than a sector) further on without
    overlapping it, so ~32 B / delta warps own distinct words of each
    sector (the paper's Fig. 6 b, lanes on rows)."""
    zero = (0,) * len(grid)
    ext0 = _block_extent(op, model.predict(zero))
    if ext0 is None:
        return None
    run = _row_run_bytes(op, ext0[1] - ext0[0], ext0[3] - ext0[2])
    if run >= _SECTOR:
        return None
    best_ratio, best_axis, best_delta = 0, -1, 0
    for a in range(len(grid)):
        if grid[a] < 2:
            continue
        probe = [0] * len(grid)
        probe[a] = 1
        ext_a = _block_extent(op, model.predict(probe))
        if ext_a is None:
            continue
        delta = _byte_delta(op, ext0, ext_a)
        if delta < _WORD or delta >= _SECTOR or run > delta:
            continue
        ratio = _SECTOR // delta
        if ratio >= 2 and ratio > best_ratio:
            best_ratio, best_axis, best_delta = ratio, a, delta
    if best_ratio < 2:
        return None
    return LintFinding(
        pattern=FALSE_SHARING,
        region=op.name,
        kernel=kernel,
        severity=1.0 - 1.0 / best_ratio,
        evidence=(
            f"adjacent warps along grid axis {best_axis} start {op.name}'s "
            f"{run}-byte block rows {best_delta} bytes apart inside one "
            f"{_SECTOR} B sector: ~{best_ratio} warps own distinct words of "
            "each sector -> one transfer per warp where 1 would do",
            "swap the thread indices so a warp's lanes cover whole sectors",
        ),
        rule="overlap-false-sharing",
        details=(("mean_ratio", float(best_ratio)),),
    )


def _rule_strided(
    op: OperandSpec,
    model: AffineModel,
    grid: Tuple[int, ...],
    kernel: str,
) -> Optional[LintFinding]:
    """Word- or lane-sparse block footprints: strided layout (Fig. 6 d)."""
    if len(op.shape) == 1 or op.once:
        return None
    if not _tpu(op):
        return _rule_strided_sector(op, model, grid, kernel)
    geom = op.geometry
    sub = geom.sublanes
    zero = (0,) * len(grid)
    ext0 = _block_extent(op, model.predict(zero))
    if ext0 is None:
        return None
    r0, r1, c0, c1 = ext0
    h, w = r1 - r0, c1 - c0
    # (a) word-sparse: short blocks jumping >= a whole sector per step —
    # one warm word per fetched tile, the rest dead
    if h * 4 <= sub:
        for a in range(len(grid)):
            if grid[a] < 2:
                continue
            probe = [0] * len(grid)
            probe[a] = 1
            ext_a = _block_extent(op, model.predict(probe))
            if ext_a is None:
                continue
            delta = abs(ext_a[0] - r0)
            if delta >= sub:
                waste = 1.0 - h / sub
                return LintFinding(
                    pattern=STRIDED,
                    region=op.name,
                    kernel=kernel,
                    severity=min(1.0, waste),
                    evidence=(
                        f"{op.name} blocks are {h} row(s) tall but advance "
                        f"{delta} rows per program along axis {a}: only "
                        f"{h}/{sub} words of each fetched tile are used",
                        "transpose the layout so the strided axis becomes "
                        "the minor (lane) dim, or gather once into scratch",
                    ),
                    rule="word-sparse-stride",
                    details=(
                        ("waste", waste),
                        ("word_offset", float(r0 % sub)),
                        ("stride", float(delta)),
                    ),
                )
    # (b) lane-minor: tall, narrow column reads drag whole (sub, 128)
    # tiles for a sliver of lanes
    if w * 4 <= LANES and h >= 2 * sub and geom.shape2d[1] > w:
        waste = 1.0 - w / LANES
        return LintFinding(
            pattern=STRIDED,
            region=op.name,
            kernel=kernel,
            severity=min(1.0, waste),
            evidence=(
                f"{op.name} blocks are {w} lane(s) wide over {h} rows: "
                f"each fetched ({sub},{LANES}) tile carries {w}/{LANES} "
                "useful lanes",
                "transpose the layout so the walked axis becomes the minor "
                "(lane) dim (the paper's kernel3 qT fix)",
            ),
            rule="lane-minor-stride",
            details=(
                ("waste", waste),
                ("word_offset", float(c0 % LANES)),
            ),
        )
    return None


def _rule_strided_sector(
    op: OperandSpec,
    model: AffineModel,
    grid: Tuple[int, ...],
    kernel: str,
) -> Optional[LintFinding]:
    """``word-sparse-stride`` in sectors: a block of at least four rows
    whose row runs cover at most a quarter of a sector's words, one row a
    sector apart or more, so most of each fetched sector is dead.

    ``lane-minor-stride`` stays silent under ``H100Sector``: it prices a
    narrow column read against the 128 lanes of a TPU tile row, and a
    sector has no lanes.  A tall narrow column over flat sectors is the
    word-sparse case above, which already says it.
    """
    ext0 = _block_extent(op, model.predict((0,) * len(grid)))
    if ext0 is None:
        return None
    r0, r1, c0, c1 = ext0
    h = r1 - r0
    cols = op.geometry.shape2d[1]
    isz = int(np.dtype(op.dtype).itemsize)
    run = _row_run_bytes(op, h, c1 - c0)
    if h < 4 or run * 4 > _SECTOR or cols * isz < _SECTOR:
        return None
    used = max(1, -(-run // _WORD))
    waste = 1.0 - used / (_SECTOR // _WORD)
    return LintFinding(
        pattern=STRIDED,
        region=op.name,
        kernel=kernel,
        severity=min(1.0, waste),
        evidence=(
            f"{op.name} blocks are {h} rows of {run} bytes, rows "
            f"{cols * isz} bytes apart: only {used}/{_SECTOR // _WORD} words "
            "of each fetched sector are used",
            "transpose the layout so the walked axis is contiguous, or stage "
            "the column once in shared memory",
        ),
        rule="word-sparse-stride",
        details=(
            ("waste", waste),
            ("word_offset", float((c0 * isz % _SECTOR) // _WORD)),
            ("stride", float(cols * isz)),
        ),
    )


def _rule_coverage_gap(
    op: OperandSpec, walk: _Walk, kernel: str
) -> Optional[LintFinding]:
    """Grid leaves a chunk of the operand's sectors unreachable."""
    if op.once:
        return None
    geom = op.geometry
    touched = len(walk.touched_tags)
    total = geom.n_sectors
    if total <= 1 or touched == 0:
        return None
    gap = 1.0 - touched / total
    if gap <= 1.0 / 8.0:
        return None
    return LintFinding(
        pattern=COVERAGE_GAP,
        region=op.name,
        kernel=kernel,
        severity=min(1.0, gap),
        evidence=(
            f"the grid reaches {touched}/{total} sectors of {op.name}: "
            f"{100 * gap:.0f}% of the array is never touched by any "
            "program (static-only check; a trace cannot show this)",
        ),
        rule="coverage-gap",
        details=(("gap", gap),),
    )


def _rule_scratch_local(
    sc: ScratchSpec, pids: np.ndarray, kernel: str
) -> Optional[LintFinding]:
    """Scratch whose access model gives every program a disjoint word set."""
    if sc.access_model is None:
        return None  # whole-buffer: genuinely shared by every program
    geom = sc.geometry
    n_programs = int(pids.shape[0])
    if n_programs < 2:
        return None
    per_prog = 0
    parts: List[np.ndarray] = []
    for i in range(n_programs):
        pid = tuple(int(x) for x in pids[i])
        slices = list(sc.access_model(pid))
        chunks = [
            geom.slice_to_touch_arrays(r0, r1, c0, c1)
            for r0, r1, c0, c1 in slices
        ]
        if chunks:
            tags = np.concatenate([t for t, _ in chunks])
            words = np.concatenate([w for _, w in chunks])
            uniq = np.unique(tags * geom.words_per_sector + words)
        else:
            uniq = np.empty(0, dtype=np.int64)
        per_prog += len(uniq)
        parts.append(uniq)
    union = np.unique(np.concatenate(parts)) if parts else np.empty(0)
    if len(union) == 0 or per_prog != len(union):
        return None  # some word is shared between programs: not abuse
    return LintFinding(
        pattern=SCRATCH_ABUSE,
        region=sc.name,
        kernel=kernel,
        severity=1.0,
        evidence=(
            f"all {n_programs} programs' access-model word sets on "
            f"{sc.name} are pairwise disjoint: the data is program-local "
            "and buys nothing from shared scratch",
            "keep the value in a VREG accumulator (fuse the reduction) and "
            "drop the scratch allocation"
            if _tpu(sc)
            else "keep the value in a register accumulator and drop the "
            "shared-memory buffer and its barriers",
        ),
        rule="scratch-local",
        details=(("local_fraction", 1.0),),
    )


# ---------------------------------------------------------------------------
# the linter
# ---------------------------------------------------------------------------


def lint_spec(
    spec: KernelSpec,
    sampler: Optional[GridSampler] = None,
    kernel: Optional[str] = None,
) -> LintReport:
    """Statically lint one KernelSpec: affine probe + rule engine.

    Collects zero traces.  Dynamic operands get a ``dynamic`` verdict
    and no findings — the static view cannot see data-dependent
    gathers; a ``nonaffine`` verdict means the affine probe failed but
    the exact (per-key) replay still priced the operand.
    """
    sampler = sampler or GridSampler()
    name = kernel or spec.name
    grid = tuple(int(g) for g in spec.grid)
    pids = sampled_grid_array(grid, sampler)
    n_programs = int(pids.shape[0])
    dynamic_names = {n for n, _ in spec.dynamic}

    findings: List[LintFinding] = []
    verdicts: List[OperandVerdict] = []
    total: Optional[int] = 0

    for op in spec.operands:
        if op.name in dynamic_names:
            verdicts.append(
                OperandVerdict(region=op.name, space=op.space, status="dynamic")
            )
            if op.space == "hbm":
                total = None
            continue
        walk = _walk_operand(op, pids)
        model = probe_affine_map(op.index_map, grid)
        verdicts.append(
            OperandVerdict(
                region=op.name,
                space=op.space,
                status="affine" if model is not None else "nonaffine",
                modeled_transactions=walk.transactions,
                floor_transactions=len(walk.touched_tags),
            )
        )
        if total is not None and op.space == "hbm":
            total += walk.transactions
        findings.extend(_rule_oob_and_dead(op, walk, name))
        mis = _rule_misaligned_origin(op, name)
        if mis:
            findings.append(mis)
        if model is not None:
            strided = None
            overlap = _rule_overlap(op, model, grid, name)
            if overlap:
                findings.append(overlap)
            else:
                # precedence mirrors patterns.detect_all: false sharing is
                # the more specific diagnosis — its heat signature subsumes
                # the strided one, so don't report both for one region
                strided = _rule_strided(op, model, grid, name)
                if strided:
                    findings.append(strided)
            hot = _rule_redundant_fetch(op, model, grid, n_programs, name)
            # under H100Sector hot means a sector whose warm words are each
            # shared by the warps that re-fetch them (patterns.detect_hot):
            # a falsely shared block re-fetched m times is hot beside its
            # false sharing, and a word-sparse one is strided, not hot
            if hot and (_tpu(op) or not strided):
                findings.append(hot)
        gap = _rule_coverage_gap(op, walk, name)
        if gap:
            findings.append(gap)

    for sc in spec.scratch:
        verdicts.append(
            OperandVerdict(region=sc.name, space="vmem_scratch", status="scratch")
        )
        f = _rule_scratch_local(sc, pids, name)
        if f:
            findings.append(f)

    findings.sort(key=lambda f: (f.level != "error", -f.severity, f.region))
    return LintReport(
        kernel=name,
        grid=grid,
        sampler=sampler.describe(),
        findings=tuple(findings),
        operands=tuple(verdicts),
        static_transactions=total,
    )


def lint_ref(ref: str) -> LintReport:
    """Lint a registry ``name`` / ``name:variant`` reference.

    Uses the registry entry's own sampler and the canonical
    ``name:variant`` label, same as ``cuthermo profile`` would.
    """
    from repro_torch import kernels as kreg

    entry, variant = kreg.resolve(ref)
    return lint_spec(
        variant.spec(),
        sampler=entry.sampler(),
        kernel=f"{entry.name}:{variant.name}",
    )


# ---------------------------------------------------------------------------
# predicted vs observed (the report bundle's cross-tab)
# ---------------------------------------------------------------------------


def predicted_vs_observed(
    report: LintReport, observed: Iterable[PatternReport]
) -> List[Dict[str, object]]:
    """Cross-tabulate lint predictions against dynamic detections.

    Rows are (pattern, region) pairs from either side, with a status of
    ``agree`` (both saw it), ``static-only`` (lint-only — either a
    purely-static check or a prediction the trace did not confirm) or
    ``dynamic-only`` (the trace saw what the static view cannot, e.g.
    data-dependent gathers).
    """
    pred = {(f.pattern, f.region): f for f in report.findings}
    obs = {(r.pattern, r.region): r for r in observed}
    rows: List[Dict[str, object]] = []
    for key in sorted(set(pred) | set(obs)):
        pattern, region = key
        in_p, in_o = key in pred, key in obs
        status = "agree" if in_p and in_o else (
            "static-only" if in_p else "dynamic-only"
        )
        rows.append(
            {
                "pattern": pattern,
                "region": region,
                "status": status,
                "predicted_severity": pred[key].severity if in_p else None,
                "observed_severity": obs[key].severity if in_o else None,
                "rule": pred[key].rule if in_p else None,
            }
        )
    return rows


def lint_document(
    reports: Sequence[LintReport], strict: bool = False
) -> Dict[str, object]:
    """The versioned ``cuthermo lint --json`` document for N reports."""
    failures: List[str] = []
    for rep in reports:
        for f in rep.errors:
            failures.append(f"{rep.kernel}: [{f.rule}] {f.evidence[0]}")
        if strict:
            for f in rep.warnings:
                failures.append(
                    f"{rep.kernel}: [{f.rule}] {f.pattern} @ {f.region}"
                )
    return {
        "format": LINT_FORMAT,
        "schema_version": LINT_SCHEMA_VERSION,
        "strict": strict,
        "passed": not failures,
        "failures": failures,
        "reports": [rep.as_dict() for rep in reports],
    }


__all__ = [
    "COVERAGE_GAP",
    "DEAD_OPERAND",
    "LINT_FORMAT",
    "LINT_SCHEMA_VERSION",
    "LintError",
    "LintFinding",
    "LintReport",
    "OUT_OF_BOUNDS",
    "OperandVerdict",
    "STATIC_ONLY_PATTERNS",
    "lint_document",
    "lint_ref",
    "lint_spec",
    "predicted_vs_observed",
    "static_transactions",
]
