"""Advisor-driven autotuning: the paper's Fig. 2 loop, closed end to end.

CUTHERMO's workflow is profile -> read the heat map -> optimize ->
re-profile, and its headline speedups come from *walking* that loop.
Everything before this module automates the reading (patterns), the
advice (:mod:`repro_torch.core.advisor` Actions) and the bookkeeping
(:mod:`repro_torch.core.session`); the human still had to perform the
"optimize" step.  The tuner performs it:

1. **Map actions to candidates.**  Every advisor :class:`~.advisor.Action`
   is expanded into concrete :class:`Candidate` variants — the kernel
   registry's hand-written ladder steps (``gemm:v01``, ``spmv:zigzag``,
   ...) plus *generated* parametric candidates synthesized by structural
   surgery on the baseline :class:`~.collector.KernelSpec` (re-tile the
   block/grid, pin a hot operand, align a misaligned view, transpose a
   strided layout, drop an abused scratch buffer).  Each move reads the
   operand's geometry; a move with no meaning for ``H100Sector``'s flat
   sectors proposes nothing, and the run's summary says so.
2. **Re-profile.**  Candidates are profiled through the same
   :func:`~.session.profile_kernel` assembly point every other entry
   point uses, so their heat maps are exactly comparable to the
   baseline's.  The baseline and every ladder rung whose registry variant
   has a kernel also launch that kernel on ``device``, checked against
   its plain version (:func:`repro_torch.kernels.run_variant`, exactly as
   ``cuthermo profile`` does), and the record is the iteration's ``run``.
   A generated candidate is spec surgery with no kernel, so it has no run.
   A rung whose kernel fails to build, launch or agree fails the run.
3. **Rank and iterate.**  Each candidate is diffed against the current
   best (the heat-map transaction model + :attr:`HeatmapDiff.verdict`,
   with profile wall time as the tie-break); improvements become the new
   best, their advisor actions spawn the next round of candidates, and
   the loop runs until no inefficiency patterns remain or the candidate
   budget is exhausted.  A kernel's time on the card is recorded, never
   ranked on.

Every step is persisted as a session iteration whose manifest records
which Action spawned which candidate (the JAX package's ``tuning``
block, see ``docs/file-format.md``), so the whole trajectory is
auditable and re-renderable later.  ``cuthermo tune`` is the CLI front
end.  :func:`tune_all` tunes many families at once: the scheduler
thread runs each round's kernels on the card one after another, then
their walks overlap on a thread pool over one shared shard pool.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.fault import Preempted

from .advisor import Action
from .cache import CollectionCache
from .collector import KernelSpec, OperandSpec, ShardedCollector
from .diff import HeatmapDiff, diff as diff_heatmaps
from .heatmap import Heatmap
from .lint import static_transactions
from .resilience import FaultEvent
from .session import (
    ProfiledKernel,
    ProfileSession,
    _effective_region_map,
    profile_kernel,
)
from .tiles import TPUTile
from .trace import GridSampler

#: Looks up a kernel family by name: ``repro_torch.kernels.get`` unless a
#: test passes another source of rungs (see :func:`ladder_candidates`).
Rungs = Callable[[str], object]

#: Default number of candidate re-profiles one ``tune`` call may spend.
DEFAULT_BUDGET = 8

#: Maximum parametric retile factors generated per retile action.
_RETILE_FACTORS = 2

#: VMEM capacity budget for generated pin candidates under ``TPUTile``.
#: Pinning models keeping an operand resident for the kernel's lifetime,
#: so the sum of pinned operand bytes must fit what a TPU core can
#: realistically hold alongside the working blocks (~16 MiB of VMEM).
VMEM_PIN_BUDGET_BYTES = 16 << 20

#: The pin budget under ``H100Sector`` on a host without a card: the
#: shared memory one block of an H100 may opt in to (227 KiB), the limit
#: the kernels' own wrappers hold (``kernels/ssd.py:MAX_SMEM``).
SMEM_PIN_DEFAULT_BYTES = 232_448


def pin_budget_bytes(geometry_kind: str) -> int:
    """What a pinned operand set may hold, by the operand's geometry.

    ``TPUTile``: :data:`VMEM_PIN_BUDGET_BYTES`.  ``H100Sector``: a pinned
    operand is staged in one block's shared memory, so the budget is the
    per-block opt-in limit of card 0 (``torch.cuda.get_device_properties``)
    when a card is present, else :data:`SMEM_PIN_DEFAULT_BYTES`.
    """
    if geometry_kind == TPUTile.kind:
        return VMEM_PIN_BUDGET_BYTES
    import torch

    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return int(props.shared_memory_per_block_optin)
    return SMEM_PIN_DEFAULT_BYTES


class TuneError(RuntimeError):
    """Raised for unusable tuning inputs (unknown kernel, empty ladder)."""


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One concrete optimization the tuner can profile.

    A candidate is either a registry *ladder* step (``source='ladder'``,
    rebuilt by reference from the family's registry entry) or a
    *generated* variant
    (``source='generated'``): a structural transformation of the parent
    spec synthesized from the advisor action that spawned it.
    """

    label: str  # unique within one tuning run, e.g. 'ladder:v01'
    source: str  # 'ladder' | 'generated'
    action: Optional[Action]  # the advisor action that spawned it
    build: Callable[[], Tuple[KernelSpec, Optional[Dict[str, np.ndarray]]]]
    ref: Optional[str] = None  # registry ref for ladder candidates
    variant: str = ""  # registry variant name (ladder) or transform tag
    predicted_saving: float = 0.0  # the spawning action's estimate
    order: int = 0  # ladder position (ladder steps are tried in order)
    region_map: Tuple[Tuple[str, str], ...] = ()  # renames this step makes
    params: Tuple[Tuple[str, str], ...] = ()  # generation parameters

    def provenance(self) -> dict:
        """JSON-ready provenance (persisted into iteration manifests)."""
        return {
            "label": self.label,
            "source": self.source,
            "ref": self.ref,
            "variant": self.variant,
            "predicted_saving": self.predicted_saving,
            "params": {k: v for k, v in self.params},
            "region_map": {old: new for old, new in self.region_map},
            "action": self.action.as_dict() if self.action else None,
        }


# ---------------------------------------------------------------------------
# generated candidates: structural surgery on a KernelSpec
# ---------------------------------------------------------------------------


def _normalize(idx) -> Tuple:
    return idx if isinstance(idx, tuple) else (idx,)


def _classify_axis(
    index_map, grid: Tuple[int, ...], axis: int
) -> Optional[List[str]]:
    """Classify each index-map output component against one grid axis.

    Returns one of ``'identity'`` (component equals the axis coordinate)
    or ``'constant'`` (component ignores the axis) per output component,
    or ``None`` when the map does anything else — strides, offsets,
    piecewise arithmetic — in which case the caller must skip structural
    transforms along this axis.  The certification is exhaustive: every
    coordinate of the axis is evaluated (vectorized when the map
    broadcasts, validated against scalar evaluation at the endpoints,
    exactly like the collector's batch walker), so a map that only
    *looks* identity on a prefix cannot slip through.
    """
    n = int(grid[axis])
    if n < 2:
        return None
    ndim = len(grid)

    def at(k: int) -> Optional[Tuple[int, ...]]:
        pid = [0] * ndim
        pid[axis] = k
        try:
            return tuple(int(v) for v in _normalize(index_map(*pid)))
        except Exception:
            return None

    first, last = at(0), at(n - 1)
    if first is None or last is None or len(first) != len(last):
        return None
    ks = np.arange(n, dtype=np.int64)
    cols: Optional[List[np.ndarray]] = None
    try:
        args = [ks if d == axis else np.zeros(n, np.int64) for d in range(ndim)]
        out = _normalize(index_map(*args))
        if len(out) == len(first):
            vec = [
                np.broadcast_to(np.asarray(o, dtype=np.int64), (n,))
                for o in out
            ]
            if (
                tuple(int(v[0]) for v in vec) == first
                and tuple(int(v[-1]) for v in vec) == last
            ):
                cols = vec
    except Exception:
        cols = None
    if cols is None:  # map does not broadcast: exhaustive scalar walk
        rows = [at(k) for k in range(n)]
        if any(r is None or len(r) != len(first) for r in rows):
            return None
        cols = [
            np.asarray([r[c] for r in rows], dtype=np.int64)
            for c in range(len(first))
        ]
    roles: List[str] = []
    for col in cols:
        if np.all(col == col[0]):
            roles.append("constant")
        elif np.array_equal(col, ks):
            roles.append("identity")
        else:
            return None
    return roles


def _coarsen_map(index_map, axis: int, factor: int, divide: frozenset):
    """Wrap an index map for a grid whose ``axis`` was coarsened by ``factor``.

    The wrapped map evaluates the original at the fine-grid coordinate
    and divides the identity components (whose block widened by
    ``factor``) back down to the coarse block index.  Works on scalars
    and numpy arrays alike, so the collector's vectorized evaluation
    path still applies.
    """
    def wrapped(*pid):
        fine = list(pid)
        fine[axis] = fine[axis] * factor
        out = _normalize(index_map(*fine))
        return tuple(
            o // factor if c in divide else o for c, o in enumerate(out)
        )

    return wrapped


def retile_spec(
    spec: KernelSpec, region: str, factor: int
) -> Optional[KernelSpec]:
    """Coarsen the grid so one program owns ``factor`` x more sublanes.

    The false-sharing fix (paper §VI-A): when each grid program along one
    axis owns a different sublane slice of ``region``'s tiles, merging
    ``factor`` consecutive programs into one (grid axis divided, block
    sublane dim multiplied) makes one program cover whole tiles.  Exact
    only when every operand's index map is *identity or constant* along
    the chosen axis — anything else returns ``None`` instead of guessing.
    Restricted to 1-D grids: the per-axis probe cannot certify cross-axis
    arithmetic (``i+j``, ``i*j``), and the false-sharing ladder lives on
    1-D grids anyway.

    Under ``H100Sector`` there is no sublane dimension: a sector is 32 B
    of the region's flat row-major bytes, and which of its words a warp
    owns is set by the warp's lanes, not by its block's rows.  The sector
    fix is the thread-index swap the registry's ladder carries (gemm v00
    -> v01), so this move proposes nothing there (``None``).
    """
    target = next((o for o in spec.operands if o.name == region), None)
    if target is None or len(target.block_shape) < 2:
        return None
    if target.geometry_kind != TPUTile.kind:
        return None
    if len(spec.grid) != 1:
        return None  # cross-axis index arithmetic cannot be certified
    if spec.dynamic or any(sc.access_model for sc in spec.scratch):
        return None  # pid-keyed access models do not survive re-gridding
    sub_comp = len(target.block_shape) - 2  # the sublane dimension
    axis = None
    for g in range(len(spec.grid)):
        roles = _classify_axis(target.index_map, spec.grid, g)
        if roles and roles[sub_comp] == "identity":
            axis = g
            break
    if axis is None or factor < 2 or spec.grid[axis] % factor != 0:
        return None
    new_ops = []
    for op in spec.operands:
        roles = _classify_axis(op.index_map, spec.grid, axis)
        if roles is None:
            return None
        divide = frozenset(
            c for c, role in enumerate(roles) if role == "identity"
        )
        block = tuple(
            b * factor if c in divide else b
            for c, b in enumerate(op.block_shape)
        )
        new_ops.append(
            dataclasses.replace(
                op,
                block_shape=block,
                index_map=_coarsen_map(op.index_map, axis, factor, divide),
            )
        )
    grid = tuple(
        g // factor if i == axis else g for i, g in enumerate(spec.grid)
    )
    return dataclasses.replace(
        spec,
        name=f"{spec.name}+retile{factor}",
        grid=grid,
        operands=tuple(new_ops),
        source=None,
    )


def _operand_bytes(op: OperandSpec) -> int:
    """Whole-array byte size of one operand."""
    n = 1
    for s in op.shape:
        n *= int(s)
    return n * int(np.dtype(op.dtype).itemsize)


def pin_spec(spec: KernelSpec, region: str) -> Optional[KernelSpec]:
    """Model pinning ``region`` on chip for the kernel's lifetime.

    The hot-spot fix: a heavily re-fetched operand is staged once and
    kept resident (a TPU's VMEM; an H100 block's shared memory).  In the
    transfer model that is an operand fetched by a single program
    (``once=True``); a data-dependent gather on the region is dropped
    with it — the gather now hits on-chip memory.

    Only *loads* are pinnable (a store has to cross back to device
    memory; the
    guarded-single-store fix is the ladder's job), and the pinned bytes
    — this operand plus anything already pinned — must fit the operand
    geometry's :func:`pin_budget_bytes` (VMEM under ``TPUTile``, one
    block's shared memory under ``H100Sector``), so the tuner cannot
    "win" by pinning a working set no real core could hold.
    """
    target = next((o for o in spec.operands if o.name == region), None)
    if target is None or target.once or target.kind != "load":
        return None
    pinned = sum(
        _operand_bytes(o)
        for o in spec.operands
        if o.once and o.space == "hbm"
    )
    if pinned + _operand_bytes(target) > pin_budget_bytes(target.geometry_kind):
        return None
    ops = tuple(
        dataclasses.replace(o, once=True) if o.name == region else o
        for o in spec.operands
    )
    dynamic = tuple((n, fn) for n, fn in spec.dynamic if n != region)
    return dataclasses.replace(
        spec,
        name=f"{spec.name}+pin",
        operands=ops,
        dynamic=dynamic,
        source=None,
    )


def align_spec(spec: KernelSpec, region: str) -> Optional[KernelSpec]:
    """Zero ``region``'s origin offset: the pad/align misalignment fix.

    Models padding the backing array (or shifting the block origin) to
    the native-tile boundary so blocks stop straddling two tiles.  Only
    applicable when the operand actually *has* a non-zero origin (the
    misaligned-view encoding, e.g. SpMV's ``rowOffsets[r+1]``).
    """
    target = next((o for o in spec.operands if o.name == region), None)
    if target is None or tuple(target.origin) == (0, 0):
        return None
    ops = tuple(
        dataclasses.replace(o, origin=(0, 0)) if o.name == region else o
        for o in spec.operands
    )
    return dataclasses.replace(
        spec, name=f"{spec.name}+align", operands=ops, source=None
    )


def drop_scratch_spec(spec: KernelSpec, region: str) -> Optional[KernelSpec]:
    """Delete an abused scratch buffer (program-local data -> registers).

    The scratch-abuse fix: partials parked in user-managed scratch (VMEM,
    or shared memory) that no other program reads belong in register
    accumulators; the fused kernel simply has no scratch allocation (and
    no barriers around it).
    """
    if not any(sc.name == region for sc in spec.scratch):
        return None
    scratch = tuple(sc for sc in spec.scratch if sc.name != region)
    return dataclasses.replace(
        spec, name=f"{spec.name}+noscratch", scratch=scratch, source=None
    )


def transpose_spec(spec: KernelSpec, region: str) -> Optional[KernelSpec]:
    """Transpose a strided 2-D operand so the walk becomes lane-contiguous.

    The strided fix: store the array transposed so the strided axis is
    the minor (lane) dimension — a column block ``(N, 1)`` becomes a row
    block ``(1, N)``.  Falls back to ``None`` for non-2-D or
    data-dependent regions; :func:`pin_spec` covers those (stage the
    strided column once instead).
    """
    target = next((o for o in spec.operands if o.name == region), None)
    dynamic_names = {name for name, _ in spec.dynamic}
    if (
        target is None
        or len(target.shape) != 2
        or region in dynamic_names
    ):
        return None

    def transposed(index_map):
        def wrapped(*pid):
            out = _normalize(index_map(*pid))
            return (out[1], out[0])

        return wrapped

    ops = tuple(
        dataclasses.replace(
            o,
            shape=(o.shape[1], o.shape[0]),
            block_shape=(o.block_shape[1], o.block_shape[0]),
            origin=(o.origin[1], o.origin[0]),
            index_map=transposed(o.index_map),
        )
        if o.name == region
        else o
        for o in spec.operands
    )
    return dataclasses.replace(
        spec, name=f"{spec.name}+transpose", operands=ops, source=None
    )


def _retile_factors(spec: KernelSpec, region: str) -> List[int]:
    """Candidate widening factors for a retile, best (tile-exact) first."""
    target = next((o for o in spec.operands if o.name == region), None)
    if target is None or len(target.block_shape) < 2:
        return []
    if target.geometry_kind != TPUTile.kind:
        return []  # retile_spec says why
    sublanes = target.geometry.sublanes
    cur = int(target.block_shape[-2])
    factors = []
    if cur < sublanes and sublanes % cur == 0:
        factors.append(sublanes // cur)  # reach a whole-tile block
    for f in (4, 2):
        if f not in factors:
            factors.append(f)
    return factors[:_RETILE_FACTORS]


def candidates_for_action(
    action: Action,
    spec: KernelSpec,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
) -> List[Candidate]:
    """Expand one advisor action into generated (spec-surgery) candidates.

    Every ``Action.kind`` maps to at least one transform; transforms that
    do not structurally apply to this spec (no such operand, map too
    exotic to certify) are silently skipped — the registry ladder is the
    fallback for those.  ``dynamic_context`` is the parent spec's seeded
    context; transformed specs keep it (their surviving dynamic walkers
    still need the same index arrays).
    """
    def cand(tag: str, built: Optional[KernelSpec], **params) -> List[Candidate]:
        if built is None:
            return []
        label = f"{tag}({action.region})"
        if params:
            label += ":" + ",".join(f"{k}={v}" for k, v in params.items())
        return [
            Candidate(
                label=label,
                source="generated",
                action=action,
                build=lambda b=built: (b, dynamic_context),
                variant=tag,
                predicted_saving=action.est_transaction_saving,
                params=tuple((k, str(v)) for k, v in params.items()),
            )
        ]

    out: List[Candidate] = []
    if action.kind == "retile":
        for f in _retile_factors(spec, action.region):
            out += cand("retile", retile_spec(spec, action.region, f), factor=f)
        # a layout flip also de-interleaves falsely-shared sublanes; it
        # usually costs more than it saves (the static pre-screen prices
        # it without tracing), but when re-gridding cannot be certified
        # it is the only structural move left
        out += cand("transpose", transpose_spec(spec, action.region))
    elif action.kind in ("vmem_pin", "reorder_grid"):
        out += cand("pin", pin_spec(spec, action.region))
    elif action.kind == "pad_align":
        out += cand("align", align_spec(spec, action.region))
    elif action.kind == "drop_scratch":
        out += cand("drop_scratch", drop_scratch_spec(spec, action.region))
    elif action.kind == "transpose":
        out += cand("transpose", transpose_spec(spec, action.region))
        if not out:  # 1-D / data-dependent layout: stage it once instead
            out += cand("pin", pin_spec(spec, action.region))
    return out


def silent_moves(action: Action, spec: KernelSpec) -> List[str]:
    """The moves ``action`` maps to that propose nothing for want of a
    meaning in the region's geometry: ``retile`` under ``H100Sector``
    (:func:`retile_spec` says why).  The tuner's summary lists them."""
    if action.kind != "retile":
        return []
    target = next((o for o in spec.operands if o.name == action.region), None)
    if target is None or target.geometry_kind == TPUTile.kind:
        return []
    return [f"retile({action.region})"]


def _default_rungs() -> Rungs:
    from repro_torch import kernels as kreg

    return kreg.get


def _resolve(rungs: Rungs, ref: str):
    """(entry, variant) of a ``name`` or ``name:variant`` reference."""
    name, _, variant = ref.partition(":")
    entry = rungs(name)
    return entry, entry.variant(variant or None)


def _build(rungs: Rungs, ref: str):
    """The (spec, dynamic context) of a rung, as ``kernels.build`` makes it.

    A rung of the port's registry is source-stamped (``kernels.build``),
    so a sharded collector rebuilds it in a worker; a rung from another
    source of rungs (the test seam) has no ref a worker could rebuild and
    is sharded in process.
    """
    from repro_torch import kernels as kreg

    if rungs is kreg.get:
        return kreg.build(ref)
    _, variant = _resolve(rungs, ref)
    return variant.spec(), variant.dynamic_context()


def ladder_candidates(
    entry,
    tried_variants: frozenset,
    actions: Sequence[Action],
    min_position: int = 0,
    rungs: Optional[Rungs] = None,
) -> List[Candidate]:
    """Untried registry ladder steps, in the family's published order.

    Ladder candidates are attributed to the highest-saving open action
    (the ladder is the paper's hand-written fix for exactly those
    patterns) and rebuilt by registry reference.  ``min_position``
    drops rungs at or below the one already accepted — the ladder is
    walked forward, never revisited.

    ``rungs`` looks a family up by name; it defaults to the port's
    registry (``repro_torch.kernels.get``).  It is a test seam: the
    tests pass the JAX package's rungs, rebuilt as port specs, to hold
    the tuner to the reference's trajectories.  Nothing on the main path
    passes it.
    """
    rungs = rungs or _default_rungs()
    top = actions[0] if actions else None
    out = []
    for pos, v in entry.ladder(min_position):
        if v.name in tried_variants:
            continue
        ref = f"{entry.name}:{v.name}"
        out.append(
            Candidate(
                label=f"ladder:{v.name}",
                source="ladder",
                action=top,
                build=lambda r=ref: _build(rungs, r),
                ref=ref,
                variant=v.name,
                predicted_saving=(
                    top.est_transaction_saving if top else 0.0
                ),
                order=pos,
                region_map=tuple(entry.region_map),
            )
        )
    return out


# ---------------------------------------------------------------------------
# the tuning loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuneStep:
    """One profiled candidate inside a tuning run."""

    step: int  # 1-based candidate index (0 is the baseline)
    candidate: Candidate
    profiled: ProfiledKernel
    diff: HeatmapDiff  # vs. the best at the time of profiling
    accepted: bool
    iteration: str = ""  # session iteration name, "" when unpersisted

    @property
    def transactions(self) -> int:
        """Modeled device-memory transfers of this candidate's heat map."""
        return self.profiled.transactions

    def as_dict(self) -> dict:
        """JSON-ready view (report bundles, manifests)."""
        return {
            "step": self.step,
            "candidate": self.candidate.provenance(),
            "iteration": self.iteration,
            "transactions": self.transactions,
            "wall_s": self.profiled.wall_s,
            "run": self.profiled.run,
            "verdict": self.diff.verdict,
            "speedup_vs_parent": self.diff.speedup_estimate,
            "fixed": [list(p) for p in self.diff.fixed],
            "introduced": [list(p) for p in self.diff.introduced],
            "accepted": self.accepted,
        }


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """Outcome of one ``tune`` run: trajectory + final verdict."""

    kernel: str  # registry family name
    baseline: ProfiledKernel
    best: ProfiledKernel
    best_label: str  # 'baseline' or the winning candidate label
    steps: Tuple[TuneStep, ...]
    final: HeatmapDiff  # baseline -> best
    converged: bool  # nothing left to try (vs. budget exhausted)
    budget: int
    seed: int
    wall_s: float
    baseline_iteration: str = ""
    # candidates the static pre-screen proved worse and never profiled
    # (see _TuneLoop._prescreen); they consume no budget and no traces
    static_skipped: Tuple[dict, ...] = ()
    # candidate-failure FaultEvents: candidates whose re-profile raised.
    # They are skipped, never re-proposed, and do not abort the run.
    faults: Tuple[FaultEvent, ...] = ()
    # moves an action asked for that have no meaning in the region's
    # geometry and proposed nothing (see silent_moves)
    silent: Tuple[str, ...] = ()

    @property
    def speedup(self) -> float:
        """Modeled transaction speedup of the winning variant."""
        return self.final.speedup_estimate

    @property
    def improved(self) -> bool:
        """True when the best variant strictly reduced modeled transfers."""
        return self.final.tx_after < self.final.tx_before

    @property
    def fixed_patterns(self) -> Tuple[Tuple[str, str], ...]:
        """(region, pattern) pairs the winning variant eliminated."""
        return self.final.fixed

    def ranked(self) -> List[TuneStep]:
        """All tried candidates, best first.

        Rank order is the tuner's selection metric: fewest modeled
        device-memory transactions, then fewest scratch sector touches,
        then measured profile wall time — deterministic for a fixed
        seed because candidate generation and trial order are.
        """
        return sorted(
            self.steps,
            key=lambda s: (
                s.transactions,
                _scratch_transactions(s.profiled.heatmap),
                s.profiled.wall_s,
                s.step,
            ),
        )

    def as_dict(self) -> dict:
        """JSON-ready trajectory summary (report bundles)."""
        return {
            "kernel": self.kernel,
            "budget": self.budget,
            "seed": self.seed,
            "candidates_tried": len(self.steps),
            "baseline": {
                "variant": self.baseline.variant,
                "transactions": self.baseline.transactions,
                "iteration": self.baseline_iteration,
                "run": self.baseline.run,
            },
            "best": {
                "label": self.best_label,
                "variant": self.best.variant,
                "transactions": self.best.transactions,
            },
            "speedup": self.speedup,
            "improved": self.improved,
            "fixed": [list(p) for p in self.fixed_patterns],
            "converged": self.converged,
            "wall_s": self.wall_s,
            "steps": [s.as_dict() for s in self.steps],
            "static_skipped": list(self.static_skipped),
            "faults": [e.as_dict() for e in self.faults],
            "silent": list(self.silent),
        }

    def summary(self) -> str:
        """Multi-line human-readable trajectory (the ``cuthermo tune`` body)."""
        lines = [
            f"== tune: {self.kernel} (budget {self.budget}, "
            f"{len(self.steps)} candidates tried) =="
        ]
        lines.append(
            f"baseline {self.baseline.variant}: "
            f"{self.baseline.transactions} transfers"
        )
        for s in self.steps:
            mark = "accepted" if s.accepted else "rejected"
            fixed = "".join(
                f" [fixed {p} on {r}]" for r, p in s.diff.fixed
            )
            lines.append(
                f"  step {s.step}: {s.candidate.label} -> "
                f"{s.transactions} transfers "
                f"({s.diff.speedup_estimate:.2f}x vs best, "
                f"{s.diff.verdict}){fixed} => {mark}"
            )
        if self.static_skipped:
            labels = ", ".join(s["label"] for s in self.static_skipped)
            lines.append(
                f"  prescreen: {len(self.static_skipped)} candidate(s) "
                f"statically worse, never traced ({labels})"
            )
        if self.faults:
            lines.append(
                f"  faults: {len(self.faults)} candidate profile(s) "
                "failed and were skipped ("
                + "; ".join(e.detail for e in self.faults)
                + ")"
            )
        if self.silent:
            lines.append(
                f"  no sector meaning, nothing proposed: "
                f"{', '.join(self.silent)} (under h100-sector a warp's lanes "
                "set which words of a sector it owns; the ladder carries "
                "that fix)"
            )
        status = "converged" if self.converged else "budget exhausted"
        lines.append(
            f"best: {self.best_label} — {self.final.tx_before} -> "
            f"{self.final.tx_after} transfers ({self.speedup:.2f}x), "
            f"{len(self.fixed_patterns)} patterns fixed ({status})"
        )
        return "\n".join(lines)


def _scratch_transactions(hm: Heatmap) -> int:
    """Sector touches on scratch regions (the secondary objective).

    Scratch never crosses the device-memory boundary, so it is excluded
    from ``sector_transactions`` — but abused scratch still costs space
    and barriers, so between two candidates with equal device-memory
    traffic the tuner prefers the one touching less scratch.
    """
    return int(
        sum(
            int(rh.sector_temps_array.sum())
            for rh in hm.regions
            if rh.region.space == "vmem_scratch"
        )
    )


def _accepts(d: HeatmapDiff, best_hm: Heatmap, cand_hm: Heatmap) -> bool:
    """Decide whether a candidate replaces the current best.

    Strictly fewer modeled device-memory transfers always wins.  Equal transfers
    win only when the candidate eliminates a pattern or reduces scratch
    traffic without introducing anything new — the scratch-abuse fixes
    (register accumulation) land here: same footprint, no scratch,
    pattern gone.
    """
    if d.verdict == "improved":
        return True
    if d.verdict != "unchanged":
        return False
    return bool(d.fixed) or (
        _scratch_transactions(cand_hm) < _scratch_transactions(best_hm)
    )


def _open_actions(
    pk: ProfiledKernel, target_patterns: Optional[Sequence[str]]
) -> List[Action]:
    """The profiled kernel's actions, filtered to the targeted patterns."""
    acts = list(pk.actions)
    if target_patterns:
        wanted = set(target_patterns)
        acts = [a for a in acts if a.pattern in wanted]
    return acts


class _TuneLoop:
    """Stepwise tuning state machine: propose -> profile -> commit.

    Factors the serial :func:`tune` loop into explicit stages so
    :func:`tune_all` can interleave many families under one budget.  The
    loop owns every piece of deterministic state — the seeded
    tie-break jitter, the candidate queue, the ladder floor, the current
    best — and advances it ONLY inside :meth:`commit_baseline` /
    :meth:`commit`, in whatever order the caller invokes them.
    Profiling (the expensive, side-effect-free stage between a propose
    and its commit) is the caller's job, which is exactly what makes it
    safe to run concurrently: a trajectory depends only on the sequence
    of committed results, never on profiling order or timing.  Driving a
    loop propose->profile->commit one trial at a time reproduces the
    serial :func:`tune` trajectory bit for bit.
    """

    def __init__(
        self,
        kernel: str,
        *,
        budget: int = DEFAULT_BUDGET,
        target_patterns: Optional[Sequence[str]] = None,
        seed: int = 0,
        use_generated: bool = True,
        static_prescreen: bool = True,
        session: Optional[ProfileSession] = None,
        sampler: Optional[GridSampler] = None,
        progress: Optional[Callable[[str], None]] = None,
        device: str = "cuda",
        rungs: Optional[Rungs] = None,
    ):
        self.rungs = rungs or _default_rungs()
        try:
            self.entry, self.start = _resolve(self.rungs, kernel)
        except KeyError as e:
            raise TuneError(str(e.args[0])) from None
        self.device = device
        self.budget = budget
        self.seed = seed
        self.target_patterns = target_patterns
        self.use_generated = use_generated
        self.static_prescreen = static_prescreen
        self.session = session
        self.sampler = sampler or self.entry.sampler()
        self.say = progress or (lambda _msg: None)
        self.t0 = time.perf_counter()
        self._rng = np.random.default_rng(seed)
        self._jitter: Dict[str, float] = {}
        self.tried: set = {self.start.name}
        self.steps: List[TuneStep] = []
        self.queue: List[Candidate] = []
        self.baseline: Optional[ProfiledKernel] = None
        self.baseline_iter = ""
        self.best: Optional[ProfiledKernel] = None
        self._best_spec: Optional[KernelSpec] = None
        self._best_ctx: Optional[Dict[str, np.ndarray]] = None
        self._variant_names = [v.name for v in self.entry.variants]
        self._ladder_floor = (
            self._variant_names.index(self.start.name) + 1
        )
        self._cum_map: Dict[str, str] = {}
        # static pre-screen bookkeeping: every skipped candidate's record
        # (cumulative + pending for the next persisted iteration), the
        # specs the screen already built, and the skipped labels (so a
        # queue regeneration cannot re-propose them)
        self.static_skipped: List[dict] = []
        self._pending_skips: List[dict] = []
        self._prebuilt: Dict[str, Tuple] = {}
        self._skipped_labels: set = set()
        # candidate-failure provenance (profiles that raised and were
        # skipped; see record_failure)
        self.fault_events: List[FaultEvent] = []
        self.silent: List[str] = []

    def _order_key(self, c: Candidate):
        if c.label not in self._jitter:
            self._jitter[c.label] = float(self._rng.random())
        return (
            -c.predicted_saving,
            0 if c.source == "ladder" else 1,
            c.order,
            self._jitter[c.label],
            c.label,
        )

    def baseline_build(self):
        """Build the baseline (spec, dynamic_context) to profile first."""
        return _build(self.rungs, f"{self.entry.name}:{self.start.name}")

    def launch(self, cand: Optional[Candidate] = None) -> Optional[dict]:
        """Launch the kernel of the baseline (``cand`` None) or of a ladder
        rung on the loop's device, checked against its plain version
        (``run_variant``: on the CPU the plain version runs and nothing is
        timed).  None for a rung without a kernel and for a generated
        candidate, which is spec surgery with no kernel.  A kernel that
        fails to build, launch or agree raises: the run fails, it never
        falls back."""
        if cand is None:
            v = self.start
        elif cand.source == "ladder":
            v = self.entry.variant(cand.variant)
        else:
            return None
        if v.kernel is None:
            return None
        from repro_torch.kernels import run_variant

        return run_variant(v, self.device)

    def commit_baseline(
        self,
        pk: ProfiledKernel,
        spec: KernelSpec,
        ctx: Optional[Dict[str, np.ndarray]],
    ) -> None:
        """Install the profiled baseline and generate the first queue.

        The queue is generated *before* the baseline iteration persists:
        the static pre-screen runs at queue-generation time, and the
        candidates it skips belong to this iteration's provenance.
        """
        self.baseline = pk
        self.say(
            f"baseline {self.entry.name}:{self.start.name}: "
            f"{pk.transactions} transfers"
        )
        self.best, self._best_spec, self._best_ctx = pk, spec, ctx
        self.queue = self._generate()
        if self.session is not None:
            it = self.session.add_iteration(
                [pk],
                label=f"tune-{self.entry.name}-baseline",
                tuning={
                    "family": self.entry.name,
                    "step": 0,
                    "role": "baseline",
                    "budget": self.budget,
                    "seed": self.seed,
                    "candidate": None,
                    "accepted": True,
                    "static_skipped": self._take_pending_skips(),
                },
            )
            self.baseline_iter = it.path.name

    def _generate(self) -> List[Candidate]:
        acts = _open_actions(self.best, self.target_patterns)
        if not acts:  # every targeted pattern is fixed: converged
            return []
        cands = ladder_candidates(
            self.entry,
            frozenset(self.tried),
            acts,
            min_position=self._ladder_floor,
            rungs=self.rungs,
        )
        if self.use_generated:
            for act in acts:
                cands += candidates_for_action(
                    act, self._best_spec, self._best_ctx
                )
                for move in silent_moves(act, self._best_spec):
                    if move not in self.silent:
                        self.silent.append(move)
        # dedupe by label: against already-profiled steps, already-skipped
        # candidates (the best only improves, so a statically-worse skip
        # stays worse) AND within this batch (two actions can spawn the
        # same transform, e.g. pin(B) from both a hot and a reorder_grid
        # action)
        seen = {s.candidate.label for s in self.steps} | self._skipped_labels
        uniq = []
        for c in cands:
            if c.label not in seen:
                seen.add(c.label)
                uniq.append(c)
        uniq.sort(key=self._order_key)
        if not self.static_prescreen:
            return uniq
        return self._prescreen(uniq)

    def _prescreen(self, cands: List[Candidate]) -> List[Candidate]:
        """Drop candidates the static model proves strictly worse.

        Each candidate's spec is built once (and cached for
        :meth:`propose`) and priced with ``lint.static_transactions`` —
        the exact replay of the collector's transfer arithmetic.  A
        candidate whose modeled total strictly exceeds the incumbent
        best's would be rejected by :func:`_accepts` with certainty, so
        profiling it is a guaranteed wasted trace: it is skipped without
        consuming budget and recorded in the tuning provenance as
        ``static_skipped``.  Specs the model cannot price (dynamic
        operands) pass through unjudged.
        """
        kept: List[Candidate] = []
        for c in cands:
            try:
                cspec, cctx = c.build()
            except Exception:
                kept.append(c)  # propose() reports the build failure
                continue
            tx = static_transactions(cspec, self.sampler)
            if tx is not None and tx > self.best.transactions:
                if c.variant:
                    self.tried.add(c.variant)
                self._skipped_labels.add(c.label)
                record = {
                    "label": c.label,
                    "static_transactions": int(tx),
                    "parent_transactions": int(self.best.transactions),
                    "candidate": c.provenance(),
                }
                self.static_skipped.append(record)
                self._pending_skips.append(record)
                self.say(
                    f"prescreen: {c.label} statically worse "
                    f"({tx} > {self.best.transactions} transfers) — skipped"
                )
                continue
            self._prebuilt[c.label] = (cspec, cctx)
            kept.append(c)
        return kept

    def _take_pending_skips(self) -> List[dict]:
        """Drain the skips accumulated since the last persisted iteration."""
        skips, self._pending_skips = self._pending_skips, []
        return skips

    def propose(
        self,
    ) -> Optional[
        Tuple[Candidate, KernelSpec, Optional[Dict[str, np.ndarray]]]
    ]:
        """Pop the next buildable candidate, or ``None`` when finished.

        Candidates that fail to build are skipped without consuming
        budget, exactly as in the serial loop.  ``None`` means the queue
        is empty (converged) or this loop's budget is spent.
        """
        while self.queue and len(self.steps) < self.budget:
            cand = self.queue.pop(0)
            if cand.variant:
                self.tried.add(cand.variant)
            if cand.label in self._prebuilt:
                # the static pre-screen already built (and priced) this
                # spec at queue-generation time
                cspec, cctx = self._prebuilt.pop(cand.label)
                return cand, cspec, cctx
            try:
                cspec, cctx = cand.build()
            except Exception as e:  # a candidate that fails to build is skipped
                self.say(
                    f"step {len(self.steps) + 1}: {cand.label} "
                    f"failed to build ({e})"
                )
                continue
            return cand, cspec, cctx
        return None

    def record_failure(self, cand: Candidate, exc: BaseException) -> None:
        """Skip a candidate whose re-profile failed; keep tuning.

        A candidate whose profile raised must not abort the run: it is
        recorded as a ``candidate-failure``
        :class:`~repro_torch.core.resilience.FaultEvent`, its label joins the
        skip set so a queue regeneration cannot re-propose it, and the
        loop moves on without consuming budget (budget counts *judged*
        candidates, exactly like build failures).
        """
        self.fault_events.append(
            FaultEvent(
                kind="candidate-failure",
                where="tuner",
                detail=(
                    f"{self.entry.name}:{cand.label}: "
                    f"{type(exc).__name__}: {exc}"
                ),
            )
        )
        self._skipped_labels.add(cand.label)
        self.say(f"candidate {cand.label} failed to profile ({exc}) — skipped")

    def commit(
        self,
        cand: Candidate,
        cspec: KernelSpec,
        cctx: Optional[Dict[str, np.ndarray]],
        pk: ProfiledKernel,
    ) -> TuneStep:
        """Judge one profiled candidate and advance the loop state.

        An accepted candidate regenerates the queue *before* its
        iteration persists: the static pre-screen runs during
        regeneration and the candidates it skips belong to this step's
        provenance.  The step is appended provisionally first (the
        regeneration's label dedupe must see it) and patched with the
        iteration name once known.
        """
        step_map = _effective_region_map(
            dict(cand.region_map), self.best.heatmap, pk.heatmap
        )
        d = diff_heatmaps(self.best.heatmap, pk.heatmap, region_map=step_map)
        accepted = _accepts(d, self.best.heatmap, pk.heatmap)
        step_no = len(self.steps) + 1
        step = TuneStep(
            step=step_no,
            candidate=cand,
            profiled=pk,
            diff=d,
            accepted=accepted,
            iteration="",
        )
        self.steps.append(step)
        self.say(
            f"step {step_no}: {cand.label} -> {pk.transactions} "
            f"transfers ({d.verdict})"
            + (" [accepted]" if accepted else "")
        )
        if accepted:
            self.best, self._best_spec, self._best_ctx = pk, cspec, cctx
            if (
                cand.source == "ladder"
                and cand.variant in self._variant_names
            ):
                # the ladder is walked forward, never revisited
                self._ladder_floor = (
                    self._variant_names.index(cand.variant) + 1
                )
            self._cum_map.update(step_map)
            self.queue = self._generate()
        if self.session is not None:
            it = self.session.add_iteration(
                [pk],
                label=f"tune-{self.entry.name}-step{step_no}",
                tuning={
                    "family": self.entry.name,
                    "step": step_no,
                    "role": "candidate",
                    "budget": self.budget,
                    "seed": self.seed,
                    "baseline": self.baseline_iter,
                    "candidate": cand.provenance(),
                    "verdict": d.verdict,
                    "speedup_vs_parent": d.speedup_estimate,
                    "fixed": [list(p) for p in d.fixed],
                    "introduced": [list(p) for p in d.introduced],
                    "accepted": accepted,
                    "static_skipped": self._take_pending_skips(),
                },
            )
            step = dataclasses.replace(step, iteration=it.path.name)
            self.steps[-1] = step
        return step

    def result(self) -> TuneResult:
        """Freeze the trajectory into a :class:`TuneResult`."""
        final = diff_heatmaps(
            self.baseline.heatmap,
            self.best.heatmap,
            region_map=_effective_region_map(
                self._cum_map, self.baseline.heatmap, self.best.heatmap
            ),
        )
        best_label = "baseline"
        for s in self.steps:
            if s.accepted:
                best_label = s.candidate.label
        # converged = nothing left to try: every targeted pattern is
        # fixed, or no candidate can be generated for the ones that
        # remain (as opposed to stopping with untried candidates when
        # budget ran out)
        converged = not self.queue
        return TuneResult(
            kernel=self.entry.name,
            baseline=self.baseline,
            best=self.best,
            best_label=best_label,
            steps=tuple(self.steps),
            final=final,
            converged=converged,
            budget=self.budget,
            seed=self.seed,
            wall_s=time.perf_counter() - self.t0,
            baseline_iteration=(
                self.baseline_iter if self.session is not None else ""
            ),
            static_skipped=tuple(self.static_skipped),
            faults=tuple(self.fault_events),
            silent=tuple(self.silent),
        )


def tune(
    kernel: str,
    *,
    budget: int = DEFAULT_BUDGET,
    target_patterns: Optional[Sequence[str]] = None,
    seed: int = 0,
    use_generated: bool = True,
    static_prescreen: bool = True,
    session: Optional[ProfileSession] = None,
    sampler: Optional[GridSampler] = None,
    workers: int = 1,
    collector: Optional[ShardedCollector] = None,
    cache: Optional[CollectionCache] = None,
    progress: Optional[Callable[[str], None]] = None,
    device: str = "cuda",
    rungs: Optional[Rungs] = None,
) -> TuneResult:
    """Close the paper's tuning loop unattended for one kernel family.

    Profiles the family's baseline variant, expands its advisor actions
    into candidates (registry ladder steps + generated spec surgery),
    re-profiles candidates best-predicted-first, accepts improvements,
    and repeats until no targeted patterns remain or ``budget``
    candidate profiles were spent.

    ``kernel`` is a registry reference (``'gemm'`` or ``'gemm:v00'`` to
    pick the starting variant).  ``session`` persists every step as an
    iteration whose manifest carries the tuning provenance (which Action
    spawned which candidate); without one the run is in-memory only.
    ``seed`` fixes the candidate tie-break order — two runs with the
    same arguments and seed produce identical trajectories.  ``workers`` /
    ``collector`` shard the walks over a process pool (bit-identical heat
    maps; a generated candidate has no source a worker could rebuild and
    is sharded in process).  ``cache``
    (a :class:`~repro_torch.core.cache.CollectionCache`) serves repeated
    walks bit-identical cached heat maps instead of re-tracing.
    ``static_prescreen`` (on by default) prices every candidate with the
    linter's exact static transfer model and skips — without tracing or
    spending budget — any candidate provably worse than the incumbent;
    skips are recorded in the tuning provenance as ``static_skipped``.

    The baseline and every ladder rung with a kernel launch it on
    ``device`` (``"cuda"`` by default, ``"cpu"`` for the plain version),
    checked against its plain version: :meth:`_TuneLoop.launch`.  The
    record is the profile's ``run``; it is measured on every profile,
    cache or no cache, and never ranked on.  A launch failure is never a
    candidate failure: it ends the run.  ``rungs`` is the test seam of
    :func:`ladder_candidates`.
    """
    loop = _TuneLoop(
        kernel,
        budget=budget,
        target_patterns=target_patterns,
        seed=seed,
        use_generated=use_generated,
        static_prescreen=static_prescreen,
        session=session,
        sampler=sampler,
        progress=progress,
        device=device,
        rungs=rungs,
    )
    own_collector = False
    if collector is None and workers > 1:
        collector = ShardedCollector(workers)
        own_collector = True
    try:
        spec, ctx = loop.baseline_build()
        pk = profile_kernel(
            spec,
            loop.sampler,
            ctx,
            name=loop.entry.name,
            variant=loop.start.name,
            region_map=loop.entry.region_map,
            run=loop.launch(),
            collector=collector,
            cache=cache,
        )
        loop.commit_baseline(pk, spec, ctx)
        while True:
            trial = loop.propose()
            if trial is None:
                break
            cand, cspec, cctx = trial
            run = loop.launch(cand)
            try:
                pk = profile_kernel(
                    cspec,
                    loop.sampler,
                    cctx,
                    name=loop.entry.name,
                    variant=cand.label,
                    region_map=cand.region_map,
                    run=run,
                    collector=collector,
                    cache=cache,
                )
            except Preempted:
                raise
            except Exception as e:  # noqa: BLE001 — one broken spec is skipped
                loop.record_failure(cand, e)
                continue
            loop.commit(cand, cspec, cctx, pk)
    finally:
        if own_collector:
            collector.close()
    return loop.result()


@dataclasses.dataclass(frozen=True)
class TuneAllResult:
    """Outcome of one :func:`tune_all` run across many families."""

    results: Tuple[TuneResult, ...]  # one per family, input order
    budget: int  # the GLOBAL candidate budget
    spent: int  # candidate profiles actually consumed
    rounds: int  # scheduler rounds executed
    seed: int
    wall_s: float

    def as_dict(self) -> dict:
        """JSON-ready view of the whole run."""
        return {
            "budget": self.budget,
            "spent": self.spent,
            "rounds": self.rounds,
            "seed": self.seed,
            "wall_s": self.wall_s,
            "results": [r.as_dict() for r in self.results],
        }

    def summary(self) -> str:
        """Human-readable digest (the ``cuthermo tune --all`` body)."""
        lines = [
            f"== tune --all: {len(self.results)} families, "
            f"global budget {self.budget} "
            f"({self.spent} spent over {self.rounds} rounds) =="
        ]
        for r in self.results:
            status = "converged" if r.converged else "budget exhausted"
            lines.append(
                f"  {r.kernel}: {r.final.tx_before} -> "
                f"{r.final.tx_after} transfers ({r.speedup:.2f}x, "
                f"best {r.best_label}, {len(r.steps)} tried, {status})"
            )
        return "\n".join(lines)


def tune_all(
    kernels: Optional[Sequence[str]] = None,
    *,
    budget: int = DEFAULT_BUDGET,
    target_patterns: Optional[Sequence[str]] = None,
    seed: int = 0,
    use_generated: bool = True,
    static_prescreen: bool = True,
    session: Optional[ProfileSession] = None,
    workers: int = 1,
    collector: Optional[ShardedCollector] = None,
    cache: Optional[CollectionCache] = None,
    progress: Optional[Callable[[str], None]] = None,
    device: str = "cuda",
    rungs: Optional[Rungs] = None,
    max_threads: Optional[int] = None,
    preemption=None,
) -> TuneAllResult:
    """Tune many families concurrently under ONE global candidate budget.

    Each family runs its own :class:`_TuneLoop`; the scheduler works in
    rounds.  Every round it asks each still-active family (in input
    order) to propose its next candidate until the global budget is
    reserved, profiles the batch on a thread pool over the SHARED
    ``collector`` and ``cache``, then commits the results back into
    their loops in family order (*ordered result commitment*).  A loop's
    trajectory depends only on the sequence of results committed into
    it, so two runs with the same arguments and seed give identical
    trajectories, and each family's trajectory is the one :func:`tune`
    gives with the same seed as long as the global budget does not cut
    it short.  Iterations are committed in the scheduler thread, so
    their numbering is deterministic too.

    Each round's kernel runs are made first, one after another on the
    scheduler thread, while no walk runs; only then do the walks go to
    the threads.  So no kernel overlaps another on the card, and no
    thread holds the interpreter inside a run's CUDA-event window: each
    run's times are the ones it gives when its family is tuned alone.

    ``kernels`` defaults to every registry family.  ``budget`` caps the
    TOTAL candidate profiles across all families (baselines are free,
    as in :func:`tune`); a family that converges stops proposing and its
    unused share flows to the rest.  A candidate whose walk raises is
    recorded as a ``candidate-failure`` fault on its family's loop and
    skipped; a kernel that fails to build, launch or agree ends the run.
    ``preemption`` (any object with a boolean ``requested``, e.g. a
    :class:`repro_torch.runtime.fault.PreemptionHandler`) is checked at
    every round boundary: when set, the scheduler raises
    :class:`~repro_torch.runtime.fault.Preempted` between rounds, after
    the last round's iterations have durably committed.  ``device`` and
    ``rungs`` are :func:`tune`'s.
    """
    import concurrent.futures

    if kernels is None:
        from repro_torch import kernels as kreg

        kernels = list(kreg.names())
    if not kernels:
        raise TuneError("tune_all needs at least one kernel family")
    say = progress or (lambda _msg: None)

    def family_progress(name: str) -> Callable[[str], None]:
        return lambda msg: say(f"[{name}] {msg}")

    loops = [
        _TuneLoop(
            k,
            budget=budget,
            target_patterns=target_patterns,
            seed=seed,
            use_generated=use_generated,
            static_prescreen=static_prescreen,
            session=session,
            progress=family_progress(k),
            device=device,
            rungs=rungs,
        )
        for k in kernels
    ]
    own_collector = False
    if collector is None and workers > 1:
        collector = ShardedCollector(workers)
        own_collector = True
    t0 = time.perf_counter()
    spent = 0
    rounds = 0
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=max_threads or min(len(loops), 8),
        thread_name_prefix="tune-all",
    )

    def walk(loop, spec, ctx, cand, run):
        """Walk one profile (its kernel already ran); a walk failure comes
        back as the second element."""
        try:
            pk = profile_kernel(
                spec,
                loop.sampler,
                ctx,
                name=loop.entry.name,
                variant=loop.start.name if cand is None else cand.label,
                region_map=(
                    loop.entry.region_map if cand is None else cand.region_map
                ),
                run=run,
                collector=collector,
                cache=cache,
            )
        except Preempted:
            raise
        except Exception as e:  # noqa: BLE001 — one broken spec is skipped
            return None, e
        return pk, None

    try:
        # round 0: every baseline (free: budget counts candidates)
        builds = [loop.baseline_build() for loop in loops]
        # every kernel of the round runs here, serially, before any walk:
        # a launch failure raises and ends the run
        runs = [loop.launch(None) for loop in loops]
        futs = [
            pool.submit(walk, loop, spec, ctx, None, run)
            for loop, (spec, ctx), run in zip(loops, builds, runs)
        ]
        for loop, (spec, ctx), fut in zip(loops, builds, futs):
            pk, err = fut.result()
            if err is not None:
                raise err  # a baseline that cannot be walked has no loop
            loop.commit_baseline(pk, spec, ctx)

        active = list(loops)
        while active and spent < budget:
            if preemption is not None and getattr(
                preemption, "requested", False
            ):
                raise Preempted(
                    f"tune --all preempted at a round boundary after "
                    f"{rounds} round(s), {spent} candidate profile(s); "
                    "committed iterations are durable — resume to replay"
                )
            rounds += 1
            batch = []  # (loop, cand, spec, ctx)
            still = []
            for loop in active:
                if spent + len(batch) >= budget:
                    still.append(loop)  # no slot this round, stay active
                    continue
                trial = loop.propose()
                if trial is None:
                    continue  # converged: drops out of the schedule
                batch.append((loop, *trial))
                still.append(loop)
            active = still
            if not batch:
                break
            runs = [loop.launch(cand) for loop, cand, _, _ in batch]
            futs = [
                pool.submit(walk, loop, cspec, cctx, cand, run)
                for (loop, cand, cspec, cctx), run in zip(batch, runs)
            ]
            # ordered result commitment: walks finish in any order, state
            # only advances here, in family order
            for (loop, cand, cspec, cctx), fut in zip(batch, futs):
                pk, err = fut.result()
                if err is not None:
                    loop.record_failure(cand, err)
                    continue
                loop.commit(cand, cspec, cctx, pk)
                spent += 1
    finally:
        pool.shutdown()
        if own_collector:
            collector.close()

    return TuneAllResult(
        results=tuple(loop.result() for loop in loops),
        budget=budget,
        spent=spent,
        rounds=rounds,
        seed=seed,
        wall_s=time.perf_counter() - t0,
    )


def trajectories_from_session(session: ProfileSession) -> List[dict]:
    """Rebuild tuning trajectories from a session's stored provenance.

    Groups every iteration carrying v3 ``tuning`` metadata by *tuning
    run* — the (family, baseline-iteration) pair each candidate's
    ``tuning.baseline`` link records — and returns, per run, a dict
    shaped like :meth:`TuneResult.as_dict` minus the fields only the
    live run knows (wall_s, convergence) — the input the report
    bundle's trajectory section renders.  Re-tuning the same family
    into the same session therefore yields one trajectory per run, not
    one garbled merge.  Sessions without tuning metadata return ``[]``.
    """
    by_run: Dict[Tuple[str, str], List[Tuple[dict, object]]] = {}
    for it in session.iterations():
        if not it.tuning:
            continue
        meta = dict(it.tuning)
        family = str(meta.get("family", "?"))
        # a baseline anchors its own run; candidates link back to it.
        # (pre-link metadata degrades to one run per family: key "")
        if meta.get("role") == "baseline":
            run = it.path.name
        else:
            run = str(meta.get("baseline", ""))
        by_run.setdefault((family, run), []).append((meta, it))
    out: List[dict] = []
    for (family, run), rows in sorted(by_run.items()):
        rows.sort(key=lambda r: int(r[0].get("step", 0)))
        steps = []
        baseline_tx = None
        baseline_iter = run
        best_tx = None
        best_label = "baseline"
        best_iter = run
        static_skipped: List[dict] = []
        for meta, it in rows:
            pk = it.kernels[0]
            static_skipped.extend(meta.get("static_skipped") or [])
            if meta.get("role") == "baseline":
                baseline_tx = best_tx = pk.transactions
                baseline_iter = best_iter = it.path.name
                continue
            steps.append(
                {
                    "step": int(meta.get("step", len(steps) + 1)),
                    "candidate": meta.get("candidate") or {},
                    "iteration": it.path.name,
                    "transactions": pk.transactions,
                    "wall_s": pk.wall_s,
                    "verdict": meta.get("verdict", ""),
                    "speedup_vs_parent": float(
                        meta.get("speedup_vs_parent", 1.0)
                    ),
                    "fixed": meta.get("fixed", []),
                    "introduced": meta.get("introduced", []),
                    "accepted": bool(meta.get("accepted")),
                    "static_skipped": meta.get("static_skipped") or [],
                }
            )
            if meta.get("accepted"):
                best_tx = pk.transactions
                best_iter = it.path.name
                best_label = (meta.get("candidate") or {}).get(
                    "label", best_label
                )
        if baseline_tx is None:
            if not steps:
                continue
            baseline_tx = steps[0]["transactions"]
            best_tx = min(
                (s["transactions"] for s in steps if s["accepted"]),
                default=baseline_tx,
            )
        out.append(
            {
                "kernel": family,
                "run": baseline_iter,
                "candidates_tried": len(steps),
                "baseline": {
                    "transactions": baseline_tx,
                    "iteration": baseline_iter,
                },
                "best": {
                    "label": best_label,
                    "transactions": best_tx,
                    "iteration": best_iter,
                },
                "speedup": baseline_tx / max(best_tx or 1, 1),
                "improved": (best_tx or baseline_tx) < baseline_tx,
                "steps": steps,
                "static_skipped": static_skipped,
            }
        )
    out.sort(key=lambda r: (r["kernel"], r["run"]))
    return out


__all__ = [
    "Candidate",
    "DEFAULT_BUDGET",
    "SMEM_PIN_DEFAULT_BYTES",
    "TuneAllResult",
    "TuneError",
    "TuneResult",
    "TuneStep",
    "align_spec",
    "candidates_for_action",
    "drop_scratch_spec",
    "ladder_candidates",
    "pin_budget_bytes",
    "pin_spec",
    "retile_spec",
    "silent_moves",
    "transpose_spec",
    "trajectories_from_session",
    "tune",
    "tune_all",
]
