"""Optimization advisor: pattern reports -> structured, actionable fixes.

CUTHERMO's workflow (Fig. 2) is profile -> read heat map -> optimize ->
re-profile.  Every pattern maps to a structured Action that names the
CUDA knob to turn (thread-index mapping, BLOCK_M/N/K tiles, register
accumulation, vector loads) plus an estimate of the transaction saving,
derived from the same transaction model the heat map uses.  The Action
kinds, regions and savings are the JAX package's; only the prose names
CUDA knobs in place of Pallas ones.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .heatmap import Heatmap
from .patterns import (
    FALSE_SHARING,
    HOT,
    HOT_RANDOM,
    MISALIGNMENT,
    SCRATCH_ABUSE,
    STRIDED,
    PatternReport,
    detect_all,
)


@dataclasses.dataclass(frozen=True)
class Action:
    """One concrete optimization step the profile recommends.

    An Action names the CUDA knob to turn for one detected pattern:

    * ``kind`` — the knob vocabulary: ``'retile'`` (false sharing),
      ``'transpose'`` (strided), ``'pad_align'`` (misalignment),
      ``'drop_scratch'`` (scratch abuse), ``'vmem_pin'`` (hot) or
      ``'reorder_grid'`` (hot-random).
    * ``region`` / ``pattern`` — which buffer, diagnosed with what (see
      ``docs/patterns.md`` for the catalogue).
    * ``est_transaction_saving`` — the fraction of the kernel's modeled
      device-memory transfers this step is expected to remove, priced
      with the same transaction model the heat map uses; ``advise``
      sorts on it.
    * ``params`` — machine-readable knob hints (e.g. the suggested block
      multiple, the strided word offset) as (key, value) pairs.
    """

    kind: str  # 'retile' | 'reorder_grid' | 'transpose' | 'drop_scratch'
    #          | 'pad_align' | 'vmem_pin'
    region: str
    pattern: str
    description: str
    est_transaction_saving: float  # fraction of region transactions saved
    params: Tuple[Tuple[str, str], ...] = ()

    def summary(self) -> str:
        """One-line human-readable form (reports, CLI)."""
        return (
            f"{self.kind}({self.region}): save "
            f"~{100 * self.est_transaction_saving:.0f}% of transfers — "
            f"{self.description}"
        )

    def as_dict(self) -> dict:
        """JSON-ready view (session manifests, report bundles)."""
        return {
            "kind": self.kind,
            "region": self.region,
            "pattern": self.pattern,
            "description": self.description,
            "est_transaction_saving": self.est_transaction_saving,
            "params": {k: v for k, v in self.params},
        }


def _action_for(rep, weight: float) -> Optional[Action]:
    """Map one report to its Action, given the region's transfer weight.

    Duck-typed over the report: anything with ``pattern`` / ``region`` /
    ``detail()`` works.
    """
    if rep.pattern == FALSE_SHARING:
        ratio = max(1.0, rep.detail("mean_ratio", 1.0))
        save = (1.0 - 1.0 / ratio) * weight
        return Action(
            kind="retile",
            region=rep.region,
            pattern=rep.pattern,
            description=(
                f"warps each own a different word of {rep.region}'s sectors; "
                "swap the thread indices (threadIdx.x on the contiguous "
                "axis) or widen BLOCK_N so a warp's lanes cover whole 32 B "
                f"sectors — expect ~{ratio:.0f}x fewer transfers on this "
                "region"
            ),
            est_transaction_saving=save,
            params=(("lanes_on", "contiguous-axis"),),
        )
    if rep.pattern == STRIDED:
        waste = rep.detail("waste", 0.5)
        return Action(
            kind="transpose",
            region=rep.region,
            pattern=rep.pattern,
            description=(
                f"{100*waste:.0f}% of each sector moved for {rep.region} is "
                "dead; store the array transposed (strided axis contiguous) "
                "or stage the strided column in shared memory once per block"
            ),
            est_transaction_saving=waste * weight,
            params=(("word_offset", f"{rep.detail('word_offset'):.0f}"),),
        )
    if rep.pattern == MISALIGNMENT:
        over = rep.detail("overhead", 0.25)
        return Action(
            kind="pad_align",
            region=rep.region,
            pattern=rep.pattern,
            description=(
                f"block origins in {rep.region} straddle sector boundaries "
                f"(~{100*over:.0f}% extra transfers); pad rows to a 32 B "
                "multiple, or load boundary pairs with one paired vector "
                "load (ld.v2, the zigzag fix)"
            ),
            est_transaction_saving=(over / (1 + over)) * weight,
        )
    if rep.pattern == SCRATCH_ABUSE:
        return Action(
            kind="drop_scratch",
            region=rep.region,
            pattern=rep.pattern,
            description=(
                f"shared memory {rep.region} holds warp-local values; "
                "accumulate in registers instead, delete the shared-memory "
                "buffer and its __syncthreads(), and reclaim the shared "
                "memory for occupancy"
            ),
            est_transaction_saving=weight,  # all scratch traffic goes away
        )
    if rep.pattern in (HOT, HOT_RANDOM):
        temp = rep.detail("mean_temp", 4.0)
        save = (1.0 - 1.0 / max(temp, 1.0)) * weight
        return Action(
            kind="vmem_pin" if rep.pattern == HOT else "reorder_grid",
            region=rep.region,
            pattern=rep.pattern,
            description=(
                f"{rep.region} sectors are re-fetched by ~{temp:.0f} warps; "
                "re-tile with larger BLOCK_M/BLOCK_N/BLOCK_K so a thread "
                "block stages each tile once in shared memory and its warps "
                "reuse it from there"
            ),
            est_transaction_saving=save,
        )
    return None


def _advise_one(rep: PatternReport, hm: Heatmap) -> Optional[Action]:
    """Map one pattern report to its Action (None when not actionable)."""
    region_tx = hm.sector_transactions(rep.region)
    total_tx = max(1, hm.sector_transactions())
    return _action_for(rep, region_tx / total_tx)


def advise(hm: Heatmap) -> List[Action]:
    """All actions for a heat map, highest estimated saving first."""
    actions = []
    for rep in detect_all(hm):
        act = _advise_one(rep, hm)
        if act is not None:
            actions.append(act)
    actions.sort(key=lambda a: -a.est_transaction_saving)
    return actions


def format_report(hm: Heatmap) -> str:
    """Human-readable profile->advice report (the tuning-loop artifact)."""
    lines = [f"== thermo report: kernel {hm.kernel} grid={hm.grid} =="]
    lines.append(
        f"modeled sector transfers: {hm.sector_transactions()} "
        f"(waste ratio {hm.waste_ratio():.2f}x)"
    )
    reports = detect_all(hm)
    if not reports:
        lines.append("no inefficiency patterns detected")
    for rep in reports:
        lines.append(
            f"[{rep.pattern}] region={rep.region} severity={rep.severity:.2f}"
        )
        for ev in rep.evidence:
            lines.append(f"    {ev}")
    acts = advise(hm)
    if acts:
        lines.append("-- suggested actions (by estimated saving) --")
        for a in acts:
            lines.append(f"  {a.summary()}")
    return "\n".join(lines)
