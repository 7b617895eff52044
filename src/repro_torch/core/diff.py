"""Heat-map diffing: the paper's iterate loop (Fig. 2) as a first-class op.

``diff(before, after)`` aligns two heat maps region-by-region and
reports, per region and overall: transaction delta, waste-ratio delta,
patterns fixed / introduced / persisting — the artifact a tuning
iteration reviews before the next change.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .heatmap import Heatmap
from .patterns import detect_all


@dataclasses.dataclass(frozen=True)
class RegionDelta:
    region: str
    tx_before: int
    tx_after: int
    waste_before: float
    waste_after: float
    sectors_before: int = 0  # touched sectors (array-backed heatmap count)
    sectors_after: int = 0

    @property
    def tx_ratio(self) -> float:
        return self.tx_before / max(self.tx_after, 1)


@dataclasses.dataclass(frozen=True)
class HeatmapDiff:
    kernel_before: str
    kernel_after: str
    regions: Tuple[RegionDelta, ...]
    fixed: Tuple[Tuple[str, str], ...]  # (region, pattern) gone
    introduced: Tuple[Tuple[str, str], ...]  # new regressions
    persisting: Tuple[Tuple[str, str], ...]
    tx_before: int
    tx_after: int

    @property
    def speedup_estimate(self) -> float:
        """Modeled transaction speedup (the Table III currency)."""
        return self.tx_before / max(self.tx_after, 1)

    @property
    def verdict(self) -> str:
        """Tuning-loop verdict: 'improved' | 'regressed' | 'unchanged'.

        A change is a regression when it moves more data across the
        device-memory boundary OR introduces a new inefficiency pattern
        without reducing traffic (even if another pattern was fixed in
        trade) — the two signals a tuning iteration reviews before
        keeping a change.
        """
        if self.tx_after < self.tx_before:
            return "improved"
        if self.tx_after > self.tx_before or self.introduced:
            return "regressed"
        return "unchanged"

    def summary(self) -> str:
        lines = [
            f"== thermo diff: {self.kernel_before} -> {self.kernel_after} ==",
            f"modeled transfers: {self.tx_before} -> {self.tx_after} "
            f"({self.speedup_estimate:.2f}x, +{100*(self.speedup_estimate-1):.1f}%)",
        ]
        for tag, items in (("fixed", self.fixed), ("INTRODUCED", self.introduced),
                           ("persisting", self.persisting)):
            for region, pattern in items:
                lines.append(f"  [{tag}] {pattern} on {region}")
        for rd in self.regions:
            if rd.tx_before != rd.tx_after:
                lines.append(
                    f"  {rd.region}: {rd.tx_before} -> {rd.tx_after} transfers "
                    f"(waste {rd.waste_before:.2f}x -> {rd.waste_after:.2f}x)"
                )
        return "\n".join(lines)


def _pattern_set(hm: Heatmap) -> set:
    return {(r.region, r.pattern) for r in detect_all(hm)}


def diff(before: Heatmap, after: Heatmap,
         region_map: Optional[Dict[str, str]] = None) -> HeatmapDiff:
    """Compare two heat maps.  ``region_map`` renames before->after regions
    (an optimization often renames buffers, e.g. q -> qT)."""
    region_map = region_map or {}
    deltas: List[RegionDelta] = []
    after_names = set(after.region_names())
    for rh in before.regions:
        name = rh.region.name
        aname = region_map.get(name, name)
        if aname not in after_names:
            continue
        deltas.append(RegionDelta(
            region=name,
            tx_before=before.sector_transactions(name)
            if rh.region.space == "hbm" else 0,
            tx_after=after.sector_transactions(aname)
            if after.region(aname).region.space == "hbm" else 0,
            waste_before=before.waste_ratio(name),
            waste_after=after.waste_ratio(aname),
            sectors_before=rh.touched_sectors,
            sectors_after=after.region(aname).touched_sectors,
        ))
    pb = _pattern_set(before)
    pa_raw = _pattern_set(after)
    # rename after-regions back for comparison
    inv = {v: k for k, v in region_map.items()}
    pa = {(inv.get(r, r), p) for r, p in pa_raw}
    return HeatmapDiff(
        kernel_before=before.kernel,
        kernel_after=after.kernel,
        regions=tuple(deltas),
        fixed=tuple(sorted(pb - pa)),
        introduced=tuple(sorted(pa - pb)),
        persisting=tuple(sorted(pb & pa)),
        tx_before=before.sector_transactions(),
        tx_after=after.sector_transactions(),
    )
