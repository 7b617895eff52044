"""Recovery provenance carried by heat maps and artifacts.

A :class:`FaultEvent` records one recovery action a collection survived
(a worker crash, a hung shard, a corrupt cache entry, ...).  Events are
provenance: they ride on the heat map (``Heatmap.faults``), are
persisted in the v6+ artifact manifest, and are excluded from heat-map
equality, because a recovered collection is the clean collection
produced the hard way.  The port reads and writes them; the recovery
machinery that emits them comes with sharded collection.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One structured recovery event (artifact provenance, not an error).

    ``kind`` names the recovery (``worker-crash``, ``shard-timeout``,
    ``shard-retry``, ``pool-rebuild``, ``shard-resplit``,
    ``serial-fallback``, ``cache-corrupt``, ``torn-iteration``,
    ``candidate-failure``); ``where`` the pipeline layer that recovered;
    ``shard`` the affected shard id (``-1`` when not shard-scoped);
    ``attempt`` the 0-based delivery attempt; ``wall_s`` the time lost
    where measurable; ``detail`` a short human-readable note.
    """

    kind: str
    where: str = "collector"
    shard: int = -1
    attempt: int = 0
    wall_s: float = 0.0
    detail: str = ""

    def as_dict(self) -> dict:
        """JSON-ready form (manifests, report bundles)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        """Inverse of :meth:`as_dict` (artifact loaders)."""
        return cls(
            kind=str(d["kind"]),
            where=str(d.get("where", "collector")),
            shard=int(d.get("shard", -1)),
            attempt=int(d.get("attempt", 0)),
            wall_s=float(d.get("wall_s", 0.0)),
            detail=str(d.get("detail", "")),
        )
