"""Recovery provenance carried by heat maps and artifacts.

A :class:`FaultEvent` records one recovery action a collection survived
(a worker crash, a hung shard, a corrupt cache entry, ...).  Events are
provenance: they ride on the heat map (``Heatmap.faults``), are
persisted in the v6+ artifact manifest, and are excluded from heat-map
equality, because a recovered collection is the clean collection
produced the hard way: the set-union merge algebra makes a re-executed
shard contribute the same key sets, and unions are idempotent.

:class:`ResiliencePolicy` holds the knobs of the recovery loop in
:class:`~repro_torch.core.collector.ShardedCollector`: per-shard retry
attempts and backoff, the per-round hang watchdog, how many broken pools
to tolerate before degrading to serial collection, and how finely a hung
shard is re-split for its in-process re-run.  Deterministic injection of
these faults lives in :mod:`repro_torch.core.faultinject`.  Recovery
covers the host's walk only: a kernel that fails to build, launch or
agree with its plain version is never retried.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

#: Event kinds the recovery machinery emits (a closed set, so consumers
#: match on them without scraping detail strings).
FAULT_KINDS = (
    "worker-crash",      # a pool worker died; its round's shards re-ran
    "shard-timeout",     # the watchdog expired a hung shard
    "shard-retry",       # a shard failed cleanly and was resubmitted
    "pool-rebuild",      # the broken process pool was torn down and respun
    "shard-resplit",     # a hung shard re-ran in process as smaller runs
    "serial-fallback",   # pool gave up; remaining shards ran serially
    "cache-corrupt",     # a defective disk cache entry was quarantined
    "torn-iteration",    # a half-written iteration was found on load
    "candidate-failure", # a tuner candidate's profile failed; run continued
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One structured recovery event (artifact provenance, not an error).

    ``kind`` is one of :data:`FAULT_KINDS`; ``where`` the pipeline layer
    that recovered; ``shard`` the affected shard id (``-1`` when not
    shard-scoped); ``attempt`` the 0-based delivery attempt; ``wall_s``
    the time lost where measurable; ``detail`` a short human-readable
    note.
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


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Knobs of the sharded collector's recovery loop.

    ``attempts``          per-shard delivery attempts (the first included)
                          before a clean shard failure is re-raised.
    ``base_delay``        exponential-backoff base between retries, seconds
                          (attempt ``n`` sleeps ``base_delay * 2**(n-1)``).
    ``shard_timeout_s``   per-round hang watchdog: shards still running
                          this long after their round started are declared
                          hung, their workers killed, and the shard re-run
                          in process.  ``None`` disables the watchdog.
    ``max_pool_failures`` consecutive broken-pool rounds tolerated before
                          the collector degrades to serial collection.
    ``resplit``           how many smaller contiguous pid runs a hung
                          shard's in-process re-run is split into (1 = re-run
                          whole).  Sub-runs keep the shard's id and
                          partition its ``[lo, hi)``.
    """

    attempts: int = 3
    base_delay: float = 0.05
    shard_timeout_s: float = 300.0
    max_pool_failures: int = 2
    resplit: int = 2

    def backoff_s(self, attempt: int) -> float:
        """Backoff before delivery attempt ``attempt`` (1-based retries)."""
        return float(self.base_delay) * (2 ** max(0, int(attempt) - 1))


#: The default policy; fault injection swaps in a tighter watchdog
#: (`FaultPlan.policy`).
DEFAULT_POLICY = ResiliencePolicy()


def summarize_faults(events: Tuple[FaultEvent, ...]) -> str:
    """One-line digest of a fault-event sequence (CLI/report surfaces)."""
    if not events:
        return "no faults"
    counts: dict = {}
    for e in events:
        counts[e.kind] = counts.get(e.kind, 0) + 1
    return ", ".join(f"{k} x{v}" for k, v in sorted(counts.items()))


__all__ = [
    "DEFAULT_POLICY",
    "FAULT_KINDS",
    "FaultEvent",
    "ResiliencePolicy",
    "summarize_faults",
]
