"""Deterministic fault injection for the profiling pipeline.

Every recovery path in :mod:`repro_torch.core.collector` /
:mod:`repro_torch.core.cache` / :mod:`repro_torch.core.session` is
exercised by *injected* faults, not just claimed: a seeded
:class:`FaultPlan` decides — as a pure function of ``(seed, kernel,
shard, attempt)`` — which shard crashes its worker, which one hangs, and
for how long.  The same plan therefore produces the same fault sequence
on every run, which is what lets tests assert exact recovery behavior
(exit 0, recorded :class:`~repro_torch.core.resilience.FaultEvent`
provenance, bit-identity with a clean serial run).

Faults land on the host's walk only.  A kernel's build, launch or
tolerance failure is not a fault this module injects or any layer
recovers from: it ends the command.

Wire-up:

* ``cuthermo profile/tune/model --inject-faults seed=7`` parses a plan
  (:meth:`FaultPlan.parse`) and threads it into the session's
  :class:`~repro_torch.core.collector.ShardedCollector`.
* The collector asks :meth:`FaultPlan.directive` for each (shard,
  attempt) it submits and ships the directive inside the worker task;
  :func:`apply_worker_directive` executes it worker-side (``os._exit``
  for a crash, ``time.sleep`` for a hang).  Directives target specific
  *attempts*, so the recovery re-run is clean by construction and the
  collection always converges.
* Cache corruption (:func:`corrupt_cache_entry`) and torn artifact
  writes (:class:`WriteKillPoint`) are test-side injections into the
  on-disk state — they model ``kill -9`` and bit rot, which cannot be
  raised from inside the victim process.

The default plan (``seed=N`` alone) injects one worker crash and one
shard hang on the same victim shard, in that order: the crash lands on
the shard's first delivery, the hang on its post-rebuild retry.  That
sequencing makes *both* recovery paths (pool rebuild + watchdog expiry)
fire deterministically in one collection, independent of worker timing.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib
from pathlib import Path
from typing import Optional

from .resilience import ResiliencePolicy


class FaultInjectError(ValueError):
    """Raised for malformed ``--inject-faults`` specifications."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, deterministic plan of faults to inject.

    ``crashes``/``timeouts`` count injected worker crashes and shard
    hangs per collection (0 or 1 of each; the victim shard is a pure
    function of ``seed`` and the kernel name).  ``hang_s`` is how long
    an injected hang sleeps — it only needs to exceed ``watchdog_s``,
    the tightened per-round watchdog the plan's :meth:`policy` runs the
    collector with (the hung worker is killed at the watchdog, so the
    run never actually waits ``hang_s``).
    """

    seed: int = 0
    crashes: int = 1
    timeouts: int = 1
    hang_s: float = 30.0
    watchdog_s: float = 1.5

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse a ``--inject-faults`` spec like ``"seed=7,timeouts=0"``.

        Accepted keys: ``seed``, ``crashes``, ``timeouts``, ``hang``
        (seconds), ``watchdog`` (seconds).  A bare integer is shorthand
        for ``seed=N``.
        """
        text = (text or "").strip()
        if not text:
            raise FaultInjectError("empty --inject-faults spec")
        fields = {"seed": 0, "crashes": 1, "timeouts": 1,
                  "hang": 30.0, "watchdog": 1.5}
        if "=" not in text and "," not in text:
            text = f"seed={text}"
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, value = part.partition("=")
            key = key.strip()
            if not sep or key not in fields:
                known = ", ".join(sorted(fields))
                raise FaultInjectError(
                    f"bad --inject-faults item {part!r}; expected "
                    f"key=value with key in ({known})"
                )
            try:
                fields[key] = (float(value) if key in ("hang", "watchdog")
                               else int(value))
            except ValueError as e:
                raise FaultInjectError(
                    f"bad --inject-faults value {part!r} ({e})"
                ) from e
        if not 0 <= fields["crashes"] <= 1 or not 0 <= fields["timeouts"] <= 1:
            raise FaultInjectError(
                "--inject-faults supports at most one crash and one "
                "timeout per collection (crashes/timeouts must be 0 or 1)"
            )
        return cls(
            seed=fields["seed"],
            crashes=fields["crashes"],
            timeouts=fields["timeouts"],
            hang_s=fields["hang"],
            watchdog_s=fields["watchdog"],
        )

    def describe(self) -> str:
        """Human-readable one-liner (CLI banners, logs)."""
        return (
            f"seed={self.seed} crashes={self.crashes} "
            f"timeouts={self.timeouts} watchdog={self.watchdog_s}s"
        )

    def policy(self, base: Optional[ResiliencePolicy] = None) -> ResiliencePolicy:
        """The collector policy this plan should run under.

        Tightens the hang watchdog to ``watchdog_s`` (an injected hang
        must expire in test/CI time, not production time) and shrinks
        the backoff; everything else inherits from ``base``.
        """
        base = base or ResiliencePolicy()
        return dataclasses.replace(
            base, shard_timeout_s=self.watchdog_s, base_delay=0.01
        )

    # -- collector-side directives ------------------------------------------
    def victim_shard(self, kernel: str, n_shards: int) -> int:
        """The shard this plan's faults land on (pure in seed + kernel)."""
        if n_shards <= 0:
            return 0
        return zlib.crc32(f"{self.seed}:{kernel}".encode()) % n_shards

    def directive(
        self, kernel: str, n_shards: int, shard: int, attempt: int
    ) -> Optional[dict]:
        """The worker directive for one (shard, attempt) delivery, or None.

        Only the victim shard (``victim_shard(kernel, n_shards)``) ever
        gets directives.  The crash targets its first delivery (attempt
        0); the hang targets its next one — after the crash's pool
        rebuild when both are enabled, so one collection exercises pool
        rebuild *and* watchdog recovery in a deterministic order.
        """
        if shard != self.victim_shard(kernel, n_shards):
            return None
        crash_at = 0 if self.crashes else None
        hang_at = (self.crashes if self.timeouts else None)
        if crash_at is not None and attempt == crash_at:
            return {"kind": "crash"}
        if hang_at is not None and attempt == hang_at:
            return {"kind": "hang", "sleep_s": float(self.hang_s)}
        return None


def apply_worker_directive(directive: Optional[dict]) -> None:
    """Execute an injected fault inside a pool worker (worker-side).

    ``crash`` kills the process the hard way (``os._exit`` — no cleanup,
    no exception, exactly what an OOM-killed or segfaulted worker looks
    like to the parent pool).  ``hang`` sleeps past the parent watchdog.
    """
    if not directive:
        return
    kind = directive.get("kind")
    if kind == "crash":
        os._exit(int(directive.get("code", 17)))
    elif kind == "hang":
        time.sleep(float(directive.get("sleep_s", 30.0)))
    else:
        raise FaultInjectError(f"unknown worker directive {directive!r}")


# ---------------------------------------------------------------------------
# disk-state injections (cache corruption, torn writes)
# ---------------------------------------------------------------------------


def corrupt_cache_entry(cache, key: str, mode: str = "truncate") -> None:
    """Corrupt one on-disk collection-cache entry in place.

    ``truncate`` chops the npz to its first few bytes (a partially
    written file); ``garbage`` overwrites it with non-npz bytes;
    ``meta`` breaks the JSON sidecar.  The entry must exist on disk.
    Exercises the cache's quarantine path (`CollectionCache._load_disk`).
    """
    npz_path, meta_path = cache._entry_paths(key)
    if mode == "truncate":
        data = npz_path.read_bytes()
        npz_path.write_bytes(data[: max(1, len(data) // 16)])
    elif mode == "garbage":
        npz_path.write_bytes(b"\x00not an npz\x00")
    elif mode == "meta":
        meta_path.write_text("{not json")
    else:
        raise FaultInjectError(f"unknown cache corruption mode {mode!r}")
    # drop the memory tier so the next get() actually reads the disk
    with cache._lock:
        cache._mem.pop(key, None)


class InjectedKill(BaseException):
    """Raised by a :class:`WriteKillPoint` to model ``kill -9`` mid-write.

    A ``BaseException`` on purpose: ordinary ``except Exception``
    cleanup handlers must not be able to "absorb" the kill — a real
    SIGKILL would not run them either.
    """


class WriteKillPoint:
    """Kill an artifact write at an exact point of its commit sequence.

    Installed as a :func:`repro_torch.core.session.write_iteration` commit
    hook for the duration of a ``with`` block::

        with WriteKillPoint(after_files=1):
            write_iteration(path, kernels)   # raises InjectedKill

    The hook sees every atomic commit twice — ``staged`` (temp file
    durable, rename pending) and ``committed`` (renamed into place).
    Once ``after_files`` files are committed, the kill fires at the
    next ``kill_at`` event:

    * ``kill_at="committed"`` (default) dies right after the Nth
      rename — later files (ultimately the manifest) simply never
      exist, the torn state ``ProfileSession.recover()`` quarantines.
    * ``kill_at="staged"`` dies after the *next* file's temp is durable
      but before its rename — with ``after_files`` = number of npz
      files, that next file is the manifest, the exact
      fsync'd-but-not-renamed state ``recover()`` completes.
    """

    def __init__(self, after_files: int = 1, kill_at: str = "committed"):
        if kill_at not in ("staged", "committed"):
            raise FaultInjectError(
                f"kill_at must be 'staged' or 'committed', got {kill_at!r}"
            )
        self.after_files = int(after_files)
        self.kill_at = kill_at
        self.committed = 0

    def __call__(self, path: Path, event: str) -> None:
        if event == "committed":
            self.committed += 1
            if self.kill_at == "committed" and self.committed >= self.after_files:
                raise InjectedKill(
                    f"injected kill after {self.committed} committed "
                    f"file(s); last committed: {path.name}"
                )
        elif event == "staged":
            if self.kill_at == "staged" and self.committed >= self.after_files:
                raise InjectedKill(
                    f"injected kill with {path.name} staged but not "
                    f"renamed ({self.committed} file(s) committed)"
                )

    def __enter__(self) -> "WriteKillPoint":
        from . import session

        session._write_commit_hooks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        from . import session

        session._write_commit_hooks.remove(self)


__all__ = [
    "FaultInjectError",
    "FaultPlan",
    "InjectedKill",
    "WriteKillPoint",
    "apply_worker_directive",
    "corrupt_cache_entry",
]
