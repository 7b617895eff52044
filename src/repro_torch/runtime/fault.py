"""Fault tolerance on the host: preemption, straggler detection, retry.

* ``PreemptionHandler`` — SIGTERM/SIGINT flips a flag; a long-running
  loop (``cuthermo model``, ``cuthermo tune --all``, the training loop)
  sees it at its next boundary, leaves its work resumable and raises
  ``Preempted``.  ``checkpoint_hook`` is the training loop's: it writes a
  blocking checkpoint first.
* ``StragglerMonitor`` — per-step wall-time EMA + z-score; flags steps
  slower than ``threshold`` sigmas (logged and counted).
* ``retry`` — exponential-backoff wrapper for transient failures; the
  sharded collector's in-process re-runs use it.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Callable, List, Optional


class Preempted(RuntimeError):
    """A run stopped at a boundary because preemption was requested."""


class PreemptionHandler:
    """Flag-based SIGTERM handler (``register`` idempotent, restorable)."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def register(self, signals=(signal.SIGTERM,)) -> "PreemptionHandler":
        for s in signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def unregister(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _on_signal(self, signum, frame) -> None:
        self.requested = True

    def checkpoint_hook(self, manager, state_fn: Callable[[], tuple]):
        """Training hook: on preemption, blocking-save ``state_fn()``'s
        (tree, extra) at the step just finished and raise ``Preempted``."""

        def hook(step: int, state, metrics) -> None:
            if self.requested:
                tree, extra = state_fn()
                manager.save(tree, step, extra=extra, blocking=True)
                raise Preempted(f"preempted at step {step}; checkpoint written")

        return hook


@dataclasses.dataclass
class StragglerEvent:
    step: int
    wall_s: float
    zscore: float


class StragglerMonitor:
    """EMA + variance tracker; flags slow steps (z > threshold)."""

    def __init__(self, threshold: float = 3.0, alpha: float = 0.1, warmup: int = 5):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.events: List[StragglerEvent] = []
        self._last: Optional[float] = None

    def begin_step(self) -> None:
        self._last = time.perf_counter()

    def end_step(self, step: int) -> Optional[StragglerEvent]:
        if self._last is None:
            return None
        dt = time.perf_counter() - self._last
        self._last = None
        return self.observe(step, dt)

    def observe(self, step: int, wall_s: float) -> Optional[StragglerEvent]:
        self.n += 1
        if self.n <= self.warmup:
            # prime the estimates
            delta = wall_s - self.mean
            self.mean += delta / self.n
            self.var += delta * (wall_s - self.mean)
            return None
        std = math.sqrt(max(self.var / max(1, self.n - 1), 1e-12))
        z = (wall_s - self.mean) / std if std > 0 else 0.0
        # EMA update AFTER scoring (a straggler must not hide itself)
        self.mean = (1 - self.alpha) * self.mean + self.alpha * wall_s
        self.var = (1 - self.alpha) * self.var + self.alpha * (wall_s - self.mean) ** 2
        if z > self.threshold:
            ev = StragglerEvent(step=step, wall_s=wall_s, zscore=z)
            self.events.append(ev)
            return ev
        return None

    def hook(self):
        def h(step: int, state, metrics) -> None:
            ev = self.end_step(step)
            self.begin_step()
            if ev is not None:
                print(
                    f"[straggler] step {ev.step}: {ev.wall_s*1e3:.1f}ms "
                    f"(z={ev.zscore:.1f}) — policy: flag for hot-spare swap"
                )

        return h


def retry(fn: Callable, attempts: int = 3, base_delay: float = 0.1,
          retryable=(IOError, OSError),
          on_retry: Optional[Callable[[int, BaseException], None]] = None):
    """Exponential-backoff retry wrapper.

    ``on_retry(attempt, exc)`` is called before each backoff sleep with
    the 1-based number of the attempt that just failed: the hook the
    collector uses to record a
    :class:`~repro_torch.core.resilience.FaultEvent` for every recovery.
    """

    def wrapped(*args, **kwargs):
        for i in range(attempts):
            try:
                return fn(*args, **kwargs)
            except retryable as e:
                if i == attempts - 1:
                    raise
                if on_retry is not None:
                    on_retry(i + 1, e)
                time.sleep(base_delay * (2 ** i))

    return wrapped


__all__ = ["Preempted", "PreemptionHandler", "StragglerEvent", "StragglerMonitor", "retry"]
