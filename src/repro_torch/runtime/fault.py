"""Fault tolerance on the host: preemption and retry.

* ``PreemptionHandler`` — SIGTERM/SIGINT flips a flag; a long-running
  loop (``cuthermo model``, ``cuthermo tune --all``) sees it at its next
  boundary, leaves its work resumable and raises ``Preempted``.
* ``retry`` — exponential-backoff wrapper for transient failures; the
  sharded collector's in-process re-runs use it.

The training loop's hooks (a checkpoint on preemption, straggler
detection) come with the training loop.
"""

from __future__ import annotations

import signal
import time
from typing import Callable, Optional


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


__all__ = ["Preempted", "PreemptionHandler", "retry"]
