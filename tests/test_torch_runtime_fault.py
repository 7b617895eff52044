"""The port's host-side fault primitives (``repro_torch.runtime.fault``):
the preemption flag and the retry wrapper (the retry case ports
``test_runtime.py::test_retry_backoff``).
"""

import os
import signal

import pytest

from repro_torch.runtime.fault import Preempted, PreemptionHandler, retry


def test_preemption_flag_is_set_by_a_signal_and_unregister_restores():
    before = signal.getsignal(signal.SIGUSR1)
    handler = PreemptionHandler().register(signals=(signal.SIGUSR1,))
    try:
        assert not handler.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert handler.requested
    finally:
        handler.unregister()
    assert signal.getsignal(signal.SIGUSR1) == before
    assert issubclass(Preempted, RuntimeError)


def test_retry_backoff_and_on_retry():
    calls = {"n": 0}
    seen = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return "ok"

    wrapped = retry(flaky, attempts=4, base_delay=0.001,
                    on_retry=lambda attempt, exc: seen.append(attempt))
    assert wrapped() == "ok"
    assert calls["n"] == 3 and seen == [1, 2]
    with pytest.raises(IOError):
        retry(lambda: (_ for _ in ()).throw(IOError("down")), attempts=2,
              base_delay=0.001)()
