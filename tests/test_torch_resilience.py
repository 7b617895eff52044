"""Fault tolerance of the port's profiling pipeline (the recovery side).

Ports ``test_resilience.py``: the resilience primitives (FaultEvent
provenance, policy backoff), the sharded collector's recovery loop under
*injected* faults (worker crash -> pool rebuild, shard hang -> watchdog ->
in-process resplit), and the tuner's fault tolerance (candidate failures
skipped, preemption at round boundaries, resume-by-replay determinism).
A recovered collection is bit-identical to a clean one.  Pools run under
a fault plan's watchdog (1.5 s) and are closed by their ``with`` blocks.
"""

import os
import struct

import pytest

from repro_torch.core import tuner as tuner_mod
from repro_torch.core.collector import ShardedCollector, analyze, sourced_spec
from repro_torch.core.faultinject import FaultPlan
from repro_torch.core.resilience import (
    DEFAULT_POLICY,
    FAULT_KINDS,
    FaultEvent,
    ResiliencePolicy,
    summarize_faults,
)
from repro_torch.core.session import heatmaps_equal
from repro_torch.core.trace import GridSampler
from repro_torch.runtime.fault import Preempted

from torch_cases import small_rungs

GEMM = "repro_torch.kernels.gemm:gemm_v01_spec"


# -- primitives --------------------------------------------------------------


def test_fault_event_dict_roundtrip():
    ev = FaultEvent(kind="shard-timeout", where="collector", shard=3,
                    attempt=1, wall_s=0.25, detail="hung past watchdog")
    assert FaultEvent.from_dict(ev.as_dict()) == ev
    sparse = FaultEvent.from_dict({"kind": "worker-crash"})
    assert sparse.shard == -1 and sparse.where == "collector"
    assert sparse.attempt == 0 and sparse.detail == ""


def test_fault_kinds_closed_set():
    for kind in ("worker-crash", "shard-timeout", "pool-rebuild",
                 "shard-resplit", "serial-fallback", "cache-corrupt",
                 "torn-iteration", "candidate-failure"):
        assert kind in FAULT_KINDS


def test_policy_backoff_is_exponential():
    p = ResiliencePolicy(base_delay=0.1)
    assert p.backoff_s(1) == pytest.approx(0.1)
    assert p.backoff_s(2) == pytest.approx(0.2)
    assert p.backoff_s(3) == pytest.approx(0.4)
    assert DEFAULT_POLICY.attempts >= 2  # retries actually happen


def test_summarize_faults():
    assert summarize_faults(()) == "no faults"
    events = (
        FaultEvent(kind="worker-crash"),
        FaultEvent(kind="shard-timeout"),
        FaultEvent(kind="worker-crash"),
    )
    assert summarize_faults(events) == "shard-timeout x1, worker-crash x2"


# -- collector recovery under injected faults --------------------------------


def test_injected_crash_and_hang_recover_bit_identically():
    """The default plan's crash -> rebuild then hang -> watchdog ->
    resplit sequence converges to a heat map bit-identical to a clean
    serial walk, every recovery recorded as FaultEvent provenance."""
    spec = sourced_spec(GEMM, 256, 256, 256)
    clean = analyze(spec, sampler=GridSampler(None))
    with ShardedCollector(2, fault_plan=FaultPlan.parse("seed=7")) as sc:
        hm = sc.analyze(spec, GridSampler(None))
    assert heatmaps_equal(clean, hm)  # faults excluded from equality
    kinds = [e.kind for e in hm.faults]
    assert "worker-crash" in kinds and "pool-rebuild" in kinds
    assert "shard-timeout" in kinds and "shard-resplit" in kinds
    victim = FaultPlan.parse("seed=7").victim_shard(spec.name, 2)
    assert all(
        e.shard in (victim, -1) and e.kind in FAULT_KINDS for e in hm.faults
    )


def test_timeout_only_plan_and_clean_pool():
    spec = sourced_spec(GEMM, 256, 256, 256)
    clean = analyze(spec, sampler=GridSampler(None))
    plan = FaultPlan.parse("seed=3,crashes=0")
    with ShardedCollector(2, fault_plan=plan) as sc:
        hm = sc.analyze(spec, GridSampler(None))
    assert heatmaps_equal(clean, hm)
    assert "shard-timeout" in [e.kind for e in hm.faults]
    assert "worker-crash" not in [e.kind for e in hm.faults]
    # a plan-free pool records no fault provenance at all
    with ShardedCollector(2, policy=ResiliencePolicy(shard_timeout_s=60.0)) as sc:
        hm2 = sc.analyze(spec, GridSampler(None))
    assert heatmaps_equal(clean, hm2) and hm2.faults == ()


def test_killing_a_pool_ends_its_manager_thread_past_half_a_result():
    """A worker killed while it sends a result leaves half a message in the
    result pipe; the pool's manager thread must still end, or the
    interpreter's exit blocks on it."""
    sc = ShardedCollector(2)
    pool = sc._ensure_pool()
    assert list(pool.map(abs, [-1, -2])) == [1, 2]  # workers and manager up
    manager = pool._executor_manager_thread
    # a result header promising 1 MiB, then 8 bytes of it
    os.write(pool._result_queue._writer.fileno(), struct.pack("!i", 1 << 20) + b"x" * 8)
    sc._kill_pool()
    manager.join(30)
    assert not manager.is_alive()


# -- tuner fault tolerance ---------------------------------------------------


class AfterN:
    """Preemption stub: ``requested`` flips true after n polls."""

    def __init__(self, n):
        self.n = n
        self.checks = 0

    @property
    def requested(self):
        self.checks += 1
        return self.checks > self.n


def test_tune_skips_failed_candidate_and_records_fault(monkeypatch):
    """A candidate whose re-profile raises is skipped (never re-proposed,
    no budget consumed), recorded as a candidate-failure FaultEvent, and
    the run still completes."""
    real = tuner_mod.profile_kernel
    failed = []

    def flaky(spec, sampler, ctx=None, **kw):
        # fail exactly one candidate profile (the baseline runs first)
        if not failed and kw.get("variant") != "v00":
            failed.append(kw.get("variant"))
            raise RuntimeError("injected candidate profile failure")
        return real(spec, sampler, ctx, **kw)

    monkeypatch.setattr(tuner_mod, "profile_kernel", flaky)
    res = tuner_mod.tune("gemm", budget=2, seed=0, device="cpu",
                         rungs=small_rungs)
    assert failed, "no candidate was ever profiled"
    assert len(res.faults) == 1
    ev = res.faults[0]
    assert ev.kind == "candidate-failure" and ev.where == "tuner"
    assert failed[0] in ev.detail
    assert failed[0] not in [s.candidate.label for s in res.steps]
    assert "faults" in res.as_dict()
    assert "candidate profile(s) failed" in res.summary()


def test_tune_reraises_preemption(monkeypatch):
    real = tuner_mod.profile_kernel
    calls = []

    def preempting(spec, sampler, ctx=None, **kw):
        calls.append(kw.get("variant"))
        if len(calls) > 1:  # let the baseline through
            raise Preempted("injected")
        return real(spec, sampler, ctx, **kw)

    monkeypatch.setattr(tuner_mod, "profile_kernel", preempting)
    with pytest.raises(Preempted):
        tuner_mod.tune("gemm", budget=2, seed=0, device="cpu",
                       rungs=small_rungs)


def test_tune_all_preempts_at_round_boundary_and_replays_identically():
    """SIGTERM semantics: tune_all stops between rounds with Preempted,
    and replaying the same arguments (same seed and budget, shared cache)
    gives per-family trajectories identical to an uninterrupted run."""
    from repro_torch.core.cache import CollectionCache

    def traj(res):
        return {
            r.kernel: [(s.candidate.label, s.accepted) for s in r.steps]
            for r in res.results
        }

    opts = dict(budget=4, seed=0, device="cpu", rungs=small_rungs)
    cache = CollectionCache()
    clean = tuner_mod.tune_all(["gemm", "spmv"], cache=cache, **opts)
    assert clean.spent > 0

    cache2 = CollectionCache()
    with pytest.raises(Preempted, match="round boundary"):
        tuner_mod.tune_all(["gemm", "spmv"], cache=cache2,
                           preemption=AfterN(1), **opts)
    resumed = tuner_mod.tune_all(["gemm", "spmv"], cache=cache2, **opts)
    assert traj(resumed) == traj(clean)
    assert [r.best_label for r in resumed.results] == [
        r.best_label for r in clean.results
    ]
    assert cache2.stats.hits > 0  # the replay re-used the first run's walks
