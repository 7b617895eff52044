"""The port's deterministic fault-injection harness (the injection side).

Ports ``test_faultinject.py``: ``FaultPlan`` parsing, determinism and
directive sequencing, the disk-state injections (cache corruption ->
quarantine, torn artifact writes -> ``ProfileSession.recover()``), and
the crash-safe session commit protocol they exercise.  Recovery under
*live* injected pool faults is pinned in ``test_torch_resilience.py``.
"""

import pytest

from repro_torch.core.cache import CollectionCache
from repro_torch.core.collector import analyze, sourced_spec
from repro_torch.core.faultinject import (
    FaultInjectError,
    FaultPlan,
    InjectedKill,
    WriteKillPoint,
    apply_worker_directive,
    corrupt_cache_entry,
)
from repro_torch.core.resilience import ResiliencePolicy
from repro_torch.core.session import (
    JOURNAL_NAME,
    ProfileSession,
    heatmaps_equal,
    load_iteration,
    profile_kernel,
)
from repro_torch.core.trace import GridSampler

GEMM = "repro_torch.kernels.gemm"


# -- FaultPlan parsing -------------------------------------------------------


def test_parse_bare_seed_and_keys():
    assert FaultPlan.parse("7") == FaultPlan(seed=7)
    plan = FaultPlan.parse("seed=3, crashes=0, timeouts=1, "
                           "hang=5.5, watchdog=0.4")
    assert plan == FaultPlan(seed=3, crashes=0, timeouts=1,
                             hang_s=5.5, watchdog_s=0.4)
    assert "seed=3" in plan.describe() and "crashes=0" in plan.describe()


@pytest.mark.parametrize("bad", [
    "", "bogus=1", "seed", "seed=x", "crashes=2", "timeouts=-1",
])
def test_parse_rejects_malformed_specs(bad):
    with pytest.raises(FaultInjectError):
        FaultPlan.parse(bad)


def test_plan_policy_tightens_watchdog_only():
    base = ResiliencePolicy(attempts=5, shard_timeout_s=300.0)
    tight = FaultPlan(watchdog_s=0.8).policy(base)
    assert tight.shard_timeout_s == 0.8
    assert tight.attempts == 5  # everything else inherits


# -- directive sequencing ----------------------------------------------------


def test_victim_shard_deterministic_and_in_range():
    plan = FaultPlan(seed=7)
    v = plan.victim_shard("gemm_v01", 4)
    assert v == plan.victim_shard("gemm_v01", 4)
    assert 0 <= v < 4
    assert len({
        FaultPlan(seed=s).victim_shard("gemm_v01", 4) for s in range(16)
    }) > 1


def test_directive_sequencing_crash_then_hang():
    plan = FaultPlan(seed=7, crashes=1, timeouts=1, hang_s=9.0)
    victim = plan.victim_shard("k", 2)
    other = 1 - victim
    assert plan.directive("k", 2, victim, 0) == {"kind": "crash"}
    assert plan.directive("k", 2, victim, 1) == {"kind": "hang", "sleep_s": 9.0}
    assert plan.directive("k", 2, victim, 2) is None
    for attempt in range(3):
        assert plan.directive("k", 2, other, attempt) is None
    # with the crash disabled, the hang moves up to the first delivery
    hang_only = FaultPlan(seed=7, crashes=0, timeouts=1)
    assert plan.victim_shard("k", 2) == hang_only.victim_shard("k", 2)
    assert hang_only.directive("k", 2, victim, 0)["kind"] == "hang"
    assert hang_only.directive("k", 2, victim, 1) is None


def test_apply_worker_directive_noop_hang_and_unknown():
    apply_worker_directive(None)
    apply_worker_directive({"kind": "hang", "sleep_s": 0.0})
    with pytest.raises(FaultInjectError, match="unknown worker directive"):
        apply_worker_directive({"kind": "meltdown"})


# -- cache corruption -> quarantine ------------------------------------------


def _heatmap():
    spec = sourced_spec(f"{GEMM}:gemm_v00_spec", 128, 128, 128)
    return analyze(spec, sampler=GridSampler(None))


@pytest.mark.parametrize("mode", ["truncate", "garbage", "meta"])
def test_corrupt_entry_is_quarantined_not_fatal(tmp_path, mode):
    cache = CollectionCache(tmp_path / "cache")
    hm = _heatmap()
    cache.put("deadbeef01", hm)
    assert heatmaps_equal(cache.get("deadbeef01"), hm)

    corrupt_cache_entry(cache, "deadbeef01", mode=mode)
    with pytest.warns(RuntimeWarning, match="quarantine"):
        assert cache.get("deadbeef01") is None  # a miss, never an error
    assert cache.stats.corrupt == 1
    qdir = tmp_path / "cache" / "quarantine"
    assert qdir.is_dir() and any(qdir.iterdir())
    npz_path, _ = cache._entry_paths("deadbeef01")
    assert not npz_path.exists()
    cache.put("deadbeef01", hm)
    assert heatmaps_equal(cache.get("deadbeef01"), hm)


def test_corrupt_cache_entry_rejects_unknown_mode(tmp_path):
    cache = CollectionCache(tmp_path / "cache")
    cache.put("deadbeef01", _heatmap())
    with pytest.raises(FaultInjectError, match="corruption mode"):
        corrupt_cache_entry(cache, "deadbeef01", mode="cosmic-rays")


# -- torn artifact writes -> recover() ---------------------------------------


@pytest.fixture(scope="module")
def kernels():
    a = profile_kernel(
        sourced_spec(f"{GEMM}:gemm_v01_spec", 128, 128, 128), GridSampler(None)
    )
    b = profile_kernel(
        sourced_spec(f"{GEMM}:gemm_v00_spec", 128, 128, 128), GridSampler(None)
    )
    return [a, b]


def test_injected_kill_is_base_exception():
    assert issubclass(InjectedKill, BaseException)
    assert not issubclass(InjectedKill, Exception)
    with pytest.raises(FaultInjectError):
        WriteKillPoint(kill_at="eventually")


def test_kill_before_manifest_quarantines_torn_iteration(tmp_path, kernels):
    sess = ProfileSession(tmp_path / "s")
    with pytest.raises(InjectedKill):
        with WriteKillPoint(after_files=1):
            sess.add_iteration(kernels, label="torn")
    d = tmp_path / "s" / "iter0"
    assert (d / JOURNAL_NAME).exists()
    assert not (d / "manifest.json").exists()

    events = sess.recover()
    assert [e.kind for e in events] == ["torn-iteration"]
    assert not d.exists()
    assert (tmp_path / "s" / "quarantine" / "iter0").is_dir()
    assert sess.iteration_names() == []
    it = sess.add_iteration(kernels, label="retry")
    assert it.path.name == "iter0"
    assert heatmaps_equal(
        load_iteration(it.path).kernels[0].heatmap, kernels[0].heatmap
    )


def test_kill_with_manifest_staged_recovers_to_complete(tmp_path, kernels):
    """The fsync'd-but-not-renamed manifest: recover() finishes the rename
    instead of discarding a fully durable iteration."""
    sess = ProfileSession(tmp_path / "s")
    with pytest.raises(InjectedKill):
        with WriteKillPoint(after_files=2, kill_at="staged"):
            sess.add_iteration(kernels, label="staged")
    d = tmp_path / "s" / "iter0"
    assert (d / "manifest.json.tmp").exists()
    assert not (d / "manifest.json").exists()

    events = sess.recover()
    assert [e.kind for e in events] == ["torn-iteration"]
    it = sess.iteration(0)
    assert it.label == "staged"
    assert heatmaps_equal(it.kernels[0].heatmap, kernels[0].heatmap)
    assert not (d / JOURNAL_NAME).exists()


def test_kill_after_manifest_commit_only_drops_journal(tmp_path, kernels):
    sess = ProfileSession(tmp_path / "s")
    with pytest.raises(InjectedKill):
        with WriteKillPoint(after_files=3):
            sess.add_iteration(kernels, label="late")
    d = tmp_path / "s" / "iter0"
    assert (d / "manifest.json").exists() and (d / JOURNAL_NAME).exists()

    sess.recover()
    assert sess.iteration(0).label == "late"
    assert not (d / JOURNAL_NAME).exists()


def test_recover_on_clean_session_is_a_noop(tmp_path, kernels):
    sess = ProfileSession(tmp_path / "s")
    sess.add_iteration(kernels, label="clean")
    assert sess.recover() == []
    assert sess.iteration(0).label == "clean"
