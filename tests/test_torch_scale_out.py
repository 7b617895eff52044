"""Sharded collection, fault injection and journaled resume at the port's
entry points: ``profile``, ``model`` and ``tune`` with ``--workers``,
``--inject-faults`` and ``--resume``, the session's shard pool, and the
source stamps that let a worker rebuild a spec.

Ports ``test_cli.py::test_profile_workers_matches_serial``,
``test_session.py::test_workers2_session_end_to_end_with_shard_provenance``,
``test_collection_cache.py::test_hit_strips_shard_provenance`` and
``test_model_cli.py::test_model_rerun_with_cache_is_bit_identical``.  Every
pool here is closed by the code under test, and a hung worker is expired
by a watchdog in test time.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import cli
from repro_torch import kernels as kreg
from repro_torch.core import collector as collector_mod
from repro_torch.core import model_profile
from repro_torch.core.cache import CollectionCache, spec_content_hash
from repro_torch.core.collector import ShardedCollector, _collect_shard_task, _spec_fingerprint
from repro_torch.core.resilience import ResiliencePolicy
from repro_torch.core.session import (
    ProfileSession,
    heatmaps_equal,
    load_iteration,
    profile_kernel,
)
from repro_torch.core.trace import GridSampler

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
POLICY = ResiliencePolicy(shard_timeout_s=60.0)


def _walk_in_worker(spec, ctx=None, hi=2):
    """Run the pool's task function on ``spec`` (what a worker runs)."""
    return _collect_shard_task({
        "source": spec.source,
        "fingerprint": _spec_fingerprint(spec),
        "sampler": GridSampler(None),
        "dynamic_context": ctx,
        "lo": 0, "hi": hi, "shard": 0, "max_records": 1000,
    })


# -- the CLI ------------------------------------------------------------------


def test_profile_workers_matches_serial(tmp_path, capsys):
    """--workers 2 collects through the shard pool; the stored heat map is
    bit-identical to the serial run and carries shard provenance."""
    sess = str(tmp_path / "sess")
    assert cli.main(["profile", "--kernel", "ttm", "--device", "cpu",
                     "--out", sess, "--quiet"]) == 0
    assert cli.main(["profile", "--kernel", "ttm", "--device", "cpu",
                     "--out", sess, "--workers", "2"]) == 0
    out = capsys.readouterr().out
    assert "collected in 2 shards" in out
    serial = load_iteration(os.path.join(sess, "iter0")).kernel("ttm")
    sharded = load_iteration(os.path.join(sess, "iter1")).kernel("ttm")
    assert serial.shards == () and len(sharded.shards) == 2
    assert heatmaps_equal(serial.heatmap, sharded.heatmap)


def test_profile_injected_faults_recover_bit_identically(tmp_path, capsys):
    """The acceptance command: a crash and a hang injected into the
    sharded walk of gemm:v01 at the registry's 1024^3 are recovered,
    reported, recorded, and the heat map equals the serial one."""
    sess = str(tmp_path / "sess")
    base = ["profile", "-k", "gemm:v01", "--sampler", "full", "--device",
            "cpu", "--out", sess, "-q"]
    assert cli.main(base) == 0
    assert cli.main([*base, "--workers", "2", "--inject-faults", "seed=7"]) == 0
    err = capsys.readouterr().err
    assert "fault injection armed: seed=7" in err
    # a healthy shard slower than the plan's 1.5 s watchdog (a loaded
    # host) is re-run too, so only the kinds are fixed, not their counts
    (line,) = [l for l in err.splitlines() if l.startswith("recovered faults:")]
    for kind in ("pool-rebuild", "shard-resplit", "shard-timeout", "worker-crash"):
        assert f"{kind} x" in line
    serial = load_iteration(os.path.join(sess, "iter0")).kernels[0]
    faulty = load_iteration(os.path.join(sess, "iter1")).kernels[0]
    assert heatmaps_equal(serial.heatmap, faulty.heatmap)
    manifest = json.loads((tmp_path / "sess" / "iter1" / "manifest.json").read_text())
    assert {f["kind"] for f in manifest["faults"]} == {
        "worker-crash", "pool-rebuild", "shard-timeout", "shard-resplit",
    }


def test_kernel_failure_under_workers_and_faults_exits_1(tmp_path, monkeypatch):
    """Recovery covers the walk only: a kernel that disagrees with its
    plain version ends the command with exit 1, faults armed or not."""
    entry = kreg.REGISTRY["ttm"]
    bad = dataclasses.replace(
        entry.variants[0], kernel=lambda *a, **k: entry.variants[0].plain(*a, **k) + 1
    )
    monkeypatch.setitem(
        kreg.REGISTRY, "ttm",
        dataclasses.replace(entry, variants=(bad,) + entry.variants[1:]),
    )
    argv = ["profile", "-k", "ttm", "--device", "cpu", "--out",
            str(tmp_path / "s"), "--workers", "2", "--inject-faults", "seed=7"]
    assert cli.main(argv) == 1
    assert cli.main(["tune", "ttm", "--device", "cpu", "--out",
                     str(tmp_path / "t"), "--workers", "2",
                     "--inject-faults", "seed=7"]) == 1


def test_tune_resume_needs_all_and_a_journal(tmp_path, capsys):
    out = str(tmp_path / "s")
    assert cli.main(["tune", "ttm", "--resume", "--device", "cpu", "--out", out]) == 2
    assert "--resume requires --all" in capsys.readouterr().err
    assert cli.main(["tune", "--all", "--resume", "--device", "cpu", "--out", out]) == 2
    assert "nothing to resume" in capsys.readouterr().err
    assert cli.main(["model", "transformer-tiny", "--resume", "--device",
                     "cpu", "--out", out]) == 2
    assert "nothing to resume" in capsys.readouterr().err


def _sigterm_after(n, fn):
    """Wrap ``fn`` to send this process SIGTERM after its n-th call: the
    in-process preemption hook of the tests and of the card's smoke."""
    calls = []

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(1)
        if len(calls) == n:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    return wrapped


def test_model_preempted_then_resumed_is_bit_identical(tmp_path, monkeypatch, capsys):
    """model --workers 2: SIGTERM after the first kernel exits 3 with the
    journal kept; --resume with the same flags exits 0, removes the
    journal, keeps the run measured before the preemption, and the heat
    maps equal an uninterrupted run's."""
    flags = ["model", "transformer-tiny", "--device", "cpu", "--workers", "2", "-q"]
    clean = str(tmp_path / "clean")
    assert cli.main([*flags, "--out", clean]) == 0
    sess = str(tmp_path / "s")
    monkeypatch.setattr(
        model_profile, "profile_kernel",
        _sigterm_after(1, model_profile.profile_kernel),
    )
    assert cli.main([*flags, "--out", sess]) == 3
    assert "preempted after 1/" in capsys.readouterr().err
    journal = json.loads((tmp_path / "s" / model_profile.MODEL_JOURNAL).read_text())
    partial = load_iteration(os.path.join(sess, journal["partial"]))
    assert len(partial.kernels) == 1
    monkeypatch.undo()
    assert cli.main([*flags, "--out", sess, "--resume"]) == 0
    assert not (tmp_path / "s" / model_profile.MODEL_JOURNAL).exists()
    want = load_iteration(os.path.join(clean, "iter0"))
    got = load_iteration(os.path.join(sess, "iter1"))
    assert got.layers == want.layers
    assert [pk.name for pk in got.kernels] == [pk.name for pk in want.kernels]
    for x, y in zip(got.kernels, want.kernels):
        assert heatmaps_equal(x.heatmap, y.heatmap)
    assert got.kernels[0].run == partial.kernels[0].run


def test_tune_all_preempted_then_resumed_replays_identically(tmp_path, monkeypatch, capsys):
    """tune --all --workers 2: SIGTERM during the first round exits 3 at
    the next round boundary with the run journal kept; --resume replays
    it to the trajectories of an uninterrupted run and drops the journal."""
    from repro_torch.core import tuner

    flags = ["tune", "spmv", "ttm", "--all", "--budget", "2", "--device",
             "cpu", "--workers", "2", "-q"]
    clean = str(tmp_path / "clean")
    assert cli.main([*flags, "--out", clean]) == 0
    sess = str(tmp_path / "s")
    monkeypatch.setattr(
        tuner, "profile_kernel", _sigterm_after(1, tuner.profile_kernel)
    )
    assert cli.main([*flags, "--out", sess, "--cache", str(tmp_path / "c")]) == 3
    assert (tmp_path / "s" / "tune.journal.json").exists()
    monkeypatch.undo()
    assert cli.main(["tune", "--all", "--resume", "--device", "cpu",
                     "--workers", "2", "--out", sess,
                     "--cache", str(tmp_path / "c")]) == 0
    assert not (tmp_path / "s" / "tune.journal.json").exists()
    assert "resuming journaled tune --all" in capsys.readouterr().err
    want = tuner.trajectories_from_session(ProfileSession(clean))
    got = tuner.trajectories_from_session(ProfileSession(sess))

    def steps(trajs):
        return {
            t["kernel"]: [(s["candidate"]["label"], s["accepted"]) for s in t["steps"]]
            for t in trajs
        }

    assert steps(got)["spmv"] == steps(want)["spmv"]
    assert steps(got)["ttm"] == steps(want)["ttm"]



def test_tune_all_launches_on_the_scheduler_thread_while_no_walk_runs(monkeypatch):
    """tune_all's walks overlap on its threads, but every kernel run is
    made on the calling thread, one after another, while no walk is in
    flight: no run's CUDA-event window can take in another thread's work."""
    import threading
    import time

    from repro_torch.core import tuner

    from torch_cases import small_rungs

    lock = threading.Lock()
    launches, walks, live = [], [], []
    launch, walk = tuner._TuneLoop.launch, tuner.profile_kernel

    def recorded_launch(self, cand=None):
        with lock:
            launches.append((threading.current_thread(), len(live)))
        return launch(self, cand)

    def recorded_walk(*args, **kwargs):
        with lock:
            live.append(1)
        try:
            time.sleep(0.02)  # hold the walk open long enough to be seen
            return walk(*args, **kwargs)
        finally:
            with lock:
                live.pop()
                walks.append(threading.current_thread())

    monkeypatch.setattr(tuner._TuneLoop, "launch", recorded_launch)
    monkeypatch.setattr(tuner, "profile_kernel", recorded_walk)
    res = tuner.tune_all(["gemm", "spmv"], budget=4, seed=0, device="cpu",
                         rungs=small_rungs)
    assert res.spent > 0 and len(launches) == len(walks) == res.spent + 2
    assert {t for t, _ in launches} == {threading.current_thread()}
    assert all(in_flight == 0 for _, in_flight in launches)
    assert threading.current_thread() not in walks

def test_model_rerun_with_cache_is_bit_identical(tmp_path):
    """A cached rerun (sharded this time) serves hits, and the stored heat
    maps stay bit-identical with the uncached run's."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    sess, cache = str(tmp_path / "s"), str(tmp_path / "cache")

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.cli", "model", "mamba-tiny",
             "--device", "cpu", "--out", sess, "-q", "--cache", cache, *extra],
            capture_output=True, text=True, env=env, timeout=300,
        )

    a = run()
    assert a.returncode == 0, a.stderr
    b = run("--workers", "2")
    assert b.returncode == 0, b.stderr
    assert " 0 misses" in b.stdout
    first = load_iteration(os.path.join(sess, "iter0"))
    second = load_iteration(os.path.join(sess, "iter1"))
    assert first.layers == second.layers
    for x, y in zip(first.kernels, second.kernels):
        assert heatmaps_equal(x.heatmap, y.heatmap)


# -- the session and the cache ------------------------------------------------


def test_workers2_session_end_to_end_with_shard_provenance(tmp_path):
    """workers=2 profile -> artifact -> reload: bit-identical heat map and
    intact per-shard provenance after the round trip."""
    spec, ctx = kreg.build("spmv:csr")
    serial = profile_kernel(spec, GridSampler(None), ctx)
    with ProfileSession(tmp_path / "sess", workers=2) as sess:
        pk = profile_kernel(spec, GridSampler(None), ctx,
                            collector=sess.collector())
        it = sess.add_iteration([pk])
    assert sess._collector is None  # the context closed the session's pool
    assert len(pk.shards) == 2
    assert pk.shards[0].lo == 0
    assert pk.shards[0].hi == pk.shards[1].lo
    assert sum(s.programs for s in pk.shards) == int(np.prod(pk.heatmap.grid))
    assert sum(s.records for s in pk.shards) == pk.heatmap.n_records
    assert heatmaps_equal(pk.heatmap, serial.heatmap)
    re = load_iteration(it.path).kernels[0]
    assert re.shards == pk.shards
    assert heatmaps_equal(re.heatmap, pk.heatmap)
    manifest = json.loads((it.path / "manifest.json").read_text())
    stored = manifest["kernels"][0]["heatmap"]["shards"]
    assert [s["shard"] for s in stored] == [0, 1]


def test_hit_strips_shard_provenance():
    """A sharded walk is stored in its canonical form: no shard provenance,
    the same heat map."""
    spec, ctx = kreg.build("ttm:scratch")
    cache = CollectionCache()
    with ShardedCollector(2, policy=POLICY) as sc:
        hm = profile_kernel(spec, GridSampler(None), ctx, collector=sc,
                            cache=cache).heatmap
    assert len(hm.shards) == 2
    stored = cache.get(spec_content_hash(spec, GridSampler(None), ctx))
    assert stored is not None
    assert stored.shards == () and stored.faults == ()
    assert heatmaps_equal(stored, hm)


# -- source stamps: what a worker can rebuild ---------------------------------


def test_registry_spec_carries_source_and_shards_over_the_pool(monkeypatch):
    """A registry spec from ``kernels.build`` carries its ref, and a
    2-worker collector walks it in the pool, not in process: the parent's
    shard walker is disabled and the collection still completes."""
    spec, ctx = kreg.build("gemm:v01")
    assert spec.source == "gemm:v01"
    sampler = GridSampler((0,), window=64)
    serial = collector_mod.analyze(spec, sampler, ctx)

    def in_process(*_a, **_k):
        raise AssertionError("a shard was walked in the parent process")

    monkeypatch.setattr(collector_mod, "collect_shard", in_process)
    with ShardedCollector(2, policy=POLICY) as sc:
        hm = sc.analyze(spec, sampler, ctx)
    assert len(hm.shards) == 2 and hm.faults == ()
    assert heatmaps_equal(hm, serial)


def test_tuner_rungs_and_model_triples_rebuild_in_a_worker():
    """Every spec the main path hands a collector has a source a worker
    rebuilds to the same structure: the tuner's ladder rungs (registry
    refs) and the model's kernels (``model.*`` refs at the registry's
    shapes, builder triples under overrides, and backward triples)."""
    from repro_torch.core.tuner import _build
    from repro_torch.models.registry import apply_overrides, get_model

    for ref in ("gemm:v01", "gemm:v02", "histogram:scratch", "spmv:zigzag"):
        spec, ctx = _build(kreg.get, ref)
        assert spec.source == ref
        buf, info = _walk_in_worker(spec, ctx)
        assert info.programs == 2
    entry = get_model("transformer-tiny")
    for overrides in ((), ("n_layers=1",)):
        cfg = apply_overrides(entry.config, overrides)
        found = model_profile.discover(
            "transformer-tiny", cfg, entry.batch, entry.seq, backward=True,
            default_shapes=not overrides,
        )
        assert {type(d.spec.source) for d in found} == (
            {str, tuple} if not overrides else {tuple}
        )
        for d in found:
            _, info = _walk_in_worker(d.spec)
            assert info.programs == min(2, int(np.prod(d.spec.grid)))


def test_generated_candidates_have_no_source():
    """Spec surgery has no ref a worker could rebuild: the collector
    shards it in process (same heat map, no pool)."""
    from repro_torch.core.tuner import drop_scratch_spec, transpose_spec

    gemm_spec, _ = kreg.build("gemm:v00")
    ttm_spec, _ = kreg.build("ttm:scratch")
    for cand in (
        transpose_spec(gemm_spec, "B"),
        drop_scratch_spec(ttm_spec, ttm_spec.scratch[0].name),
    ):
        assert cand is not None and cand.source is None
