"""The port's autotuner: moves, candidates, the loop, and its trajectories.

Ports ``test_tuner.py``.  Under ``TPUTile`` the tuner runs on the JAX
package's rungs (``reference_rungs``: each spec through ``to_port_spec``),
and its trajectories equal the reference's per seed, step for step.
Under ``H100Sector`` it runs on the port's registry at the registry's
shapes, launching each kernel-bearing rung on the CPU here (the plain
version; ``--device cpu``), and the GEMM trajectory is pinned.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.kernels as rk
from repro.core import tuner as ref_tuner
from repro.kernels import gemm as ref_gemm
from repro.kernels import gramschm as ref_gramschm
from repro.kernels import spmv as ref_spmv
from repro.kernels import ttm as ref_ttm
from repro_torch import kernels as kreg
from repro_torch.core.advisor import Action
from repro_torch.core.cache import CollectionCache, spec_content_hash
from repro_torch.core.collector import KernelSpec, OperandSpec, analyze
from repro_torch.core.patterns import MISALIGNMENT, detect_all
from repro_torch.core.session import (
    TPU_ARTIFACT_VERSION,
    ProfileSession,
    heatmaps_equal,
    profile_kernel,
)
from repro_torch.core.trace import GridSampler
from repro_torch.core.tuner import (
    SMEM_PIN_DEFAULT_BYTES,
    VMEM_PIN_BUDGET_BYTES,
    TuneError,
    align_spec,
    candidates_for_action,
    drop_scratch_spec,
    ladder_candidates,
    pin_budget_bytes,
    pin_spec,
    retile_spec,
    transpose_spec,
    trajectories_from_session,
    tune,
    tune_all,
)

from torch_parity import reference_rungs, to_port_spec

FULL = GridSampler(None)


def _action(kind, region, pattern="hot", saving=0.5, params=()):
    return Action(kind=kind, region=region, pattern=pattern, description="synthetic",
                  est_transaction_saving=saving, params=params)


def _tpu_tune(family, **kw):
    return tune(family, rungs=reference_rungs, device="cpu", **kw)


def _sig(res):
    return [(s.candidate.label, s.accepted, s.transactions, s.diff.verdict,
             s.diff.fixed, s.diff.introduced) for s in res.steps]


# -- TPUTile: the reference's trajectories, per seed ---------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", list(rk.names()))
def test_trajectory_equals_the_reference_per_seed(family, seed):
    want = ref_tuner.tune(family, budget=8, seed=seed)
    got = _tpu_tune(family, budget=8, seed=seed)
    assert _sig(got) == _sig(want)
    assert got.best_label == want.best_label
    assert (got.final.tx_before, got.final.tx_after) == (want.final.tx_before, want.final.tx_after)
    assert got.final.fixed == want.final.fixed
    assert got.converged == want.converged
    assert [d["label"] for d in got.static_skipped] == [d["label"] for d in want.static_skipped]


def test_gemm_trajectory_is_the_recorded_one():
    """``BENCH_tune.json``: gemm 1,064,960 -> 8,224 transfers via pin(A),
    converged, three patterns fixed."""
    res = _tpu_tune("gemm", budget=8, seed=0)
    assert (res.final.tx_before, res.final.tx_after) == (1064960, 8224)
    assert res.best_label == "pin(A)" and res.converged
    assert len(res.fixed_patterns) == 3
    assert res.steps[0].candidate.label == "ladder:v01"


# -- every Action.kind produces at least one candidate ----------------------------


@pytest.mark.parametrize(
    "kind,pattern,region,spec_fn",
    [
        ("retile", "false-sharing", "C", lambda: ref_gemm.gemm_v00_spec(256, 256, 256)),
        ("vmem_pin", "hot", "B", lambda: ref_gemm.gemm_v00_spec(256, 256, 256)),
        ("reorder_grid", "hot-random", "x", lambda: ref_spmv.spmv_csr_spec(8192, 4096)),
        ("pad_align", "misalignment", "rowOffsets_shift1",
         lambda: ref_spmv.spmv_csr_spec(8192, 4096)),
        ("drop_scratch", "scratch-abuse", "Y_shr", lambda: ref_ttm.ttm_scratch_spec(512, 8, 32)),
        ("transpose", "strided", "q",
         lambda: ref_gramschm.k3_naive_block_spec(512, 512, 512, k=3)),
        # 1-D data-dependent strided region: falls back to the pin/stage fix
        ("transpose", "strided", "q", lambda: ref_gramschm.k3_naive_spec(512, 512, 512, k=3)),
    ],
)
def test_every_action_kind_yields_a_candidate(kind, pattern, region, spec_fn):
    spec = to_port_spec(spec_fn())
    cands = candidates_for_action(_action(kind, region, pattern), spec)
    want = ref_tuner.candidates_for_action(
        ref_tuner.Action(kind=kind, region=region, pattern=pattern,
                         description="synthetic", est_transaction_saving=0.5),
        spec_fn(),
    )
    assert [c.label for c in cands] == [c.label for c in want] != []
    for c in cands:
        built, _ctx = c.build()
        assert isinstance(built, KernelSpec) and built.source is None
        assert analyze(built, sampler=FULL).sector_transactions() >= 0


def test_candidates_carry_action_provenance():
    act = _action("retile", "C", "false-sharing", saving=0.9)
    (cand, *_rest) = candidates_for_action(act, to_port_spec(ref_gemm.gemm_v00_spec(256, 256, 256)))
    prov = cand.provenance()
    json.dumps(prov)
    assert prov["action"]["kind"] == "retile" and prov["action"]["region"] == "C"
    assert prov["source"] == "generated"
    assert cand.predicted_saving == act.est_transaction_saving


# -- generated-spec surgery is exact --------------------------------------------------


def test_retile_matches_handwritten_v01():
    """Under TPUTile the generated retile of gemm v00 is the hand-written
    v01 fix."""
    retiled = retile_spec(to_port_spec(ref_gemm.gemm_v00_spec(512, 512, 512)), "C", 8)
    assert retiled is not None and retiled.grid == (64,)
    hm_gen = analyze(retiled, sampler=FULL)
    hm_ref = analyze(to_port_spec(ref_gemm.gemm_v01_spec(512, 512, 512, bm=8)), sampler=FULL)
    assert hm_gen.sector_transactions() == hm_ref.sector_transactions()
    for ra, rb in zip(hm_gen.regions, hm_ref.regions):
        assert np.array_equal(ra.tags_array, rb.tags_array)
        assert np.array_equal(ra.sector_temps_array, rb.sector_temps_array)


def test_retile_refuses_unknown_region_and_exotic_maps():
    spec = to_port_spec(ref_gemm.gemm_v00_spec(256, 256, 256))
    assert retile_spec(spec, "nope", 8) is None
    assert retile_spec(spec, "C", 3) is None  # 256 % 3 != 0
    strided = dataclasses.replace(
        spec,
        operands=tuple(
            dataclasses.replace(op, index_map=lambda i: (2 * i, 0)) if op.name == "C" else op
            for op in spec.operands
        ),
    )
    assert retile_spec(strided, "C", 8) is None
    piecewise = dataclasses.replace(
        spec,
        operands=tuple(
            dataclasses.replace(op, index_map=lambda i: (min(int(i), 7), 0))
            if op.name == "C" else op
            for op in spec.operands
        ),
    )
    assert retile_spec(piecewise, "C", 8) is None  # identity only on a prefix


def test_retile_has_no_sector_meaning():
    """Under H100Sector a warp's lanes, not its block rows, set which words
    of a sector it owns: retile proposes nothing, and says so."""
    from repro_torch.core.tuner import silent_moves

    spec = to_port_spec(ref_gemm.gemm_v00_spec(256, 256, 256), geometry_kind="h100-sector")
    assert retile_spec(spec, "C", 8) is None
    act = _action("retile", "C", "false-sharing")
    assert [c.variant for c in candidates_for_action(act, spec)] == ["transpose"]
    assert silent_moves(act, spec) == ["retile(C)"]
    tpu = to_port_spec(ref_gemm.gemm_v00_spec(256, 256, 256))
    assert silent_moves(act, tpu) == []


def test_align_spec_fixes_misalignment():
    spec = to_port_spec(ref_spmv.spmv_csr_spec(8192, 4096))
    before = analyze(spec, sampler=FULL)
    assert any(r.pattern == MISALIGNMENT and r.region == "rowOffsets_shift1"
               for r in detect_all(before))
    aligned = align_spec(spec, "rowOffsets_shift1")
    after = analyze(aligned, sampler=FULL)
    assert not any(r.pattern == MISALIGNMENT and r.region == "rowOffsets_shift1"
                   for r in detect_all(after))
    assert after.sector_transactions() < before.sector_transactions()
    assert align_spec(spec, "rowOffsets") is None


def test_drop_scratch_removes_the_region():
    spec = to_port_spec(ref_ttm.ttm_scratch_spec(512, 8, 32))
    dropped = drop_scratch_spec(spec, "Y_shr")
    assert dropped is not None and dropped.scratch == ()
    assert "Y_shr" not in analyze(dropped, sampler=FULL).region_names()
    assert drop_scratch_spec(spec, "vals") is None


def test_pin_only_loads_within_vmem_budget():
    spec = to_port_spec(ref_gemm.gemm_v00_spec(256, 256, 256))
    pinned = pin_spec(spec, "B")
    assert next(o for o in pinned.operands if o.name == "B").once
    assert analyze(pinned, sampler=FULL).sector_transactions() < analyze(
        spec, sampler=FULL).sector_transactions()
    assert pin_spec(spec, "C") is None  # a store must cross back to memory
    n = int(np.sqrt(VMEM_PIN_BUDGET_BYTES / 4)) + 256
    big = KernelSpec(name="big", grid=(4,), operands=(
        OperandSpec("W", (n, n), np.float32, (n, n), lambda i: (0, 0),
                    geometry_kind="tpu-tile"),))
    assert pin_spec(big, "W") is None


def test_pin_budget_under_h100_is_the_shared_memory_limit():
    """Without a card the budget is the documented 232,448 B, the per-block
    shared memory an H100 grants (kernels/ssd.py's limit): 56 K floats
    pin, 64 K do not."""
    assert SMEM_PIN_DEFAULT_BYTES == kreg.ssd.MAX_SMEM == 232_448
    assert pin_budget_bytes("tpu-tile") == VMEM_PIN_BUDGET_BYTES
    assert pin_budget_bytes("h100-sector") == SMEM_PIN_DEFAULT_BYTES  # no card here

    def spec(n):
        return KernelSpec(name="k", grid=(4,), operands=(
            OperandSpec("W", (n,), np.float32, (n,), lambda i: (0,)),))

    assert pin_spec(spec(56 * 1024), "W") is not None
    assert pin_spec(spec(64 * 1024), "W") is None
    # the registry's 1024^2 GEMM operands (4 MiB) never pin on the card
    assert pin_spec(kreg.build("gemm:v00")[0], "A") is None


def test_transpose_turns_column_block_into_row_block():
    spec = to_port_spec(ref_gramschm.k3_naive_block_spec(512, 512, 512, k=3))
    t = transpose_spec(spec, "q")
    q = next(o for o in t.operands if o.name == "q")
    assert q.shape == (512, 512) and q.block_shape == (1, 512)
    assert analyze(t, sampler=FULL).sector_transactions("q") < analyze(
        spec, sampler=FULL).sector_transactions("q")


# -- ladder candidates round-trip through the registry --------------------------------


def test_ladder_candidates_round_trip_kernels_build():
    for name in kreg.names():
        entry = kreg.get(name)
        cands = ladder_candidates(entry, frozenset(), [], min_position=0)
        assert len(cands) == sum(1 for v in entry.variants if v.role == "optimized")
        for c in cands:
            assert c.ref and c.source == "ladder"
            spec, ctx = c.build()
            spec2, ctx2 = kreg.build(c.ref)
            assert spec_content_hash(spec, dynamic_context=ctx) == spec_content_hash(
                spec2, dynamic_context=ctx2)


def test_ladder_is_walked_forward():
    cands = ladder_candidates(kreg.get("gemm"), frozenset(), [], min_position=2)
    assert [c.variant for c in cands] == ["v02"]  # v01 is behind the floor


def test_ladder_rungs_default_to_the_port_registry():
    (cand,) = ladder_candidates(kreg.get("gramschm"), frozenset(), [])
    assert cand.build()[0].operands[0].geometry_kind == "h100-sector"
    (cand,) = ladder_candidates(reference_rungs("gramschm"), frozenset(), [],
                                rungs=reference_rungs)
    assert cand.build()[0].operands[0].geometry_kind == "tpu-tile"


# -- the loop -----------------------------------------------------------------------------


def test_tune_closes_the_loop_on_gemm():
    res = _tpu_tune("gemm", budget=4, seed=0)
    assert res.improved and res.fixed_patterns
    assert res.best.transactions == res.final.tx_after
    assert 1 <= len(res.steps) <= 4
    json.dumps(res.as_dict())
    assert "tune: gemm" in res.summary()


def test_tune_is_deterministic_under_a_fixed_seed():
    a = _tpu_tune("gemm", budget=3, seed=123)
    b = _tpu_tune("gemm", budget=3, seed=123)
    assert _sig(a) == _sig(b)
    assert a.ranked()[0].candidate.label == b.ranked()[0].candidate.label


def test_tune_budget_zero_returns_baseline():
    res = _tpu_tune("gemm", budget=0)
    assert res.steps == () and res.best_label == "baseline"
    assert not res.improved and not res.converged


def test_tune_target_pattern_filters_actions():
    res = _tpu_tune("gemm", budget=2, target_patterns=["false-sharing"])
    assert res.improved and res.converged
    assert all(p == "false-sharing" for _r, p in res.fixed_patterns)


def test_tune_scratch_abuse_accepted_at_equal_traffic():
    res = _tpu_tune("ttm", budget=2)
    assert not res.improved  # equal transfers by design
    assert ("Y_shr", "scratch-abuse") in res.fixed_patterns
    assert res.best_label != "baseline"


def test_tune_unknown_kernel_raises():
    with pytest.raises(TuneError):
        tune("definitely-not-a-kernel", device="cpu")


# -- session persistence -------------------------------------------------------------------


def test_tune_persists_trajectory_with_provenance(tmp_path):
    sess = ProfileSession(tmp_path / "sess")
    res = sess.tune("gramschm", budget=2, rungs=reference_rungs, device="cpu")
    assert len(sess.iteration_names()) == 1 + len(res.steps)
    it0 = sess.iteration(0)
    assert it0.tuning["role"] == "baseline" and it0.tuning["family"] == "gramschm"
    it1 = sess.iteration(1)
    assert it1.tuning["role"] == "candidate"
    cand = it1.tuning["candidate"]
    assert cand["label"] == res.steps[0].candidate.label
    assert cand["action"] is not None and "kind" in cand["action"]
    assert it1.tuning["verdict"] == res.steps[0].diff.verdict
    manifest = json.loads((it1.path / "manifest.json").read_text())
    assert manifest["version"] == TPU_ARTIFACT_VERSION == 6
    assert manifest["tuning"]["candidate"]["label"] == cand["label"]
    (traj,) = trajectories_from_session(ProfileSession(tmp_path / "sess", create=False))
    assert traj["kernel"] == "gramschm" and traj["improved"] == res.improved
    assert traj["baseline"]["transactions"] == res.baseline.transactions
    assert traj["best"]["transactions"] == res.best.transactions
    assert len(traj["steps"]) == len(res.steps)


def test_retuning_same_family_yields_separate_trajectories(tmp_path):
    sess = ProfileSession(tmp_path / "sess")
    r1 = sess.tune("ttm", budget=1, rungs=reference_rungs, device="cpu")
    r2 = sess.tune("ttm", budget=1, rungs=reference_rungs, device="cpu")
    trajs = trajectories_from_session(ProfileSession(tmp_path / "sess", create=False))
    assert [t["kernel"] for t in trajs] == ["ttm", "ttm"]
    assert trajs[0]["run"] != trajs[1]["run"]
    for traj, res in zip(trajs, (r1, r2)):
        assert traj["candidates_tried"] == len(res.steps)
        assert traj["best"]["transactions"] == res.best.transactions
    assert trajs[0]["best"]["iteration"] in {
        s["iteration"] for s in trajs[0]["steps"] if s["accepted"]
    } | {trajs[0]["baseline"]["iteration"]}


def test_non_tuned_iterations_have_no_tuning(tmp_path):
    from repro_torch.kernels.gemm import gemm_v00_spec

    sess = ProfileSession(tmp_path / "sess")
    it = sess.add_iteration([profile_kernel(gemm_v00_spec(128, 128, 128))])
    assert it.tuning is None
    assert trajectories_from_session(sess) == []


# -- tune_all, serially -----------------------------------------------------------------------


def test_tune_all_single_family_matches_serial():
    serial = _tpu_tune("gramschm", budget=3, seed=7)
    (res,) = tune_all(["gramschm"], budget=3, seed=7, rungs=reference_rungs,
                      device="cpu").results
    assert _sig(res) == _sig(serial) and res.best_label == serial.best_label


def test_tune_all_equals_the_reference_schedule():
    """One global budget over the reference's families: the same spend,
    rounds and per-family trajectories as the JAX package's scheduler."""
    fams = ["gemm", "spmv", "histogram", "gramschm", "ttm", "ragged_flash", "paged_attn"]
    want = ref_tuner.tune_all(fams, budget=12, seed=0)
    got = tune_all(fams, budget=12, seed=0, rungs=reference_rungs, device="cpu")
    assert (got.spent, got.rounds) == (want.spent, want.rounds)
    assert [_sig(r) for r in got.results] == [_sig(r) for r in want.results]


def test_tune_all_enforces_one_global_budget():
    res = tune_all(["gramschm", "ttm"], budget=2, seed=0, rungs=reference_rungs, device="cpu")
    assert res.spent == 2 and [len(r.steps) for r in res.results] == [1, 1]
    assert res.rounds == 1


def test_tune_all_budget_zero_profiles_baselines_only():
    res = tune_all(["gramschm", "ttm"], budget=0, seed=0, rungs=reference_rungs, device="cpu")
    assert res.spent == 0 and all(not r.steps for r in res.results)
    assert all(r.best_label == "baseline" for r in res.results)


def test_tune_all_empty_family_list_raises():
    with pytest.raises(TuneError):
        tune_all([], budget=2, device="cpu")


def test_tune_all_persists_linked_provenance(tmp_path):
    sess = ProfileSession(tmp_path / "sess")
    res = tune_all(["gramschm", "ttm"], budget=2, seed=0, session=sess,
                   rungs=reference_rungs, device="cpu")
    assert sess.iteration_names() == ["iter0", "iter1", "iter2", "iter3"]
    assert sess.iteration(0).tuning["family"] == "gramschm"
    assert sess.iteration(1).tuning["family"] == "ttm"
    for r in res.results:
        assert r.baseline_iteration
        for s in r.steps:
            it = sess.iteration(s.iteration)
            assert it.tuning["baseline"] == r.baseline_iteration
            assert it.tuning["candidate"]["label"] == s.candidate.label


def test_tune_all_shared_cache_bounds_fresh_traces(tmp_path):
    cache = CollectionCache(tmp_path / "cache")
    tune_all(["gramschm", "ttm"], budget=2, seed=0, cache=cache,
             rungs=reference_rungs, device="cpu")
    before = cache.stats.misses
    res = tune_all(["gramschm", "ttm"], budget=2, seed=0, cache=cache,
                   rungs=reference_rungs, device="cpu")
    assert cache.stats.misses == before
    assert cache.stats.hits >= res.spent + len(res.results)


# -- H100Sector: the port's own registry ---------------------------------------------------------


def test_h100_gemm_trajectory_is_pinned_and_a_warm_retune_is_bit_identical(tmp_path):
    """ROADMAP queue 3 item 1, decided: under H100Sector at the registry's
    1024^3 float32 the ladder direction survives.  v00 -> v01 is accepted
    first (false sharing on B and C fixed), then v02; pin(A) does not fit
    a block's shared memory and retile has no sector meaning.  Every rung
    launches its kernel (the plain version on the CPU) and stores the run;
    a warm re-tune walks nothing, gives the same heat maps, and measures
    the runs again."""
    cache = CollectionCache()
    cold = tune("gemm", budget=3, seed=0, device="cpu", cache=cache)
    assert [(s.candidate.label, s.accepted, s.transactions) for s in cold.steps] == [
        ("ladder:v01", True, 138543104),
        ("ladder:v02", True, 3276800),
    ]
    assert cold.baseline.transactions == 168820736
    assert set(cold.steps[0].diff.fixed) == {("B", "false-sharing"), ("C", "false-sharing")}
    # v00's B is hot beside its false sharing (the hot rule reads sharing
    # on words), so v01 introduces nothing
    assert cold.steps[0].diff.introduced == ()
    assert ("B", "hot") in cold.steps[0].diff.persisting
    assert cold.converged and cold.improved and cold.best_label == "ladder:v02"
    assert cold.silent == ("retile(B)", "retile(C)")
    assert "no sector meaning" in cold.summary()
    for pk in (cold.baseline, *(s.profiled for s in cold.steps)):
        assert pk.run["device"] == "cpu" and pk.run["max_abs_err"] <= 1e-3
    misses = cache.stats.misses
    warm = tune("gemm", budget=3, seed=0, device="cpu", cache=cache)
    assert _sig(warm) == _sig(cold)
    assert cache.stats.misses == misses
    for a, b in zip((cold.baseline, *(s.profiled for s in cold.steps)),
                    (warm.baseline, *(s.profiled for s in warm.steps))):
        assert b.cached and heatmaps_equal(a.heatmap, b.heatmap)
        assert b.run is not None and b.run["shapes"] == [[1024, 1024], [1024, 1024]]


def test_h100_generated_candidates_carry_no_run(tmp_path):
    """A generated candidate is spec surgery with no kernel: no run, while
    the ladder rungs with a kernel launch theirs and the session stores
    each run with its iteration."""
    sess = ProfileSession(tmp_path / "sess")
    res = sess.tune("ragged_flash", budget=4, seed=0, device="cpu")
    assert [(s.candidate.label, s.accepted, s.profiled.run is not None) for s in res.steps] == [
        ("ladder:decode-ragged", True, True),
        ("ladder:prefill-ragged", False, False),  # spec only: no kernel
        ("pin(starts)", True, False),
        ("pin(ends)", True, False),
    ]
    assert res.baseline.run is not None
    stored = [it.kernels[0].run is not None for it in sess.iterations()]
    assert stored == [True, True, False, False, False]


def test_tune_accepts_the_ragged_rung(tmp_path):
    """``test_serving_kernels.py::test_tune_accepts_the_ragged_rung`` on the
    port's registry: the tuner accepts the gated decode rung and persists
    its provenance, and the rung's kernel runs (plain version here)."""
    sess = ProfileSession(tmp_path / "sess")
    res = sess.tune("ragged_flash:decode", budget=2, use_generated=False, device="cpu")
    assert res.improved and res.best.transactions < res.baseline.transactions
    (traj,) = trajectories_from_session(ProfileSession(tmp_path / "sess", create=False))
    assert traj["kernel"] == "ragged_flash"
    accepted = [s for s in traj["steps"] if s["accepted"]]
    assert accepted and accepted[0]["candidate"]["label"] == "ladder:decode-ragged"
    assert res.best.run is not None and res.baseline.run is not None
    want = ref_tuner.tune("ragged_flash:decode", budget=2, use_generated=False)
    assert want.steps[0].candidate.label == "ladder:decode-ragged" and want.improved


def test_cli_tune_report_and_exit_contract(tmp_path, capsys):
    from repro_torch.cli import main

    out = str(tmp_path / "s")
    assert main(["tune", "ttm", "--budget", "3", "--device", "cpu", "--out", out,
                 "--report", "--cache", str(tmp_path / "c")]) == 0
    text = capsys.readouterr().out
    assert "1 improved" not in text and "patterns fixed" in text
    html = (tmp_path / "s" / "report" / "index.html").read_text()
    assert "tuning trajectory" in html and "ran the plain version on cpu" in html
    assert main(["tune", "--device", "cpu", "--out", out]) == 2
    assert main(["tune", "nope", "--device", "cpu", "--out", out]) == 2
    assert main(["report", out]) == 0
    assert "tuning trajectory" in (tmp_path / "s" / "iter1" / "report" / "report.md").read_text()
    capsys.readouterr()


@pytest.mark.parametrize(
    "argv",
    [
        ["tune", "gemm", "--workers", "2"],
        ["tune", "--all", "--resume"],
        ["tune", "gemm", "--inject-faults", "seed=7"],
        ["profile", "-k", "gemm", "--workers", "2"],
        ["profile", "-k", "gemm", "--inject-faults", "seed=7"],
        ["model", "transformer-tiny", "--resume"],
        ["model", "transformer-tiny", "--workers", "2"],
    ],
)
def test_cli_scale_out_flags_exit_as_the_reference(argv, tmp_path, capsys):
    """The seven command lines the port once refused run, and exit with
    the reference CLI's code on the same arguments (``--device cpu`` for
    the port): 0, or 2 for a ``--resume`` with no journal."""
    from repro import cli as ref_cli
    from repro_torch.cli import main

    want = ref_cli.main([*argv, "--out", str(tmp_path / "ref")])
    got = main([*argv, "--device", "cpu", "--out", str(tmp_path / "port")])
    assert got == want
    assert got == (2 if "--resume" in argv else 0)
    err = capsys.readouterr().err
    assert "not ported yet" not in err


def test_cli_tune_without_a_card_is_exit_2(tmp_path, capsys):
    from repro_torch.cli import main

    assert main(["tune", "gemm", "--out", str(tmp_path / "s")]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_h100_spmv_trajectory_takes_zigzag_then_pin_x():
    """ROADMAP queue 3 item 4: under ``H100Sector`` the advisor maps false
    sharing on the gathered x to ``retile`` (no sector meaning), as the
    reference maps it, and offers no ``pin`` for it.  The x words that 4
    warps or more share carry most of its transfers (item 12), so x is
    hot-random beside its false sharing and ``tune spmv`` goes on from
    ``ladder:zigzag`` (1.03x) to ``pin(x)``: 83734 -> 20937 (4.00x), where
    the reference's ``pin(x)`` for hot gives 15.22x."""
    res = tune("spmv", device="cpu")
    assert [(s.candidate.label, s.accepted, s.transactions) for s in res.steps] == [
        ("ladder:zigzag", True, 81686),
        ("pin(x)", True, 20937),
    ]
    assert res.baseline.transactions == 83734 and res.converged
    assert res.silent == ("retile(x)",)
    assert set(res.steps[1].diff.fixed) == {("x", "false-sharing"), ("x", "hot-random")}
