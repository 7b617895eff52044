"""The port's static linter: held to the reference under TPUTile, and to the
traced detectors under H100Sector.

Ports ``test_lint.py``.  Under ``TPUTile`` every report on the reference's
own specs (passed through ``to_port_spec``) equals the JAX package's,
finding for finding.  Under ``H100Sector`` the rules are stated in 32 B
sectors, and the suite holds the *static/dynamic agreement contract* on
the port's registry: the modeled transfer total of every static variant
equals the traced total, and every predicted class is either observed by
the traced detectors on the same spec or a documented static-only check.
"""

import functools
import json

import numpy as np
import pytest

import repro.kernels as rk
from repro.core import advisor as ref_advisor
from repro.core import lint as ref_lint
from repro.core import tuner as ref_tuner
from repro_torch import kernels as kreg
from repro_torch.cli import main as cli_main
from repro_torch.core.advisor import advise_static
from repro_torch.core import lint as lint_mod
from repro_torch.core.check import CheckError, CheckThresholds, check_static
from repro_torch.core.collector import (
    KernelSpec,
    OperandSpec,
    analyze,
    probe_affine_map,
)
from repro_torch.core.lint import (
    COVERAGE_GAP,
    DEAD_OPERAND,
    OUT_OF_BOUNDS,
    STATIC_ONLY_PATTERNS,
    lint_document,
    lint_spec,
    predicted_vs_observed,
    static_transactions,
)
from repro_torch.core.patterns import (
    FALSE_SHARING,
    HOT,
    MISALIGNMENT,
    SCRATCH_ABUSE,
    STRIDED,
    detect_all,
)
from repro_torch.core.session import ProfileSession
from repro_torch.core.trace import GridSampler
from repro_torch.core.tuner import trajectories_from_session, tune

from torch_parity import port_sampler, reference_rungs, to_port_spec

FULL = GridSampler(None)

REF_REFS = [f"{n}:{v.name}" for n in rk.names() for v in rk.get(n).variants]
PORT_REFS = [f"{n}:{v.name}" for n in kreg.names() for v in kreg.get(n).variants]

#: The port's variants whose device-memory operands are all static: their
#: modeled total must equal the traced total bit-exactly.
PORT_STATIC_REFS = (
    "gemm:v00", "gemm:v01", "ttm:scratch", "ttm:fused", "cuszp:like",
    "gmm:default",
)

#: Predicted classes the port's traced detectors never report for that
#: ref under H100Sector, with the reason.
DOCUMENTED_STATIC_ONLY = {
    # the expert-indexed W fetch reaches only the experts the ids hit
    "gmm:default": {COVERAGE_GAP},
}


@pytest.fixture(autouse=True, scope="module")
def _lint_once():
    """Lint each registry ref once per module: a report is immutable, and
    the 1024^3 GEMM rungs take seconds each to price.  ``check_static``
    and the CLI look ``lint_ref`` up at call time, so they share it."""
    original = lint_mod.lint_ref
    lint_mod.lint_ref = functools.lru_cache(maxsize=None)(original)
    yield
    lint_mod.lint_ref = original


def lint_ref(ref):
    return lint_mod.lint_ref(ref)


def _reference_report(ref):
    """(the JAX package's lint report, the port's on the same spec)."""
    entry, variant = rk.resolve(ref)
    want = ref_lint.lint_ref(ref)
    got = lint_spec(
        to_port_spec(variant.spec()),
        sampler=port_sampler(entry.sampler()),
        kernel=f"{entry.name}:{variant.name}",
    )
    return want, got


def _observe(ref):
    """Traced heat map + detected patterns of a port registry ref."""
    entry, _variant = kreg.resolve(ref)
    spec, ctx = kreg.build(ref)
    hm = analyze(spec, entry.sampler(), ctx)
    return hm, detect_all(hm)


# -- TPUTile: the reference's verdicts, finding for finding -------------------


@pytest.mark.parametrize("ref", REF_REFS)
def test_tpu_lint_report_equals_the_reference(ref):
    want, got = _reference_report(ref)
    assert got.as_dict() == want.as_dict()
    assert got.summary() == want.summary()


@pytest.mark.parametrize("ref", REF_REFS)
def test_tpu_static_transactions_equal_the_reference(ref):
    entry, variant = rk.resolve(ref)
    spec = variant.spec()
    want = ref_lint.static_transactions(spec, entry.sampler())
    assert static_transactions(to_port_spec(spec), port_sampler(entry.sampler())) == want


@pytest.mark.parametrize("ref", ["gemm:v00", "ttm:scratch", "spmv:csr", "flash:default"])
def test_tpu_advise_static_equals_the_reference(ref):
    want, got = _reference_report(ref)
    sig = lambda acts: [  # noqa: E731 — descriptions name each package's knobs
        (a.kind, a.region, a.pattern, a.est_transaction_saving) for a in acts
    ]
    assert sig(advise_static(got)) == sig(ref_advisor.advise_static(want))


# -- H100Sector: the agreement contract on the port's registry ----------------


@pytest.mark.parametrize("ref", PORT_REFS)
def test_h100_static_total_and_predictions_agree_with_the_trace(ref):
    rep = lint_ref(ref)
    hm, observed = _observe(ref)
    if ref in PORT_STATIC_REFS:
        assert rep.static_transactions == hm.sector_transactions()
    else:
        assert rep.static_transactions is None
        assert any(ov.status == "dynamic" for ov in rep.operands)
    obs_keys = {(r.region, r.pattern) for r in observed}
    allowed = DOCUMENTED_STATIC_ONLY.get(ref, set())
    for f in rep.findings:
        if f.pattern in STATIC_ONLY_PATTERNS or f.pattern in allowed \
                or (f.region, f.pattern) in allowed:
            continue
        assert (f.region, f.pattern) in obs_keys, (
            f"{ref}: lint predicted {f.pattern} on {f.region} "
            f"(rule {f.rule}) but the trace observed only {obs_keys}"
        )


def test_static_transactions_empty_grid_is_zero():
    spec = KernelSpec(
        name="k", grid=(0,),
        operands=(OperandSpec("x", (4096,), np.int32, (1024,), lambda i: (i,)),),
    )
    assert static_transactions(spec, FULL) == 0


def test_known_bad_gemm_v00_under_h100():
    """The port's v00 (lanes on rows): false sharing on B and C, hot on A,
    and hot on B beside its false sharing (each B word is re-fetched by the
    32 warps of its column), as the trace flags them (ROADMAP queue 3 item
    1)."""
    rep = lint_ref("gemm:v00")
    keys = {(f.pattern, f.region) for f in rep.findings}
    assert keys == {(FALSE_SHARING, "B"), (FALSE_SHARING, "C"), (HOT, "A"), (HOT, "B")}
    fs = {f.region: f for f in rep.findings if f.pattern == FALSE_SHARING}
    # 4-byte words one word apart: eight warps share each 32 B sector
    assert fs["C"].detail("mean_ratio") == 8.0
    assert rep.verdict() == "dirty" and not rep.errors
    assert rep.static_transactions == 168820736


def test_known_bad_spmv_misalignment():
    rep = lint_ref("spmv:csr")
    keys = {(f.pattern, f.region) for f in rep.findings}
    assert (MISALIGNMENT, "rowOffsets_shift1") in keys
    # the fixed variant drops the finding
    assert MISALIGNMENT not in lint_ref("spmv:zigzag").patterns()


def test_known_bad_scratch_abuse():
    assert (SCRATCH_ABUSE, "Y_shr") in {
        (f.pattern, f.region) for f in lint_ref("ttm:scratch").findings
    }
    assert SCRATCH_ABUSE in lint_ref("cuszp:like").patterns()
    # the fused fix and the genuinely-shared histogram scratch stay clean
    assert SCRATCH_ABUSE not in lint_ref("ttm:fused").patterns()
    assert SCRATCH_ABUSE not in lint_ref("histogram:scratch").patterns()


@pytest.mark.parametrize("geometry", ["h100-sector", "tpu-tile"])
def test_strided_predicted_on_naive_column_walk(geometry):
    """A (512, 1) column walk: the TPU tile's lane-minor rule, and under
    H100Sector the word-sparse rule (a sector has no lanes)."""
    from repro.kernels.gramschm import k3_naive_block_spec as ref_spec
    from repro_torch.kernels.gramschm import k3_naive_block_spec

    if geometry == "tpu-tile":
        spec = to_port_spec(ref_spec(512, 512, 512))
        rule = "lane-minor-stride"
    else:
        spec = k3_naive_block_spec(512, 512, 512)
        rule = "word-sparse-stride"
    rep = lint_spec(spec, sampler=FULL)
    strided = [f for f in rep.findings if f.pattern == STRIDED]
    assert strided[0].region == "q" and strided[0].rule == rule
    if geometry == "h100-sector":
        # one warm word of eight in each sector: not hot, whoever re-reads it
        assert (HOT, "q") not in {(f.pattern, f.region) for f in rep.findings}
        observed = {(r.pattern, r.region) for r in detect_all(analyze(spec, FULL))}
        assert observed == {(STRIDED, "q")}


def test_ladder_tops_stay_statically_dirty():
    v02 = lint_ref("gemm:v02")
    assert v02.verdict() == "dirty"
    assert {f.region for f in v02.findings if f.pattern == HOT} == {"A"}


def test_lint_collects_zero_traces(monkeypatch):
    import repro_torch.core.trace as trace_mod

    def boom(self, *a, **k):
        raise AssertionError("lint must never allocate a TraceBuffer")

    spec, _ctx = kreg.build("ttm:scratch")
    monkeypatch.setattr(trace_mod.TraceBuffer, "__init__", boom)
    rep = lint_spec(spec, sampler=FULL)
    assert rep.verdict() == "dirty"
    assert rep.static_transactions == 18944


# -- affine probing ------------------------------------------------------------


def test_probe_affine_recovers_exact_model():
    model = probe_affine_map(lambda i, j: (2 * i + 3 * j + 1, j), (4, 5))
    assert model is not None
    assert model.base == (1, 0)
    for i in range(4):
        for j in range(5):
            assert model.predict((i, j)) == (2 * i + 3 * j + 1, j)


@pytest.mark.parametrize(
    "index_map,grid",
    [
        (lambda i: (0 if i < 5 else i,), (8,)),  # piecewise: agrees at a corner only
        (lambda i, j: (i * j,), (4, 4)),  # multiplicative
    ],
)
def test_probe_rejects_nonaffine_maps(index_map, grid):
    assert probe_affine_map(index_map, grid) is None


def test_nonaffine_operand_still_priced_exactly():
    rep = lint_ref("gmm:default")
    status = {ov.region: ov.status for ov in rep.operands}
    assert status["W"] == "nonaffine"
    modeled = {ov.region: ov.modeled_transactions for ov in rep.operands}
    # nonaffine != unpriced: the per-key replay still gives the total
    assert modeled["W"] is not None and modeled["W"] > 0
    assert rep.static_transactions == sum(
        ov.modeled_transactions for ov in rep.operands if ov.space == "hbm"
    )


# -- purely-static error rules -------------------------------------------------


@pytest.mark.parametrize("geometry", ["h100-sector", "tpu-tile"])
def test_oob_origin_is_an_error(geometry):
    spec = KernelSpec(
        name="k", grid=(4,),
        operands=(
            OperandSpec("x", (4096,), np.int32, (1024,), lambda i: (i,),
                        origin=(0, 1024), geometry_kind=geometry),
        ),
    )
    rep = lint_spec(spec, sampler=FULL)
    assert rep.verdict() == "error"
    (err,) = rep.errors
    assert err.pattern == OUT_OF_BOUNDS and err.rule == "oob-origin"
    # errors gate the document even without --strict
    doc = lint_document([rep])
    assert doc["passed"] is False and doc["failures"]


@pytest.mark.parametrize("geometry", ["h100-sector", "tpu-tile"])
def test_dead_operand_is_an_error(geometry):
    spec = KernelSpec(
        name="k", grid=(4,),
        operands=(
            OperandSpec("x", (4096,), np.int32, (1024,), lambda i: (i,),
                        origin=(0, 8192), geometry_kind=geometry),
        ),
    )
    rep = lint_spec(spec, sampler=FULL)
    assert DEAD_OPERAND in rep.patterns()
    assert rep.verdict() == "error"


def test_h100_misaligned_origin_is_stated_in_sectors():
    """One 4-byte element past a sector boundary misaligns; eight (32 B)
    do not."""
    def spec(shift):
        return KernelSpec(
            name="k", grid=(16,),
            operands=(
                OperandSpec("x", (4096,), np.float32, (64,), lambda i: (i,),
                            origin=(0, shift)),
            ),
        )

    assert MISALIGNMENT in lint_spec(spec(1), sampler=FULL).patterns()
    assert MISALIGNMENT not in lint_spec(spec(8), sampler=FULL).patterns()
    observed = {r.pattern for r in detect_all(analyze(spec(1), FULL))}
    assert MISALIGNMENT in observed


def test_coverage_gap_on_gmm():
    rep = lint_ref("gmm:default")
    gaps = [f for f in rep.findings if f.pattern == COVERAGE_GAP]
    assert gaps and gaps[0].region == "W"
    assert gaps[0].level == "warning"  # reachable-but-wasteful, not a bug


# -- lint -> advisor (the shared Action surface) --------------------------------


def test_advise_static_prices_gemm_v00():
    acts = advise_static(lint_ref("gemm:v00"))
    assert acts[0].kind == "vmem_pin" and acts[0].region == "A"
    assert acts[0].est_transaction_saving > 0.75  # A is ~80% of the traffic
    kinds = {(a.kind, a.region) for a in acts}
    assert ("retile", "B") in kinds and ("retile", "C") in kinds


def test_advise_static_drop_scratch():
    acts = advise_static(lint_ref("ttm:scratch"))
    assert acts[0].kind == "drop_scratch" and acts[0].region == "Y_shr"


# -- predicted vs observed cross-tab -------------------------------------------


def test_predicted_vs_observed_statuses():
    _hm, observed = _observe("spmv:csr")
    rows = predicted_vs_observed(lint_ref("spmv:csr"), observed)
    by = {(r["region"], r["pattern"]): r["status"] for r in rows}
    assert by[("rowOffsets_shift1", MISALIGNMENT)] == "agree"
    # the dynamic x gather is invisible to the static view
    assert by[("x", FALSE_SHARING)] == "dynamic-only"
    agree = [r for r in rows if r["status"] == "agree"]
    assert all(
        r["predicted_severity"] is not None and r["observed_severity"] is not None
        for r in agree
    )


def test_predicted_vs_observed_static_only_gap():
    _hm, observed = _observe("gmm:default")
    rows = predicted_vs_observed(lint_ref("gmm:default"), observed)
    assert ("W", COVERAGE_GAP) in {
        (r["region"], r["pattern"]) for r in rows if r["status"] == "static-only"
    }


# -- tuner pre-screen (TPUTile, the reference's rungs) ---------------------------


def _step_sig(res):
    return [(s.candidate.label, s.accepted, s.transactions) for s in res.steps]


def test_prescreen_preserves_gemm_trajectory():
    on = tune("gemm", budget=8, seed=0, rungs=reference_rungs, device="cpu")
    off = tune("gemm", budget=8, seed=0, static_prescreen=False,
               rungs=reference_rungs, device="cpu")
    # identical accepted trajectory, bit for bit
    assert _step_sig(on) == _step_sig(off)
    assert on.best_label == off.best_label
    labels = {d["label"] for d in on.static_skipped}
    assert labels == {"transpose(A)", "transpose(C)"}
    want = ref_tuner.tune("gemm", budget=8, seed=0)
    assert [d["label"] for d in on.static_skipped] == [
        d["label"] for d in want.static_skipped
    ]
    for d in on.static_skipped:
        assert d["static_transactions"] > d["parent_transactions"]
        assert d["candidate"]["source"] == "generated"
    assert not off.static_skipped
    assert "prescreen: 2 candidate(s) statically worse" in on.summary()
    assert len(json.loads(json.dumps(on.as_dict()))["static_skipped"]) == 2


def test_prescreen_skips_regressing_pin_on_gramschm():
    res = tune("gramschm", budget=2, seed=0, rungs=reference_rungs, device="cpu")
    assert [s.candidate.label for s in res.steps] == ["ladder:opt"]
    assert [d["label"] for d in res.static_skipped] == ["pin(qT)"]
    assert res.improved and res.converged


def test_prescreen_session_provenance(tmp_path):
    sess = ProfileSession(tmp_path / "sess")
    res = sess.tune("histogram", budget=6, seed=0, rungs=reference_rungs, device="cpu")
    labels = [d["label"] for d in res.static_skipped]
    assert "ladder:partials" in labels
    (traj,) = trajectories_from_session(ProfileSession(tmp_path / "sess", create=False))
    assert [d["label"] for d in traj["static_skipped"]] == labels
    # skips ride the iteration that triggered the regeneration
    per_step = [d["label"] for s in traj["steps"] for d in s["static_skipped"]]
    stored = json.loads((sess.iteration(0).path / "manifest.json").read_text())
    baseline_skips = [d["label"] for d in stored["tuning"].get("static_skipped", [])]
    assert sorted(per_step + baseline_skips) == sorted(labels)


def test_prescreen_can_be_disabled_through_session(tmp_path):
    sess = ProfileSession(tmp_path / "sess")
    res = sess.tune("gramschm", budget=2, seed=0, static_prescreen=False,
                    rungs=reference_rungs, device="cpu")
    assert not res.static_skipped
    assert [s.candidate.label for s in res.steps] == ["ladder:opt", "pin(qT)"]


# -- static regression gate (check --static) -------------------------------------


def test_check_static_down_the_ladder_fails_on_the_h100_class_divergence():
    """v00 -> v01 cuts the modeled transfers.  Under H100Sector v00's B is
    hot beside its false sharing (a block re-fetched by 32 warps: each word
    is shared, as the hot rule reads it on words; ROADMAP queue 3 item 1),
    so v01's hot B is no new class: the strict gate passes, and exempting
    hot still does."""
    rep = check_static("gemm:v01", "gemm:v00")
    assert rep.mode == "static" and rep.passed
    kc = rep.kernels[0]
    assert kc.transactions_after < kc.transactions_before
    assert kc.new_patterns == ()
    assert set(kc.fixed_patterns) == {("B", FALSE_SHARING), ("C", FALSE_SHARING)}
    lenient = CheckThresholds.from_specs(["allow-pattern=hot"])
    assert check_static("gemm:v01", "gemm:v00", thresholds=lenient).passed


def test_check_static_fails_up_ladder():
    rep = check_static("gemm:v00", "gemm:v01")
    assert not rep.passed
    assert any("modeled transfers" in f for f in rep.failures)
    assert ("C", FALSE_SHARING) in rep.kernels[0].new_patterns


def test_check_static_applies_family_region_map():
    # gramschm's q -> qT rename must align, in either direction
    assert check_static("gramschm:opt", "gramschm:naive").passed
    doc = check_static("gramschm:opt", "gramschm:naive").as_dict()
    assert doc["format"] == "cuthermo-check" and doc["mode"] == "static"


def test_check_static_unknown_ref_raises():
    with pytest.raises(CheckError):
        check_static("nope:x", "gemm:v00")


# -- CLI contract ----------------------------------------------------------------


def test_cli_lint_exit_codes(capsys):
    assert cli_main(["lint", "histogram:scratch"]) == 0  # clean
    assert cli_main(["lint", "ttm:scratch"]) == 0  # warnings pass by default
    assert cli_main(["lint", "ttm:scratch", "--strict"]) == 1
    assert cli_main(["lint", "definitely-not-a-kernel"]) == 2
    assert cli_main(["lint"]) == 2
    capsys.readouterr()


def test_cli_lint_json_document(tmp_path, capsys):
    path = tmp_path / "lint.json"
    rc = cli_main(["lint", "ttm:scratch", "--strict", "--json", str(path), "--quiet"])
    assert rc == 1
    doc = json.loads(path.read_text())
    assert doc["format"] == "cuthermo-lint"
    assert doc["schema_version"] == 1
    assert doc["strict"] is True and doc["passed"] is False
    patterns = {f["pattern"] for rep in doc["reports"] for f in rep["findings"]}
    assert SCRATCH_ABUSE in patterns
    assert capsys.readouterr().out == ""


def test_cli_lint_all_and_kernels_lint(capsys):
    # the whole registry is warning-or-clean: default lint must exit 0
    assert cli_main(["lint", "--all", "--quiet"]) == 0
    assert cli_main(["kernels", "--lint"]) == 0
    out = capsys.readouterr().out
    # every variant shows a verdict; known-dirty rungs read dirty
    assert "v00        dirty  168820736 transfers" in out
    assert "scratch    clean" in out  # histogram:scratch
    assert "hot(A)" in out and "scratch-abuse(Y_shr)" in out
    assert "no kernels were run or traced" in out


def test_cli_check_static_exit_codes(capsys):
    assert cli_main(["check", "gramschm:opt", "--static", "--baseline",
                     "gramschm:naive", "-q"]) == 0
    assert cli_main(["check", "gemm:v00", "--static", "--baseline", "gemm:v01", "-q"]) == 1
    assert cli_main(["check", "gemm:v00", "--static", "--baseline", "nope", "-q"]) == 2
    # --static is ref-based: session-mode flags are usage errors
    assert cli_main(["check", "gemm:v00", "--static", "--anomaly",
                     "--baseline", "gemm:v01", "-q"]) == 2
    assert cli_main(["check", "gemm:v00", "--static", "-q"]) == 2
    capsys.readouterr()


def test_cli_tune_no_prescreen_flag(tmp_path, capsys):
    rc = cli_main(["tune", "gramschm", "--budget", "2", "--device", "cpu",
                   "--out", str(tmp_path / "s1")])
    out = capsys.readouterr().out
    assert rc == 0 and "prescreen:" not in out
    assert "ladder:opt" in out
    rc = cli_main(["tune", "gramschm", "--budget", "2", "--device", "cpu",
                   "--no-prescreen", "--out", str(tmp_path / "s2")])
    assert rc == 0 and "prescreen:" not in capsys.readouterr().out


# -- report bundle cross-tab ---------------------------------------------------------


def test_report_bundle_lint_section(tmp_path):
    from repro_torch.core.render import ReportEntry, write_report_bundle

    hm, observed = _observe("ttm:scratch")
    rep = lint_ref("ttm:scratch")
    rows = predicted_vs_observed(rep, observed)
    assert any(r["status"] == "agree" for r in rows)
    payload = [{
        "kernel": "ttm", "ref": "ttm:scratch", "verdict": rep.verdict(),
        "static_transactions": rep.static_transactions, "rows": rows,
    }]
    written = write_report_bundle([ReportEntry(heatmap=hm)], str(tmp_path / "rep"),
                                  lint=payload)
    html = open(written["index.html"]).read()
    assert "static lint: predicted vs observed" in html and "agree" in html
    md = open(written["report.md"]).read()
    assert "## static lint: predicted vs observed" in md


def test_cli_report_includes_lint_crosstab(tmp_path, capsys):
    assert cli_main(["profile", "-k", "spmv:csr", "--device", "cpu",
                     "--out", str(tmp_path / "s"), "-q"]) == 0
    assert cli_main(["report", str(tmp_path / "s")]) == 0
    capsys.readouterr()
    md = (tmp_path / "s" / "iter0" / "report" / "report.md").read_text()
    assert "static lint: predicted vs observed" in md
    assert "misalignment" in md and "dynamic-only" in md


# -- the document ------------------------------------------------------------------------


def test_lint_document_versioned_and_strict():
    reps = [lint_ref("ttm:scratch"), lint_ref("histogram:scratch")]
    doc = lint_document(reps)
    assert doc["format"] == "cuthermo-lint"
    assert doc["schema_version"] == 1
    assert doc["passed"] is True  # warnings only, not strict
    json.dumps(doc)
    strict = lint_document(reps, strict=True)
    assert strict["passed"] is False
    assert any("ttm:scratch" in f for f in strict["failures"])
    assert not any("histogram:scratch" in f for f in strict["failures"])


# -- the cases that waited on lint ------------------------------------------------------


@pytest.mark.parametrize(
    "ref",
    [f"{f}:{v}" for f in ("ragged_flash", "paged_attn")
     for v in ("decode", "decode-ragged" if f == "ragged_flash" else "decode-paged",
               "prefill", "prefill-ragged" if f == "ragged_flash" else "prefill-paged")],
)
def test_serving_specs_lint_without_nonaffine(ref):
    """``test_serving_kernels.py::test_serving_specs_lint_without_nonaffine``:
    under TPUTile on the reference's spec exactly its assertions; under
    H100Sector every serving rung is an exact index walk, so every
    affine-probed operand is affine and the walks are 'dynamic'."""
    want, got = _reference_report(ref)
    statuses = {ov.status for ov in got.operands}
    assert "nonaffine" not in statuses, (ref, statuses)
    if ref.endswith(("-ragged", "-paged")):
        assert "dynamic" in statuses, (ref, statuses)
    else:
        assert got.static_transactions is not None
    h100 = {ov.status for ov in lint_ref(ref).operands}
    assert "nonaffine" not in h100 and "dynamic" in h100, (ref, h100)


def test_model_refs_lint_cleanly_enough_to_tune():
    """``test_model_profile.py::test_model_refs_lint_cleanly_enough_to_tune``:
    the reference's model refs price statically under TPUTile; the port's
    lint the same refs without a model failure ('nonaffine'), and the v01
    rung (static under H100Sector) prices to its traced total."""
    for ref in ("model.transformer-tiny.mlp:v01",
                "model.transformer-tiny.mlp:v02",
                "model.mamba-tiny.ssm:chunk"):
        entry, variant = rk.resolve(ref)
        got = lint_spec(to_port_spec(variant.spec()), sampler=port_sampler(entry.sampler()))
        assert got.static_transactions is not None, ref
        rep = lint_ref(ref)
        assert not any(ov.status == "nonaffine" for ov in rep.operands), ref
    rep = lint_ref("model.transformer-tiny.mlp:v01")
    hm, _ = _observe("model.transformer-tiny.mlp:v01")
    assert rep.static_transactions == hm.sector_transactions()
