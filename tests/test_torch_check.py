"""The port's regression gate: thresholds, verdicts, anomaly bands, exit codes.

Ports ``test_check.py``.  The gate's iterations are profiled from the
reference's own specs under ``TPUTile`` (``to_port_spec``), so every
expectation is the reference's, and the gate's JSON document is held equal
to the JAX package's on the same heat maps.  The ``H100Sector`` cases pin
what the port's own GEMM ladder gives the gate: v01 introduces hot on B
where v00 falsely shared it (ROADMAP queue 3 item 1).
"""

import json
from pathlib import Path

import pytest

from repro.core import check as ref_check
from repro.core import session as ref_session
from repro.core.collector import analyze as ref_analyze
from repro.core.patterns import detect_all as ref_detect_all
from repro.kernels import gemm as ref_gemm
from repro.kernels import gramschm as ref_gramschm
from repro_torch import cli
from repro_torch.core.advisor import advise
from repro_torch.core.check import (
    CHECK_SCHEMA_VERSION,
    Anomaly,
    CheckError,
    CheckReport,
    CheckThresholds,
    check_iterations,
    check_session_anomalies,
    detect_anomalies,
    merge_reports,
    pct_delta,
    robust_band,
)
from repro_torch.core.collector import analyze
from repro_torch.core.patterns import detect_all
from repro_torch.core.session import (
    HistoryPoint,
    Iteration,
    ProfiledKernel,
    ProfileSession,
    load_iteration,
    write_iteration,
)
from repro_torch.core.trace import GridSampler
from repro_torch.kernels import gemm

from torch_parity import to_port_spec

FULL = GridSampler(None)


def _profiled(spec, name="gemm", variant="v00", with_reports=True):
    hm = analyze(spec, sampler=FULL)
    return ProfiledKernel(
        name=name,
        variant=variant,
        heatmap=hm,
        reports=tuple(detect_all(hm)) if with_reports else (),
        actions=tuple(advise(hm)),
    )


@pytest.fixture(scope="module")
def naive():
    return _profiled(to_port_spec(ref_gemm.gemm_v00_spec(128, 128, 128)), variant="v00")


@pytest.fixture(scope="module")
def tiled():
    return _profiled(to_port_spec(ref_gemm.gemm_v01_spec(128, 128, 128)), variant="v01")


def _iteration(tmp_path, name, kernels, **kw):
    return load_iteration(write_iteration(tmp_path / name, kernels, label=name, **kw))


# -- thresholds parsing ------------------------------------------------------


def test_thresholds_defaults_are_strict():
    t = CheckThresholds()
    assert t.max_transfer_pct == 0.0
    assert t.max_aggregate_pct == 0.0
    assert t.max_scratch_pct == 0.0
    assert t.fail_on_new_patterns and t.fail_on_missing
    assert t.allowed_patterns == ()


def test_thresholds_from_specs():
    specs = ["transfer-pct=5", "aggregate-pct=2.5", "scratch-pct=inf",
             "severity=0.1", "new-patterns=off", "missing=off",
             "allow-pattern=hot", "allow-pattern=strided", "allow-pattern=hot"]
    t = CheckThresholds.from_specs(specs)
    assert t.max_transfer_pct == 5.0
    assert t.max_aggregate_pct == 2.5
    assert t.max_scratch_pct == float("inf")
    assert t.max_severity_increase == 0.1
    assert not t.fail_on_new_patterns and not t.fail_on_missing
    assert t.allowed_patterns == ("hot", "strided")  # deduped, ordered
    assert t.as_dict() == ref_check.CheckThresholds.from_specs(specs).as_dict()


@pytest.mark.parametrize("spec", [
    "bogus=1",                # unknown key
    "transfer-pct",           # no '='
    "transfer-pct=abc",       # not a number
    "new-patterns=maybe",     # not on|off
    "allow-pattern=nope",     # unknown pattern class
])
def test_thresholds_bad_specs_raise(spec):
    with pytest.raises(CheckError):
        CheckThresholds.from_specs([spec])


def test_pct_delta_edges():
    assert pct_delta(100, 150) == 50.0
    assert pct_delta(100, 50) == -50.0
    assert pct_delta(0, 0) == 0.0
    assert pct_delta(0, 5) is None  # unbounded growth from zero


# -- baseline gate -------------------------------------------------------------


def test_check_identical_iterations_pass(tmp_path, tiled):
    base = _iteration(tmp_path, "base", [tiled])
    good = _iteration(tmp_path, "good", [tiled])
    report = check_iterations(base, good)
    assert report.passed and report.failures == ()
    (kc,) = report.kernels
    assert kc.status == "pass" and kc.verdict == "unchanged"
    assert report.aggregate.failures == ()
    assert "check passed" in report.summary()


def test_check_regression_fails_on_transfers_and_patterns(tmp_path, naive, tiled):
    base = _iteration(tmp_path, "base", [tiled])
    bad = _iteration(tmp_path, "bad", [naive])
    report = check_iterations(base, bad)
    assert not report.passed
    (kc,) = report.kernels
    assert kc.status == "fail" and kc.verdict == "regressed"
    assert kc.transactions_after > kc.transactions_before
    assert any("false-sharing" in f for f in kc.failures)
    assert any("transfers" in f for f in kc.failures)
    assert report.aggregate.failures
    assert "FAILED" in report.summary()


def test_check_improvement_passes(tmp_path, naive, tiled):
    base = _iteration(tmp_path, "base", [naive])
    cand = _iteration(tmp_path, "cand", [tiled])
    report = check_iterations(base, cand)
    assert report.passed
    (kc,) = report.kernels
    assert kc.verdict == "improved"
    assert kc.fixed_patterns


@pytest.mark.parametrize("pair", [("tiled", "naive"), ("naive", "tiled"), ("tiled", "tiled")])
def test_check_document_equals_the_reference(pair, tmp_path, request):
    """The gate's JSON on the same heat maps is the JAX package's, key for
    key (the port's artifacts are v6 for TPU tiles, which it reads)."""
    ref_spec = {"naive": ref_gemm.gemm_v00_spec, "tiled": ref_gemm.gemm_v01_spec}

    def ref_pk(which):
        hm = ref_analyze(ref_spec[which](128, 128, 128), sampler=ref_session.GridSampler(None))
        return ref_session.ProfiledKernel(
            name="gemm", variant=which, heatmap=hm,
            reports=tuple(ref_detect_all(hm)), actions=(),
        )

    base, cand = pair
    want = ref_check.check_iterations(
        ref_session.load_iteration(ref_session.write_iteration(
            tmp_path / "rb", [ref_pk(base)], label="base")),
        ref_session.load_iteration(ref_session.write_iteration(
            tmp_path / "rc", [ref_pk(cand)], label="cand")),
    ).as_dict()
    got = check_iterations(
        _iteration(tmp_path, "base", [request.getfixturevalue(base)]),
        _iteration(tmp_path, "cand", [request.getfixturevalue(cand)]),
    ).as_dict()
    assert got == want


def test_check_lenient_thresholds_absorb_regression(tmp_path, naive, tiled):
    base = _iteration(tmp_path, "base", [tiled])
    bad = _iteration(tmp_path, "bad", [naive])
    t = CheckThresholds.from_specs(["transfer-pct=900", "aggregate-pct=900", "new-patterns=off"])
    assert check_iterations(base, bad, thresholds=t).passed
    t2 = CheckThresholds.from_specs(
        ["transfer-pct=900", "aggregate-pct=900", "allow-pattern=false-sharing"]
    )
    report = check_iterations(base, bad, thresholds=t2)
    assert report.passed and report.kernels[0].new_patterns == ()


def test_check_missing_and_added_kernels(tmp_path, tiled):
    other = _profiled(to_port_spec(ref_gemm.gemm_v01_spec(128, 128, 128)), "other", "v01")
    third = _profiled(to_port_spec(ref_gemm.gemm_v01_spec(128, 128, 128)), "third", "v01")
    base = _iteration(tmp_path, "base", [tiled, other])
    cand = _iteration(tmp_path, "cand", [tiled, third])
    report = check_iterations(base, cand)
    by_name = {kc.kernel: kc for kc in report.kernels}
    assert by_name["other"].status == "missing" and by_name["other"].failures
    assert by_name["third"].status == "added" and by_name["third"].failures == ()
    assert not report.passed
    lenient = CheckThresholds.from_specs(["missing=off"])
    assert check_iterations(base, cand, thresholds=lenient).passed


def test_check_disjoint_iterations_raise(tmp_path, tiled):
    base = _iteration(tmp_path, "base", [tiled])
    unrelated = _profiled(to_port_spec(ref_gemm.gemm_v01_spec(128, 128, 128)), "unrelated")
    with pytest.raises(CheckError):
        check_iterations(base, _iteration(tmp_path, "cand", [unrelated]))


def test_check_scratch_gate():
    from repro_torch import kernels as kreg

    def ttm(ref):
        spec, ctx = kreg.build(ref)
        entry, variant = kreg.resolve(ref)
        hm = analyze(spec, sampler=entry.sampler(), dynamic_context=ctx)
        # reports stripped: isolate the scratch gate from pattern rules
        return ProfiledKernel(name="ttm", variant=variant.name, heatmap=hm,
                              reports=(), actions=())

    base = Iteration(path=Path("base"), label="base", created=0.0,
                     kernels=(ttm("ttm:fused"),))
    cand = Iteration(path=Path("cand"), label="cand", created=0.0,
                     kernels=(ttm("ttm:scratch"),))
    (kc,) = check_iterations(base, cand).kernels
    assert kc.scratch_before == 0 and kc.scratch_after > 0
    assert kc.scratch_delta_pct is None  # growth from zero
    assert any("scratch words" in f for f in kc.failures)
    # growth from zero blows any finite budget...
    t = CheckThresholds.from_specs(["scratch-pct=1000000", "new-patterns=off"])
    assert not check_iterations(base, cand, thresholds=t).passed
    # ...and only the explicit inf escape hatch disables the gate
    t = CheckThresholds.from_specs(["scratch-pct=inf", "new-patterns=off"])
    assert check_iterations(base, cand, thresholds=t).passed


def test_check_region_rename_alignment(tmp_path):
    def gs(spec_fn, variant):
        return _profiled(to_port_spec(spec_fn(512, 512, 512, k=3)), "gramschm", variant)

    base = _iteration(tmp_path, "base", [gs(ref_gramschm.k3_naive_spec, "naive")])
    cand = _iteration(tmp_path, "cand", [gs(ref_gramschm.k3_opt_spec, "opt")])
    rename = {"gramschm": {"q": "qT"}}
    report = check_iterations(base, cand, region_maps=rename)
    (kc,) = report.kernels
    assert kc.verdict == "improved"
    assert ("q", "strided") in kc.fixed_patterns
    assert kc.new_patterns == (("q", "hot"),)
    assert report.failures == ("gramschm: new pattern: hot on q",)
    t = CheckThresholds.from_specs(["allow-pattern=hot"])
    assert check_iterations(base, cand, thresholds=t, region_maps=rename).passed
    assert check_iterations(base, base, region_maps=rename).passed


def test_report_json_schema(tmp_path, naive, tiled):
    doc = check_iterations(
        _iteration(tmp_path, "base", [tiled]), _iteration(tmp_path, "bad", [naive])
    ).as_dict()
    json.dumps(doc)
    assert doc["format"] == "cuthermo-check"
    assert doc["schema_version"] == CHECK_SCHEMA_VERSION == 1
    assert doc["passed"] is False and doc["mode"] == "baseline"
    for key in ("candidate", "baseline", "thresholds", "kernels",
                "aggregate", "anomalies", "failures"):
        assert key in doc
    (kc,) = doc["kernels"]
    for key in ("kernel", "status", "verdict", "failures",
                "transactions_before", "transactions_after",
                "transactions_delta_pct", "scratch_before",
                "scratch_after", "new_patterns", "worsened_patterns"):
        assert key in kc
    assert doc["failures"]


# -- H100Sector: the port's own GEMM ladder --------------------------------------


@pytest.fixture(scope="module")
def h100_ladder():
    return {
        v: _profiled(getattr(gemm, f"gemm_{v}_spec")(128, 128, 128), variant=v)
        for v in ("v00", "v01")
    }


def test_h100_regression_fails_and_improvement_trades_false_sharing_for_hot(
    tmp_path, h100_ladder
):
    v00 = _iteration(tmp_path, "v00", [h100_ladder["v00"]])
    v01 = _iteration(tmp_path, "v01", [h100_ladder["v01"]])
    back = check_iterations(v01, v00)
    assert not back.passed and back.kernels[0].verdict == "regressed"
    assert set(back.kernels[0].new_patterns) == {("B", "false-sharing"), ("C", "false-sharing")}
    # v00's B is hot beside its false sharing (ROADMAP queue 3 item 1, the
    # hot rule read on word temperatures), so v01 adds no new class; at
    # 128^3 each B word goes from the 4 warps of its column to all 128 row
    # warps, and the strict gate fails on that (at the registry's 1024^3 the
    # rise is under the gate's +0.05: tests/test_torch_cli.py)
    forward = check_iterations(v00, v01)
    (kc,) = forward.kernels
    assert kc.verdict == "improved"
    assert set(kc.fixed_patterns) == {("B", "false-sharing"), ("C", "false-sharing")}
    assert kc.new_patterns == ()
    (failure,) = forward.failures
    assert failure.startswith("gemm: worsened pattern: hot on B (severity 0.06 -> 0.25")
    t = CheckThresholds.from_specs(["allow-pattern=hot"])
    assert check_iterations(v00, v01, thresholds=t).passed


# -- anomaly bands ------------------------------------------------------------------


def _pt(i, tx, patterns=(), scratch=0, accepted=None):
    return HistoryPoint(
        iteration=f"iter{i}", label=f"iter{i}", created=float(i),
        kernel="k", variant="v", transactions=tx, waste_ratio=1.0,
        patterns=tuple(patterns), scratch_words=scratch,
        tuning_accepted=accepted,
    )


def test_robust_band_is_deterministic_and_floored():
    values = [100.0, 101.0, 99.0, 100.0]
    assert robust_band(values) == robust_band(values) == ref_check.robust_band(values)
    med, _mad, _lo, hi = robust_band(values, nmads=4.0, rel_floor=0.02)
    assert med == 100.0
    assert hi - med >= 0.02 * med
    _, _, lo0, hi0 = robust_band([50.0, 50.0, 50.0])
    assert lo0 < 50.0 < hi0


def test_detect_anomalies_flags_spike_not_wiggle():
    stable = [_pt(i, 1000) for i in range(4)]
    flags, meta = detect_anomalies({"k": stable + [_pt(4, 5000)]})
    assert [a.metric for a in flags] == ["transactions"]
    a = flags[0]
    assert a.kernel == "k" and a.value == 5000.0 and a.iteration == "iter4"
    assert meta["kernels_scanned"] == 1
    flags2, _ = detect_anomalies({"k": stable + [_pt(4, 1010)]})
    assert flags2 == ()


def test_detect_anomalies_pattern_count_and_scratch():
    stable = [_pt(i, 1000, patterns=(("r", "hot"),)) for i in range(3)]
    latest = _pt(3, 1000, patterns=(("r", "hot"), ("r", "strided"), ("s", "hot")))
    flags, _ = detect_anomalies({"k": stable + [latest]})
    assert {a.metric for a in flags} == {"patterns"}
    hist = [_pt(i, 1000, scratch=100) for i in range(3)]
    flags2, _ = detect_anomalies({"k": hist + [_pt(3, 1000, scratch=900)]})
    assert {a.metric for a in flags2} == {"scratch_words"}


def test_detect_anomalies_skips_short_and_unversioned_history():
    flags, meta = detect_anomalies({"k": [_pt(0, 10), _pt(1, 9000)]})
    assert flags == () and meta["kernels_skipped"] == 1
    hist = [_pt(i, 1000, scratch=None) for i in range(3)]
    flags2, _ = detect_anomalies({"k": hist + [_pt(3, 1000, scratch=10**6)]})
    assert flags2 == ()


def test_anomaly_over_session_is_deterministic(tmp_path, naive, tiled):
    sess = ProfileSession(tmp_path / "sess")
    for _ in range(4):
        sess.add_iteration([tiled])
    sess.add_iteration([naive])
    r1 = check_session_anomalies(sess)
    r2 = check_session_anomalies(sess)
    assert r1.as_dict() == r2.as_dict()
    assert not r1.passed
    assert {a.metric for a in r1.anomalies} == {"transactions", "patterns"}
    assert r1.mode == "anomaly"
    json.dumps(r1.as_dict())


def test_anomaly_excludes_tuner_rejected_iterations(tmp_path, naive, tiled):
    sess = ProfileSession(tmp_path / "sess")
    for _ in range(4):
        sess.add_iteration([tiled])
    sess.add_iteration(
        [naive],
        tuning={"family": "gemm", "step": 1, "role": "candidate", "accepted": False},
    )
    sess.add_iteration([tiled])
    assert check_session_anomalies(sess).passed
    assert len(sess.history(include_rejected=True)["gemm"]) == 6
    assert len(sess.history(include_rejected=False)["gemm"]) == 5
    assert sess.kernel_history("gemm")[-2].tuning_role == "candidate"
    assert sess.kernel_history("nope") == []


def test_history_points_equal_the_reference(tmp_path, naive, tiled):
    """The port's manifest-level history of a session the JAX package can
    read is the JAX package's, point for point."""
    sess = ProfileSession(tmp_path / "sess")
    sess.add_iteration([tiled])
    sess.add_iteration([naive], tuning={"role": "candidate", "accepted": False})
    want = ref_session.ProfileSession(tmp_path / "sess", create=False).history()
    got = sess.history()
    assert {k: [p.__dict__ for p in v] for k, v in got.items()} == {
        k: [p.__dict__ for p in v] for k, v in want.items()
    }


def test_merge_reports_combines_modes(tmp_path, tiled):
    base = _iteration(tmp_path, "base", [tiled])
    good = _iteration(tmp_path, "good", [tiled])
    baseline_report = check_iterations(base, good)
    anomaly = Anomaly(kernel="gemm", metric="transactions", value=9.0,
                      median=1.0, mad=0.0, lo=0.9, hi=1.1, n_history=3)
    anomaly_report = CheckReport(mode="anomaly", candidate="s", anomalies=(anomaly,),
                                 anomaly_meta={"nmads": 4.0})
    merged = merge_reports(baseline_report, anomaly_report)
    assert merged.mode == "baseline+anomaly"
    assert not merged.passed
    assert merged.kernels == baseline_report.kernels


# -- CLI exit-code contract ------------------------------------------------------------


@pytest.fixture()
def gate_dirs(tmp_path, naive, tiled):
    write_iteration(tmp_path / "base", [tiled], label="base")
    write_iteration(tmp_path / "good", [tiled], label="good")
    write_iteration(tmp_path / "bad", [naive], label="bad")
    return tmp_path


def test_cli_check_pass_is_exit_0(gate_dirs, capsys):
    rc = cli.main(["check", str(gate_dirs / "good"), "--baseline", str(gate_dirs / "base")])
    assert rc == 0
    assert "check passed" in capsys.readouterr().out


def test_cli_check_gate_failure_is_exit_1(gate_dirs, capsys):
    rc = cli.main(["check", str(gate_dirs / "bad"), "--baseline", str(gate_dirs / "base")])
    assert rc == 1
    assert "FAILED" in capsys.readouterr().out


@pytest.mark.parametrize(
    "manifest",
    ['{"format": "cuthermo-iteration", "version": 6, "kernels": 5}',
     '[1, 2]',
     '{"format": "cuthermo-iteration", "version": 6, "kernels": [5]}',
     '{"format": "cuthermo-iteration", "version": 99, "kernels": []}',
     "{not json"],
)
def test_cli_check_malformed_manifest_is_exit_2_without_traceback(gate_dirs, capsys, manifest):
    (gate_dirs / "bad" / "manifest.json").write_text(manifest)
    rc = cli.main(["check", str(gate_dirs / "bad"), "--baseline", str(gate_dirs / "base")])
    assert rc == 2
    err = capsys.readouterr().err
    assert err.startswith("cuthermo: ") and "Traceback" not in err


def test_cli_check_usage_and_load_errors_are_exit_2(gate_dirs, capsys):
    assert cli.main(["check", str(gate_dirs / "good")]) == 2
    assert cli.main(["check", str(gate_dirs / "nope"), "--baseline", str(gate_dirs / "base")]) == 2
    assert cli.main(["check", str(gate_dirs / "good"), "--baseline", str(gate_dirs / "base"),
                     "--threshold", "bogus=1"]) == 2
    assert cli.main(["check", str(gate_dirs / "good"), "--baseline", str(gate_dirs / "base"),
                     "--region-map", "nocolon"]) == 2
    assert cli.main(["check", str(gate_dirs / "good"), "--anomaly"]) == 2
    capsys.readouterr()


def test_cli_check_writes_json_and_sidecar(gate_dirs, capsys):
    out = gate_dirs / "check-report.json"
    rc = cli.main(["check", str(gate_dirs / "bad"), "--baseline", str(gate_dirs / "base"),
                   "--json", str(out), "--quiet"])
    assert rc == 1
    capsys.readouterr()
    doc = json.loads(out.read_text())
    assert doc["schema_version"] == CHECK_SCHEMA_VERSION and doc["passed"] is False
    assert json.loads((gate_dirs / "bad" / "check.json").read_text()) == doc


def test_cli_check_json_stdout(gate_dirs, capsys):
    rc = cli.main(["check", str(gate_dirs / "good"), "--baseline", str(gate_dirs / "base"),
                   "--json", "-"])
    assert rc == 0
    captured = capsys.readouterr()
    assert json.loads(captured.out)["passed"] is True  # stdout is pure JSON
    assert "check passed" in captured.err


def test_cli_check_anomaly_session_flow(tmp_path, naive, tiled, capsys):
    sess = ProfileSession(tmp_path / "sess")
    for _ in range(4):
        sess.add_iteration([tiled])
    sess.add_iteration([naive])
    assert cli.main(["check", str(tmp_path / "sess"), "--anomaly"]) == 1
    assert "anomal" in capsys.readouterr().out
    write_iteration(tmp_path / "base", [tiled], label="base")
    rc = cli.main(["check", str(tmp_path / "sess"), "--baseline", str(tmp_path / "base"),
                   "--anomaly", "--json", str(tmp_path / "c.json"), "--quiet"])
    assert rc == 1
    capsys.readouterr()
    doc = json.loads((tmp_path / "c.json").read_text())
    assert doc["mode"] == "baseline+anomaly" and doc["anomalies"]["flags"]
    rc = cli.main(["check", str(tmp_path / "sess"), "--anomaly", "--nmads", "4",
                   "--min-history", "6", "--quiet"])
    assert rc == 0
    capsys.readouterr()


def test_cli_report_renders_check_verdict(gate_dirs, capsys, tmp_path):
    assert cli.main(["check", str(gate_dirs / "bad"), "--baseline", str(gate_dirs / "base"),
                     "--quiet"]) == 1
    out = tmp_path / "bundle"
    assert cli.main(["report", str(gate_dirs / "bad"), "--out", str(out)]) == 0
    capsys.readouterr()
    html = (out / "index.html").read_text()
    assert "regression check" in html and "FAILED" in html
    assert "regression check" in (out / "report.md").read_text()


def test_cli_gate_on_the_h100_ladder(tmp_path, capsys):
    """The main path's gate: ``profile -k gemm:v01`` then ``-k gemm`` into
    one session, and ``check iter1 --baseline iter0`` exits 1 with the
    versioned document on stdout (the port's registry, on the CPU)."""
    sess = str(tmp_path / "s")
    for ref in ("gemm:v01", "gemm"):
        assert cli.main(["profile", "-k", ref, "--device", "cpu", "--out", sess, "-q"]) == 0
    capsys.readouterr()
    rc = cli.main(["check", f"{sess}/iter1", "--baseline", f"{sess}/iter0", "--json", "-"])
    assert rc == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["schema_version"] == 1 and doc["kernels"][0]["verdict"] == "regressed"
    assert cli.main(["check", sess, "--anomaly"]) == 0
    capsys.readouterr()


def test_cli_strict_gate_passes_down_the_h100_ladder(tmp_path, capsys):
    """ROADMAP queue 3 item 1, closed: ``profile -k gemm`` then ``-k
    gemm:v01`` at the registry's 1024^3, and the strict ``check iter1
    --baseline iter0`` exits 0 with no ``allow-pattern``.  v00's B is hot
    beside its false sharing (the hot rule reads sharing on words), so v01's
    hot B is no new class, and its severity rises by under the gate's
    +0.05."""
    sess = str(tmp_path / "s")
    for ref in ("gemm", "gemm:v01"):
        assert cli.main(["profile", "-k", ref, "--device", "cpu", "--out", sess, "-q"]) == 0
    capsys.readouterr()
    rc = cli.main(["check", f"{sess}/iter1", "--baseline", f"{sess}/iter0", "--json", "-"])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 0 and doc["passed"], doc
    (kc,) = doc["kernels"]
    assert kc["verdict"] == "improved"
