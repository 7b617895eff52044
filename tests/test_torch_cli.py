"""``python -m repro_torch.cli``: profile -> diff -> report on the CPU, and
the 0/1/2 exit contract."""

import json

import pytest
import torch

from repro_torch import cli


@pytest.fixture(scope="module")
def sess(tmp_path_factory):
    """gemm v00, v01 and v02 profiled on the CPU, one per iteration."""
    root = tmp_path_factory.mktemp("cli") / "sess"
    for argv in (
        ["-k", "gemm:v00", "--device", "cpu"],
        ["-k", "gemm:v01", "--device", "cpu", "-q"],
        ["-k", "gemm:v02", "--device", "cpu", "-q"],
    ):
        assert cli.main(["profile", *argv, "--out", str(root)]) == 0
    return root


def test_profile_records_the_cpu_run(sess, capsys):
    manifest = json.loads((sess / "iter0" / "manifest.json").read_text())
    assert manifest["version"] == 7
    (entry,) = manifest["kernels"]
    assert entry["name"] == "gemm" and entry["variant"] == "v00"
    assert entry["run"]["device"] == "cpu" and entry["run"]["ms"] is None
    assert entry["run"]["launches"] == 0
    assert {p["pattern"] for p in entry["patterns"]} >= {"false-sharing"}


def test_diff_shows_false_sharing_on_c_fixed(sess, capsys):
    assert cli.main(["diff", str(sess / "iter0"), str(sess / "iter1")]) == 0
    out = capsys.readouterr().out
    assert "[fixed] false-sharing on C" in out
    assert "[ improved] gemm: transfers 168820736 -> 138543104" in out


def test_diff_gates_a_regression(sess, capsys):
    argv = ["diff", str(sess / "iter1"), str(sess / "iter0")]
    assert cli.main(argv) == 0
    assert cli.main([*argv, "--fail-on-regression"]) == 1
    assert "regressed" in capsys.readouterr().out


def test_report_writes_the_bundle(sess, tmp_path, capsys):
    out = tmp_path / "bundle"
    assert cli.main(["report", str(sess / "iter0"), "--out", str(out)]) == 0
    assert (out / "index.html").is_file() and (out / "report.md").is_file()
    assert (out / "gemm.csv").read_text().startswith("region,sector_tag,repeat,w0")
    md = (out / "report.md").read_text()
    assert "ran the plain version on cpu" in md
    # a session directory reports its latest iteration
    assert cli.main(["report", str(sess)]) == 0
    assert (sess / "iter2" / "report" / "index.html").is_file()


def test_kernels_lists_the_ladder(capsys):
    assert cli.main(["kernels"]) == 0
    out = capsys.readouterr().out
    assert "gemm" in out and "v00*" in out and "v02" in out


@pytest.mark.parametrize(
    "argv",
    [
        [],
        ["profile"],
        ["profile", "-k", "nosuch", "--device", "cpu"],
        ["profile", "-k", "gemm:v07", "--device", "cpu"],
        ["diff", "nowhere0", "nowhere1"],
        ["diff", "a", "b", "--region-map", "bad"],
        ["report", "nowhere"],
    ],
)
def test_usage_and_load_errors_exit_2(argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv) == 2


def test_bad_sampler_exits_2(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main(["profile", "-k", "gemm", "--sampler", "window:0", "--out", str(tmp_path)])
    assert e.value.code == 2


def test_cuda_without_a_card_exits_2_and_writes_nothing(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "s"
    assert cli.main(["profile", "-k", "gemm", "--out", str(out)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_empty_session_report_exits_2(tmp_path):
    from repro_torch.core.session import ProfileSession

    ProfileSession(tmp_path / "s")
    assert cli.main(["report", str(tmp_path / "s")]) == 2


def test_kernel_mismatch_exits_1(tmp_path, monkeypatch):
    import dataclasses

    from repro_torch import kernels as kreg

    entry = kreg.REGISTRY["gemm"]
    bad = dataclasses.replace(entry.variants[2], kernel=lambda a, b: a @ b + 1)
    monkeypatch.setitem(
        kreg.REGISTRY, "gemm",
        dataclasses.replace(entry, variants=entry.variants[:2] + (bad,)),
    )
    argv = ["profile", "-k", "gemm:v02", "--device", "cpu", "--out", str(tmp_path)]
    assert cli.main(argv) == 1
