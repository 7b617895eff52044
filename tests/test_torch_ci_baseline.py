"""The port's dogfooded regression gate against its committed baseline.

``artifacts/ci-baseline-torch`` is written by
``tools/make_ci_baseline_torch.py``: the reference's three optimized rungs
(``gemm:v01``, ``gramschm:opt``, ``model.transformer-tiny.mlp:v02``)
profiled by the port under its ``H100Sector`` geometry.  Profiling is
integer arithmetic over seeded contexts, so a fresh profile equals the
committed one, heat map for heat map; only the manifest's timestamps and
``wall_s`` differ between runs.  The check-smoke runs through the
in-process CLI on the CPU: the three rungs pass the gate (exit 0) and
``gemm:v00`` fails it (exit 1, on modeled transfers).  Under ``TPUTile``
the reference's own rungs, profiled by the port, pass the reference's own
committed ``artifacts/ci-baseline``.
"""

import importlib
import importlib.util
import json
import tomllib
from pathlib import Path

import numpy as np
import pytest

from repro import kernels as rk
from repro_torch import cli
from repro_torch.core.check import check_iterations
from repro_torch.core.session import (
    heatmaps_equal,
    load_iteration,
    profile_kernel,
    write_iteration,
)
from torch_parity import port_sampler, to_port_spec

ROOT = Path(__file__).resolve().parent.parent
BASELINE = ROOT / "artifacts" / "ci-baseline-torch"
REF_BASELINE = ROOT / "artifacts" / "ci-baseline"
WRITER = ROOT / "tools" / "make_ci_baseline_torch.py"

#: modeled transfers and pattern classes of each baseline rung under the
#: port's H100Sector geometry
WANT = {
    "gemm": (138543104, ["hot@A", "hot@B"]),
    "gramschm": (34112, ["hot@qT"]),
    "model.transformer-tiny.mlp": (16384, []),
}
#: the reference's committed baseline under its TPU tiles (artifacts/ci-baseline)
WANT_TPU = {"gemm": 133120, "gramschm": 264, "model.transformer-tiny.mlp": 384}


def writer():
    spec = importlib.util.spec_from_file_location("make_ci_baseline_torch", WRITER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def classes(pk):
    return sorted(f"{r.pattern}@{r.region}" for r in pk.reports)


def stable(manifest):
    """A manifest without what may differ between runs: ``created`` and
    each kernel's ``wall_s``."""
    out = {k: v for k, v in manifest.items() if k != "created"}
    out["kernels"] = [{k: v for k, v in e.items() if k != "wall_s"} for e in manifest["kernels"]]
    return out


def npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_same_iteration_files(got, want):
    got_m = json.loads((got / "manifest.json").read_text())
    want_m = json.loads((want / "manifest.json").read_text())
    assert stable(got_m) == stable(want_m)
    for entry in want_m["kernels"]:
        a, b = npz_arrays(got / entry["npz"]), npz_arrays(want / entry["npz"])
        assert a.keys() == b.keys(), entry["name"]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{entry['name']}/{key}")


@pytest.fixture(scope="module")
def candidate(tmp_path_factory):
    """The check-smoke's candidate: the three rungs profiled fresh through
    the CLI on the CPU (each rung's plain version runs; no timing)."""
    sess = tmp_path_factory.mktemp("cand")
    argv = ["profile", "--kernel", "gemm:v01", "--kernel", "gramschm:opt",
            "--kernel", "model.transformer-tiny.mlp:v02", "--device", "cpu",
            "--out", str(sess), "--quiet"]
    assert cli.main(argv) == 0
    return sess / "iter0"


def test_the_committed_baseline_loads_and_is_pinned():
    it = load_iteration(BASELINE)
    assert it.label == "ci-baseline-torch"
    assert "tools/make_ci_baseline_torch.py" in it.note
    assert {pk.name: (pk.transactions, classes(pk)) for pk in it.kernels} == WANT
    assert {pk.name: pk.variant for pk in it.kernels} == {
        "gemm": "v01", "gramschm": "opt", "model.transformer-tiny.mlp": "v02"}
    for pk in it.kernels:
        assert pk.run is None
        assert {r.region.geometry.kind for r in pk.heatmap.regions} == {"h100-sector"}


def test_a_fresh_profile_equals_the_committed_baseline(candidate):
    base = {pk.name: pk for pk in load_iteration(BASELINE).kernels}
    fresh = load_iteration(candidate).kernels
    assert [pk.name for pk in fresh] == list(WANT)
    for pk in fresh:
        assert (pk.transactions, classes(pk)) == WANT[pk.name]
        assert pk.transactions == base[pk.name].transactions
        assert classes(pk) == classes(base[pk.name])
        assert heatmaps_equal(pk.heatmap, base[pk.name].heatmap), pk.name
        # the CLI ran each rung's plain version on the CPU
        assert pk.run is not None and pk.run["device"] == "cpu"


def test_the_writer_is_deterministic_and_reproduces_the_artifact(tmp_path):
    mod = writer()
    assert mod.BASELINE_REFS == {
        "gemm": "gemm:v01", "gramschm": "gramschm:opt",
        "model.transformer-tiny.mlp": "model.transformer-tiny.mlp:v02"}
    a, b = tmp_path / "a", tmp_path / "b"
    assert mod.main(["--out", str(a)]) == 0
    assert mod.main(["--out", str(b)]) == 0
    assert_same_iteration_files(a, b)
    assert_same_iteration_files(a, BASELINE)


def test_check_smoke_the_baseline_rungs_pass(candidate, tmp_path):
    doc_path = tmp_path / "check-pass.json"
    rc = cli.main(["check", str(candidate), "--baseline", str(BASELINE),
                   "--json", str(doc_path), "--quiet"])
    assert rc == 0
    doc = json.loads(doc_path.read_text())
    assert doc["format"] == "cuthermo-check"
    assert doc["schema_version"] == 1
    assert doc["passed"] is True, doc["failures"]
    assert {k["kernel"]: k["status"] for k in doc["kernels"]} == dict.fromkeys(WANT, "pass")


def test_check_smoke_the_detiled_gemm_fails(tmp_path):
    sess = tmp_path / "detiled"
    assert cli.main(["profile", "--kernel", "gemm:v00", "--device", "cpu",
                     "--out", str(sess), "--quiet"]) == 0
    doc_path = tmp_path / "check-fail.json"
    rc = cli.main(["check", str(sess / "iter0"), "--baseline", str(BASELINE),
                   "--threshold", "missing=off", "--json", str(doc_path), "--quiet"])
    assert rc == 1
    doc = json.loads(doc_path.read_text())
    assert doc["schema_version"] == 1 and doc["passed"] is False
    assert any("modeled transfers" in f for f in doc["failures"]), doc["failures"]
    (gemm,) = [k for k in doc["kernels"] if k["kernel"] == "gemm"]
    assert gemm["status"] == "fail"
    assert load_iteration(sess / "iter0").kernels[0].transactions == 168820736


def test_under_tpu_tiles_the_port_passes_the_reference_s_baseline(tmp_path):
    """Engine parity of the gate: the reference's own rungs through the
    port's engine, gated by the port's check against the reference's own
    committed baseline."""
    profiled = []
    for name, ref in writer().BASELINE_REFS.items():
        entry, variant = rk.resolve(ref)
        spec, ctx = rk.build(ref)
        profiled.append(profile_kernel(
            to_port_spec(spec), port_sampler(entry.sampler()), ctx,
            name=name, variant=variant.name, region_map=entry.region_map,
        ))
    cand = load_iteration(write_iteration(tmp_path / "cand", profiled, label="tpu"))
    base = load_iteration(REF_BASELINE)
    report = check_iterations(base, cand)
    assert report.passed, report.summary()
    assert {k.name: k.transactions for k in cand.kernels} == WANT_TPU
    assert {k.name: k.transactions for k in base.kernels} == WANT_TPU
    for got, want in zip(cand.kernels, base.kernels):
        assert got.name == want.name
        assert classes(got) == classes(want)
        assert heatmaps_equal(got.heatmap, want.heatmap), got.name


def test_console_script_resolves_to_the_port_s_main():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["cuthermo"] == "repro.cli:main"
    module, attr = scripts["cuthermo-torch"].split(":")
    assert getattr(importlib.import_module(module), attr) is cli.main
