"""The port's artifacts: it reads the JAX package's v1–v6, writes v6 that the
JAX package reads bit-identically, and stamps H100 iterations v7."""

import json
from pathlib import Path

import pytest

import repro.kernels as rk
from repro.core import session as ref_session
from repro_torch.core import session
from repro_torch.core.trace import GridSampler
from repro_torch.kernels import gemm

from torch_parity import assert_heatmaps_match, to_port_spec

FIXTURES = Path(__file__).parent / "fixtures"


def _tpu_profiled(ref, name="gemm"):
    spec, ctx = rk.build(ref)
    return session.profile_kernel(
        to_port_spec(spec), GridSampler(None), ctx, name=name,
        variant=ref.partition(":")[2],
    )


def _h100_profiled(variant="v00", name="gemm", run=None):
    spec = getattr(gemm, f"gemm_{variant}_spec")(64, 64, 64)
    return session.profile_kernel(spec, name=name, variant=variant, run=run)


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5, 6])
def test_port_loads_reference_fixture(version):
    path = FIXTURES / f"artifact-v{version}"
    want = ref_session.load_iteration(path)
    got = session.load_iteration(path)
    assert got.version == version
    assert got.label == want.label and got.note == want.note
    assert got.kernel_names() == want.kernel_names()
    assert got.tuning == want.tuning and got.layers == want.layers
    assert got.faults == want.faults
    for g, w in zip(got.kernels, want.kernels):
        assert_heatmaps_match(g.heatmap, w.heatmap)
        assert g.heatmap.shards == tuple(
            session.ShardInfo(**s.__dict__) for s in w.heatmap.shards
        )
        assert [f.as_dict() for f in g.heatmap.faults] == [
            f.as_dict() for f in w.heatmap.faults
        ]
        assert [(r.pattern, r.region, r.severity) for r in g.reports] == [
            (r.pattern, r.region, r.severity) for r in w.reports
        ]
        assert g.region_map == w.region_map and g.variant == w.variant
        assert all(rh.region.geometry.kind == "tpu-tile" for rh in g.heatmap.regions)


def test_reference_reads_port_tpu_iteration_bit_identically(tmp_path):
    pks = [_tpu_profiled("gemm:v00", "gemm:v00"), _tpu_profiled("spmv:csr", "spmv")]
    session.write_iteration(tmp_path / "it", pks, label="port")
    manifest = json.loads((tmp_path / "it" / "manifest.json").read_text())
    assert manifest["version"] == 6
    it = ref_session.load_iteration(tmp_path / "it")
    for name, ref in (("gemm:v00", "gemm:v00"), ("spmv", "spmv:csr")):
        spec, ctx = rk.build(ref)
        want = ref_session.profile_kernel(spec, rk.get(ref.split(":")[0]).sampler(), ctx)
        assert ref_session.heatmaps_equal(it.kernel(name).heatmap, want.heatmap)
    assert it.label == "port"


def test_reference_rejects_h100_iteration(tmp_path):
    session.write_iteration(tmp_path / "it", [_h100_profiled()])
    assert json.loads((tmp_path / "it" / "manifest.json").read_text())["version"] == 7
    with pytest.raises(ref_session.SessionError, match="version 7"):
        ref_session.load_iteration(tmp_path / "it")


def test_mixed_geometries_are_stamped_v7(tmp_path):
    pks = [_tpu_profiled("gemm:v00", "tpu"), _h100_profiled(name="h100")]
    assert session.iteration_version(pks) == 7
    assert session.iteration_version(pks[:1]) == 6


def test_h100_iteration_round_trips_with_its_run(tmp_path):
    run = {"device": "NVIDIA H100 80GB HBM3", "launches": 21, "ms": 0.1,
           "max_abs_err": 0.0, "dtype": "float32", "shapes": [[64, 64], [64, 64]]}
    pk = _h100_profiled(run=run)
    session.write_iteration(tmp_path / "it", [pk])
    back = session.load_iteration(tmp_path / "it").kernels[0]
    assert session.heatmaps_equal(back.heatmap, pk.heatmap)
    assert all(rh.region.geometry.kind == "h100-sector" for rh in back.heatmap.regions)
    assert back.run == run
    assert back.transactions == pk.transactions


def test_session_diff_matches_reference_on_tpu_specs(tmp_path):
    sess = session.ProfileSession(tmp_path / "s")
    sess.add_iteration([_tpu_profiled("gemm:v00")])
    sess.add_iteration([_tpu_profiled("gemm:v01")])
    assert sess.iteration_names() == ["iter0", "iter1"]
    got = sess.diff(0, -1)
    want = ref_session.ProfileSession(tmp_path / "s", create=False).diff(0, 1)
    assert got.summary() == want.summary()
    assert [v.verdict for v in got.verdicts] == ["improved"]


def test_h100_session_diff(tmp_path):
    sess = session.ProfileSession(tmp_path / "s")
    sess.add_iteration([_h100_profiled("v00")])
    sess.add_iteration([_h100_profiled("v01")])
    d = sess.diff("iter0", "iter1").verdicts[0]
    assert d.verdict == "improved"
    assert ("C", "false-sharing") in d.diff.fixed


def test_load_errors(tmp_path):
    with pytest.raises(session.SessionError, match="no manifest"):
        session.load_iteration(tmp_path)
    (tmp_path / "manifest.json").write_text(json.dumps({"version": 99}))
    with pytest.raises(session.SessionError, match="version 99"):
        session.load_iteration(tmp_path)
    with pytest.raises(session.SessionError, match="duplicate"):
        session.write_iteration(tmp_path / "d", [_h100_profiled(), _h100_profiled()])
    with pytest.raises(session.SessionError, match="session.json"):
        session.ProfileSession(tmp_path / "none", create=False)
