"""The port's heat-map engine held against the JAX package's, and the port's
GEMM specs held against the CUDA kernels they describe."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.kernels as rk
from repro.core import analyze as ref_analyze
from repro.core.advisor import advise as ref_advise
from repro.core.collector import probe_affine_map as ref_probe_affine_map
from repro.core.patterns import detect_all as ref_detect_all
from repro_torch.core import api
from repro_torch.core.advisor import advise
from repro_torch.core.collector import analyze, probe_affine_map
from repro_torch.core.diff import diff
from repro_torch.core.patterns import FALSE_SHARING, HOT, detect_all
from repro_torch.core.trace import GridSampler, sampled_grid_array
from repro_torch.kernels import gemm

from torch_parity import assert_heatmaps_match, heat_of_warps, to_port_spec

SRC = Path(__file__).resolve().parents[1] / "src"

REFS = [f"{name}:{v.name}" for name in rk.names() for v in rk.get(name).variants]


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.cli, repro_torch.kernels\n"
        "import repro_torch.core.api, repro_torch.core.session\n"
        "import repro_torch.core.render, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.gramschm, repro_torch.kernels.ttm\n"
        "import repro_torch.kernels.histogram, repro_torch.kernels.spmv\n"
        "import repro_torch.kernels.flash, repro_torch.kernels.gmm, repro_torch.kernels.ssd\n"
        "import repro_torch.kernels.ragged_flash, repro_torch.kernels.paged_attn\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.core.model_profile\n"
        "import repro_torch.core._reference, repro_torch.core.faultinject\n"
        "import repro_torch.runtime.fault, repro_torch.core.tuner\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, check=True,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
    )
    assert out.stdout.strip() == ""


def test_registry_has_24_variants():
    assert len(REFS) == 24


@pytest.mark.parametrize("ref", REFS)
def test_engine_parity_on_reference_specs(ref):
    """Under TPUTile the port's analysis equals the JAX package's."""
    entry = rk.get(ref.partition(":")[0])
    spec, ctx = rk.build(ref)
    want = ref_analyze(spec, sampler=entry.sampler(), dynamic_context=ctx)
    got = analyze(to_port_spec(spec), sampler=entry.sampler(), dynamic_context=ctx)
    assert_heatmaps_match(got, want)
    assert [(r.pattern, r.region, r.severity) for r in detect_all(got)] == [
        (r.pattern, r.region, r.severity) for r in ref_detect_all(want)
    ]
    assert [(a.kind, a.region, a.est_transaction_saving) for a in advise(got)] == [
        (a.kind, a.region, a.est_transaction_saving) for a in ref_advise(want)
    ]


@pytest.mark.parametrize("ref", REFS)
def test_probe_affine_map_parity(ref):
    """Every operand's affine model (or its absence) equals the reference's,
    and a model predicts the index map over the whole grid."""
    spec = rk.build(ref)[0]
    pids = sampled_grid_array(spec.grid, GridSampler(None))
    for op in spec.operands:
        got = probe_affine_map(op.index_map, spec.grid)
        want = ref_probe_affine_map(op.index_map, spec.grid)
        assert (got is None) == (want is None), op.name
        if got is None:
            continue
        assert (got.base, got.coeffs) == (want.base, want.coeffs), op.name
        expect = np.array([op.index_map(*map(int, p)) for p in pids[:: max(1, len(pids) // 64)]])
        np.testing.assert_array_equal(
            got.predict_batch(pids[:: max(1, len(pids) // 64)]), expect
        )


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("sampler", [GridSampler(None), GridSampler((0,), window=5)])
def test_drain_dynamic_parity(itemsize, sampler):
    """A Level-2 index trace drains to the reference's heat map under
    TPUTile; under H100Sector an 8-byte element touches two words."""
    from repro.core import collector as rc
    from repro.core.heatmap import Analyzer as RefAnalyzer
    from repro_torch.core import collector as pc
    from repro_torch.core.heatmap import Analyzer

    dtype = np.float32 if itemsize == 4 else np.float64
    rng = np.random.default_rng(itemsize)
    grid = (4, 6)
    trace = rng.integers(-1, 64 * 40, size=(24, 12))
    mask = rng.random((24, 12)) < 0.8
    ref_op = rc.OperandSpec("x", (64, 40), dtype, (1, 40), lambda i, j: (i, 0))
    maps = []
    for geom_kind in ("tpu-tile", "h100-sector"):
        op = pc.OperandSpec(
            "x", (64, 40), dtype, (1, 40), lambda i, j: (i, 0),
            geometry_kind=geom_kind,
        )
        an = Analyzer("k", grid, sampler.describe())
        an.ingest(pc.drain_dynamic("k", grid, op, trace, sampler, mask))
        maps.append(an.flush())
    ref_an = RefAnalyzer("k", grid, sampler.describe())
    ref_an.ingest(rc.drain_dynamic("k", grid, ref_op, trace, sampler, mask))
    assert_heatmaps_match(maps[0], ref_an.flush())
    h100 = maps[1].region("x")
    if itemsize == 8:
        # every 8-byte element covers an even word and the odd one after it
        wt = h100.word_temps_matrix
        np.testing.assert_array_equal(wt[:, 0::2], wt[:, 1::2])


def test_gemm_ladder_transfers_match_reference_transcript():
    before = analyze(to_port_spec(rk.build("gemm:v00")[0]), GridSampler(None))
    after = analyze(to_port_spec(rk.build("gemm:v01")[0]), GridSampler(None))
    d = diff(before, after)
    assert (d.tx_before, d.tx_after) == (1064960, 133120)
    assert ("C", FALSE_SHARING) in d.fixed and ("A", FALSE_SHARING) in d.fixed
    assert ("B", HOT) in d.persisting


def test_sampled_window_parity():
    spec = rk.build("gemm:v00")[0]
    sampler = GridSampler((0,), window=32)
    assert_heatmaps_match(
        analyze(to_port_spec(spec), sampler), ref_analyze(spec, sampler)
    )


# -- the port's own GEMM specs under the H100 geometry -------------------------


def _classes(hm):
    return {(r.region, r.pattern) for r in detect_all(hm)}


@pytest.fixture(scope="module")
def h100_ladder():
    return {
        v: analyze(getattr(gemm, f"gemm_{v}_spec")(256, 256, 256), GridSampler(None))
        for v in ("v00", "v01", "v02")
    }


def test_story_parity_under_h100(h100_ladder):
    v00, v01, v02 = (h100_ladder[v] for v in ("v00", "v01", "v02"))
    assert ("C", FALSE_SHARING) in _classes(v00)
    assert ("C", FALSE_SHARING) not in _classes(v01)
    assert v02.sector_transactions() < v01.sector_transactions()
    assert v01.sector_transactions() < v00.sector_transactions()
    d = diff(v00, v01)
    assert ("C", FALSE_SHARING) in d.fixed
    assert d.verdict == "improved"


def test_h100_pattern_classes_per_rung(h100_ladder):
    """Recorded divergence from the reference rungs: with a warp's lanes on
    one column of B, v00's B sectors are each read one word per warp
    (false sharing) while each word is read by every warp of its column
    (hot, read on word temperatures: the paper's Table I has B {hot,
    false-sharing}), and A is the operand every warp re-reads (hot)."""
    assert _classes(h100_ladder["v00"]) == {
        ("C", FALSE_SHARING), ("B", FALSE_SHARING), ("B", HOT), ("A", HOT)
    }
    assert _classes(h100_ladder["v01"]) == {("A", HOT), ("B", HOT)}
    # v02's 64 x 128 tiles: at 256^3 each A sector is read by the 2 warps of
    # its column tiles (under hot's 4), each B sector by the 4 of its row tiles
    assert _classes(h100_ladder["v02"]) == {("B", HOT)}


def test_api_report_names_cuda_knobs():
    text = api.report(gemm.gemm_v00_spec(64, 64, 64), GridSampler(None))
    assert "false-sharing" in text
    assert "thread indices" in text


# -- specs against an emulation of csrc/gemm.cu ---------------------------------


def _threads_v00(m, n, k):
    """(warp id, row, col) of every live thread of gemm_v00_kernel."""
    out = []
    for bx in range((m + 31) // 32):
        for by in range((n + 7) // 8):
            for ty in range(8):
                for tx in range(32):
                    row, col = bx * 32 + tx, by * 8 + ty
                    if row < m and col < n:
                        out.append(((bx, by, ty), row, col))
    return out


def _threads_v01(m, n, k):
    out = []
    for bx in range((n + 31) // 32):
        for by in range((m + 7) // 8):
            for ty in range(8):
                for tx in range(32):
                    col, row = bx * 32 + tx, by * 8 + ty
                    if row < m and col < n:
                        out.append(((bx, by, ty), row, col))
    return out


def _emulate_naive(threads, m, n, k):
    """Per-warp flat indices of A, B, C for the one-thread-per-C kernels."""
    acc = {"A": {}, "B": {}, "C": {}}
    kk = np.arange(k)
    for warp, row, col in threads:
        acc["A"].setdefault(warp, []).append(row * k + kk)
        acc["B"].setdefault(warp, []).append(kk * n + col)
        acc["C"].setdefault(warp, []).append(np.array([row * n + col]))
    return acc


def _tc_block_rows(m, n):
    """The bfloat16 route's tile rule: 128-row tiles when the 128 x 128 grid
    has a block for each of the 132 SMs, else 64."""
    return 128 if -(-m // 128) * -(-n // 128) >= 132 else 64


def _add(acc, name, key, idx):
    acc[name].setdefault(key, []).append(np.asarray(idx, np.int64))


def _emulate_v02_f32(m, n, k):
    """Per-warp flat indices of A, B, C for gemm_v02_kernel (float32), thread
    by thread: 64 x 128 tiles, 128 threads a block; thread t loads the
    float4 at row t / 2, columns 4 (t % 2) of each (64, 8) A tile and
    float4 items t, t + 128 (row i / 32, columns 4 (i % 32)) of each
    (8, 128) B tile, every element past M, N or K left out; thread
    (t / 16, t % 16) stores rows 8 (t / 16) .. +7 at columns 4 (t % 16) ..
    +3 and 64 + that."""
    bm, threads = 64, 128
    acc = {"A": {}, "B": {}, "C": {}}
    for rt in range(-(-m // bm)):
        for ct in range(-(-n // 128)):
            row0, col0 = rt * bm, ct * 128
            for tid in range(threads):
                key = (rt, ct, tid // 32)
                for name in acc:
                    _add(acc, name, key, [])
                a_r, a_k = tid // 2, (tid % 2) * 4
                for k0 in range(0, k, 8):
                    gr, gk = row0 + a_r, k0 + a_k
                    if gr < m:
                        _add(acc, "A", key, gr * k + np.arange(gk, min(gk + 4, k)))
                    for s in range(8 * 128 // 4 // threads):
                        i = tid + threads * s
                        gkr, gc = k0 + i // 32, col0 + (i % 32) * 4
                        if gkr < k:
                            _add(acc, "B", key, gkr * n + np.arange(gc, min(gc + 4, n)))
                tx, ty = tid % 16, tid // 16
                for i in range(8):
                    gr = row0 + 8 * ty + i
                    if gr >= m:
                        continue
                    for half in range(2):
                        gc = col0 + 64 * half + 4 * tx
                        _add(acc, "C", key, gr * n + np.arange(gc, min(gc + 4, n)))
    return acc


def _emulate_v02_tc(m, n, k):
    """Per-warp flat indices of A, B, C for gemm_v02_tc_kernel<BM>
    (bfloat16), thread by thread: 128 threads a block; thread t copies
    16-byte chunks t, t + 128, ... (8 elements each) of every (BM, 64) A
    tile and (64, 128) B tile, the elements inside M, K and N; lane l of
    warp w stores chunks l, l + 32, ... of rows (BM/4) w .. of the C tile."""
    bm = _tc_block_rows(m, n)
    acc = {"A": {}, "B": {}, "C": {}}
    for rt in range(-(-m // bm)):
        for ct in range(-(-n // 128)):
            row0, col0 = rt * bm, ct * 128
            for tid in range(128):
                w, lane = divmod(tid, 32)
                key = (rt, ct, w)
                for name in acc:
                    _add(acc, name, key, [])
                for k0 in range(0, k, 64):
                    for i in range(tid, bm * 8, 128):
                        r, col = i // 8, k0 + (i % 8) * 8
                        if row0 + r < m:
                            _add(acc, "A", key, (row0 + r) * k + np.arange(col, min(col + 8, k)))
                    for i in range(tid, 64 * 16, 128):
                        r, col = k0 + i // 16, col0 + (i % 16) * 8
                        if r < k:
                            _add(acc, "B", key, r * n + np.arange(col, min(col + 8, n)))
                per = bm // 4
                for i in range(lane, per * 16, 32):
                    r, gc = row0 + per * w + i // 16, col0 + 8 * (i % 16)
                    if r < m and gc < n:
                        _add(acc, "C", key, r * n + np.arange(gc, min(gc + 8, n)))
    return acc


def _assert_gemm_spec_matches(spec, acc, m, n, k, itemsize):
    hm = analyze(spec, GridSampler(None))
    shapes = {"A": (m, k), "B": (k, n), "C": (m, n)}
    for name in ("A", "B", "C"):
        tags, wt, st, warps = heat_of_warps(acc[name], shapes[name], itemsize)
        rh = hm.region(name)
        np.testing.assert_array_equal(rh.tags_array, tags, err_msg=name)
        np.testing.assert_array_equal(rh.word_temps_matrix, wt, err_msg=name)
        np.testing.assert_array_equal(rh.sector_temps_array, st, err_msg=name)
        assert rh.n_programs == warps, name


@pytest.mark.parametrize("mnk", [(64, 128, 32), (40, 72, 24)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("variant", ["v00", "v01", "v02"])
def test_spec_matches_kernel_thread_mapping(variant, dtype, mnk):
    m, n, k = mnk
    itemsize = 4 if dtype is np.float32 else 2
    spec_dtype = np.float32 if itemsize == 4 else np.float16  # same width
    if variant == "v02":
        # the route's own kernel: bfloat16 names the tensor-core one
        acc = (_emulate_v02_f32 if itemsize == 4 else _emulate_v02_tc)(m, n, k)
        spec_dtype = dtype
    else:
        threads = (_threads_v00 if variant == "v00" else _threads_v01)(m, n, k)
        acc = _emulate_naive(threads, m, n, k)
    spec = getattr(gemm, f"gemm_{variant}_spec")(m, n, k, dtype=spec_dtype)
    _assert_gemm_spec_matches(spec, acc, m, n, k, itemsize)


@pytest.mark.parametrize(
    "mnk",
    [
        (1, 1, 1),  # one element
        (37, 130, 13),  # K and N not multiples of 4: scalar loads; two column tiles
        (130, 260, 70),  # a ragged last row, column and K step
        (1537, 1409, 5),  # bf16: 13 x 12 tiles of 128 rows (the grid fills the card), ragged
    ],
)
@pytest.mark.parametrize("route", ["float32", "bfloat16"])
def test_v02_spec_matches_each_route_at_ragged_edges(route, mnk):
    """gemm_v02_spec for each dtype's route, held against the thread-by-thread
    emulation of that route's kernel, at one element, at ragged edges in
    M, N and K, and on both of the bf16 route's tile heights (64 rows, and
    128 once the grid of 128 x 128 tiles has a block for each of the 132
    SMs; the f32 route has 64 only)."""
    m, n, k = mnk
    assert gemm.block_rows(m, n, torch.bfloat16) == _tc_block_rows(m, n) == (128 if m > 1500 else 64)
    assert gemm.block_rows(m, n, torch.float32) == 64
    if route == "float32":
        acc, itemsize = _emulate_v02_f32(m, n, k), 4
    else:
        acc, itemsize = _emulate_v02_tc(m, n, k), 2
    _assert_gemm_spec_matches(gemm.gemm_v02_spec(m, n, k, dtype=route), acc, m, n, k, itemsize)
