"""The paper's Table I (patterns detected per application, kernel and data
object) on the port's engine, under both geometries.

The ten expected rows and the five "clean" rows of the optimized variants
are copied from the JAX package's Table I bench
(``benchmarks/bench_patterns.py:29-40`` and ``:103-109``), with its
shapes, samplers and seeded inputs (``:44-76``); this file neither imports
nor reads that folder.  A row scores when the detected classes meet the
expected set; a clean row scores when the optimized variant lacks the
class it fixed.

* Under ``H100Sector`` the port's own specs (its CUDA kernels' thread
  mappings) score 15/15 (ROADMAP queue 3 items 1 and 12).
* Under ``TPUTile`` the reference's specs, rebuilt by
  ``torch_parity.to_port_spec``, give on the port's engine the classes the
  reference's engine gives, row by row.

Two synthetic walks hold the strided rule's gate: a random gather is not
strided and a walk over one word of every sector is, under both
geometries.
"""

import numpy as np
import pytest

from repro.core import analyze as ref_analyze
from repro.core.heatmap import Heatmap as RefHeatmap
from repro.core.heatmap import RegionHeatmap as RefRegionHeatmap
from repro.core.patterns import detect_all as ref_detect_all
from repro.core.tiles import TileGeometry
from repro.core.trace import GridSampler as RefSampler
from repro.core.trace import RegionInfo as RefRegionInfo
from repro.kernels import gemm as ref_gemm
from repro.kernels import gramschm as ref_gramschm
from repro.kernels import histogram as ref_histogram
from repro.kernels import spmv as ref_spmv
from repro.kernels import ttm as ref_ttm
from repro_torch.core.collector import analyze
from repro_torch.core.heatmap import Heatmap, RegionHeatmap
from repro_torch.core.patterns import STRIDED, detect_all, detect_strided
from repro_torch.core.tiles import H100Sector, TPUTile
from repro_torch.core.trace import GridSampler, RegionInfo
from repro_torch.kernels import gemm, gramschm, histogram, spmv, ttm

from torch_parity import port_sampler, to_port_spec

# benchmarks/bench_patterns.py:29-40, as they are there
EXPECTED = [
    ("GEMM", "gemm_v00", "B", {"hot", "false-sharing"}),
    ("GEMM", "gemm_v00", "C", {"false-sharing"}),
    ("GEMM", "gemm_v01", "B", {"hot"}),
    ("SpMV", "spmv_csr", "rowOffsets_shift1", {"misalignment"}),
    ("SpMV", "spmv_csr", "x", {"hot", "hot-random"}),
    ("PASTA", "spt_TTMRankRBNnzKernelSM", "Y_shr", {"scratch-abuse"}),
    ("cuSZp", "cuszp_compress_like", "exel_sum", {"scratch-abuse"}),
    ("cuSZp", "cuszp_compress_like", "base_idx", {"scratch-abuse"}),
    ("GRAMSCHM", "gramschmidt_kernel3", "q", {"strided"}),
    ("GPUMD", "find_cell_counts", "cell_count", {"hot", "false-sharing", "strided"}),
]

# benchmarks/bench_patterns.py:103-109: optimized variants must be clean of
# their original pattern
CLEAN = [
    ("gemm_v02", "C", "false-sharing"),
    ("spmv_zigzag", "rowPairs", "misalignment"),
    ("spt_TTMRankRBNnzKernel_reg", "Y_shr", "scratch-abuse"),
    ("gramschmidt_kernel3_opt", "qT", "strided"),
    ("find_cell_counts_opt2", "cell_count", "false-sharing"),
]

N_ROWS, N_COLS = 65536, 36417  # the SpMV's scale (bench_patterns.py:49-50)


def _inputs():
    """The bench's seeded inputs, drawn in its order from one generator."""
    rng = np.random.default_rng(0)
    colidx = np.minimum(
        rng.zipf(1.3, size=N_ROWS).astype(np.int64) * 37 % N_COLS, N_COLS - 1
    ).astype(np.int32)
    cells = rng.integers(0, 2048, size=65536).astype(np.int64)
    return colidx, cells


def _cases(mods):
    """(kernel name, spec, window, dynamic context) for each heat map of the
    bench (bench_patterns.py:44-76), built by the modules ``mods``."""
    g, s, t, gs, h = (mods[k] for k in ("gemm", "spmv", "ttm", "gramschm", "histogram"))
    colidx, cells = _inputs()
    spmv_ctx = {"col_indices": colidx}
    return [
        ("gemm_v00", g.gemm_v00_spec(1024, 1024, 1024), 32, None),
        ("gemm_v01", g.gemm_v01_spec(1024, 1024, 1024), 32, None),
        ("gemm_v02", g.gemm_v02_spec(1024, 1024, 1024), 8, None),
        ("spmv_csr", s.spmv_csr_spec(N_ROWS, N_COLS), 32, spmv_ctx),
        ("spmv_zigzag", s.spmv_zigzag_spec(N_ROWS, N_COLS), 32, spmv_ctx),
        ("spt_TTMRankRBNnzKernelSM", t.ttm_scratch_spec(512, 8, 32), 32, None),
        ("spt_TTMRankRBNnzKernel_reg", t.ttm_fused_spec(512, 8, 32), 32, None),
        ("cuszp_compress_like", t.cuszp_like_spec(64), 32, None),
        ("gramschmidt_kernel3", gs.k3_naive_spec(512, 512, 512, k=3), 4, None),
        ("gramschmidt_kernel3_opt", gs.k3_opt_spec(512, 512, 512, k=3), 4, None),
        ("find_cell_counts", h.hist_naive_spec(65536, 2048), 32, {"cells": cells}),
        ("find_cell_counts_opt2", h.hist_opt2_spec(65536, 2048), 32, None),
    ]


def _by_region(reports):
    out = {}
    for rep in reports:
        out.setdefault(rep.region, set()).add(rep.pattern)
    return out


def _score(detected):
    """(hits, rows): the bench's score over EXPECTED then CLEAN."""
    rows = []
    for _app, kernel, obj, expect in EXPECTED:
        rows.append(bool(detected[kernel].get(obj, set()) & expect))
    for kernel, obj, pattern in CLEAN:
        rows.append(pattern not in detected[kernel].get(obj, set()))
    return sum(rows), rows


PORT = {"gemm": gemm, "spmv": spmv, "ttm": ttm, "gramschm": gramschm, "histogram": histogram}
REF = {"gemm": ref_gemm, "spmv": ref_spmv, "ttm": ref_ttm, "gramschm": ref_gramschm,
       "histogram": ref_histogram}


@pytest.fixture(scope="module")
def h100():
    """Classes by kernel and region: the port's specs under H100Sector."""
    return {
        name: _by_region(detect_all(analyze(spec, GridSampler((0,), window=w), ctx)))
        for name, spec, w, ctx in _cases(PORT)
    }


@pytest.fixture(scope="module")
def tpu():
    """(port, reference) classes by kernel and region: the reference's specs
    under TPUTile on both engines."""
    port, ref = {}, {}
    for name, spec, w, ctx in _cases(REF):
        sampler = RefSampler((0,), window=w)
        port[name] = _by_region(detect_all(analyze(to_port_spec(spec), port_sampler(sampler),
                                                   ctx)))
        ref[name] = _by_region(ref_detect_all(ref_analyze(spec, sampler=sampler,
                                                          dynamic_context=ctx)))
    return port, ref


ROW_IDS = [f"{k}.{o}" for _a, k, o, _e in EXPECTED] + [f"clean.{k}.{o}" for k, o, _p in CLEAN]


def test_table_one_scores_15_of_15_under_h100(h100):
    hits, rows = _score(h100)
    missed = [i for i, ok in zip(ROW_IDS, rows) if not ok]
    assert (hits, missed) == (15, [])


@pytest.mark.parametrize("row", range(len(EXPECTED)), ids=ROW_IDS[:len(EXPECTED)])
def test_table_one_expected_row_under_h100(h100, row):
    _app, kernel, obj, expect = EXPECTED[row]
    assert h100[kernel].get(obj, set()) & expect


@pytest.mark.parametrize("row", range(len(CLEAN)), ids=ROW_IDS[len(EXPECTED):])
def test_table_one_clean_row_under_h100(h100, row):
    kernel, obj, pattern = CLEAN[row]
    assert pattern not in h100[kernel].get(obj, set())


def test_table_one_h100_classes_of_the_repaired_rows(h100):
    """ROADMAP queue 3 items 1 and 12: SpMV's gathered x is hot-random and
    not strided; v00's B is hot beside its false sharing; GRAMSCHM's q and
    GPUMD's cell_count keep what they showed before the rules were
    restated for sectors."""
    assert h100["spmv_csr"]["x"] == {"hot-random"}
    assert h100["spmv_zigzag"]["x"] == {"hot-random"}
    assert h100["gemm_v00"]["B"] == {"hot", "false-sharing"}
    assert h100["gemm_v01"]["B"] == {"hot"}
    assert h100["gramschmidt_kernel3"]["q"] == {"strided"}
    assert h100["find_cell_counts"]["cell_count"] == {"false-sharing"}


@pytest.mark.parametrize("row", range(len(EXPECTED) + len(CLEAN)), ids=ROW_IDS)
def test_table_one_row_under_tpu_tile_is_the_reference(tpu, row):
    port, ref = tpu
    kernel, obj = (EXPECTED[row][1:3] if row < len(EXPECTED)
                   else CLEAN[row - len(EXPECTED)][:2])
    assert port[kernel].get(obj, set()) == ref[kernel].get(obj, set())


def test_table_one_score_under_tpu_tile_is_the_reference(tpu):
    port, ref = tpu
    assert _score(port) == _score(ref)
    assert port == ref


# -- the strided rule's gate on two synthetic walks ----------------------------------


def _heat(geometry, per_warp):
    """(tags, word temps, sector temps) of per-warp flat element indices."""
    wps = geometry.words_per_sector
    word_keys, sector_keys = [], []
    for flat in per_warp:
        tags, words = geometry.flat_to_touch_arrays(np.asarray(flat))
        keys = np.unique(tags * wps + words)
        word_keys.append(keys)
        sector_keys.append(np.unique(keys // wps))
    wk, wcount = np.unique(np.concatenate(word_keys), return_counts=True)
    tags, scount = np.unique(np.concatenate(sector_keys), return_counts=True)
    wt = np.zeros((tags.size, wps), np.int64)
    wt[np.searchsorted(tags, wk // wps), wk % wps] = wcount
    return tags, wt, scount


def _classes(kind, shape, per_warp):
    """The port's classes of one region walked by ``per_warp`` under the
    geometry ``kind``; under TPUTile also the reference's."""
    geometry = (H100Sector if kind == "h100-sector" else TPUTile)(shape, 4, "a")
    tags, wt, st = _heat(geometry, per_warp)
    rh = RegionHeatmap(RegionInfo("a", geometry), n_programs=len(per_warp), tags=tags,
                       word_temps=wt, sector_temps=st)
    hm = Heatmap("walk", (len(per_warp),), "all", (rh,), len(per_warp), 0)
    got = {r.pattern for r in detect_all(hm)}
    if kind == "tpu-tile":
        ref_rh = RefRegionHeatmap(RefRegionInfo("a", TileGeometry(shape, 4, "a")),
                                  n_programs=len(per_warp), tags=tags, word_temps=wt,
                                  sector_temps=st)
        want = {r.pattern for r in ref_detect_all(
            RefHeatmap("walk", (len(per_warp),), "all", (ref_rh,), len(per_warp), 0))}
        assert got == want
    return got, rh


@pytest.mark.parametrize("kind", ["h100-sector", "tpu-tile"])
def test_a_random_gather_is_not_strided(kind):
    """32 warps gather 32 random floats each from a 36,417-float vector.
    In 32 B sectors almost every touched sector has one warm word, at
    offsets spread evenly (~1/8 at the commonest): sparse, but no offset
    recurs.  A TPU tile holds 1024 of the floats, and the gather warms most
    of its words."""
    rng = np.random.default_rng(0)
    per_warp = [rng.integers(0, N_COLS, size=32) for _ in range(32)]
    got, rh = _classes(kind, (N_COLS,), per_warp)
    assert STRIDED not in got
    assert detect_strided(rh, "walk") is None
    if kind == "h100-sector":
        touched = (rh.word_temps_matrix > 0).sum(axis=1)
        assert (touched <= 2).mean() >= 0.6  # sparse: only the gate stops it


@pytest.mark.parametrize("kind", ["h100-sector", "tpu-tile"])
def test_a_walk_over_one_word_of_every_sector_is_strided(kind):
    """8 warps each read word 3 of every sector of a (256, 128) float32
    array: column 3 of each 8-float run of a row in 32 B sectors, row
    8 j + 3 of each (8, 128) tile in TPU tiles."""
    rows, cols = 256, 128
    if kind == "h100-sector":
        flat = np.arange(rows)[:, None] * cols + np.arange(3, cols, 8)[None, :]
    else:
        flat = np.arange(3, rows, 8)[:, None] * cols + np.arange(cols)[None, :]
    got, rh = _classes(kind, (rows, cols), [flat.reshape(-1)] * 8)
    assert STRIDED in got
    assert detect_strided(rh, "walk").detail("word_offset") == 3.0
