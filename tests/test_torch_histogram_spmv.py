"""The port's histogram and SpMV case studies held against the JAX package.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the JAX package's Pallas kernels (interpret mode), its oracles and
the port.  The histogram ``*_spec`` functions are held against a numpy
emulation of the CUDA kernels' thread-index arithmetic, the CSR spec
against an emulation of the paper's scalar CSR warp loads, and the pattern
classes against the reference rungs'.  The CUDA kernels themselves run
only on the card: ``test_torch_cuda.py``.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
from repro.core import analyze as ref_analyze
from repro.core.diff import diff as ref_diff
from repro.core.patterns import detect_all as ref_detect_all
from repro.core.trace import GridSampler as RefSampler
from repro.kernels import histogram as ref_hist
from repro.kernels import ref as ref_oracles
from repro.kernels import spmv as ref_spmv
from repro_torch import cli
from repro_torch import kernels as kreg
from repro_torch.core.collector import analyze
from repro_torch.core.diff import diff
from repro_torch.core.patterns import (
    FALSE_SHARING, HOT, HOT_RANDOM, MISALIGNMENT, STRIDED, detect_all,
)
from repro_torch.core.tiles import H100Sector
from repro_torch.core.trace import GridSampler
from repro_torch.kernels import histogram, ops, ref, spmv

from torch_parity import heat_of_warps

HIST_REFS = ["histogram:naive", "histogram:partials", "histogram:scratch"]
SPMV_REFS = ["spmv:csr", "spmv:zigzag"]
PALLAS_HIST = {
    "naive": ref_hist.hist_naive,
    "partials": ref_hist.hist_opt,
    "scratch": ref_hist.hist_opt2,
}


def _port_hist(variant, cells, n_bins):
    """The port's histogram for one rung, through ``ops`` where it reaches."""
    if variant == "scratch":
        return histogram.hist_opt2(cells, n_bins)
    return ops.histogram(cells, n_bins, naive=variant == "naive")


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


# -- kernel parity: the port on the CPU against Pallas (interpret) and ref.py --


@pytest.mark.parametrize("variant", ["naive", "partials", "scratch"])
def test_histogram_matches_pallas_kernels(variant):
    # the reference test's case: 4096 ids in [0, 64), 64 bins
    cells = np.random.default_rng(0).integers(0, 64, size=4096).astype(np.int32)
    want = np.asarray(PALLAS_HIST[variant](jnp.asarray(cells), 64, interpret=True))
    got = _port_hist(variant, torch.from_numpy(cells), 64)
    assert got.dtype == torch.float32 and tuple(got.shape) == (64,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, np.asarray(ref_oracles.hist_ref(jnp.asarray(cells), 64))
    )
    np.testing.assert_array_equal(ref.hist_ref(torch.from_numpy(cells), 64).numpy(), want)


@pytest.mark.parametrize("variant", ["naive", "partials", "scratch"])
@pytest.mark.parametrize("n, n_bins", [(3000, 64), (1, 1), (1025, 2048)])
def test_histogram_ragged_n_matches_plain_version(variant, n, n_bins):
    cells = np.random.default_rng(1).integers(0, n_bins, size=n).astype(np.int32)
    got = _port_hist(variant, torch.from_numpy(cells), n_bins)
    np.testing.assert_array_equal(
        got.numpy(), histogram.hist_plain(torch.from_numpy(cells), n_bins).numpy()
    )
    np.testing.assert_array_equal(got.numpy(), np.bincount(cells, minlength=n_bins))


@pytest.mark.parametrize("variant", ["naive", "partials", "scratch"])
def test_histogram_drops_out_of_range_ids_as_the_pallas_kernels_do(variant):
    n_bins = 64
    cells = np.tile(np.array([-1, 0, 1, 63, 64, 70, 5, 5], np.int32), 128)
    want = np.asarray(PALLAS_HIST[variant](jnp.asarray(cells), n_bins, interpret=True))
    got = _port_hist(variant, torch.from_numpy(cells), n_bins).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 640 and got[63] == 128 and got[5] == 256
    np.testing.assert_array_equal(ref.hist_ref(torch.from_numpy(cells), n_bins).numpy(), got)


def test_reference_hist_ref_wraps_negative_ids_and_the_port_does_not():
    """A fact of the reference: ``.at[cells].add`` wraps -1 round to bin 63
    (and drops ids >= n_bins), so its oracle counts 768 where the Pallas
    kernels count 640.  The port's oracle follows the kernels."""
    cells = np.tile(np.array([-1, 0, 1, 63, 64, 70, 5, 5], np.int32), 128)
    wraps = np.asarray(ref_oracles.hist_ref(jnp.asarray(cells), 64))
    port = ref.hist_ref(torch.from_numpy(cells), 64).numpy()
    assert wraps.sum() == 768 and wraps[63] == 256
    assert port.sum() == 640 and port[63] == 128
    np.testing.assert_array_equal(np.delete(wraps, 63), np.delete(port, 63))


@pytest.mark.parametrize("r, k", [(8, 4), (32, 16), (64, 33)])
def test_spmv_matches_pallas_kernel(r, k):
    vals, xg = _rand(0, (r, k)), _rand(1, (r, k))
    jv, jx = jnp.asarray(vals), jnp.asarray(xg)
    want = np.asarray(ref_spmv.spmv_ell(jv, jx, br=8, interpret=True))
    oracle = np.asarray(ref_oracles.spmv_ref(jv, jx))
    got = ops.spmv(torch.from_numpy(vals), torch.from_numpy(xg))
    assert got.dtype == torch.float32 and tuple(got.shape) == (r,)
    # as tests/test_kernels.py: float32 sums of k products in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=1e-4)
    got_ref = ref.spmv_ref(torch.from_numpy(vals), torch.from_numpy(xg))
    np.testing.assert_allclose(got_ref.numpy(), oracle, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("r, k", [(30, 5), (1, 1), (13, 40)])
def test_spmv_ragged_rows_match_plain_version(r, k):
    vals, xg = _rand(2, (r, k)), _rand(3, (r, k))
    got = ops.spmv(torch.from_numpy(vals), torch.from_numpy(xg))
    want = spmv.spmv_ell_plain(torch.from_numpy(vals), torch.from_numpy(xg))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    exact = (vals.astype(np.float64) * xg.astype(np.float64)).sum(1)
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5, rtol=1e-4)


def test_spmv_csr_end_to_end():
    """The reference's CSR case through the port's csr_to_ell and oracle."""
    rng = np.random.default_rng(0)
    n, nnz_per_row = 64, 6
    row_offsets = np.arange(0, (n + 1) * nnz_per_row, nnz_per_row).astype(np.int32)
    col_indices = rng.integers(0, n, size=n * nnz_per_row).astype(np.int32)
    values = rng.normal(size=n * nnz_per_row).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    idx, val = spmv.csr_to_ell(row_offsets, col_indices, values, n)
    got = ops.spmv(torch.from_numpy(val), torch.from_numpy(x)[torch.from_numpy(idx).long()])
    want = ref.spmv_csr_ref(row_offsets, col_indices, values, x)
    assert want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(
        want, ref_oracles.spmv_csr_ref(row_offsets, col_indices, values, x)
    )
    want64 = ref.spmv_csr_ref(
        row_offsets, col_indices, values.astype(np.float64), x.astype(np.float64)
    )
    assert want64.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want64, atol=1e-5, rtol=1e-4)


def _random_csr(seed, n_rows, max_nnz, n_cols, base=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_nnz + 1, size=n_rows)
    row_offsets = (base + np.concatenate([[0], np.cumsum(counts)])).astype(np.int32)
    nnz = base + int(counts.sum())
    col_indices = rng.integers(0, n_cols, size=nnz).astype(np.int32)
    values = rng.standard_normal(nnz).astype(np.float32)
    return row_offsets, col_indices, values


@pytest.mark.parametrize(
    "n_rows, max_nnz, base, take",
    [(64, 6, 0, 64), (50, 9, 0, 50), (40, 3, 7, 40), (40, 5, 0, 25), (1, 0, 0, 1)],
)
def test_csr_to_ell_equals_the_reference(n_rows, max_nnz, base, take):
    row_offsets, col_indices, values = _random_csr(n_rows, n_rows, max_nnz, 97, base)
    got = spmv.csr_to_ell(row_offsets, col_indices, values, take)
    want = ref_spmv.csr_to_ell(row_offsets, col_indices, values, take)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    kreg.reset_launch_counts()
    cells = torch.tensor([0, 3, 3, -2, 9, 1], dtype=torch.int32)
    for fn in histogram.KERNELS.values():
        torch.testing.assert_close(fn(cells, 4), histogram.hist_plain(cells, 4))
    vals, xg = torch.randn(5, 3), torch.randn(5, 3)
    torch.testing.assert_close(spmv.spmv_ell(vals, xg), spmv.spmv_ell_plain(vals, xg))
    for fn in (*histogram.KERNELS.values(), spmv.spmv_ell):
        assert fn.launches == 0
    assert ref.hist_ref is histogram.hist_plain
    assert ref.spmv_ref is spmv.spmv_ell_plain


def test_reset_launch_counts_reaches_spmv_ell():
    spmv.spmv_ell.launches = 5
    histogram.hist_opt2.launches = 2
    kreg.reset_launch_counts()
    assert spmv.spmv_ell.launches == 0 and histogram.hist_opt2.launches == 0


@pytest.mark.parametrize(
    "cells, n_bins, exc",
    [
        (torch.zeros(8, dtype=torch.int64), 4, TypeError),
        (torch.zeros(8, dtype=torch.float32), 4, TypeError),
        (torch.zeros((2, 4), dtype=torch.int32), 4, ValueError),
        (torch.zeros(8, dtype=torch.int32)[::2], 4, ValueError),
        (torch.zeros(8, dtype=torch.int32, device="meta"), 4, ValueError),
        (torch.zeros(0, dtype=torch.int32), 4, ValueError),
        (torch.zeros(8, dtype=torch.int32), 0, ValueError),
        (torch.zeros(8, dtype=torch.int32), 4.0, TypeError),
        (np.zeros(8, np.int32), 4, TypeError),
    ],
)
def test_histogram_wrappers_reject_what_the_kernels_do_not_take(cells, n_bins, exc):
    for fn in histogram.KERNELS.values():
        with pytest.raises(exc):
            fn(cells, n_bins)


def test_hist_opt2_takes_what_fits_in_shared_memory():
    cells = torch.tensor([0, histogram.MAX_OPT2_BINS], dtype=torch.int32)
    with pytest.raises(ValueError, match="shared"):
        histogram.hist_opt2(cells, histogram.MAX_OPT2_BINS + 1)
    wide = histogram.hist_opt(cells, histogram.MAX_OPT2_BINS + 1)
    assert wide.sum() == 2
    fits = histogram.hist_opt2(cells, histogram.MAX_OPT2_BINS)
    assert fits.sum() == 1 and fits[0] == 1


@pytest.mark.parametrize(
    "vals, xg, exc",
    [
        (torch.randn(4, 2, dtype=torch.float64), torch.randn(4, 2, dtype=torch.float64), TypeError),
        (torch.randn(4, 2), torch.randn(4, 2, dtype=torch.bfloat16), TypeError),
        (torch.randn(4), torch.randn(4), ValueError),
        (torch.randn(4, 2), torch.randn(4, 3), ValueError),
        (torch.randn(4, 2), torch.randn(5, 2), ValueError),
        (torch.randn(4, 2), torch.randn(2, 4).t(), ValueError),
        (torch.randn(4, 2, device="meta"), torch.randn(4, 2, device="meta"), ValueError),
        (torch.randn(0, 2), torch.randn(0, 2), ValueError),
        (np.zeros((4, 2), np.float32), torch.randn(4, 2), TypeError),
    ],
)
def test_spmv_wrapper_rejects_what_the_kernel_does_not_take(vals, xg, exc):
    with pytest.raises(exc):
        ops.spmv(vals, xg)


# -- the specs against an emulation of csrc/histogram.cu ----------------------


def _emulate_hist(cells, n_bins, variant, max_blocks=histogram.OPT2_MAX_BLOCKS):
    """Per-warp flat indices of cells and the histogram regions, from the
    kernels' thread-index arithmetic: blocks of 1024 threads, thread t of
    block b on cell b*1024 + t (naive, opt), or striding by the grid
    (opt2); ids outside [0, n_bins) touch no bin."""
    n = len(cells)
    out = {"cells": {}, "cell_count": {}, "partials": {}, "acc": {}}
    empty = np.empty(0, np.int64)
    blocks = math.ceil(n / 1024)
    if variant != "scratch":
        dest = "cell_count" if variant == "naive" else "partials"
        for b in range(blocks):
            for t in range(1024):
                i = b * 1024 + t
                if i >= n:
                    continue  # returns before touching memory
                warp = (b, t // 32)
                out["cells"].setdefault(warp, []).append(np.array([i]))
                out[dest].setdefault(warp, [empty])
                c = int(cells[i])
                if 0 <= c < n_bins:
                    bin_ = c if variant == "naive" else b * n_bins + c
                    out[dest][warp].append(np.array([bin_]))
        return out
    # opt2: one int4 a thread at least, and a thread g of the grid reads
    # int4s g, g + S, ... of the n // 4 whole ones, then (g < n % 4) the
    # tail cell 4 (n // 4) + g
    grid = min(math.ceil(n / 4096), max_blocks)
    chunk = 32 * math.ceil(n_bins / 1024)
    threads = grid * 1024
    for b in range(grid):
        for t in range(1024):
            warp, lane = (b, t // 32), t % 32
            for name in ("cells", "cell_count", "acc"):
                out[name].setdefault(warp, [empty])
            lo = (t // 32) * chunk
            bins = np.arange(lo + lane, min(lo + chunk, n_bins), 32)
            out["acc"][warp].append(b * n_bins + bins)  # zero, then flush
            out["cell_count"][warp].append(bins)
            g = b * 1024 + t
            i = [4 * v + e for v in range(g, n // 4, threads) for e in range(4)]
            if g < n % 4:
                i.append(4 * (n // 4) + g)
            i = np.asarray(i, np.int64)
            c = np.asarray(cells, np.int64)[i]
            out["cells"][warp].append(i)
            out["acc"][warp].append(b * n_bins + c[(c >= 0) & (c < n_bins)])
    return out


def _assert_spec_matches(hm, acc, shapes):
    assert sorted(hm.region_names()) == sorted(shapes)
    for name, shape in shapes.items():
        tags, wt, st, warps = heat_of_warps(acc[name], shape, 4)
        rh = hm.region(name)
        np.testing.assert_array_equal(rh.tags_array, tags, err_msg=name)
        np.testing.assert_array_equal(rh.word_temps_matrix, wt, err_msg=name)
        np.testing.assert_array_equal(rh.sector_temps_array, st, err_msg=name)
        assert rh.n_programs == warps, name


def _hist_shapes(variant, n, n_bins, grid):
    shapes = {"cells": (n,)}
    if variant == "naive":
        shapes["cell_count"] = (n_bins,)
    elif variant == "partials":
        shapes["partials"] = (math.ceil(n / 1024), n_bins)
    else:
        shapes.update(cell_count=(n_bins,), acc=(grid, n_bins))
    return shapes


@pytest.mark.parametrize("variant", ["naive", "partials", "scratch"])
def test_hist_spec_matches_kernel_thread_mapping_at_registry_shape(variant):
    spec, ctx = kreg.build(f"histogram:{variant}")
    n, n_bins = kreg.HIST_SHAPE
    hm = analyze(spec, GridSampler(None), ctx)
    acc = _emulate_hist(ctx["cells"], n_bins, variant)
    _assert_spec_matches(hm, acc, _hist_shapes(variant, n, n_bins, 16))
    if variant == "scratch":
        assert hm.region("acc").region.space == "vmem_scratch"


@pytest.mark.parametrize(
    "n, n_bins, max_blocks",
    [(3000, 64, histogram.OPT2_MAX_BLOCKS), (5000, 100, 2), (2500, 2100, 1), (40, 8, 3)],
)
@pytest.mark.parametrize("variant", ["naive", "partials", "scratch"])
def test_hist_spec_matches_kernel_thread_mapping_ragged(variant, n, n_bins, max_blocks):
    rng = np.random.default_rng(n)
    # some ids outside [0, n_bins): the kernels drop them, so do the specs
    cells = rng.integers(-3, n_bins + 3, size=n).astype(np.int64)
    if variant == "scratch":
        spec = histogram.hist_opt2_spec(n, n_bins, max_blocks=max_blocks)
    else:
        spec = getattr(histogram, f"hist_{'naive' if variant == 'naive' else 'opt'}_spec")(n, n_bins)
    hm = analyze(spec, GridSampler(None), {"cells": cells})
    acc = _emulate_hist(cells, n_bins, variant, max_blocks)
    grid = min(math.ceil(n / 4096), max_blocks)
    _assert_spec_matches(hm, acc, _hist_shapes(variant, n, n_bins, grid))


def test_hist_opt2_grid_is_capped_and_strides():
    spec = histogram.hist_opt2_spec(10 * 4096 * histogram.OPT2_MAX_BLOCKS, 2048)
    assert spec.grid == (histogram.OPT2_MAX_BLOCKS * 32,)
    # one int4 a thread at least: 16 blocks for the registry's 65,536 ids
    assert histogram.hist_opt2_spec(65536, 2048).grid == (16 * 32,)
    assert histogram.opt2_blocks(4097) == 2 and histogram.opt2_blocks(1) == 1
    # thread g reads int4s g, g + S, ... and the tail cell 4 (n // 4) + g
    assert histogram.opt2_cells(1, 4 * 10 + 3, 4).tolist() == [4, 5, 6, 7, 20, 21, 22, 23, 36, 37, 38, 39, 41]


# -- the CSR spec against an emulation of the paper's scalar CSR kernel ------


def _emulate_csr(n_rows, col_indices):
    """Per-warp flat indices of the scalar CSR kernel: thread r of the grid
    on row r loads rowOffsets[r] and rowOffsets[r + 1] and gathers x."""
    out = {"rowOffsets": {}, "rowOffsets_shift1": {}, "x": {}}
    for r in range(n_rows):
        warp = r // 32
        out["rowOffsets"].setdefault(warp, []).append(np.array([r]))
        out["rowOffsets_shift1"].setdefault(warp, []).append(np.array([r + 1]))
        out["x"].setdefault(warp, []).append(np.array([int(col_indices[r])]))
    return out


@pytest.mark.parametrize("n_rows, n_cols", [(96, 200), (65536, 36417)])
def test_csr_spec_matches_the_scalar_csr_warp_loads(n_rows, n_cols):
    if n_rows == 65536:
        spec, ctx = kreg.build("spmv:csr")
    else:
        ctx = {"col_indices": np.random.default_rng(5).integers(0, n_cols, n_rows)}
        spec = spmv.spmv_csr_spec(n_rows, n_cols)
    hm = analyze(spec, GridSampler(None), ctx)
    acc = _emulate_csr(n_rows, ctx["col_indices"])
    _assert_spec_matches(
        hm, acc,
        {"rowOffsets": (n_rows + 1,), "rowOffsets_shift1": (n_rows + 1,), "x": (n_cols,)},
    )
    # the aligned 128 B load is 4 sectors a warp, the shifted one 5
    geom = H100Sector((n_rows + 1,), 4)
    for warp, parts in list(acc["rowOffsets_shift1"].items())[:4]:
        shifted, _ = geom.flat_to_touch_arrays(np.concatenate(parts))
        aligned, _ = geom.flat_to_touch_arrays(np.concatenate(acc["rowOffsets"][warp]))
        assert (np.unique(aligned).size, np.unique(shifted).size) == (4, 5)
    warps = n_rows // 32
    assert hm.region("rowOffsets").sector_temps_array.sum() == 4 * warps
    assert hm.region("rowOffsets_shift1").sector_temps_array.sum() == 5 * warps


def test_zigzag_spec_reads_one_aligned_256_byte_block_per_warp():
    spec = spmv.spmv_zigzag_spec(96, 200)
    ctx = {"col_indices": np.random.default_rng(5).integers(0, 200, 96)}
    rh = analyze(spec, GridSampler(None), ctx).region("rowPairs")
    np.testing.assert_array_equal(rh.tags_array, np.arange(24))
    assert (rh.sector_temps_array == 1).all() and (rh.word_temps_matrix == 1).all()


@pytest.mark.parametrize("n_rows", [0, 30, 100])
def test_spmv_specs_take_whole_warps_of_rows(n_rows):
    for fn in (spmv.spmv_csr_spec, spmv.spmv_zigzag_spec):
        with pytest.raises(ValueError, match="whole warps"):
            fn(n_rows, 10)


# -- story parity: the H100 rungs against the reference rungs' classes ---------


def _classes(hm):
    return {(r.region, r.pattern) for r in detect_all(hm)}


def _port_heatmap(ref_name):
    spec, ctx = kreg.build(ref_name)
    return analyze(spec, GridSampler(None), ctx)


def _ref_heatmap(ref_name):
    entry = rk.get(ref_name.partition(":")[0])
    spec, ctx = rk.build(ref_name)
    return ref_analyze(spec, sampler=entry.sampler(), dynamic_context=ctx)


def _ref_classes(ref_name):
    return {(r.region, r.pattern) for r in ref_detect_all(_ref_heatmap(ref_name))}


PORT_CLASSES = {
    "histogram:naive": {("cell_count", FALSE_SHARING), ("cell_count", HOT)},
    "histogram:partials": {("partials", FALSE_SHARING)},
    "histogram:scratch": {("cell_count", HOT)},
    "spmv:csr": {("rowOffsets_shift1", MISALIGNMENT), ("x", FALSE_SHARING), ("x", HOT_RANDOM)},
    "spmv:zigzag": {("x", FALSE_SHARING), ("x", HOT_RANDOM)},
}


@pytest.mark.parametrize("ref_name", HIST_REFS + SPMV_REFS)
def test_h100_pattern_classes_per_rung(ref_name):
    assert _classes(_port_heatmap(ref_name)) == PORT_CLASSES[ref_name]


@pytest.mark.parametrize(
    "ref_name, only_port, only_ref",
    [
        # a warp scatters 32 ids into 256 sectors: ~240 warps a sector, ~32 a
        # word (false sharing, and hot: the hot rule reads sharing on words);
        # a TPU program's block is the whole histogram (hot)
        ("histogram:naive", {("cell_count", FALSE_SHARING)}, set()),
        ("histogram:partials", set(), set()),
        # every one of the 16 blocks flushes every bin: no single final store
        ("histogram:scratch", {("cell_count", HOT)}, set()),
        # 32 random gathers a warp: ~14 warps a sector, ~2 a word (false
        # sharing), and the words that 4 warps or more happen to share carry
        # most of the transfers (hot-random beside the false sharing,
        # ROADMAP queue 3 item 12); a TPU program gathers 1024 over 36 tiles
        # (hot), whose ragged edge tiles it counts as misaligned
        ("spmv:csr", {("x", FALSE_SHARING), ("x", HOT_RANDOM)},
         {("x", HOT), ("x", MISALIGNMENT)}),
        ("spmv:zigzag", {("x", FALSE_SHARING), ("x", HOT_RANDOM)},
         {("x", HOT), ("x", MISALIGNMENT)}),
    ],
)
def test_pattern_divergences_from_reference_are_the_recorded_ones(ref_name, only_port, only_ref):
    """ROADMAP queue 3 items 3 and 4: the classes each geometry alone flags."""
    port, want = _classes(_port_heatmap(ref_name)), _ref_classes(ref_name)
    assert (port - want, want - port) == (only_port, only_ref)


def _spmv_columns(kind):
    """The SpMV's column ids: ``zipf`` as the paper's Table I bench draws
    them (benchmarks/bench_patterns.py:50-53), ``uniform`` as the
    registry's context does."""
    n, n_cols = kreg.SPMV_SHAPE
    if kind == "zipf":
        rng = np.random.default_rng(0)
        zipf = rng.zipf(1.3, size=n).astype(np.int64) * 37 % n_cols
        return np.minimum(zipf, n_cols - 1).astype(np.int32)
    return np.random.default_rng(0).integers(0, n_cols, size=n).astype(np.int32)


@pytest.mark.parametrize(
    "columns, window, port_x, port_tx, ref_x",
    [
        # zipf columns are sparse multiples of 37: one warm word a sector,
        # the low ids shared by many warps (29 of 286 sectors at window 32
        # carry 318 of 627 transfers of x); their offsets do not recur
        # (42 of 291 touches at the commonest, so not strided)
        ("zipf", 32, {HOT_RANDOM}, 915, {HOT}),
        ("zipf", None, {HOT_RANDOM}, 57894, {HOT}),
        # 1024 uniform gathers over 4552 sectors of x share nothing: the
        # hottest sector is read by 3 of the 32 warps; a TPU tile holds 1024
        # columns, so each of the 36 is read by every program
        ("uniform", 32, set(), 1307, {HOT, MISALIGNMENT}),
        # the full grid: ~14 warps a sector, ~2 a word (item 4's false
        # sharing), with the words shared by 4 warps or more hot-random
        ("uniform", None, {FALSE_SHARING, HOT_RANDOM}, 83734, {HOT, MISALIGNMENT}),
    ],
    ids=["zipf-window32", "zipf-full", "uniform-window32", "uniform-full"],
)
def test_spmv_x_classes_by_columns_and_sampling(columns, window, port_x, port_tx, ref_x):
    """ROADMAP queue 3 item 12: a random gather is not strided under
    H100Sector, and is hot-random where its sharing carries the transfers."""
    n, n_cols = kreg.SPMV_SHAPE
    ctx = {"col_indices": _spmv_columns(columns)}
    sampler = GridSampler((0,), window=window) if window else GridSampler(None)
    hm = analyze(spmv.spmv_csr_spec(n, n_cols), sampler, ctx)
    got = {r.pattern for r in detect_all(hm) if r.region == "x"}
    assert got == port_x and STRIDED not in got
    assert hm.sector_transactions() == port_tx
    ref_sampler = RefSampler((0,), window=window) if window else RefSampler(None)
    want = ref_analyze(ref_spmv.spmv_csr_spec(n, n_cols), sampler=ref_sampler,
                       dynamic_context=ctx)
    assert {r.pattern for r in ref_detect_all(want) if r.region == "x"} == ref_x


@pytest.mark.parametrize(
    "family, before, after, tx, verdict, fixed, introduced, persisting, as_ref",
    [
        ("histogram", "naive", "partials", (69912, 69912), "regressed",
         (("cell_count", FALSE_SHARING), ("cell_count", HOT)),
         (("partials", FALSE_SHARING),), (), ("introduced", "persisting")),
        ("histogram", "naive", "scratch", (69912, 12288), "improved",
         (("cell_count", FALSE_SHARING),), (), (("cell_count", HOT),),
         ("introduced",)),
        ("spmv", "csr", "zigzag", (83734, 81686), "improved",
         (("rowOffsets_shift1", MISALIGNMENT),), (),
         (("x", FALSE_SHARING), ("x", HOT_RANDOM)), ("fixed", "introduced")),
    ],
)
def test_story_parity_diff(
    family, before, after, tx, verdict, fixed, introduced, persisting, as_ref
):
    d = diff(_port_heatmap(f"{family}:{before}"), _port_heatmap(f"{family}:{after}"))
    want = ref_diff(_ref_heatmap(f"{family}:{before}"), _ref_heatmap(f"{family}:{after}"))
    assert (d.tx_before, d.tx_after) == tx
    assert (d.fixed, d.introduced, d.persisting) == (fixed, introduced, persisting)
    # the verdict is the reference's; the lines named in as_ref are too, the
    # others differ by the divergences recorded in ROADMAP queue 3
    assert d.verdict == want.verdict == verdict
    for field in as_ref:
        assert getattr(d, field) == getattr(want, field), field


# -- the registry ----------------------------------------------------------------


def test_registry_order_and_families():
    assert kreg.names() == (
        "gemm", "spmv", "histogram", "gramschm", "ttm", "cuszp", "flash", "gmm", "ssd",
        "ragged_flash", "paged_attn",
    )
    assert [n for n in rk.names() if n in kreg.names()] == list(kreg.names())
    for name in ("spmv", "histogram"):
        got, want = kreg.get(name), rk.get(name)
        assert got.variant_names() == want.variant_names()
        assert [v.role for v in got.variants] == [v.role for v in want.variants]
        assert [p for p, _ in got.ladder()] == [p for p, _ in want.ladder()]


def test_registry_spmv_is_spec_only():
    entry, variant = kreg.resolve("spmv")
    assert variant.name == "csr" and [v.name for _, v in entry.ladder()] == ["zigzag"]
    for v in entry.variants:
        assert (v.kernel, v.plain, v.inputs) == (None, None, None)
        spec, ctx = kreg.build(f"spmv:{v.name}")
        assert spec.grid == (2048,)
        np.testing.assert_array_equal(
            ctx["col_indices"], rk.build(f"spmv:{v.name}")[1]["col_indices"]
        )
    with pytest.raises(ValueError, match="no kernel"):
        kreg.run_variant(variant, device="cpu")


def test_registry_histogram_runs_its_kernels_on_the_profiled_cells():
    entry, variant = kreg.resolve("histogram")
    assert variant.name == "naive" and [v.name for _, v in entry.ladder()] == [
        "partials", "scratch",
    ]
    ref_cells = rk.build("histogram:naive")[1]["cells"]
    for v in entry.variants:
        assert v.kernel is histogram.KERNELS[v.name]
        assert v.plain is histogram.hist_plain
        assert v.kwargs == (("n_bins", 2048),) and v.atol == 0.0
        (cells,) = v.inputs(torch.device("cpu"), torch.Generator().manual_seed(9))
        assert cells.dtype == torch.int32
        np.testing.assert_array_equal(cells.numpy(), v.dynamic_context()["cells"])
        np.testing.assert_array_equal(cells.numpy(), ref_cells)


@pytest.mark.parametrize("ref_name", HIST_REFS)
def test_run_variant_on_cpu_runs_the_plain_version(ref_name):
    run = kreg.run_variant(kreg.resolve(ref_name)[1], device="cpu")
    assert run == {
        "device": "cpu", "shapes": [[65536]], "dtype": "int32", "max_abs_err": 0.0,
        "ms": None, "device_ms": None, "kwargs": {"n_bins": 2048}, "launches": 0,
    }


# -- python -m repro_torch.cli on the CPU -----------------------------------------


@pytest.mark.parametrize(
    "family, pairs",
    [
        (
            "histogram",
            {
                (0, 1): ["[regressed] histogram: transfers 69912 -> 69912 (1.00x)",
                         "[fixed] false-sharing on cell_count",
                         "[fixed] hot on cell_count",
                         "[INTRODUCED] false-sharing on partials"],
                (0, 2): ["[ improved] histogram: transfers 69912 -> 12288 (5.69x)",
                         "[fixed] false-sharing on cell_count",
                         "[persisting] hot on cell_count"],
            },
        ),
        (
            "spmv",
            {
                (0, 1): ["[ improved] spmv: transfers 83734 -> 81686 (1.03x)",
                         "[fixed] misalignment on rowOffsets_shift1",
                         "[persisting] false-sharing on x",
                         "[persisting] hot-random on x"],
            },
        ),
    ],
)
def test_cli_profile_then_diff_shows_the_fix(family, pairs, tmp_path, capsys):
    sess = tmp_path / "sess"
    for variant in kreg.get(family).variant_names():
        argv = ["profile", "-k", f"{family}:{variant}", "--device", "cpu", "-q"]
        assert cli.main([*argv, "--out", str(sess)]) == 0
    for (a, b), lines in pairs.items():
        capsys.readouterr()
        assert cli.main(["diff", str(sess / f"iter{a}"), str(sess / f"iter{b}")]) == 0
        out = capsys.readouterr().out
        for line in lines:
            assert line in out
    manifest = json.loads((sess / "iter0" / "manifest.json").read_text())
    (entry,) = manifest["kernels"]
    assert entry["name"] == family
    if family == "histogram":
        assert entry["run"]["launches"] == 0 and entry["run"]["device"] == "cpu"
    else:
        assert "run" not in entry
    last = len(kreg.get(family).variants) - 1
    assert cli.main(["report", str(sess / f"iter{last}")]) == 0
