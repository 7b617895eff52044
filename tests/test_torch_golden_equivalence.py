"""Golden equivalence: the port's columnar engine vs its seed engine.

Ports ``test_golden_equivalence.py``.  Every case runs under both
geometries (``h100-sector`` and ``tpu-tile``) and asserts bit-identical
heat maps: region set, sector tags, word and sector temperatures,
contributor and record counts, and the derived transaction model.  The
seed engine (``repro_torch.core._reference``) computes each touch element
by element, independently of the vectorized geometry code.  The merge
cases hold every partition of a trace, merged, to the single pass.
"""

import numpy as np
import pytest

from repro_torch.core._reference import (
    ReferenceAnalyzer,
    ReferenceTraceBuffer,
    analyze_reference,
    collect_reference,
    drain_dynamic_reference,
)
from repro_torch.core.collector import (
    OperandSpec,
    ShardedCollector,
    _unify_shard_groups,
    analyze,
    collect,
    collect_shard,
    drain_dynamic,
    shard_bounds,
)
from repro_torch.core.heatmap import Analyzer, compress_region, compress_rows
from repro_torch.core.tiles import make_geometry
from repro_torch.core.trace import AccessRecord, GridSampler, RegionInfo, TraceBuffer
from repro_torch.kernels import gemm, histogram, spmv, ttm

from torch_cases import (
    GEOMETRIES,
    as_geometry,
    assert_heatmaps_identical,
    misc_cases,
    shard_cases,
)

SAMPLERS = [GridSampler((0,), window=8), GridSampler(None)]
SAMPLER_IDS = ["window8", "full"]

geometry = pytest.mark.parametrize("kind", GEOMETRIES)
samplers = pytest.mark.parametrize("sampler", SAMPLERS, ids=SAMPLER_IDS)


@geometry
@samplers
def test_gemm_equivalence(kind, sampler):
    for spec in (
        gemm.gemm_v00_spec(128, 128, 128),
        gemm.gemm_v01_spec(128, 128, 128),
        gemm.gemm_v02_spec(128, 128, 128),
    ):
        spec = as_geometry(spec, kind)
        assert_heatmaps_identical(
            analyze(spec, sampler), analyze_reference(spec, sampler)
        )


@geometry
@samplers
def test_spmv_misaligned_origin_equivalence(kind, sampler):
    rng = np.random.default_rng(7)
    colidx = rng.integers(0, 512, size=1024).astype(np.int32)
    spec = as_geometry(spmv.spmv_csr_spec(1024, 512), kind)
    assert any(op.origin != (0, 0) for op in spec.operands)
    ctx = {"col_indices": colidx}
    assert_heatmaps_identical(
        analyze(spec, sampler, dynamic_context=ctx),
        analyze_reference(spec, sampler, dynamic_context=ctx),
    )


@geometry
@samplers
def test_dynamic_gather_equivalence(kind, sampler):
    rng = np.random.default_rng(3)
    cells = rng.integers(0, 512, size=8192).astype(np.int64)
    spec = as_geometry(histogram.hist_naive_spec(8192, 512), kind)
    ctx = {"cells": cells}
    assert_heatmaps_identical(
        analyze(spec, sampler, dynamic_context=ctx),
        analyze_reference(spec, sampler, dynamic_context=ctx),
    )


@geometry
@samplers
def test_scratch_accumulator_equivalence(kind, sampler):
    rng = np.random.default_rng(5)
    cases = [
        (ttm.ttm_scratch_spec(256, 8, 32), None),
        (histogram.hist_opt2_spec(16384, 512),
         {"cells": rng.integers(0, 512, size=16384).astype(np.int64)}),
        (ttm.cuszp_like_spec(32), None),
    ]
    for spec, ctx in cases:
        spec = as_geometry(spec, kind)
        assert_heatmaps_identical(
            analyze(spec, sampler, dynamic_context=ctx),
            analyze_reference(spec, sampler, dynamic_context=ctx),
        )


@geometry
def test_misc_kernels_full_equivalence(kind):
    """Sweep the remaining case-study specs at full trace."""
    for spec, ctx in misc_cases(kind):
        assert_heatmaps_identical(
            analyze(spec, GridSampler(None), dynamic_context=ctx),
            analyze_reference(spec, GridSampler(None), dynamic_context=ctx),
        )


@geometry
def test_drain_dynamic_equivalence(kind):
    op = OperandSpec("x", (4096,), np.float32, (4096,), lambda i: (0,),
                     geometry_kind=kind)
    rng = np.random.default_rng(5)
    trace = rng.integers(-64, 4096, size=(8, 96))
    for sampler in SAMPLERS:
        buf = drain_dynamic("k", (8,), op, trace, sampler)
        ref = drain_dynamic_reference("k", (8,), op, trace, sampler)
        an, ran = Analyzer("k", (8,), "s"), ReferenceAnalyzer("k", (8,), "s")
        an.ingest(buf)
        ran.ingest(ref)
        assert_heatmaps_identical(an.flush(), ran.flush())
        # record views agree up to object identity
        got = sorted((r.program_id, r.touches) for r in buf.records)
        want = sorted((r.program_id, r.touches) for r in ref.records)
        assert got == want


@geometry
def test_drain_dynamic_valid_mask_equivalence(kind):
    op = OperandSpec("x", (1024, 256), np.float32, (8, 256), lambda i: (i, 0),
                     geometry_kind=kind)
    rng = np.random.default_rng(9)
    trace = rng.integers(0, 1024 * 256, size=(4, 32))
    mask = rng.random((4, 32)) < 0.5
    buf = drain_dynamic("k", (4,), op, trace, GridSampler(None), mask)
    ref = drain_dynamic_reference("k", (4,), op, trace, GridSampler(None), mask)
    an, ran = Analyzer("k", (4,), "s"), ReferenceAnalyzer("k", (4,), "s")
    an.ingest(buf)
    ran.ingest(ref)
    assert_heatmaps_identical(an.flush(), ran.flush())


@geometry
def test_compat_append_path_equivalence(kind):
    """Record-at-a-time appends (the exact path) match the seed bitmasks,
    including duplicate touches and repeated program ids, and the
    Analyzer's reconstructed bitmask state equals the seed's."""
    geom = make_geometry(kind, (64, 256), 4, "A")
    recs = [
        ((0,), [(0, 0), (0, 0), (1, 3)]),  # duplicate touch
        ((1,), [(0, 0)]),
        ((0,), [(1, 3), (2, 7)]),  # repeated pid, overlapping touch
        ((2,), []),  # a zero-touch record still counts as a contributor
    ]
    buf, ref = TraceBuffer(), ReferenceTraceBuffer()
    for b in (buf, ref):
        b.register_region(RegionInfo("A", geom))
        for pid, touches in recs:
            b.append(
                AccessRecord(array="A", site="k/A", space="hbm", kind="load",
                             program_id=pid, touches=tuple(touches))
            )
    an, ran = Analyzer("k", (4,), "s"), ReferenceAnalyzer("k", (4,), "s")
    an.ingest(buf)
    ran.ingest(ref)
    assert_heatmaps_identical(an.flush(), ran.flush())
    masks = {t: (h.word_masks, h.sector_mask) for t, h in an._maps["A"].items()}
    want = {t: (h.word_masks, h.sector_mask) for t, h in ran._maps["A"].items()}
    assert masks == want
    one = Analyzer("k", (4,), "s")
    one._regions["A"] = RegionInfo("A", geom)
    for rec in buf.records:
        one._ingest_record(rec)
    assert_heatmaps_identical(one.flush(), ran.flush())


@geometry
def test_compress_region_matches_compress_rows(kind):
    rng = np.random.default_rng(2)
    colidx = rng.integers(0, 512, size=1024).astype(np.int32)
    heatmaps = [
        analyze(as_geometry(gemm.gemm_v00_spec(256, 256, 256), kind),
                GridSampler((0,), window=32)),
        analyze(as_geometry(spmv.spmv_csr_spec(1024, 512), kind),
                GridSampler(None), dynamic_context={"col_indices": colidx}),
    ]
    for hm in heatmaps:
        for rh in hm.regions:
            assert compress_region(rh) == compress_rows(rh.rows)


@geometry
def test_mixed_buffer_ingest_equivalence(kind):
    """Two collect() buffers (overlapping pid windows) ingested into one
    Analyzer must still dedupe contributors exactly (cross-group path)."""
    spec = as_geometry(gemm.gemm_v01_spec(128, 128, 128), kind)
    buf1, _ = collect(spec, GridSampler((0,), window=8))
    buf2, _ = collect(spec, GridSampler((0,), window=16))  # superset window
    an = Analyzer(spec.name, spec.grid, "mixed")
    an.ingest(buf1)
    an.ingest(buf2)

    ref1, _ = collect_reference(spec, GridSampler((0,), window=8))
    ref2, _ = collect_reference(spec, GridSampler((0,), window=16))
    ran = ReferenceAnalyzer(spec.name, spec.grid, "mixed")
    ran.ingest(ref1)
    ran.ingest(ref2)
    assert_heatmaps_identical(an.flush(), ran.flush())


# ---------------------------------------------------------------------------
# merge algebra: any partition of a trace into shards merges bit-identically
# ---------------------------------------------------------------------------


def _partition_merge(spec, ctx, bounds, sampler=None):
    """Collect each [lo, hi) shard, unify tokens, flush ONE analyzer."""
    sampler = sampler or GridSampler(None)
    results = [
        collect_shard(spec, sampler, ctx, lo, hi, i)
        for i, (lo, hi) in enumerate(bounds)
    ]
    bufs = [b for b, _ in results]
    _unify_shard_groups(bufs)
    an = Analyzer(spec.name, spec.grid, sampler.describe())
    for buf in bufs:
        an.ingest(buf)
    return an.flush()


def _heatmap_merge(spec, ctx, bounds, sampler=None):
    """Flush each shard with key state, fold through Heatmap.merge."""
    sampler = sampler or GridSampler(None)
    merged = None
    for i, (lo, hi) in enumerate(bounds):
        buf, _ = collect_shard(spec, sampler, ctx, lo, hi, i)
        an = Analyzer(spec.name, spec.grid, sampler.describe())
        an.ingest(buf)
        hm = an.flush(keep_keys=True)
        merged = hm if merged is None else merged.merge(hm)
    return merged


def _strip_keys(hm):
    """Key state is an internal carrier; compare the flushed arrays."""
    for rh in hm.regions:
        rh.key_state = None
    return hm


@geometry
@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_partitioned_chunk_merge_bit_identical(kind, n_shards):
    """Sharded chunk-level merge == serial single pass, every case."""
    for spec, ctx in shard_cases(kind):
        serial = analyze(spec, GridSampler(None), dynamic_context=ctx)
        total = int(np.prod(spec.grid))
        sharded = _partition_merge(spec, ctx, shard_bounds(total, n_shards))
        assert_heatmaps_identical(sharded, serial)


@geometry
def test_partitioned_heatmap_merge_bit_identical(kind):
    """Heatmap.merge over key-state shards == serial single pass."""
    for spec, ctx in shard_cases(kind):
        serial = analyze(spec, GridSampler(None), dynamic_context=ctx)
        total = int(np.prod(spec.grid))
        merged = _heatmap_merge(spec, ctx, shard_bounds(total, 3))
        assert_heatmaps_identical(_strip_keys(merged), serial)


@geometry
def test_uneven_partition_merge_bit_identical(kind):
    """Degenerate partitions (empty and single-program shards) merge
    exactly too: the monoid has an identity."""
    spec = as_geometry(gemm.gemm_v00_spec(128, 128, 128), kind)
    serial = analyze(spec, GridSampler(None))
    total = int(np.prod(spec.grid))
    bounds = [(0, 0), (0, 1), (1, 1), (1, total)]
    assert_heatmaps_identical(_partition_merge(spec, None, bounds), serial)
    assert_heatmaps_identical(
        _strip_keys(_heatmap_merge(spec, None, bounds)), serial
    )


@geometry
def test_overlapping_heatmap_merge_is_union_not_sum(kind):
    """Merging OVERLAPPING shards unions contributors, never adds
    temperatures: the defining property of the merge algebra."""
    spec = as_geometry(gemm.gemm_v01_spec(128, 128, 128), kind)
    full = [(0, int(np.prod(spec.grid)))] * 2
    serial = analyze(spec, GridSampler(None))
    merged = _heatmap_merge(spec, None, full)
    assert merged.n_records == 2 * serial.n_records  # records DO add
    for name in serial.region_names():  # temperatures do NOT
        np.testing.assert_array_equal(
            merged.region(name).word_temps_matrix,
            serial.region(name).word_temps_matrix,
        )
        np.testing.assert_array_equal(
            merged.region(name).sector_temps_array,
            serial.region(name).sector_temps_array,
        )


@geometry
def test_sharded_collector_inprocess_bit_identical(kind):
    """The ShardedCollector's in-process path (no source) end to end."""
    for spec, ctx in shard_cases(kind):
        serial = analyze(spec, GridSampler(None), dynamic_context=ctx)
        with ShardedCollector(3) as sc:
            sharded = sc.analyze(spec, GridSampler(None), ctx)
        assert len(sharded.shards) == 3
        assert sum(s.programs for s in sharded.shards) == int(np.prod(spec.grid))
        assert_heatmaps_identical(sharded, serial)


@geometry
def test_collection_cache_hits_bit_identical(kind, tmp_path):
    """A cache hit, from the memory tier or a fresh process's disk tier,
    reproduces the freshly collected heat map exactly, for every case."""
    from repro_torch.core.cache import CollectionCache, spec_content_hash

    cache = CollectionCache(tmp_path / "cache")
    for spec, ctx in shard_cases(kind):
        serial = analyze(spec, GridSampler(None), dynamic_context=ctx)
        key = spec_content_hash(spec, GridSampler(None), ctx)
        cache.put(key, serial)
        assert_heatmaps_identical(cache.get(key), serial)  # memory tier
        rebooted = CollectionCache(tmp_path / "cache")  # fresh process
        assert_heatmaps_identical(rebooted.get(key), serial)


def _partition_from(rng, total):
    """A random contiguous partition of range(total) into shards."""
    n_cuts = int(rng.integers(0, min(6, total) + 1))
    cuts = sorted(int(c) for c in rng.integers(0, total + 1, size=n_cuts))
    edges = [0] + cuts + [total]
    return list(zip(edges[:-1], edges[1:]))


def _assert_partition_merges(kind, case, bounds_of):
    spec, ctx = shard_cases(kind)[case]
    total = int(np.prod(spec.grid))
    bounds = bounds_of(total)
    serial = analyze(spec, GridSampler(None), dynamic_context=ctx)
    assert_heatmaps_identical(_partition_merge(spec, ctx, bounds), serial)
    assert_heatmaps_identical(
        _strip_keys(_heatmap_merge(spec, ctx, bounds)), serial
    )


try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # the property runs as a seeded sweep instead
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @geometry
    @given(data=st.data(), case=st.integers(min_value=0, max_value=5))
    @settings(max_examples=20, deadline=None)
    def test_any_partition_merges_bit_identically(kind, data, case):
        """PROPERTY: for ANY contiguous partition of the sampled grid,
        both merge paths reproduce the single-pass heat map exactly."""

        def bounds_of(total):
            cuts = sorted(data.draw(st.lists(
                st.integers(min_value=0, max_value=total), max_size=6,
            )))
            edges = [0] + cuts + [total]
            return list(zip(edges[:-1], edges[1:]))

        _assert_partition_merges(kind, case, bounds_of)

else:

    @geometry
    @pytest.mark.parametrize("seed", range(6))
    def test_any_partition_merges_bit_identically(kind, seed):
        """PROPERTY (seeded sweep): for a random contiguous partition of
        the sampled grid, both merge paths reproduce the single pass."""
        rng = np.random.default_rng(seed)
        _assert_partition_merges(
            kind, seed, lambda total: _partition_from(rng, total)
        )
