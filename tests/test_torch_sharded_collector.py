"""ShardedCollector mechanics: partition math, shard provenance, token
unification, chunk consolidation, drop accounting, and the spawn pool.

Ports ``test_sharded_collector.py``.  Bit-identity of sharded and serial
heat maps is pinned for every collector path, under both geometries, in
``test_torch_golden_equivalence.py``; this module covers the machinery
around it.  Every test that starts a pool closes it and runs under a
watchdog that expires in test time.
"""

import dataclasses
import random

import numpy as np
import pytest

from repro_torch.core.collector import (
    ShardedCollector,
    analyze_sharded,
    _collect_shard_task,
    _spec_fingerprint,
    _unify_shard_groups,
    analyze,
    collect,
    collect_shard,
    shard_bounds,
    sourced_spec,
)
from repro_torch.core.heatmap import Analyzer, HeatKeys
from repro_torch.core.resilience import ResiliencePolicy
from repro_torch.core.session import heatmaps_equal
from repro_torch.core.trace import (
    GridSampler,
    KernelWhitelist,
    ShardInfo,
    sampled_grid,
    sampled_grid_array,
    sampled_grid_size,
    sampled_grid_slice,
)
from repro_torch.kernels import gemm

from torch_cases import as_geometry, pinned

#: A pool's watchdog in these tests: a wedged worker fails the test in
#: seconds instead of hanging the run.
POLICY = ResiliencePolicy(shard_timeout_s=60.0)


# -- partition math ----------------------------------------------------------


def test_shard_bounds_partition_exactly():
    for total in (0, 1, 2, 7, 128, 1000):
        for shards in (1, 2, 3, 8, 64):
            bounds = shard_bounds(total, shards)
            # contiguous, ordered, covering [0, total) exactly once
            assert bounds[0][0] == 0
            assert bounds[-1][1] == total
            for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
                assert hi == lo2
            if total > 0:
                assert len(bounds) == min(shards, total)
                assert all(hi > lo for lo, hi in bounds)
            else:
                assert bounds == [(0, 0)]


def test_shard_bounds_near_equal():
    bounds = shard_bounds(10, 3)
    sizes = [hi - lo for lo, hi in bounds]
    assert sum(sizes) == 10 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("grid", [(7,), (4, 5), (3, 4, 6)])
@pytest.mark.parametrize(
    "sampler",
    [GridSampler(None), GridSampler((0,)), GridSampler((1,), window=2),
     GridSampler((1, 0), window=3)],
    ids=["full", "row0", "window2", "pinned2"],
)
def test_sampled_grid_slice_and_size_match_the_array(grid, sampler):
    """A shard's rows are computed directly, and equal the sampled grid's."""
    whole = sampled_grid_array(grid, sampler)
    assert sampled_grid_size(grid, sampler) == whole.shape[0]
    assert [tuple(int(x) for x in row) for row in whole] == list(
        sampled_grid(grid, sampler)
    )
    n = whole.shape[0]
    for lo, hi in ((0, n), (1, n - 1), (n // 2, n), (2, 2), (0, n + 5)):
        np.testing.assert_array_equal(
            sampled_grid_slice(grid, sampler, lo, hi), whole[lo:max(lo, hi)]
        )


def test_kernel_whitelist_admits_named_kernels():
    assert KernelWhitelist().admits("anything")
    only = KernelWhitelist(["gemm_v01"])
    assert only.admits("gemm_v01") and not only.admits("gemm_v00")


# -- shard collection & provenance ------------------------------------------


def _spec(kind="h100-sector"):
    # grid (128, 4): one program per A row strip, 4 column strips each
    return as_geometry(gemm.gemm_v01_spec(128, 128, 128), kind)


def test_collect_shard_provenance_and_stamps():
    spec = _spec()
    buf, info = collect_shard(spec, GridSampler(None), None, 32, 96, 5)
    assert info == ShardInfo(
        shard=5, lo=32, hi=96, programs=64, records=len(buf),
        dropped=0, wall_s=info.wall_s,
    )
    assert info.wall_s > 0
    assert all(c.shard == 5 for c in buf.chunks)
    # the shard walked exactly its slice of the sampled grid
    lin = np.concatenate([c.pids[:, 0] * 4 + c.pids[:, 1] for c in buf.chunks])
    assert lin.min() >= 32 and lin.max() < 96


def test_shard_info_dict_roundtrip():
    info = ShardInfo(shard=1, lo=0, hi=8, programs=8, records=24,
                     dropped=2, wall_s=0.5)
    assert ShardInfo.from_dict(info.as_dict()) == info


def test_once_operand_owned_by_first_shard_only():
    """once= operands are emitted by the lo == 0 shard alone."""
    spec = pinned(_spec(), "B")
    once_names = {op.name for op in spec.operands if op.once}
    assert once_names == {"B"}
    b0, _ = collect_shard(spec, GridSampler(None), None, 0, 8, 0)
    b1, _ = collect_shard(spec, GridSampler(None), None, 8, 16, 1)
    sites0 = {c.site.array for c in b0.chunks}
    sites1 = {c.site.array for c in b1.chunks}
    assert once_names <= sites0
    assert not (once_names & sites1)


def test_unify_shard_groups_one_token_per_site():
    spec = _spec()
    b0, _ = collect_shard(spec, GridSampler(None), None, 0, 256, 0)
    b1, _ = collect_shard(spec, GridSampler(None), None, 256, 512, 1)
    _unify_shard_groups([b0, b1])
    by_site = {}
    for buf in (b0, b1):
        for c in buf.chunks:
            by_site.setdefault(c.site, set()).add(c.group)
    for site, groups in by_site.items():
        assert len(groups) == 1, site
    tokens = [next(iter(g)) for g in by_site.values()]
    assert len(set(tokens)) == len(tokens)


# -- chunk consolidation -----------------------------------------------------


def _flush(spec, buf):
    an = Analyzer(spec.name, spec.grid, "full-grid")
    an.ingest(buf)
    return an.flush()


def test_consolidate_is_exact_and_compacts():
    spec = _spec()  # one broadcast chunk per A row and per C block
    buf, _ = collect(spec, GridSampler(None))
    n_before = len(buf.chunks)
    records_before = len(buf)
    hm_before = _flush(spec, buf)
    buf.consolidate()
    assert len(buf.chunks) < n_before
    assert len(buf) == records_before
    assert heatmaps_equal(_flush(spec, buf), hm_before)


def test_consolidate_skips_record_heavy_broadcast():
    """Broadcast chunks with many records per touch set must NOT be
    expanded into CSR (A of gemm_v00: 128 warps share each row strip)."""
    spec = gemm.gemm_v00_spec(128, 128, 128)
    buf, _ = collect(spec, GridSampler(None))
    a_chunks = [c for c in buf.chunks if c.site.array == "A"]
    assert len(a_chunks) == 4 and all(c.n_records == 128 for c in a_chunks)
    buf.consolidate()
    a_after = [c for c in buf.chunks if c.site.array == "A"]
    assert len(a_after) == 4 and all(c.ptr is None for c in a_after)


# -- drop accounting across shards ------------------------------------------


def test_drop_accounting_sums_exactly_across_shards():
    spec = _spec()
    with ShardedCollector(4, max_records=40, policy=POLICY) as sc:
        bufs, infos = sc.collect(spec, GridSampler(None))
    assert sum(i.dropped for i in infos) == sum(b.dropped for b in bufs)
    assert any(i.dropped for i in infos)
    # the GLOBAL cap holds: shards share the serial budget, not N of it
    assert sum(i.records for i in infos) <= 40
    serial_buf, _ = collect(spec, GridSampler(None), max_records=40)
    assert sum(i.records for i in infos) == len(serial_buf)
    assert sum(i.dropped for i in infos) == serial_buf.dropped
    an = Analyzer(spec.name, spec.grid, "full-grid")
    for b in bufs:
        an.ingest(b)
        an.ingest(b)  # re-ingest must not double-count shard drops
    assert an.flush().dropped == sum(i.dropped for i in infos)


def test_truncated_sharded_analyze_warns():
    with ShardedCollector(2, max_records=40, policy=POLICY) as sc:
        with pytest.warns(RuntimeWarning, match="not bit-identical"):
            hm = sc.analyze(_spec(), GridSampler(None))
    assert hm.dropped > 0 and hm.n_records <= 40


# -- merge algebra guard rails ----------------------------------------------


def test_heatmap_merge_rejects_mismatched_launches():
    a = analyze(gemm.gemm_v00_spec(128, 128, 128), GridSampler(None))
    b = analyze(gemm.gemm_v01_spec(128, 128, 128), GridSampler(None))
    with pytest.raises(ValueError, match="different launches"):
        a.merge(b)


def test_region_merge_requires_key_state_and_one_geometry():
    hm = analyze(_spec(), GridSampler(None))  # flushed without keys
    with pytest.raises(ValueError, match="key-set state"):
        hm.merge(hm)
    # a TPU-tile shard never merges into an H100-sector map
    keyed = {}
    for kind in ("h100-sector", "tpu-tile"):
        buf, _ = collect_shard(_spec(kind), GridSampler(None), None, 0, 64, 0)
        an = Analyzer("gemm_v01", (128, 4), "s")
        an.ingest(buf)
        keyed[kind] = an.flush(keep_keys=True)
    with pytest.raises(ValueError, match="geometry 'h100-sector'.*'tpu-tile'"):
        keyed["h100-sector"].merge(keyed["tpu-tile"])


def test_heat_keys_union_is_idempotent_and_commutative():
    spec = _spec()
    buf, _ = collect_shard(spec, GridSampler(None), None, 0, 256, 0)
    an = Analyzer(spec.name, spec.grid, "s")
    an.ingest(buf)
    ks = an.flush(keep_keys=True).region("A").key_state
    assert ks is not None and ks.union(ks).equals(ks)
    assert ks.union(HeatKeys.empty()).equals(ks)
    buf2, _ = collect_shard(spec, GridSampler(None), None, 256, 512, 1)
    an2 = Analyzer(spec.name, spec.grid, "s")
    an2.ingest(buf2)
    ks2 = an2.flush(keep_keys=True).region("A").key_state
    assert ks.union(ks2).equals(ks2.union(ks))


# -- spec sources ------------------------------------------------------------


def test_sourced_spec_builds_and_stamps():
    ref = "repro_torch.kernels.gemm:gemm_v01_spec"
    spec = sourced_spec(ref, 256, 256, 256)
    assert spec.grid and spec.source == (ref, (256, 256, 256), {})
    direct = gemm.gemm_v01_spec(256, 256, 256)
    assert heatmaps_equal(
        analyze(spec, GridSampler(None)), analyze(direct, GridSampler(None))
    )


def test_registry_build_stamps_source():
    from repro_torch import kernels as kreg

    spec, _ = kreg.build("gemm")
    assert spec.source == "gemm:v00"
    assert kreg.build("gemm:v01")[0].source == "gemm:v01"
    assert kreg.build("model.transformer-tiny.attn")[0].source == (
        "model.transformer-tiny.attn:" + kreg.get("model.transformer-tiny.attn").variants[0].name
    )


def test_rebuild_rejects_stale_source_and_foreign_geometry():
    """A spec structurally changed after source stamping, or walked under
    another geometry, is never silently replaced by the pristine rebuild
    in the worker."""
    from repro_torch import kernels as kreg

    spec, _ = kreg.build("gemm:v00")  # the registry builds at 1024^3
    task = {
        "sampler": GridSampler(None),
        "dynamic_context": None,
        "lo": 0, "hi": 1, "shard": 0, "max_records": 100,
    }
    stale = dataclasses.replace(
        gemm.gemm_v00_spec(64, 64, 64), source=spec.source
    )
    foreign = as_geometry(spec, "tpu-tile")
    for bad in (stale, foreign):
        with pytest.raises(ValueError, match="structurally"):
            _collect_shard_task(dict(
                task, source=bad.source, fingerprint=_spec_fingerprint(bad)
            ))


# -- merge-algebra property: duplication/permutation invariance --------------
#
# The recovery loop leans on this: a re-executed shard (retry, pool
# rebuild, watchdog resplit) contributes its key sets AGAIN, and the union
# must not care.  Folding any shard sequence that covers every shard at
# least once, duplicates and order arbitrary, gives temperature state
# bit-identical to the serial full-grid build.

_N_SHARDS = 4


@pytest.fixture(scope="module")
def shard_maps():
    spec = gemm.gemm_v01_spec(32, 64, 32)  # grid (32, 2): 64 warps
    maps = []
    for i, (lo, hi) in enumerate(shard_bounds(64, _N_SHARDS)):
        buf, _ = collect_shard(spec, GridSampler(None), None, lo, hi, i)
        an = Analyzer(spec.name, spec.grid, "full-grid")
        an.ingest(buf)
        maps.append(an.flush(keep_keys=True))
    serial_buf, _ = collect(spec, GridSampler(None))
    an = Analyzer(spec.name, spec.grid, "full-grid")
    an.ingest(serial_buf)
    return maps, an.flush(keep_keys=True)


def _temps_equal(a, b):
    """Bit-identity of temperature state only (n_records and shards differ
    by construction when a shard is merged twice)."""
    if a.region_names() != b.region_names():
        return False
    for ra, rb in zip(a.regions, b.regions):
        if ra.n_programs != rb.n_programs:
            return False
        if not (
            np.array_equal(ra.tags_array, rb.tags_array)
            and np.array_equal(ra.word_temps_matrix, rb.word_temps_matrix)
            and np.array_equal(ra.sector_temps_array, rb.sector_temps_array)
        ):
            return False
    return True


def _assert_fold_matches_serial(seq, shard_maps):
    maps, serial = shard_maps
    merged = maps[seq[0]]
    for i in seq[1:]:
        merged = merged.merge(maps[i])
    assert _temps_equal(merged, serial), seq


try:
    from hypothesis import given, settings
    from hypothesis import strategies as hyp_st

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

if HAVE_HYPOTHESIS:

    @settings(max_examples=30, deadline=None)
    @given(
        seq=hyp_st.lists(
            hyp_st.integers(0, _N_SHARDS - 1), min_size=_N_SHARDS,
            max_size=3 * _N_SHARDS,
        ).filter(lambda s: set(s) == set(range(_N_SHARDS)))
    )
    def test_merge_duplication_invariance_property(seq, shard_maps):
        _assert_fold_matches_serial(seq, shard_maps)

else:

    @pytest.mark.parametrize("case", range(24))
    def test_merge_duplication_invariance_property(case, shard_maps):
        rng = random.Random(case)
        base = list(range(_N_SHARDS))
        rng.shuffle(base)
        extra = [
            rng.randrange(_N_SHARDS)
            for _ in range(rng.randrange(2 * _N_SHARDS + 1))
        ]
        seq = base + extra
        rng.shuffle(seq)
        _assert_fold_matches_serial(seq, shard_maps)


def test_remerging_same_subset_twice_is_bit_identical(shard_maps):
    """The resilient collector's shape: a subset lands, then lands AGAIN
    (duplicated delivery after a presumed-lost shard)."""
    maps, serial = shard_maps
    once = maps[0]
    for m in maps[1:]:
        once = once.merge(m)
    twice = once
    for m in maps[:2]:
        twice = twice.merge(m)
    assert _temps_equal(once, serial)
    assert _temps_equal(twice, once)


# -- the process pool (spawn) ------------------------------------------------


def test_pool_sharded_analyze_matches_serial():
    """End to end across real spawned workers: a source-stamped spec is
    rebuilt in the worker under its own geometry, chunks are shipped
    back and merged bit-identically; the pool is reused."""
    spec = sourced_spec("repro_torch.kernels.gemm:gemm_v01_spec", 128, 128, 128)
    serial = analyze(spec, GridSampler(None))
    with ShardedCollector(2, policy=POLICY) as sc:
        sharded = sc.analyze(spec, GridSampler(None))
        sharded2 = sc.analyze(spec, GridSampler(None))
    assert heatmaps_equal(serial, sharded)
    assert heatmaps_equal(serial, sharded2)
    assert [(s.lo, s.hi) for s in sharded.shards] == [
        (s.lo, s.hi) for s in sharded2.shards
    ]
    assert len(sharded.shards) == 2 and sharded.faults == ()
    # the one-shot form on a spec with no source: in process, 3 shards
    local = analyze_sharded(_spec(), GridSampler(None), workers=3)
    assert heatmaps_equal(local, analyze(_spec(), GridSampler(None)))
    assert len(local.shards) == 3
