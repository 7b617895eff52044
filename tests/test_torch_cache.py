"""The port's collection cache: keys, tiers, geometry and bit-identity.

Ports ``test_collection_cache.py``: the same keys, tiers and hits, on the
port's specs under both geometries.  The geometry is part of the key, so
an entry walked under ``TPUTile`` never answers an ``H100Sector`` walk;
an entry holds the heat map only, never a profile's ``run`` record.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import repro.kernels as rk
from repro.core.collector import analyze as ref_analyze
from repro_torch import kernels as kreg
from repro_torch.core.cache import (
    CACHE_VERSION,
    CacheKeyError,
    CollectionCache,
    callable_fingerprint,
    spec_content_hash,
)
from repro_torch.core.collector import KernelSpec, OperandSpec
from repro_torch.core.session import ProfileSession, heatmaps_equal, profile_kernel
from repro_torch.core.trace import GridSampler

from torch_parity import assert_heatmaps_match, to_port_spec

GEOMETRIES = ("h100-sector", "tpu-tile")


def _spec(index_map=None, origin=(0, 0), geometry="h100-sector"):
    imap = index_map or (lambda i, j: (i, 0))
    return KernelSpec(
        name="toy",
        grid=(8, 8),
        operands=(
            OperandSpec("A", (64, 64), np.float32, (8, 64), imap,
                        geometry_kind=geometry),
            OperandSpec(
                "B", (64, 64), np.float32, (8, 64),
                lambda i, j: (0, j), origin=origin, geometry_kind=geometry,
            ),
        ),
    )


class Opaque:
    def __call__(self, i, j):
        return (i, 0)


# ---------------------------------------------------------------------------
# key derivation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_hash_is_deterministic_in_process(geometry):
    assert spec_content_hash(_spec(geometry=geometry)) == spec_content_hash(
        _spec(geometry=geometry)
    )


def test_hash_changes_with_index_map():
    a = spec_content_hash(_spec(lambda i, j: (i, 0)))
    b = spec_content_hash(_spec(lambda i, j: (0, i)))
    assert a != b


def test_hash_changes_with_captured_closure_value():
    def make(k):
        return lambda i, j: (i * k, 0)

    assert spec_content_hash(_spec(make(1))) != spec_content_hash(_spec(make(2)))


def test_hash_same_for_identical_closures():
    def make(k):
        return lambda i, j: (i * k, 0)

    assert spec_content_hash(_spec(make(2))) == spec_content_hash(_spec(make(2)))


def test_hash_changes_with_origin():
    assert spec_content_hash(_spec()) != spec_content_hash(_spec(origin=(0, 7)))


def test_hash_changes_with_geometry():
    """The same spec under the two geometries: two keys, never one."""
    assert spec_content_hash(_spec(geometry="h100-sector")) != spec_content_hash(
        _spec(geometry="tpu-tile")
    )


def test_hash_changes_with_sampler():
    spec = _spec()
    full = spec_content_hash(spec, GridSampler(None))
    windowed = spec_content_hash(spec, GridSampler((0,), window=4))
    wider = spec_content_hash(spec, GridSampler((0,), window=8))
    assert len({full, windowed, wider}) == 3


def test_hash_changes_with_dynamic_context():
    spec, ctx = kreg.build("spmv:csr")
    base = spec_content_hash(spec, dynamic_context=ctx)
    changed = {k: v.copy() for k, v in ctx.items()}
    name = sorted(changed)[0]
    changed[name] = changed[name] + 1
    assert spec_content_hash(spec, dynamic_context=changed) != base


def test_registry_specs_hash_stably_across_processes():
    """Rebuilding the same registry spec in a fresh interpreter yields the
    same content key: the property the on-disk tier rests on."""
    here = {}
    for ref in ("gemm:v00", "gramschm:opt"):
        spec, ctx = kreg.build(ref)
        here[ref] = spec_content_hash(spec, dynamic_context=ctx)
    script = textwrap.dedent(
        """
        import sys
        sys.path.insert(0, sys.argv[1])
        from repro_torch.core.cache import spec_content_hash
        from repro_torch.kernels import build
        for ref in ("gemm:v00", "gramschm:opt"):
            spec, ctx = build(ref)
            print(spec_content_hash(spec, dynamic_context=ctx))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script, str(Path(__file__).parent.parent / "src")],
        capture_output=True,
        text=True,
        check=True,
    )
    assert out.stdout.split() == [here["gemm:v00"], here["gramschm:opt"]]


def test_every_registry_spec_is_content_hashable():
    """The main path's specs all hash: none profiles uncached."""
    for name in kreg.names():
        for v in kreg.get(name).variants:
            spec, ctx = kreg.build(f"{name}:{v.name}")
            assert len(spec_content_hash(spec, dynamic_context=ctx)) == 64


def test_uncacheable_callable_raises():
    with pytest.raises(CacheKeyError):
        spec_content_hash(_spec(Opaque()))


def test_callable_fingerprint_distinguishes_bytecode():
    assert callable_fingerprint(lambda i: (i, 0)) != callable_fingerprint(
        lambda i: (0, i)
    )


# ---------------------------------------------------------------------------
# cache behavior through profile_kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_hit_is_bit_identical_to_fresh_collection(geometry):
    cache = CollectionCache()
    fresh = profile_kernel(_spec(geometry=geometry), cache=cache)
    assert not fresh.cached and fresh.cache_key
    again = profile_kernel(_spec(geometry=geometry), cache=cache)
    assert again.cached and again.cache_key == fresh.cache_key
    assert heatmaps_equal(fresh.heatmap, again.heatmap)
    assert {rh.region.geometry.kind for rh in again.heatmap.regions} == {geometry}
    assert cache.stats.hits == 1 and cache.stats.misses == 1


@pytest.mark.parametrize("ref", ["gemm:v00", "spmv:csr", "ttm:scratch"])
def test_cached_reference_spec_matches_the_reference_walk(ref, tmp_path):
    """Under TPUTile a disk hit is the JAX package's heat map, array for
    array (the cache round trip loses nothing)."""
    spec, ctx = rk.build(ref)
    want = ref_analyze(spec, GridSampler(None), ctx)
    profile_kernel(to_port_spec(spec), None, ctx, cache=CollectionCache(tmp_path))
    warm = profile_kernel(to_port_spec(spec), None, ctx, cache=CollectionCache(tmp_path))
    assert warm.cached
    assert_heatmaps_match(warm.heatmap, want)


def test_tpu_entry_never_answers_an_h100_walk(tmp_path):
    cache = CollectionCache(tmp_path / "cache")
    tpu = profile_kernel(_spec(geometry="tpu-tile"), cache=cache)
    h100 = profile_kernel(_spec(geometry="h100-sector"), cache=cache)
    assert not h100.cached and h100.cache_key != tpu.cache_key
    assert cache.stats.hits == 0 and cache.stats.misses == 2
    assert {rh.region.geometry.kind for rh in h100.heatmap.regions} == {"h100-sector"}
    assert h100.transactions != tpu.transactions


def test_changed_spec_misses():
    cache = CollectionCache()
    profile_kernel(_spec(), cache=cache)
    pk = profile_kernel(_spec(lambda i, j: (0, i)), cache=cache)
    assert not pk.cached
    assert cache.stats.misses == 2 and cache.stats.hits == 0


def test_uncacheable_spec_profiles_uncached():
    cache = CollectionCache()
    pk = profile_kernel(_spec(Opaque()), cache=cache)
    assert not pk.cached and pk.cache_key == ""
    assert pk.transactions > 0
    assert cache.stats.uncacheable == 1
    assert cache.stats.hits == cache.stats.misses == 0


def test_hit_strips_shard_provenance():
    cache = CollectionCache()
    hm = profile_kernel(_spec(), cache=cache).heatmap
    stored = cache.get(spec_content_hash(_spec(), GridSampler(None)))
    assert stored is not None
    assert stored.shards == ()
    assert heatmaps_equal(stored, hm)


def test_entry_never_holds_a_run_record(tmp_path):
    """The run is the caller's measurement: a hit carries the run given to
    it now, and nothing of a run is stored."""
    cache = CollectionCache(tmp_path / "cache")
    cold = profile_kernel(_spec(), cache=cache, run={"device": "cpu", "ms": None, "launches": 1})
    warm = profile_kernel(_spec(), cache=cache, run={"device": "cpu", "ms": None, "launches": 2})
    assert warm.cached and warm.run["launches"] == 2 and cold.run["launches"] == 1
    assert profile_kernel(_spec(), cache=cache).run is None
    _npz, meta_path = cache._entry_paths(cold.cache_key)
    assert '"run"' not in meta_path.read_text()
    assert not any("run" in k for k in np.load(_npz).files)


# ---------------------------------------------------------------------------
# the on-disk tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_disk_round_trip_survives_restart(geometry, tmp_path):
    first = CollectionCache(tmp_path / "cache")
    fresh = profile_kernel(_spec(geometry=geometry), cache=first)
    # a new cache object over the same directory models a new process
    second = CollectionCache(tmp_path / "cache")
    pk = profile_kernel(_spec(geometry=geometry), cache=second)
    assert pk.cached
    assert heatmaps_equal(pk.heatmap, fresh.heatmap)
    assert second.stats.disk_hits == 1
    # the disk hit was promoted: the next lookup is a memory hit
    profile_kernel(_spec(geometry=geometry), cache=second)
    assert second.stats.memory_hits == 1


def test_cache_version_mismatch_is_a_miss(tmp_path):
    cache = CollectionCache(tmp_path / "cache")
    pk = profile_kernel(_spec(), cache=cache)
    _npz, meta_path = cache._entry_paths(pk.cache_key)
    meta = json.loads(meta_path.read_text())
    meta["cache_version"] = CACHE_VERSION + 1
    meta_path.write_text(json.dumps(meta))
    stale = CollectionCache(tmp_path / "cache")
    assert stale.get(pk.cache_key) is None
    assert stale.stats.misses == 1 and stale.stats.corrupt == 0


def test_corrupt_npz_is_a_miss_and_quarantined(tmp_path):
    cache = CollectionCache(tmp_path / "cache")
    pk = profile_kernel(_spec(), cache=cache)
    npz_path, meta_path = cache._entry_paths(pk.cache_key)
    npz_path.write_bytes(b"not an npz")
    broken = CollectionCache(tmp_path / "cache")
    with pytest.warns(RuntimeWarning, match="quarantine"):
        assert broken.get(pk.cache_key) is None
    assert broken.stats.corrupt == 1
    quarantine = tmp_path / "cache" / "quarantine"
    assert sorted(p.name for p in quarantine.iterdir()) == sorted(
        [npz_path.name, meta_path.name]
    )
    # the next profile re-collects and stores a sound entry again
    again = profile_kernel(_spec(), cache=CollectionCache(tmp_path / "cache"))
    assert not again.cached and npz_path.is_file()


def test_disk_layout_is_sharded_by_key_prefix(tmp_path):
    cache = CollectionCache(tmp_path / "cache")
    pk = profile_kernel(_spec(), cache=cache)
    key = pk.cache_key
    assert (tmp_path / "cache" / key[:2] / f"{key}.npz").is_file()
    meta = json.loads((tmp_path / "cache" / key[:2] / f"{key}.json").read_text())
    assert meta["format"] == "cuthermo-collection-cache"
    assert meta["key"] == key
    assert meta["provenance"]["python"]
    assert [r["geometry"] for r in meta["heatmap"]["regions"]] == ["h100-sector"] * 2


# ---------------------------------------------------------------------------
# session, CLI and tuner integration
# ---------------------------------------------------------------------------


def test_session_opens_its_cache_from_a_directory(tmp_path):
    from repro_torch.kernels.gemm import gemm_v00_spec

    sess = ProfileSession(tmp_path / "sess", cache=tmp_path / "cache")
    assert isinstance(sess.cache, CollectionCache) and sess.cache.path == tmp_path / "cache"
    first = sess.add_iteration([profile_kernel(gemm_v00_spec(128, 128, 128), cache=sess.cache)])
    again = ProfileSession(tmp_path / "sess", cache=tmp_path / "cache")
    second = again.add_iteration([profile_kernel(gemm_v00_spec(128, 128, 128), cache=again.cache)])
    assert again.cache.stats.disk_hits == 1 and again.cache.stats.misses == 0
    assert heatmaps_equal(first.kernels[0].heatmap, second.kernels[0].heatmap)


def test_cli_profile_cache_rerun_is_bit_identical(tmp_path, capsys):
    from repro_torch.cli import main

    argv = ["profile", "-k", "gramschm:opt", "--device", "cpu", "--out",
            str(tmp_path / "s"), "--cache", str(tmp_path / "c"), "-q"]
    assert main(argv) == 0
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "cache: 1 hits (0 memory, 1 disk), 0 misses" in out
    sess = ProfileSession(tmp_path / "s", create=False)
    cold, warm = (it.kernels[0] for it in sess.iterations())
    assert heatmaps_equal(cold.heatmap, warm.heatmap)
    # the run is measured again on the warm profile, never served
    assert cold.run is not None and warm.run is not None


def test_cli_model_cache_rerun_is_bit_identical(tmp_path, capsys):
    from repro_torch.cli import main

    argv = ["model", "transformer-tiny", "--device", "cpu", "--out",
            str(tmp_path / "s"), "--cache", str(tmp_path / "c"), "-q"]
    assert main(argv) == 0
    assert main(argv) == 0
    out = capsys.readouterr().out
    sess = ProfileSession(tmp_path / "s", create=False)
    cold, warm = sess.iterations()
    # two kernels of one kind share a spec: the cold run hits on the second
    assert "cache: 2 hits (2 memory, 0 disk), 3 misses" in out
    assert "cache: 5 hits (2 memory, 3 disk), 0 misses" in out
    for a, b in zip(cold.kernels, warm.kernels):
        assert heatmaps_equal(a.heatmap, b.heatmap)
    assert warm.layers["table"] == cold.layers["table"]


def test_tune_reuses_cached_traces():
    """A repeated tune run performs no fresh walk: every profile, the
    baseline included, is served from the cache, bit-identically."""
    from repro_torch.core.tuner import tune

    cache = CollectionCache()
    cold = tune("gramschm", budget=2, seed=0, cache=cache, device="cpu")
    before = cache.stats.misses
    warm = tune("gramschm", budget=2, seed=0, cache=cache, device="cpu")
    assert cache.stats.misses == before
    assert cache.stats.hits == len(warm.steps) + 1
    assert heatmaps_equal(cold.best.heatmap, warm.best.heatmap)
    assert warm.best.run is not None  # measured again, never cached


def test_replaced_field_changes_the_key():
    spec = _spec()
    op = dataclasses.replace(spec.operands[0], once=True)
    assert spec_content_hash(spec) != spec_content_hash(
        dataclasses.replace(spec, operands=(op, spec.operands[1]))
    )
