"""Test-side bridge from the JAX package's specs to the port's.

The port never imports ``repro``; only tests hold the two side by side.
``to_port_spec`` rebuilds a ``repro`` KernelSpec field by field as a
port KernelSpec under the TPU tile geometry, so both engines walk the
same spec.
"""

import numpy as np

from repro_torch.core import collector as pc
from repro_torch.core.tiles import H100Sector


def to_port_spec(spec, geometry_kind="tpu-tile"):
    """A port KernelSpec equal, field by field, to a ``repro`` one."""
    return pc.KernelSpec(
        name=spec.name,
        grid=tuple(spec.grid),
        operands=tuple(
            pc.OperandSpec(
                name=op.name,
                shape=tuple(op.shape),
                dtype=op.dtype,
                block_shape=tuple(op.block_shape),
                index_map=op.index_map,
                kind=op.kind,
                space=op.space,
                origin=tuple(op.origin),
                once=op.once,
                geometry_kind=geometry_kind,
            )
            for op in spec.operands
        ),
        scratch=tuple(
            pc.ScratchSpec(
                name=sc.name,
                shape=tuple(sc.shape),
                dtype=sc.dtype,
                access_model=sc.access_model,
                kind=sc.kind,
                geometry_kind=geometry_kind,
            )
            for sc in spec.scratch
        ),
        dynamic=tuple(spec.dynamic),
    )


def assert_heatmaps_match(got, want):
    """Port heat map ``got`` equals reference ``want``, array for array."""
    assert got.kernel == want.kernel
    assert got.grid == want.grid
    assert got.sampler == want.sampler
    assert got.n_records == want.n_records
    assert got.dropped == want.dropped
    assert got.region_names() == want.region_names()
    for g, w in zip(got.regions, want.regions):
        name = w.region.name
        assert g.region.space == w.region.space, name
        assert tuple(g.region.geometry.shape) == tuple(w.region.geometry.shape)
        assert g.region.geometry.itemsize == w.region.geometry.itemsize
        assert g.n_programs == w.n_programs, name
        np.testing.assert_array_equal(g.tags_array, w.tags_array, err_msg=name)
        np.testing.assert_array_equal(
            g.word_temps_matrix, w.word_temps_matrix, err_msg=name
        )
        np.testing.assert_array_equal(
            g.sector_temps_array, w.sector_temps_array, err_msg=name
        )
    assert got.sector_transactions() == want.sector_transactions()
    assert got.waste_ratio() == want.waste_ratio()


def heat_of_warps(per_warp, shape, itemsize):
    """(tags, word temps, sector temps, warps) from per-warp flat indices."""
    geom = H100Sector(shape, itemsize)
    wps = geom.words_per_sector
    word_keys, sector_keys = [], []
    for parts in per_warp.values():
        tags, words = geom.flat_to_touch_arrays(np.concatenate(parts))
        keys = np.unique(tags * wps + words)
        word_keys.append(keys)
        sector_keys.append(np.unique(keys // wps))
    wk, wcount = np.unique(np.concatenate(word_keys), return_counts=True)
    tags, scount = np.unique(np.concatenate(sector_keys), return_counts=True)
    wt = np.zeros((tags.size, wps), np.int64)
    wt[np.searchsorted(tags, wk // wps), wk % wps] = wcount
    return tags, wt, scount, len(per_warp)


def port_sampler(sampler):
    """The port's GridSampler equal to a ``repro`` one."""
    from repro_torch.core.trace import GridSampler

    return GridSampler(sampler.target, window=sampler.window)


def reference_rungs(name):
    """The JAX package's registry family ``name`` as a port RegistryEntry:
    every rung's spec rebuilt by ``to_port_spec`` under the TPU tile, no
    kernel.  The tuner's rung source for holding it to the reference."""
    from repro import kernels as rk
    from repro_torch import kernels as pk

    entry = rk.get(name)
    return pk.RegistryEntry(
        name=entry.name,
        summary=entry.summary,
        variants=tuple(
            pk.KernelVariant(
                v.name,
                lambda v=v: to_port_spec(v.spec()),
                context=v.context,
                role=v.role,
                note=v.note,
            )
            for v in entry.variants
        ),
        sampler=lambda: port_sampler(entry.sampler()),
        region_map=tuple(entry.region_map),
    )
