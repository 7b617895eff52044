"""Test-side bridge from the JAX package's specs to the port's.

The port never imports ``repro``; only tests hold the two side by side.
``to_port_spec`` rebuilds a ``repro`` KernelSpec field by field as a
port KernelSpec under the TPU tile geometry, so both engines walk the
same spec.
"""

import numpy as np

from repro_torch.core import collector as pc


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
