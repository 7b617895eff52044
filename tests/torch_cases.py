"""Shared cases of the port's golden, sharding and resilience tests.

Imports the port only (no JAX, no ``repro``), so the files that use it
also run on the card's machine.  Every case is a port spec at a small
shape; ``as_geometry`` walks it under either geometry.
"""

import dataclasses

import numpy as np

from repro_torch.kernels import gemm, gramschm, histogram, spmv, ttm

GEOMETRIES = ("h100-sector", "tpu-tile")


def as_geometry(spec, kind):
    """``spec`` with every operand and scratch buffer under ``kind``."""
    return dataclasses.replace(
        spec,
        operands=tuple(
            dataclasses.replace(op, geometry_kind=kind) for op in spec.operands
        ),
        scratch=tuple(
            dataclasses.replace(sc, geometry_kind=kind) for sc in spec.scratch
        ),
    )


def pinned(spec, region):
    """``spec`` with ``region`` read once, by the first visitor (what the
    tuner's ``pin`` move makes: an operand staged once and kept)."""
    return dataclasses.replace(
        spec,
        operands=tuple(
            dataclasses.replace(op, once=True) if op.name == region else op
            for op in spec.operands
        ),
    )


def shard_cases(kind):
    """Cases exercising every collector path under sharding: static
    broadcast operands, once= single-program stores, scratch
    accumulators, and dynamic (Level-2) CSR operands and scratch."""
    rng = np.random.default_rng(17)
    cases = [
        (gemm.gemm_v00_spec(128, 128, 128), None),
        (gemm.gemm_v01_spec(128, 128, 128), None),
        (ttm.ttm_scratch_spec(256, 8, 32), None),
        (pinned(gemm.gemm_v01_spec(128, 128, 128), "B"), None),  # once=
        (histogram.hist_opt2_spec(16384, 512),  # dynamic scratch
         {"cells": rng.integers(0, 512, size=16384).astype(np.int64)}),
        (histogram.hist_naive_spec(8192, 512),
         {"cells": rng.integers(0, 512, size=8192).astype(np.int64)}),
        (spmv.spmv_csr_spec(1024, 512),
         {"col_indices": rng.integers(0, 512, size=1024).astype(np.int32)}),
    ]
    return [(as_geometry(spec, kind), ctx) for spec, ctx in cases]


def misc_cases(kind):
    """The remaining case-study specs, walked at full trace."""
    rng = np.random.default_rng(11)
    colidx = rng.integers(0, 512, size=1024).astype(np.int32)
    cases = [
        (gramschm.k3_naive_block_spec(64, 64, 64, k=3), None),
        (gramschm.k3_opt_spec(64, 64, 64, k=3), None),
        (ttm.ttm_fused_spec(128, 8, 32), None),
        (spmv.spmv_zigzag_spec(1024, 512), {"col_indices": colidx}),
    ]
    return [(as_geometry(spec, kind), ctx) for spec, ctx in cases]


def assert_heatmaps_identical(got, want):
    """Bit-identical heat maps: regions, tags, temperatures, counts, and
    the derived transaction model."""
    assert got.kernel == want.kernel
    assert got.grid == want.grid
    assert got.n_records == want.n_records
    assert got.dropped == want.dropped
    assert got.region_names() == want.region_names()
    for g, w in zip(got.regions, want.regions):
        name = w.region.name
        assert g.region == w.region, name
        assert g.n_programs == w.n_programs, name
        np.testing.assert_array_equal(
            g.tags_array, w.tags_array, err_msg=f"tags of {name}"
        )
        np.testing.assert_array_equal(
            g.word_temps_matrix, w.word_temps_matrix,
            err_msg=f"word temps of {name}",
        )
        np.testing.assert_array_equal(
            g.sector_temps_array, w.sector_temps_array,
            err_msg=f"sector temps of {name}",
        )
        assert g.rows == w.rows, name
    assert got.sector_transactions() == want.sector_transactions()
    assert got.useful_word_transactions() == want.useful_word_transactions()
    assert got.waste_ratio() == want.waste_ratio()
    for name in got.region_names():
        assert got.waste_ratio(name) == want.waste_ratio(name), name
        assert (
            got.sector_transactions(name) == want.sector_transactions(name)
        ), name


def small_rungs(name):
    """The port registry's family ``name`` with every rung's spec at a
    small shape and no kernel: a cheap source of rungs for the tuner's
    tests (``rungs=``).  Families: ``gemm`` (128^3) and ``spmv`` (1024 x
    512)."""
    from repro_torch import kernels as kreg

    rng = np.random.default_rng(0)
    colidx = rng.integers(0, 512, size=1024).astype(np.int32)
    builds = {
        "gemm": {
            "v00": lambda: gemm.gemm_v00_spec(128, 128, 128),
            "v01": lambda: gemm.gemm_v01_spec(128, 128, 128),
            "v02": lambda: gemm.gemm_v02_spec(128, 128, 128),
        },
        "spmv": {
            "csr": lambda: spmv.spmv_csr_spec(1024, 512),
            "zigzag": lambda: spmv.spmv_zigzag_spec(1024, 512),
        },
    }[name]
    entry = kreg.get(name)
    return dataclasses.replace(
        entry,
        variants=tuple(
            dataclasses.replace(
                v,
                build=builds[v.name],
                context=(lambda: {"col_indices": colidx}) if name == "spmv" else None,
                kernel=None,
            )
            for v in entry.variants
        ),
    )
