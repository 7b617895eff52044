"""Engine parity: the port's seed engine held to the JAX package's.

Under ``tpu-tile`` the port's seed engine (``repro_torch.core._reference``)
must reproduce ``repro.core._reference`` bit for bit on the reference's
own specs (rebuilt field by field by ``torch_parity.to_port_spec``).  The
port-only golden files import no JAX; this one does.
"""

import numpy as np
import pytest

from repro.core import _reference as ref_seed
from repro.core.collector import OperandSpec as RefOperandSpec
from repro_torch.core import _reference as seed
from repro_torch.core.collector import OperandSpec
from repro_torch.core.heatmap import Analyzer
from repro_torch.core.trace import GridSampler

from torch_parity import assert_heatmaps_match, port_sampler, to_port_spec


def _cases():
    """The reference golden suite's specs, with their dynamic contexts."""
    from repro.kernels.gemm import gemm_v00_spec, gemm_v01_spec, gemm_v02_spec
    from repro.kernels.gramschm import k3_naive_block_spec, k3_opt_spec
    from repro.kernels.histogram import hist_naive_spec, hist_opt2_spec
    from repro.kernels.spmv import spmv_csr_spec, spmv_zigzag_spec
    from repro.kernels.ttm import cuszp_like_spec, ttm_fused_spec, ttm_scratch_spec

    rng = np.random.default_rng(7)
    return {
        "gemm_v00": (gemm_v00_spec(128, 128, 128), None),
        "gemm_v01": (gemm_v01_spec(256, 256, 256), None),
        "gemm_v02": (gemm_v02_spec(256, 256, 256, bm=64, bn=64, bk=64), None),
        "spmv_csr": (spmv_csr_spec(4096, 2048, block_rows=512),
                     {"col_indices": rng.integers(0, 2048, size=4096).astype(np.int32)}),
        "hist_naive": (hist_naive_spec(8192, 512, block=1024),
                       {"cells": rng.integers(0, 512, size=8192).astype(np.int64)}),
        "ttm_scratch": (ttm_scratch_spec(256, 8, 32), None),
        "hist_opt2": (hist_opt2_spec(16384, 512), None),
        "cuszp": (cuszp_like_spec(32), None),
        "gramschm_naive": (k3_naive_block_spec(256, 256, 256, k=3), None),
        "gramschm_opt": (k3_opt_spec(256, 256, 256, k=3), None),
        "ttm_fused": (ttm_fused_spec(128, 8, 32), None),
        "spmv_zigzag": (spmv_zigzag_spec(2048, 1024, block_rows=512),
                        {"col_indices": rng.integers(0, 1024, size=2048).astype(np.int32)}),
    }


CASES = sorted(_cases())
SAMPLERS = {"window8": ((0,), 8), "full": (None, 1)}


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
@pytest.mark.parametrize("case", CASES)
def test_seed_engine_matches_reference_seed(case, sampler):
    from repro.core.trace import GridSampler as RefSampler

    spec, ctx = _cases()[case]
    target, window = SAMPLERS[sampler]
    ref_sampler = RefSampler(target, window=window)
    want = ref_seed.analyze_reference(spec, ref_sampler, dynamic_context=ctx)
    got = seed.analyze_reference(
        to_port_spec(spec), port_sampler(ref_sampler), dynamic_context=ctx
    )
    assert_heatmaps_match(got, want)
    for g, w in zip(got.regions, want.regions):
        assert [tuple(vars(r).values()) for r in g.rows] == [
            tuple(vars(r).values()) for r in w.rows
        ]


def test_drain_dynamic_seed_matches_reference_seed():
    rng = np.random.default_rng(5)
    trace = rng.integers(-64, 4096, size=(8, 96))
    mask = rng.random((8, 96)) < 0.5
    ref_op = RefOperandSpec("x", (4096,), np.float32, (4096,), lambda i: (0,))
    op = OperandSpec("x", (4096,), np.float32, (4096,), lambda i: (0,),
                     geometry_kind="tpu-tile")
    for m in (None, mask):
        ref_buf = ref_seed.drain_dynamic_reference("k", (8,), ref_op, trace,
                                                   None, m)
        buf = seed.drain_dynamic_reference("k", (8,), op, trace,
                                           GridSampler(), m)
        assert [(r.program_id, r.touches) for r in buf.records] == [
            (r.program_id, r.touches) for r in ref_buf.records
        ]
        an, ran = seed.ReferenceAnalyzer("k", (8,), "s"), ref_seed.ReferenceAnalyzer("k", (8,), "s")
        an.ingest(buf)
        ran.ingest(ref_buf)
        assert_heatmaps_match(an.flush(), ran.flush())


def test_reconstructed_bitmasks_match_reference_columnar_engine():
    """``Analyzer._maps`` (the paper's bitmask state rebuilt from columnar
    chunks) equals the JAX package's on the same trace."""
    from repro.core.collector import collect as ref_collect
    from repro.core.heatmap import Analyzer as RefAnalyzer
    from repro.core.trace import GridSampler as RefSampler
    from repro.kernels.gemm import gemm_v01_spec
    from repro_torch.core.collector import collect

    spec = gemm_v01_spec(128, 128, 128)
    ref_buf, _ = ref_collect(spec, RefSampler((0,), window=8))
    buf, _ = collect(to_port_spec(spec), GridSampler((0,), window=8))
    an, ran = Analyzer(spec.name, spec.grid, "s"), RefAnalyzer(spec.name, spec.grid, "s")
    an.ingest(buf)
    ran.ingest(ref_buf)
    got, want = an._maps, ran._maps
    assert sorted(got) == sorted(want)
    for name in want:
        assert {t: (h.word_masks, h.sector_mask) for t, h in got[name].items()} == {
            t: (h.word_masks, h.sector_mask) for t, h in want[name].items()
        }
