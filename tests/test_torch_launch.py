"""The spmv_ell kernel's lane mapping and the one launch path of the wrappers.

``csrc/spmv.cu`` runs only on the card, so its thread-index arithmetic is
held here against a numpy emulation: lanes per row, float4 chunks or the
scalar path, row groups, the grid-stride loop and the xor-shuffle sum, each
(row, k) element read exactly once and each y[r] written once.  ``_build``
is held to binding each entry point once, with a libc function standing in
for a kernel's entry point, and the wrapper modules to launching through it.
"""

import ctypes
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, spmv

KERNELS_DIR = Path(spmv.__file__).resolve().parent
WRAPPER_MODULES = ("flash", "gemm", "gmm", "gramschm", "histogram", "paged_attn",
                   "ragged_flash", "spmv", "ssd", "ttm")
WARP = 32


def _fma(a, b, c):
    """fmaf in float32: the product is exact in float64, one rounding after."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulate_spmv(vals, xg, offsets, blocks=None):
    """y from ``csrc/spmv.cu``'s lane mapping, the reads of each (row, k)
    element and the writes of each y[r].  ``offsets`` are the element
    offsets of vals' and xg's base pointers from a 16-byte boundary (the
    vector path needs K % 4 == 0 and both at 0); ``blocks`` caps the grid,
    as the SM count does on the card."""
    r, k = vals.shape
    g = spmv.lanes_per_row(k)
    vec = k % 4 == 0 and all(o % 4 == 0 for o in offsets)
    width = 4 if vec else 1  # floats a chunk
    n = k // width  # chunks a row
    rows_per_warp = WARP // g
    step_rows = spmv.ROW_GROUPS * rows_per_warp
    grid = math.ceil(r / spmv.rows_per_block(g))
    if blocks is not None:
        grid = min(grid, blocks)
    warps = grid * (spmv.THREADS // WARP)
    lane = np.arange(WARP)
    sub, group = lane % g, lane // g
    reads = np.zeros((r, k), np.int64)
    writes = np.zeros(r, np.int64)
    y = np.zeros(r, np.float32)
    for warp in range(warps):
        for base in range(warp * step_rows, r, warps * step_rows):
            rows = base + np.arange(spmv.ROW_GROUPS)[:, None] * rows_per_warp + group
            live = rows < r
            acc = np.zeros(rows.shape, np.float32)
            for first in range(0, n, g):  # lane l's chunks l % g, + g, ...
                c = first + sub
                on = live & (c < n)
                rr = rows[on]
                for j in range(width):  # x, y, z, w within a float4
                    col = (c * width + j)[np.nonzero(on)[1]]
                    acc[on] = _fma(vals[rr, col], xg[rr, col], acc[on])
                    np.add.at(reads, (rr, col), 1)
            off = g // 2
            while off:  # __shfl_xor_sync, offsets g/2 down to 1
                acc = acc + acc[:, lane ^ off]
                off //= 2
            store = live & (sub == 0)
            y[rows[store]] = acc[store]
            np.add.at(writes, rows[store], 1)
    return y, reads, writes


@pytest.mark.parametrize("k, lanes", [(1, 1), (4, 1), (5, 2), (8, 2), (9, 4), (16, 4),
                                      (32, 8), (33, 16), (64, 16), (100, 32), (1000, 32)])
def test_lanes_per_row_give_each_lane_a_float4_at_most_32(k, lanes):
    assert spmv.lanes_per_row(k) == lanes
    assert spmv.rows_per_block(lanes) == spmv.THREADS // WARP * spmv.ROW_GROUPS * WARP // lanes


@pytest.mark.parametrize("grid", ["full", "one block"])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [1, 4, 5, 16, 32, 33, 100])
def test_spmv_lane_mapping_reads_each_element_once_and_matches_plain(k, offset, grid):
    rng = np.random.default_rng(k * 10 + offset)
    # a row count that is not a multiple of the rows a block covers
    r = spmv.rows_per_block(spmv.lanes_per_row(k)) + 37
    buf_v = rng.standard_normal(offset + r * k, dtype=np.float32)
    buf_x = rng.standard_normal(offset + r * k, dtype=np.float32)
    vals, xg = buf_v[offset:].reshape(r, k), buf_x[offset:].reshape(r, k)
    y, reads, writes = _emulate_spmv(vals, xg, (offset, offset),
                                     blocks=1 if grid == "one block" else None)
    assert (reads == 1).all() and (writes == 1).all()
    want = spmv.spmv_ell_plain(torch.from_numpy(vals), torch.from_numpy(xg)).numpy()
    scale = float(np.abs(want).max())
    # float32 sums of k products in another order
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-5 * scale)
    exact = (vals.astype(np.float64) * xg.astype(np.float64)).sum(1)
    np.testing.assert_allclose(y, exact, rtol=0, atol=1e-5 * scale)


def test_spmv_vector_path_needs_both_bases_aligned():
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((300, 16), dtype=np.float32)
    xg = rng.standard_normal((300, 16), dtype=np.float32)
    aligned, reads, _ = _emulate_spmv(vals, xg, (0, 0))
    scalar, reads_s, _ = _emulate_spmv(vals, xg, (0, 2))
    assert (reads == 1).all() and (reads_s == 1).all()
    np.testing.assert_allclose(aligned, scalar, rtol=0, atol=1e-5 * float(np.abs(aligned).max()))


class _Libc:
    """A kernel library stand-in: ``labs`` is the entry point (it returns
    |x|, so 0 is "no error") and ``strerror`` the error-string export."""

    def __init__(self):
        libc = ctypes.CDLL(None)
        self.labs = libc.labs
        self.repro_cuda_error_string = libc.strerror


@pytest.fixture
def libc(monkeypatch):
    loads = []

    def load(name):
        loads.append(name)
        return lib

    lib = _Libc()
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_BOUND", {})
    return lib, loads


def test_build_binds_an_entry_point_once(libc):
    lib, loads = libc
    _build.call("libc", "labs", [ctypes.c_long], 0)
    bound = _build._BOUND[("libc", "labs")]
    assert bound is lib.labs and bound.argtypes == [ctypes.c_long]
    assert bound.restype is ctypes.c_int
    bound.argtypes = None  # a second call that set argtypes again would show here
    _build.call("libc", "labs", [ctypes.c_long], 0)
    assert _build._BOUND[("libc", "labs")] is bound and bound.argtypes is None
    assert loads == ["libc"]


def test_build_raises_with_the_error_string_when_an_entry_point_fails(libc):
    _, loads = libc
    with pytest.raises(RuntimeError, match=r"labs launch failed: cuda error 5: \S"):
        _build.call("libc", "labs", [ctypes.c_long], -5)
    assert ("libc", "repro_cuda_error_string") in _build._BOUND
    assert loads == ["libc", "libc"]  # the entry point, then the error string


@pytest.mark.parametrize("module", WRAPPER_MODULES)
def test_wrappers_launch_through_the_one_build_path(module):
    text = (KERNELS_DIR / f"{module}.py").read_text()
    assert "_build.launch(" in text
    for own in ("torch.cuda.device(", "current_stream(", "cuda_stream", "_build.call("):
        assert own not in text, f"{module}.py keeps its own {own}"
    assert not re.search(r"\.(argtypes|restype)\s*=", text), f"{module}.py binds its own entry point"
