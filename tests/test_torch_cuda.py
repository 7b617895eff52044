"""The port's CUDA kernels on the card (marked ``gpu``; they skip elsewhere).

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch import kernels as kreg
from repro_torch.kernels import (
    _build, flash, gemm, gmm, gramschm, histogram, ops, paged_attn, ragged_flash, spmv, ssd, ttm,
)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# chip_smoke.py's limits on kernels.device_time_ms, and why: against
# torch.profiler's kernel sum (DEVICE_TOL, and DEVICE_SLACK_MS for each
# kernel of a call), and between two runs of one call (ALONE_TOL,
# ALONE_SLACK_MS)
DEVICE_TOL, DEVICE_SLACK_MS = 0.05, 0.0015
ALONE_TOL, ALONE_SLACK_MS = 0.05, 0.0005
#: every registry variant that launches a kernel, and spmv_ell, which only
#: ops.spmv reaches
TIMED = [f"{name}:{v.name}" for name in kreg.names() for v in kreg.get(name).variants
         if v.kernel is not None] + ["spmv_ell"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "mnk", [(32, 64, 32), (64, 64, 64), (128, 128, 64), (40, 72, 24), (1, 1, 1)]
)
def test_cuda_kernels_match_plain_version(card, dtype, mnk):
    m, n, k = mnk
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(card, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(card, dtype)
    want = gemm.gemm_plain(a, b).float()
    for fn in gemm.KERNELS.values():
        before = fn.launches
        got = fn(a, b)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == dtype and got.device == a.device
        tol = TOL[dtype] * k
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_cuda_wrappers_reject_mixed_devices(card):
    for fn in gemm.KERNELS.values():
        with pytest.raises(ValueError, match="device"):
            fn(torch.randn(4, 4, device=card), torch.randn(4, 4))
    for fn in gramschm.KERNELS.values():
        with pytest.raises(ValueError, match="device"):
            fn(torch.randn(4, 4, device=card), torch.randn(4, 4), 0)
    for fn in ttm.KERNELS.values():
        with pytest.raises(ValueError, match="device"):
            fn(torch.randn(4, 2, device=card), torch.randn(4, 2, 3))
    with pytest.raises(ValueError, match="device"):
        ops.spmv(torch.randn(4, 2, device=card), torch.randn(4, 2))
    with pytest.raises(ValueError, match="device"):
        ops.spmv(torch.randn(4, 2), torch.randn(4, 2, device=card))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 3])
@pytest.mark.parametrize(
    "ni, nj, nk", [(64, 256, 32), (512, 512, 512), (40, 300, 7), (1, 1, 4)]
)
def test_cuda_gramschm_matches_plain_version(card, ni, nj, nk, k):
    if k >= nk:
        k = nk - 1
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((ni, nk), dtype=np.float32)).to(card)
    a = torch.from_numpy(rng.standard_normal((ni, nj), dtype=np.float32)).to(card)
    want = gramschm.gramschm_k3_plain(q, a, k)
    for fn, qq in ((gramschm.gramschm_k3_naive, q), (gramschm.gramschm_k3_opt, q.t().contiguous())):
        before = fn.launches
        got = fn(qq, a, k)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == (nj,) and got.dtype == torch.float32
        # float32 sums of ni products in another order
        torch.testing.assert_close(got, want, atol=2e-5 * ni, rtol=2e-5 * ni)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "ni, nj, nk",
    [(4096, 4096, 4096), (300, 77, 5), (1, 1, 4), (2000, 4098, 3), (65535 * 256 + 1, 4, 1)],
)
def test_cuda_gramschm_opt_split_is_right_and_repeatable(card, ni, nj, nk):
    """The split-i route at the timing shape, at NJ % 4 != 0 with NI not a
    multiple of a slice, at one element, and with more than 65535 slices
    (NI past 65535 x 256: the grid is 1-D): within the float32 tolerance of
    the plain version, and a second call gives the same bits."""
    k = nk - 1
    q = _randn(card, 0, ni, nk)
    a = _randn(card, 1, ni, nj)
    qt = q.t().contiguous()
    want = gramschm.gramschm_k3_plain(q, a, k)
    before = gramschm.gramschm_k3_opt.launches
    got = gramschm.gramschm_k3_opt(qt, a, k)
    again = gramschm.gramschm_k3_opt(qt, a, k)
    torch.cuda.synchronize()
    assert gramschm.gramschm_k3_opt.launches == before + 2
    assert got.shape == (nj,) and torch.equal(got, again)
    # float32 sums of ni products in another order
    torch.testing.assert_close(got, want, atol=2e-5 * ni, rtol=2e-5 * ni)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "f, nf, r", [(16, 8, 32), (512, 8, 32), (32, 4, 64), (13, 3, 70), (9, 1, 1)]
)
def test_cuda_ttm_matches_plain_version(card, f, nf, r):
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal((f, nf), dtype=np.float32)).to(card)
    urows = torch.from_numpy(rng.standard_normal((f, nf, r), dtype=np.float32)).to(card)
    want = ttm.ttm_plain(vals, urows)
    for fn in ttm.KERNELS.values():
        before = fn.launches
        got = fn(vals, urows)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == (f, r) and got.dtype == torch.float32
        # float32 sums of nf products, fused or not
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n, n_bins, lo, hi",
    [
        (65536, 2048, 0, 2048),  # the registry's shape
        (3000, 64, -3, 70),  # ragged, with ids outside [0, n_bins)
        (1, 1, 0, 1),
        (300 * 1024 + 17, 12288, -1, 12290),  # more blocks than opt2's grid
        (1 << 20, 5, 0, 5),  # heavy contention on five bins
    ],
)
def test_cuda_histogram_matches_plain_version(card, n, n_bins, lo, hi):
    rng = np.random.default_rng(n)
    cells = torch.from_numpy(rng.integers(lo, hi, size=n).astype(np.int32)).to(card)
    want = histogram.hist_plain(cells, n_bins)
    for fn in histogram.KERNELS.values():
        before = fn.launches
        got = fn(cells, n_bins)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == (n_bins,) and got.dtype == torch.float32
        # integer counts below 2**24: exact in float32 in any order of atomics
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
def test_cuda_histogram_drops_out_of_range_ids(card):
    cells = torch.tensor([-1, 0, 1, 63, 64, 70, 5, 5] * 128, dtype=torch.int32, device=card)
    for fn in histogram.KERNELS.values():
        got = fn(cells, 64).cpu()
        assert got.sum() == 640 and got[63] == 128 and got[5] == 256


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 4097, 65537, 300 * 4096 + 7])
def test_cuda_hist_opt2_takes_any_slice(card, n, offset):
    """hist_opt2 reads its ids as int4 from the first 16-byte boundary: an
    unaligned slice (offset 1-3 ids), n not a multiple of 4 and ids outside
    [0, n_bins) are all bit-equal to the plain version and to np.bincount."""
    rng = np.random.default_rng(n + offset)
    ids = rng.integers(-2, 70, size=n + offset).astype(np.int32)
    cells = torch.from_numpy(ids).to(card)[offset:]
    assert cells.data_ptr() % 16 == 4 * offset % 16
    before = histogram.hist_opt2.launches
    got = histogram.hist_opt2(cells, 64)
    torch.cuda.synchronize()
    assert histogram.hist_opt2.launches == before + 1
    kept = ids[offset:][(ids[offset:] >= 0) & (ids[offset:] < 64)]
    torch.testing.assert_close(got, histogram.hist_plain(cells, 64), atol=0, rtol=0)
    np.testing.assert_array_equal(got.cpu().numpy(), np.bincount(kept, minlength=64))


@pytest.mark.gpu
def test_opt2_grid_cap_matches_the_kernel_source(card):
    lib = _build.load("histogram")
    assert lib.repro_hist_opt2_max_blocks() == histogram.OPT2_MAX_BLOCKS


@pytest.mark.gpu
@pytest.mark.parametrize(
    "r, k", [(8, 4), (32, 16), (64, 33), (30, 5), (65536, 16), (1, 1), (1000, 100)]
)
def test_cuda_spmv_matches_plain_version(card, r, k):
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.standard_normal((r, k), dtype=np.float32)).to(card)
    xg = torch.from_numpy(rng.standard_normal((r, k), dtype=np.float32)).to(card)
    want = spmv.spmv_ell_plain(vals, xg)
    before = spmv.spmv_ell.launches
    got = ops.spmv(vals, xg)
    torch.cuda.synchronize()
    assert spmv.spmv_ell.launches == before + 1
    assert got.shape == (r,) and got.dtype == torch.float32
    # float32 sums of k products in another order
    torch.testing.assert_close(got, want, atol=1e-5 * k, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "r, k, offsets",
    [(1000, 16, (1, 1)), (1000, 32, (0, 3)), (257, 130, (0, 0)), (4097, 517, (2, 1)),
     (65536, 16, (0, 0)), (1048576, 32, (0, 0))],
)
def test_cuda_spmv_paths_match_plain_and_float64_and_repeat_bits(card, r, k, offsets):
    """Misaligned contiguous views (``buf[off:].view(r, k)``) and K % 4 != 0
    take the scalar path, the registry's and the timing widths the float4
    one; each within 1e-5 of max|y| of the plain version and of float64,
    and a second call gives the same bits."""
    vals, xg = (_randn(card, i, off + r * k)[off:].view(r, k) for i, off in enumerate(offsets))
    want = spmv.spmv_ell_plain(vals, xg)
    exact = (vals.double() * xg.double()).sum(1)
    before = spmv.spmv_ell.launches
    got = ops.spmv(vals, xg)
    again = ops.spmv(vals, xg)
    torch.cuda.synchronize()
    assert spmv.spmv_ell.launches == before + 2
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert float((got.double() - exact).abs().max()) <= tol
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_cuda_spmv_rows_per_block_and_refused_lanes(card):
    import ctypes

    lib = _build.load("spmv")
    lib.repro_spmv_ell_rows_per_block.restype = ctypes.c_longlong
    for lanes in (1, 2, 4, 8, 16, 32):
        assert lib.repro_spmv_ell_rows_per_block(lanes) == spmv.rows_per_block(lanes)
    vals = _randn(card, 0, 64, 16)
    y = torch.empty(64, device=card)
    with pytest.raises(RuntimeError, match="repro_spmv_ell launch failed: cuda error"):
        _build.launch("spmv", "repro_spmv_ell", spmv._ARGTYPES, vals,
                      vals.data_ptr(), vals.data_ptr(), y.data_ptr(), 64, 16, 3)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "ref",
    ["gemm:v02", "gramschm:opt", "ttm:fused", "histogram:scratch", "flash", "gmm", "ssd",
     "ragged_flash:decode-ragged", "paged_attn:decode-paged", "spmv_ell"],
)
def test_cuda_wrappers_launch_once_on_the_current_stream(card, ref):
    """One kernel of each wrapper module, called on a side stream whose
    inputs are copied there after a sleep: a launch on any other stream
    would read them before they are written."""
    if ref == "spmv_ell":
        args, kwargs = (_randn(card, 0, 4096, 16), _randn(card, 1, 4096, 16)), {}
        kernel, plain, atol = spmv.spmv_ell, spmv.spmv_ell_plain, None
    else:
        variant = kreg.resolve(ref)[1]
        args = variant.inputs(card, torch.Generator(device=card).manual_seed(0))
        kwargs = dict(variant.kwargs)
        kernel, plain, atol = variant.kernel, variant.plain, variant.atol
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(card)
    before = kernel.launches
    with torch.cuda.stream(side):
        torch.cuda._sleep(20_000_000)
        copies = tuple(t.clone() for t in args)
        got = kernel(*copies, **kwargs)
    side.synchronize()
    assert kernel.launches == before + 1
    for g, w in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))):
        if atol is None:
            tol = 1e-5 * float(w.abs().max())
        else:
            tol = atol(w, *args) if callable(atol) else atol
        _assert_within(g, w, tol)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "ref",
    ["gemm:v00", "gemm:v01", "gemm:v02", "gramschm:naive", "gramschm:opt",
     "ttm:scratch", "ttm:fused", "histogram:naive", "histogram:partials",
     "histogram:scratch", "flash", "gmm", "ssd", "model.transformer-tiny.attn:base",
     "model.transformer-tiny.attn:wide-kv", "model.moe-tiny.moe:tile32",
     "model.moe-tiny.moe:tile64", "model.mamba-tiny.ssm", "ragged_flash:decode",
     "ragged_flash:decode-ragged", "paged_attn:decode", "paged_attn:decode-paged"],
)
def test_run_variant_launches_and_times_on_the_card(card, ref):
    variant = kreg.resolve(ref)[1]
    run = kreg.run_variant(variant, device=card, iters=3)
    assert run["device"] == torch.cuda.get_device_name(card)
    # the check, the warm-up, the event-timed runs, the runs on the card
    assert run["launches"] == 1 + 2 + 3 + 3
    assert run["ms"] > 0 and run["device_ms"] > 0
    if not callable(variant.atol):  # a kernel's own tolerance is held per element
        assert run["max_abs_err"] <= variant.atol
    if ref.startswith("histogram"):
        assert run["max_abs_err"] == 0 and run["kwargs"] == {"n_bins": 2048}


def _timed_call(ref, card):
    """A call of ``ref`` (a registry variant, or ``spmv_ell`` at 65,536 x 16)
    on seeded inputs at the registry's shapes, made once."""
    if ref == "spmv_ell":
        gen = torch.Generator(device=card).manual_seed(4)
        vals, xg = (torch.randn(65536, 16, device=card, generator=gen) for _ in range(2))
        call = lambda: spmv.spmv_ell(vals, xg)  # noqa: E731
    else:
        variant = kreg.resolve(ref)[1]
        args = variant.inputs(card, torch.Generator(device=card).manual_seed(0))
        call = lambda: variant.kernel(*args, **dict(variant.kwargs))  # noqa: E731
    call()
    torch.cuda.synchronize()
    return call


@pytest.mark.gpu
@pytest.mark.parametrize("ref", TIMED)
def test_device_time_is_the_profilers_kernel_sum_and_no_more_than_the_event_median(card, ref):
    from repro_torch.kernels.rule2_times import device_kernels_ms

    call = _timed_call(ref, card)
    ms = kreg.cuda_time_ms(call, iters=30)
    device_ms = kreg.device_time_ms(call, iters=30)
    # a profile that recorded no kernel at all measured nothing: once more
    kernels = device_kernels_ms(call) or device_kernels_ms(call)
    summed = sum(kernels.values())
    assert 0 < device_ms <= ms, (device_ms, ms)
    assert kernels and abs(device_ms - summed) <= (
        DEVICE_TOL * summed + DEVICE_SLACK_MS * len(kernels)), (device_ms, kernels)


@pytest.mark.gpu
@pytest.mark.parametrize("ref", ["histogram:naive", "spmv_ell"])
def test_device_time_holds_beside_a_thread_spinning_in_python(card, ref):
    """A second thread that holds the interpreter lock slows the host's
    issue many times over; the card's time of a call stays put."""
    call = _timed_call(ref, card)
    alone = kreg.device_time_ms(call, iters=30)
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    spinner = threading.Thread(target=spin)
    spinner.start()
    try:
        beside = kreg.device_time_ms(call, iters=30)
    finally:
        stop.set()
        spinner.join(timeout=30)
    assert not spinner.is_alive()
    assert abs(beside - alone) <= ALONE_TOL * alone + ALONE_SLACK_MS, (alone, beside)


def _randn(card, seed, *shape, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(card, dtype)


def _assert_within(got, want, tol):
    """Every element of ``got`` within ``tol`` (a number, or a tensor that
    broadcasts over ``want``) of ``want``."""
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), (
        f"max |err| {float(err.max()):.3e}, largest err/tol {float((err / tol).max()):.3f}"
    )


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bkv", flash.BKV_CHOICES)
@pytest.mark.parametrize(
    "bh, sq, skv, d, causal",
    [(4, 128, 128, 32, True), (2, 100, 130, 64, False), (1, 77, 77, 128, True),
     (3, 40, 150, 20, True), (1, 1, 1, 8, True), (2, 300, 64, 16, True)],
)
def test_cuda_flash_matches_plain_version(card, bh, sq, skv, d, causal, bkv, dtype):
    q, k, v = (_randn(card, i, bh, s, d, dtype=dtype) for i, s in enumerate((sq, skv, skv)))
    want = flash.flash_plain(q, k, v, causal).float()
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, causal=causal, bkv=bkv)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_within(got, want, flash.tolerance(want, q))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "groups, k, n, bm",
    [([100, 28, 0, 130], 64, 48, 32), ([0, 0, 5, 1], 64, 48, 32), ([64, 64, 64, 64], 40, 70, 64),
     ([10, 300], 33, 130, 128), ([1], 1, 1, 32), ([500, 20, 7], 256, 200, 64)],
)
def test_cuda_gmm_matches_plain_version(card, groups, k, n, bm, dtype):
    _, ids, m = gmm.plan_groups(np.asarray(groups), bm)
    x, w = _randn(card, 0, m, k, dtype=dtype), _randn(card, 1, len(groups), k, n, dtype=dtype)
    tile_ids = torch.from_numpy(ids).to(card)
    want = gmm.gmm_plain(x, w, tile_ids, bm).float()
    before = gmm.gmm.launches
    got = gmm.gmm(x, w, tile_ids, bm=bm)
    torch.cuda.synchronize()
    assert gmm.gmm.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _assert_within(got, want, gmm.tolerance(want, x))


@pytest.mark.gpu
@pytest.mark.parametrize("bkv", [32, 128])
@pytest.mark.parametrize("d", [8, 20, 33, 128])
@pytest.mark.parametrize("sq, skv", [(1000, 1000), (130, 1000), (1000, 130)])
def test_cuda_flash_f32_walks_the_ring_to_a_ragged_last_stage(card, sq, skv, d, bkv):
    """The float32 route's 32-key stages through its two-stage ring: 1000
    keys end in an 8-row stage; causal with Sq != Skv both ways; D 8 and
    20 (zero-filled to 64), 33 (4-byte copies) and 128.  A second call
    gives the same bits."""
    q, k, v = (_randn(card, i, 2, s, d) for i, s in enumerate((sq, skv, skv)))
    want = flash.flash_plain(q, k, v, True)
    got = flash.flash_attention(q, k, v, causal=True, bkv=bkv)
    again = flash.flash_attention(q, k, v, causal=True, bkv=bkv)
    torch.cuda.synchronize()
    _assert_within(got, want, flash.tolerance(want, q))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("bm", [32, 64, 128])
@pytest.mark.parametrize("k, n", [(264, 1000), (4096, 300), (18, 130)])
def test_cuda_gmm_f32_raster_groups_and_expert_boundaries(card, bm, k, n):
    """Groups [257, 0, 31, 600, 700]: experts change inside a raster group
    of 8 row blocks, the last group is ragged, K is not a multiple of the
    16-deep step (and 18 is off 16 bytes: 4-byte copies), N leaves a ragged
    last 128-column slice.  A second call gives the same bits."""
    _, ids, m = gmm.plan_groups(np.asarray([257, 0, 31, 600, 700]), bm)
    assert m // gmm.block_rows(bm) % 8
    x, w = _randn(card, 0, m, k), _randn(card, 1, 5, k, n)
    tile_ids = torch.from_numpy(ids).to(card)
    want = gmm.gmm_plain(x, w, tile_ids, bm)
    got = gmm.gmm(x, w, tile_ids, bm=bm)
    again = gmm.gmm(x, w, tile_ids, bm=bm)
    torch.cuda.synchronize()
    _assert_within(got, want, gmm.tolerance(want, x))
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("bm", [32, 64])
def test_cuda_gmm_f32_ids_out_of_range_between_runs(card, bm):
    """Tiles with ids 2, 9, 2, -1, ...: one expert in two runs, and two
    tiles out of range, whose rows come out zero, in 32- and 64-row
    blocks."""
    ids = np.asarray([2, 9, 2, -1, 0, 0, 1, 1], np.int32)
    x, w = _randn(card, 0, 8 * bm, 40), _randn(card, 1, 3, 40, 70)
    tile_ids = torch.from_numpy(ids).to(card)
    want = gmm.gmm_plain(x, w, tile_ids, bm)
    got = gmm.gmm(x, w, tile_ids, bm=bm)
    torch.cuda.synchronize()
    _assert_within(got, want, gmm.tolerance(want, x))
    assert not got[bm:2 * bm].any() and not got[3 * bm:4 * bm].any()


@pytest.mark.gpu
def test_cuda_flash_bf16_walks_many_ring_stages_and_a_ragged_last_tile(card):
    """1000 keys in tiles of 128: eight tiles through the two-stage ring,
    the last one 104 rows long."""
    q, k, v = (_randn(card, i, 2, 1000, 128, dtype=torch.bfloat16) for i in range(3))
    want = flash.flash_plain(q, k, v, True).float()
    got = flash.flash_attention(q, k, v, causal=True, bkv=128)
    torch.cuda.synchronize()
    _assert_within(got, want, flash.tolerance(want, q))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_and_gmm_take_operands_off_16_byte_alignment(card, dtype):
    """Views that start 2 elements into their storage: the bf16 kernels
    stage and store them with narrow loads instead of 16-byte copies."""

    def shifted(seed, *shape):
        flat = _randn(card, seed, int(np.prod(shape)) + 2, dtype=dtype)
        return flat[2:].view(*shape)

    q, k, v = (shifted(i, 2, 100, 64) for i in range(3))
    assert q.data_ptr() % 16 and q.is_contiguous()
    want = flash.flash_plain(q, k, v, True).float()
    _assert_within(flash.flash_attention(q, k, v, causal=True), want, flash.tolerance(want, q))
    _, ids, m = gmm.plan_groups(np.asarray([100, 28, 0, 130]), 32)
    x, w = shifted(3, m, 64), shifted(4, 4, 64, 48)
    tile_ids = torch.from_numpy(ids).to(card)
    want = gmm.gmm_plain(x, w, tile_ids, 32).float()
    _assert_within(gmm.gmm(x, w, tile_ids, bm=32), want, gmm.tolerance(want, x))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_gmm_bf16_expert_boundaries_inside_128_row_lines(card):
    """Groups [257, 0, 31, 600] at bm 32: experts change inside 128-row
    lines, so the plan cuts chunks shorter than 128 rows; K = 4096 and
    N = 1000 (a ragged last column block)."""
    _, ids, m = gmm.plan_groups(np.asarray([257, 0, 31, 600]), 32)
    x, w = _randn(card, 0, m, 4096, dtype=torch.bfloat16), _randn(card, 1, 4, 4096, 1000, dtype=torch.bfloat16)
    tile_ids = torch.from_numpy(ids).to(card)
    assert any(len({*ids[i:i + 4].tolist()}) > 1 for i in range(0, len(ids), 4))
    want = gmm.gmm_plain(x, w, tile_ids, 32).float()
    got = gmm.gmm(x, w, tile_ids, bm=32)
    torch.cuda.synchronize()
    _assert_within(got, want, gmm.tolerance(want, x))


@pytest.mark.gpu
def test_cuda_gmm_bf16_ids_out_of_range_between_runs(card):
    """Tiles with ids 2, 9, 2, -1, ...: one expert in two runs, and two
    tiles out of range, whose rows come out zero."""
    ids = np.asarray([2, 9, 2, -1, 0, 0, 1, 1], np.int32)
    x, w = _randn(card, 0, 256, 40, dtype=torch.bfloat16), _randn(card, 1, 3, 40, 70, dtype=torch.bfloat16)
    tile_ids = torch.from_numpy(ids).to(card)
    want = gmm.gmm_plain(x, w, tile_ids, 32).float()
    got = gmm.gmm(x, w, tile_ids, bm=32)
    torch.cuda.synchronize()
    _assert_within(got, want, gmm.tolerance(want, x))
    assert not got[32:64].any() and not got[96:128].any()


@pytest.mark.gpu
def test_cuda_flash_and_gmm_bf16_kernels_run_on_the_tensor_cores(card):
    """Every bf16 kernel function of the two libraries holds HMMA
    instructions (cuobjdump -sass); the float32 ones (``flash_kernel``,
    ``gmm_kernel``, present) hold none."""
    for name, tc, f32 in (("flash", "flash_tc_kernel", "flash_kernel"),
                          ("gmm", "gmm_tc_kernel", "gmm_kernel")):
        counts = _build.sass_counts(name)
        tc_counts = {fn: c for fn, c in counts.items() if tc in fn}
        assert tc_counts and all(c > 0 for c in tc_counts.values()), counts
        assert any(f32 in fn for fn in counts), counts
        assert all(c == 0 for fn, c in counts.items() if tc not in fn), counts


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_takes_the_mamba2_chunk(card, dtype):
    """L 256, P 64, N 128 (Mamba2-2.7b): 103,424 B of shared memory in
    float32 (one ring stage), 72,704 in bfloat16."""
    x, b, cm = (_randn(card, i, 2, 2, 256, s, dtype=dtype) for i, s in enumerate((64, 128, 128)))
    a = (-_randn(card, 3, 2, 2, 256).abs() * 0.4).to(dtype)
    want = ssd.ssd_plain(x, a, b, cm)
    got = ssd.ssd_chunk(x, a, b, cm)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _assert_within(g, w_, ssd.tolerance(w_, x))


@pytest.mark.gpu
def test_cuda_gmm_writes_zeros_for_an_id_out_of_range(card):
    x, w = _randn(card, 0, 64, 8), _randn(card, 1, 2, 8, 4)
    got = gmm.gmm(x, w, torch.tensor([1, 5], dtype=torch.int32, device=card), bm=32)
    torch.testing.assert_close(got[:32], x[:32] @ w[1], atol=1e-5, rtol=0)
    assert not got[32:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "bh, c, l, p, n",
    [(3, 4, 16, 8, 4), (2, 2, 64, 64, 16), (1, 2, 37, 20, 5), (4, 8, 128, 64, 64),
     (2, 1, 256, 64, 16), (1, 1, 300, 3, 2), (1, 1, 1, 1, 1), (1, 1, 64, 128, 8),
     (2, 3, 16, 8, 4), (1, 1, 64, 100, 3), (1, 1, 32, 32, 16), (1, 1, 200, 128, 130),
     (1, 2, 130, 40, 200)],
)
def test_cuda_ssd_matches_plain_version(card, bh, c, l, p, n, dtype):
    x, b, cm = (_randn(card, i, bh, c, l, s, dtype=dtype) for i, s in enumerate((p, n, n)))
    a = (-_randn(card, 3, bh, c, l).abs() * 0.4).to(dtype)
    want = ssd.ssd_plain(x, a, b, cm)
    before = ssd.ssd_chunk.launches
    got = ssd.ssd_chunk(x, a, b, cm)
    torch.cuda.synchronize()
    assert ssd.ssd_chunk.launches == before + 1
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w_.shape
        assert bool(torch.isfinite(g).all())
        _assert_within(g, w_, ssd.tolerance(w_, x))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_long_chunk_stays_finite(card, dtype):
    """Strong decays over a 256-step chunk: exp(cum[i] - cum[j]) for j > i
    overflows unless it is masked before the exponential."""
    x, b, cm = (_randn(card, i, 1, 1, 256, s, dtype=dtype) for i, s in enumerate((64, 16, 16)))
    a = (-_randn(card, 3, 1, 1, 256).abs() * 4.0).to(dtype)
    y, s = ssd.ssd_chunk(x, a, b, cm)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    want = ssd.ssd_plain(x, a, b, cm)
    _assert_within(y, want[0], ssd.tolerance(want[0], x))


def _ssd_float64(x, a, b, c):
    """The chunk term and end state in float64 on the card, on the values
    the kernel sees (bf16 inputs widened exactly)."""
    x, a, b, c = (t.double() for t in (x, a, b, c))
    cum = torch.cumsum(a, dim=-1)
    l = a.shape[-1]
    keep = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~keep, 0.0)
    dec = torch.exp(seg).masked_fill(~keep, 0.0)
    y = torch.matmul(torch.matmul(c, b.transpose(-1, -2)) * dec, x)
    w = torch.exp(cum[..., -1:] - cum)
    return y, torch.matmul((x * w[..., None]).transpose(-1, -2), b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(128, 16, 256, 64, 16), (80, 16, 256, 64, 128)])
def test_cuda_ssd_published_chunks_match_plain_and_float64_and_repeat(card, shape, dtype):
    """Jamba-v0.1-52B's chunks (128 heads of 64, state 16) and Mamba2-2.7b's
    (80 heads of 64, state 128) at seq 4096: within ssd.tolerance of the
    plain version and of a float64 oracle, and a second call gives the
    same bits (no atomics, sums in a fixed order)."""
    bh, c, l, p, n = shape
    x, b, cm = (_randn(card, i, bh, c, l, s, dtype=dtype) for i, s in enumerate((p, n, n)))
    a = (-_randn(card, 3, bh, c, l).abs() * 0.4).to(dtype)
    got = ssd.ssd_chunk(x, a, b, cm)
    again = ssd.ssd_chunk(x, a, b, cm)
    want = ssd.ssd_plain(x, a, b, cm)
    exact = _ssd_float64(x, a, b, cm)
    torch.cuda.synchronize()
    for g, ag, w_, e in zip(got, again, want, exact):
        assert torch.equal(g, ag)
        tol = ssd.tolerance(w_, x)
        _assert_within(g, w_, tol)
        _assert_within(g.double(), e, tol)


@pytest.mark.gpu
def test_cuda_ssd_bf16_kernel_runs_on_the_tensor_cores(card):
    """Every ssd_tc_kernel function (4 widths of P x 4 counts of held C
    fragments) holds HMMA instructions (cuobjdump -sass); the float32
    ssd_chunk_kernel functions hold none."""
    counts = _build.sass_counts("ssd")
    tc = {fn: c for fn, c in counts.items() if "ssd_tc_kernel" in fn}
    f32 = {fn: c for fn, c in counts.items() if "ssd_chunk_kernel" in fn}
    assert len(tc) == 16 and all(c > 0 for c in tc.values()), counts
    assert len(f32) == 4 and not any(f32.values()), counts


@pytest.mark.gpu
def test_cuda_model_path_launches_every_kernel(card, tmp_path):
    from repro_torch import cli

    kreg.reset_launch_counts()
    for name in ("transformer-tiny", "moe-tiny", "mamba-tiny"):
        assert cli.main(["model", name, "--out", str(tmp_path / name), "-q"]) == 0
    assert flash.flash_attention.launches > 0
    assert gmm.gmm.launches > 0
    assert ssd.ssd_chunk.launches > 0
    assert gemm.gemm_v01.launches > 0


def _ragged_case(card, b, h, s, d, bounds, dtype):
    q, k, v = (_randn(card, i, *shape, dtype=dtype) for i, shape in enumerate(((b, h, d), (b, s, d), (b, s, d))))
    starts, ends = (torch.tensor(x, dtype=torch.int32, device=card) for x in zip(*bounds))
    return q, k, v, starts, ends


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bkv", ragged_flash.BKV_CHOICES)
@pytest.mark.parametrize(
    "b, h, s, d, bounds",
    [(4, 8, 512, 128, None), (3, 4, 200, 32, [(0, 200), (17, 150), (40, 41)]),
     (2, 48, 300, 128, [(5, 60), (100, 300)]), (2, 13, 77, 20, [(0, 77), (-5, 999)]),
     (3, 64, 256, 64, [(64, 128), (0, 1), (255, 256)]), (65543, 2, 64, 16, None)],
)
def test_cuda_ragged_decode_matches_plain_version(card, b, h, s, d, bounds, bkv, dtype):
    """At the registry's shape (seeded bounds), at S not a multiple of bkv,
    with a range inside one tile, bounds past either end, H up to 64, and
    B past grid y's 65535 (the split and combine grids are 1-D)."""
    if bounds is None:
        ctx = ragged_flash.ragged_context(b, s)
        bounds = list(zip(ctx["starts"].tolist(), ctx["ends"].tolist()))
    args = _ragged_case(card, b, h, s, d, bounds, dtype)
    want = ragged_flash.ragged_decode_plain(*args, bkv=bkv).float()
    for dense in (False, True):
        before = ragged_flash.ragged_decode_attention.launches
        got = ragged_flash.ragged_decode_attention(*args, bkv=bkv, dense=dense)
        torch.cuda.synchronize()
        assert ragged_flash.ragged_decode_attention.launches == before + 1
        assert got.dtype == dtype and got.shape == args[0].shape
        _assert_within(got, want, ragged_flash.tolerance(want, args[0]))


@pytest.mark.gpu
def test_cuda_ragged_decode_dense_equals_gated_and_empty_rows_are_zero(card):
    args = _ragged_case(card, 4, 8, 256, 64, [(10, 10), (0, 0), (3, 200), (256, 300)], torch.float32)
    gated = ragged_flash.ragged_decode_attention(*args)
    dense = ragged_flash.ragged_decode_attention(*args, dense=True)
    torch.cuda.synchronize()
    assert torch.equal(gated, dense)
    assert not gated[[0, 1, 3]].any() and gated[2].abs().max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ragged_decode_split_walk_at_granite_widths(card, dtype):
    """Granite-20B's decode widths (H 48, D 128, S 8192): one sequence live
    over all of S (all 32 splits live), two empty rows, bounds past both
    ends and a range inside one split.  Within tolerance() of the plain
    version, dense equal to gated, empty rows 0, repeated calls the same bits."""
    bounds = [(0, 8192), (100, 100), (-50, 9000), (4000, 4100), (8192, 8192), (513, 7000)]
    args = _ragged_case(card, len(bounds), 48, 8192, 128, bounds, dtype)
    want = ragged_flash.ragged_decode_plain(*args).float()
    tol = ragged_flash.tolerance(want, args[0])
    gated = ragged_flash.ragged_decode_attention(*args)
    again = ragged_flash.ragged_decode_attention(*args)
    dense = ragged_flash.ragged_decode_attention(*args, dense=True)
    torch.cuda.synchronize()
    assert torch.equal(gated, again) and torch.equal(gated, dense)
    assert not gated[[1, 4]].any() and bool(torch.isfinite(gated.float()).all())
    _assert_within(gated, want, tol)


@pytest.mark.gpu
def test_cuda_ragged_decode_bf16_split_kernels_run_on_the_tensor_cores(card):
    """Every bf16 split kernel function of the ragged library holds HMMA
    instructions; the float32 one and the combines hold none."""
    counts = _build.sass_counts("ragged_decode")
    tc_counts = {fn: c for fn, c in counts.items() if "ragged_split_tc_kernel" in fn}
    assert len(tc_counts) == 4 and all(c > 0 for c in tc_counts.values()), counts
    assert all(c == 0 for fn, c in counts.items() if fn not in tc_counts), counts


def _paged_case(card, b, h, d, pages, page, slots, dtype, seed=0):
    q = _randn(card, seed, b, h, d, dtype=dtype)
    k_pages, v_pages = (_randn(card, seed + i, 1, pages, page, d, dtype=dtype) for i in (1, 2))
    ctx = paged_attn.paged_context(b, pages, slots, page)
    tables, lens = (torch.from_numpy(ctx[n]).to(card) for n in ("block_tables", "context_lens"))
    return q, k_pages, v_pages, tables, lens


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b, h, d, pages, page, slots",
    [(4, 8, 128, 64, 64, 8), (3, 4, 32, 16, 32, 4), (2, 48, 128, 40, 64, 16),
     (2, 5, 20, 9, 24, 3), (3, 64, 64, 12, 128, 4)],
)
def test_cuda_paged_decode_matches_plain_version(card, b, h, d, pages, page, slots, dtype):
    """At the registry's shape, at pages not a multiple of 32 and H up to 64."""
    args = _paged_case(card, b, h, d, pages, page, slots, dtype)
    want = paged_attn.paged_decode_plain(*args).float()
    before = paged_attn.paged_decode_attention.launches
    got = paged_attn.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert paged_attn.paged_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == args[0].shape
    _assert_within(got, want, paged_attn.tolerance(want, args[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_dense_sweep_of_the_gathered_cache_equals_the_gather(card, dtype):
    """The dense rung on the contiguous cache the table describes gives the
    gather's answer; an empty context and a page id out of range give what
    the plain version gives."""
    q, k_pages, v_pages, tables, lens = _paged_case(card, 4, 8, 64, 40, 32, 6, dtype)
    lens[1] = 0
    gathered = [p[0][tables.long()].reshape(4, -1, 64).contiguous() for p in (k_pages, v_pages)]
    (kc, ident), (vc, _) = (paged_attn.contiguous_pages(c, 32) for c in gathered)
    paged = paged_attn.paged_decode_attention(q, k_pages, v_pages, tables, lens)
    dense = paged_attn.paged_decode_attention(q, kc, vc, ident, lens, dense=True)
    torch.cuda.synchronize()
    _assert_within(dense, paged.float(), paged_attn.tolerance(paged, q))
    assert not paged[1].any() and not dense[1].any()
    tables[2, 0] = 99
    want = paged_attn.paged_decode_plain(q, k_pages, v_pages, tables, lens).float()
    got = paged_attn.paged_decode_attention(q, k_pages, v_pages, tables, lens)
    torch.cuda.synchronize()
    _assert_within(got, want, paged_attn.tolerance(want, q))


@pytest.mark.gpu
def test_cuda_decode_wrappers_reject_bad_inputs(card):
    q, k, v, starts, ends = _ragged_case(card, 2, 4, 64, 32, [(0, 64), (0, 10)], torch.float32)
    with pytest.raises(ValueError, match="device"):
        ragged_flash.ragged_decode_attention(q, k.cpu(), v, starts, ends)
    with pytest.raises(ValueError, match="on cuda"):
        ragged_flash.ragged_decode_attention(q, k, v, starts.cpu(), ends)
    with pytest.raises(TypeError, match="int32"):
        ragged_flash.ragged_decode_attention(q, k, v, starts.long(), ends)
    args = _paged_case(card, 4, 8, 32, 64, 64, 8, torch.float32)
    with pytest.raises(ValueError, match="block_tables"):
        paged_attn.paged_decode_attention(*args[:3], args[3].cpu(), args[4])
    with pytest.raises(TypeError, match="one dtype"):
        paged_attn.paged_decode_attention(args[0].double(), *args[1:])


# -- gemm v02 rebuilt for Hopper: bf16 on the tensor cores, f32 8 x 8 tiles -------


def _gemm_tol(want, dtype, k):
    """float32: sums of k products in another order (1e-6 per product, the
    model path's bound); bfloat16: one rounding of C, 1e-2 of max|C|."""
    if dtype == torch.float32:
        return 1e-6 * k
    return 1e-2 * float(want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "mnk",
    [(1, 1, 1), (127, 129, 33), (1000, 1000, 1000), (64, 70, 37), (65, 128, 100),
     (300, 257, 129), (1600, 1700, 70), (2048, 2048, 64)],
)
def test_cuda_gemm_v02_matches_plain_version_and_float64(card, dtype, mnk):
    """Both routes at one element, ragged edges in M, N and K, K or N not a
    multiple of 8 (rows off 16 bytes: narrow loads), and on bf16's 128-row
    tiles (the 128 x 128 grid fills the card: 1600 x 1700 and 2048^2),
    against the plain version and the float64 product; a second call, and
    in bf16 the other tile height, give the same bits."""
    m, n, k = mnk
    a, b = _randn(card, 0, m, k, dtype=dtype), _randn(card, 1, k, n, dtype=dtype)
    want = gemm.gemm_plain(a, b).float()
    exact = a.double() @ b.double()
    before = gemm.gemm_v02.launches
    got = gemm.gemm_v02(a, b)
    torch.cuda.synchronize()
    assert gemm.gemm_v02.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n) and bool(torch.isfinite(got).all())
    tol = _gemm_tol(want, dtype, k)
    _assert_within(got, want, tol)
    _assert_within(got.double(), exact, tol)
    assert torch.equal(gemm.gemm_v02(a, b), got)  # a second call: the same bits
    if dtype == torch.bfloat16:  # the other tile height: the same sums in the same order
        other = 192 - gemm.block_rows(m, n, dtype)
        assert torch.equal(gemm._launch("repro_gemm_v02", a, b, other), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gemm_v02_takes_operands_off_16_byte_alignment(card, dtype):
    """A, B and C views that start one element into their storage: both
    routes load and store them element by element."""

    def shifted(seed, *shape):
        flat = _randn(card, seed, int(np.prod(shape)) + 1, dtype=dtype)
        return flat[1:].view(*shape)

    a, b = shifted(0, 200, 136), shifted(1, 136, 264)
    assert a.data_ptr() % 16 and a.is_contiguous()
    want = gemm.gemm_plain(a, b).float()
    got = gemm.gemm_v02(a, b)
    torch.cuda.synchronize()
    _assert_within(got, want, _gemm_tol(want, dtype, 136))


@pytest.mark.gpu
def test_cuda_gemm_v02_edge_tiles_add_nothing_stale(card):
    """A NaN-filled output and a second, larger product run first: the
    ragged edge tile of the next call (M, N, K all one past a tile) must
    hold only its own sums."""
    big = gemm.gemm_v02(_randn(card, 2, 512, 512, dtype=torch.bfloat16),
                        _randn(card, 3, 512, 512, dtype=torch.bfloat16))
    del big
    a, b = _randn(card, 4, 129, 65, dtype=torch.bfloat16), _randn(card, 5, 65, 129, dtype=torch.bfloat16)
    want = gemm.gemm_plain(a, b).float()
    got = gemm.gemm_v02(a, b)
    torch.cuda.synchronize()
    _assert_within(got, want, _gemm_tol(want, torch.bfloat16, 65))
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.gpu
def test_cuda_gemm_v02_bf16_runs_on_the_tensor_cores(card):
    """Every bf16 function of gemm v02 holds HMMA instructions; v00, v01 and
    the float32 v02 hold none."""
    counts = _build.sass_counts("gemm")
    tc = {fn: c for fn, c in counts.items() if "gemm_v02_tc_kernel" in fn}
    assert len(tc) == 2 and all(c > 0 for c in tc.values()), counts
    assert all(c == 0 for fn, c in counts.items() if fn not in tc), counts


# -- paged decode on the split step ------------------------------------------------


def _paged_oracle(q, k_pages, v_pages, tables, lens):
    """float64 on the host: each sequence's positions below its clamped
    length whose page id lies in [0, P), one softmax; none gives 0."""
    n_pages, page, d = k_pages.shape[1:]
    slots = tables.shape[1]
    out = torch.zeros(q.shape, dtype=torch.float64)
    qd, kd, vd = (t.double().cpu() for t in (q, k_pages[0], v_pages[0]))
    for bi in range(q.shape[0]):
        ctx = min(max(int(lens[bi]), 0), slots * page)
        rows = [(int(tables[bi, p // page]), p % page) for p in range(ctx)]
        rows = [(ph, r) for ph, r in rows if 0 <= ph < n_pages]
        if not rows:
            continue
        kk = torch.stack([kd[ph, r] for ph, r in rows])
        vv = torch.stack([vd[ph, r] for ph, r in rows])
        p = torch.softmax(qd[bi] @ kk.T / np.sqrt(d), dim=-1)
        out[bi] = p @ vv
    return out


def _paged_table_case(card, b, h, d, page, slots, dtype, holes=()):
    """A pool of 2 * b * slots pages, each sequence's slots on distinct
    seeded pages, seeded lengths in [1, slots * page]; ``holes`` are (b, j)
    slots set to page ids outside the pool."""
    rng = np.random.default_rng(page)
    pages = 2 * b * slots
    tables = rng.permutation(pages)[: b * slots].reshape(b, slots).astype(np.int32)
    for bi, j in holes:
        tables[bi, j] = pages + 5 if j % 2 else -3
    lens = rng.integers(1, slots * page + 1, size=b).astype(np.int32)
    q = _randn(card, 0, b, h, d, dtype=dtype)
    kp, vp = (_randn(card, i, 1, pages, page, d, dtype=dtype) for i in (1, 2))
    return q, kp, vp, torch.from_numpy(tables).to(card), torch.from_numpy(lens).to(card)


def _check_paged(args, dtype):
    want = paged_attn.paged_decode_plain(*args).float()
    tol = paged_attn.tolerance(want, args[0])
    before = paged_attn.paged_decode_attention.launches
    gated = paged_attn.paged_decode_attention(*args)
    again = paged_attn.paged_decode_attention(*args)
    dense = paged_attn.paged_decode_attention(*args, dense=True)
    torch.cuda.synchronize()
    assert paged_attn.paged_decode_attention.launches == before + 3
    assert gated.dtype == dtype and gated.shape == args[0].shape
    assert torch.equal(gated, again) and torch.equal(gated, dense)
    _assert_within(gated, want, tol)
    _assert_within(gated.double().cpu(), _paged_oracle(*args), tol.double().cpu())
    return gated


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [1, 16, 48, 64, 100, 128])
def test_cuda_paged_decode_split_walk_at_every_page_size(card, page, dtype):
    """Pages of 1 to 128 rows (smaller than a chunk, a chunk crossing pages,
    one or two chunks a page): within tolerance() of the plain version and
    of a float64 oracle, dense equal to gated and a second call equal to
    the first, bit for bit."""
    slots = max(2, 512 // page)
    _check_paged(_paged_table_case(card, 3, 12, 64, page, slots, dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_out_of_range_pages_and_empty_contexts(card, dtype):
    """Page ids out of the pool (-3 and P + 5) add nothing, also when every
    page of a live split is out (sequence 0's first two splits: slots 0-3
    of pages of 16, splits of 32 positions); an empty context and a
    negative one give 0."""
    holes = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 5), (2, 0)]
    q, kp, vp, tables, lens = _paged_table_case(card, 5, 8, 128, 16, 16, dtype, holes)
    assert ragged_flash.split_len(16 * 16, 16) == 32
    lens[0] = 16 * 16
    lens[3] = 0
    lens[4] = -7
    out = _check_paged((q, kp, vp, tables, lens), dtype)
    assert not out[[3, 4]].any() and out[0].abs().max() > 0
    tables[0, 4:] = -1  # now no page of sequence 0 is in the pool: its row is 0
    out = _check_paged((q, kp, vp, tables, lens), dtype)
    assert not out[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_at_granite_widths(card, dtype):
    """Granite-20B's step: 64 sequences, 48 heads of 128, pages of 64 in 128
    slots over 8192 pages (the registry's seeded tables): split_len 256, 32
    splits; dense equals gated, repeated calls the same bits."""
    ctx = paged_attn.paged_context(64, 8192, 128, 64)
    q = _randn(card, 0, 64, 48, 128, dtype=dtype)
    kp, vp = (_randn(card, i, 1, 8192, 64, 128, dtype=dtype) for i in (1, 2))
    tables, lens = (torch.from_numpy(ctx[n]).to(card) for n in ("block_tables", "context_lens"))
    assert ragged_flash.split_len(128 * 64, 64) == 256
    args = (q, kp, vp, tables, lens)
    want = paged_attn.paged_decode_plain(*args).float()
    gated = paged_attn.paged_decode_attention(*args)
    again = paged_attn.paged_decode_attention(*args)
    dense = paged_attn.paged_decode_attention(*args, dense=True)
    torch.cuda.synchronize()
    assert torch.equal(gated, again) and torch.equal(gated, dense)
    _assert_within(gated, want, paged_attn.tolerance(want, q))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page", [32, 64, 128])
def test_cuda_ragged_from_zero_equals_paged_under_the_identity_table(card, page, dtype):
    """The two kernels share split_decode.cuh: the ragged kernel over
    [0, ctx) with tiles of `page` and the paged kernel over the same cache
    viewed as pages under the identity table walk the same splits and
    chunks, so they give the same bits."""
    b, h, s, d = 4, 16, 1024, 64
    q, k, v = (_randn(card, i, *shape, dtype=dtype) for i, shape in enumerate(((b, h, d), (b, s, d), (b, s, d))))
    ends = torch.tensor([1024, 1, 300, 777], dtype=torch.int32, device=card)
    starts = torch.zeros_like(ends)
    ragged = ragged_flash.ragged_decode_attention(q, k, v, starts, ends, bkv=page)
    (kp, ident), (vp, _) = (paged_attn.contiguous_pages(c, page) for c in (k, v))
    paged = paged_attn.paged_decode_attention(q, kp, vp, ident, ends)
    torch.cuda.synchronize()
    assert torch.equal(ragged, paged)


@pytest.mark.gpu
def test_cuda_paged_decode_bf16_split_kernels_run_on_the_tensor_cores(card):
    """Every bf16 split kernel function of the paged library holds HMMA
    instructions; the float32 ones and the combines hold none."""
    counts = _build.sass_counts("paged_decode")
    tc = {fn: c for fn, c in counts.items() if "paged_split_tc_kernel" in fn}
    assert len(tc) == 4 and all(c > 0 for c in tc.values()), counts
    assert all(c == 0 for fn, c in counts.items() if fn not in tc), counts


@pytest.mark.gpu
def test_cuda_tune_gemm_launches_each_rung_and_a_warm_cache_measures_again(card):
    """``tune gemm`` launches the baseline's and each ladder rung's kernel
    on the card, checked against the plain version, and stores the run; a
    warm re-tune walks nothing and launches them all again."""
    from repro_torch.core.cache import CollectionCache
    from repro_torch.core.session import heatmaps_equal
    from repro_torch.core.tuner import tune

    cache = CollectionCache()
    kreg.reset_launch_counts()
    cold = tune("gemm", budget=3, seed=0, cache=cache)
    rungs = (cold.baseline, *(s.profiled for s in cold.steps))
    assert [pk.variant for pk in rungs] == ["v00", "ladder:v01", "ladder:v02"]
    name = torch.cuda.get_device_name(card)
    for pk in rungs:
        assert pk.run["device"] == name and pk.run["ms"] > 0
        assert pk.run["launches"] >= 21 and pk.run["max_abs_err"] <= 1e-3
    assert all(fn.launches >= 21 for fn in gemm.KERNELS.values())
    misses = cache.stats.misses
    warm = tune("gemm", budget=3, seed=0, cache=cache)
    assert cache.stats.misses == misses
    for a, b in zip(rungs, (warm.baseline, *(s.profiled for s in warm.steps))):
        assert b.cached and heatmaps_equal(a.heatmap, b.heatmap)
        assert b.run["device"] == name and b.run["launches"] >= 21 and b.run["ms"] > 0
    assert all(fn.launches >= 42 for fn in gemm.KERNELS.values())


@pytest.mark.gpu
def test_cuda_tune_stores_no_run_on_a_generated_candidate(card):
    from repro_torch.core.tuner import tune

    res = tune("ragged_flash", budget=4, seed=0)
    runs = [(s.candidate.source, s.candidate.label, s.profiled.run) for s in res.steps]
    assert res.baseline.run["ms"] > 0
    for source, label, run in runs:
        if source == "generated" or label == "ladder:prefill-ragged":
            assert run is None, label
        else:
            assert run["launches"] >= 21 and run["ms"] > 0, label
    assert any(source == "generated" for source, _, _ in runs)


@pytest.mark.gpu
def test_cuda_pin_budget_is_the_cards_shared_memory_per_block(card):
    from repro_torch.core.tuner import pin_budget_bytes

    props = torch.cuda.get_device_properties(card)
    assert pin_budget_bytes("h100-sector") == props.shared_memory_per_block_optin


@pytest.mark.gpu
def test_cuda_spawn_workers_hold_no_context_and_rebuild_nothing(card):
    """The parent holds a CUDA context and the built libraries before the
    pool starts (the kernel runs first); the spawn workers that walk the
    shards create no context, load no library, launch nothing, and no
    library under build/ is rebuilt."""
    from repro_torch.core.collector import ShardedCollector, analyze
    from repro_torch.core.resilience import ResiliencePolicy
    from repro_torch.core.session import heatmaps_equal
    from repro_torch.core.trace import GridSampler

    kreg.run_variant(kreg.get("gemm").variant("v01"), "cuda", iters=1)
    assert torch.cuda.is_initialized()
    libs = {p: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")}
    assert libs
    spec, ctx = kreg.build("gemm:v01")
    sampler = GridSampler((0,), window=64)
    serial = analyze(spec, sampler, ctx)
    with ShardedCollector(2, policy=ResiliencePolicy(shard_timeout_s=120.0)) as sc:
        hm = sc.analyze(spec, sampler, ctx)
        states = sc.worker_states()
    assert len(hm.shards) == 2 and heatmaps_equal(hm, serial)
    assert states
    for state in states:
        assert state["cuda_initialized"] == 0, state
        assert state["libraries"] == 0 and state["launches"] == 0, state
    assert {p: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")} == libs


@pytest.mark.gpu
def test_cuda_tune_all_times_each_rung_as_when_run_alone(card, tmp_path):
    """tune_all overlaps its families' walks on threads, yet each rung's
    time on the card (``device_ms``) is the one it gives alone: no slower
    than a run_variant of the same rung made afterwards with nothing else
    running by more than ALONE_TOL and ALONE_SLACK_MS.  The event median,
    which holds the host's issue, read 0.4-3.5 ms slow beside the walks."""
    from repro_torch.core.session import ProfileSession
    from repro_torch.core.tuner import tune_all

    sess = ProfileSession(str(tmp_path / "s"))
    tune_all(["ttm", "histogram", "gramschm"], budget=3, device="cuda",
             workers=2, session=sess)
    timed = [
        (it.kernels[0], (it.tuning or {}).get("candidate") or {})
        for it in sess.iterations()
        if it.kernels[0].run is not None
    ]
    assert len(timed) >= 4
    for pk, cand in timed:
        rung = cand.get("variant") or pk.variant
        alone = kreg.run_variant(kreg.get(pk.name).variant(rung), "cuda")["device_ms"]
        assert pk.run["device_ms"] - alone <= ALONE_TOL * alone + ALONE_SLACK_MS, (
            pk.name, rung, pk.run["device_ms"], alone)


@pytest.mark.gpu
def test_cuda_kernel_failure_under_workers_and_faults_is_not_recovered(card, tmp_path, monkeypatch):
    """Fault recovery covers the walk only: with --workers 2 and faults
    armed, a kernel that disagrees with its plain version exits 1, and a
    build failure ends the command (no retry, no fallback)."""
    import dataclasses

    from repro_torch import cli

    entry = kreg.REGISTRY["ttm"]
    good = entry.variants[0]
    bad = dataclasses.replace(good, kernel=lambda *a, **k: good.kernel(*a, **k) + 1)
    monkeypatch.setitem(
        kreg.REGISTRY, "ttm", dataclasses.replace(entry, variants=(bad,) + entry.variants[1:])
    )
    argv = ["profile", "-k", "ttm", "--workers", "2", "--inject-faults", "seed=7"]
    assert cli.main([*argv, "--out", str(tmp_path / "a")]) == 1
    monkeypatch.setitem(kreg.REGISTRY, "ttm", entry)

    def refuse(*_a, **_k):
        raise _build.KernelBuildError("injected build failure")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_BOUND", {})  # entry points are bound once: bind anew
    with pytest.raises(_build.KernelBuildError):
        cli.main([*argv, "--out", str(tmp_path / "b")])


# -- the runtime on the card: serving, the optimizer, checkpoints ---------------------


def _granite_cut(layers, dtype):
    import dataclasses

    from repro_torch.configs.archs import granite_8b

    return dataclasses.replace(granite_8b(), n_layers=layers, dtype=dtype)


def _greedy(model, prompt, n, max_seq):
    dev = model.device
    with torch.no_grad():
        caches = model.init_caches(1, max_seq, dtype=torch.float32)
        lg, caches = model.prefill(torch.from_numpy(prompt).long()[None].to(dev), caches)
        toks = [int(lg[0, -1].argmax())]
        for _ in range(n - 1):
            lg, caches = model.decode_step(torch.tensor([[toks[-1]]], device=dev), caches)
            toks.append(int(lg[0, 0].argmax()))
    return toks


@pytest.mark.gpu
def test_cuda_server_matches_direct_decode(card):
    """Granite-8B's widths at depth 2 in float32: every request, the first,
    the shorter one beside it and the ones admitted into refilled slots,
    decodes as a batch-1 prefill and decode_step, with every cache tensor
    and the per-slot lengths on the card."""
    from repro_torch.models import build_model
    from repro_torch.runtime import Request, ServeConfig, Server

    cfg = _granite_cut(2, torch.float32)
    model = build_model(cfg, device=card, generator=torch.Generator(device=card).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 4, 6, 3)]
    srv = Server(model, ServeConfig(batch_slots=2, max_seq=48), dtype=torch.float32)
    reqs = [Request(rid=i, prompt=p, max_tokens=k) for i, (p, k) in
            enumerate(zip(prompts, (6, 9, 6, 7)))]
    for r in reqs:
        srv.submit(r)
    srv.run_until_done()
    for r in reqs:
        assert r.done and r.out_tokens == _greedy(model, r.prompt, r.max_tokens, 48), r.rid
    for layer in srv.caches:
        assert all(v.device == card for v in layer.values())
        assert layer["length"].dtype == torch.int64


@pytest.mark.gpu
def test_cuda_decode_tick_reads_back_only_the_sampled_tokens(card):
    import warnings

    from repro_torch.models import build_model
    from repro_torch.runtime import Request, ServeConfig, Server

    cfg = _granite_cut(1, torch.bfloat16)
    model = build_model(cfg, device=card, generator=torch.Generator(device=card).manual_seed(0))
    srv = Server(model, ServeConfig(batch_slots=4, max_seq=64), dtype=torch.bfloat16)
    for i in range(3):
        srv.submit(Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32), max_tokens=8))
    srv.step()  # admits all three, then decodes
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for _ in range(4):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                srv.step()
            syncs = [w for w in caught if "synchronizing" in str(w.message)]
            assert len(syncs) == 1, [str(w.message) for w in caught]
    finally:
        torch.cuda.set_sync_debug_mode(mode)


@pytest.mark.gpu
@pytest.mark.parametrize("state_dtype", ["f32", "bf16", "int8"])
def test_cuda_adamw_step_matches_the_cpu(card, state_dtype):
    from repro_torch.optim import adamw, cosine_warmup

    rng = np.random.default_rng(1)
    tree = {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "b": rng.standard_normal(48).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in tree.items()}
    out = {}
    for dev in ("cpu", card):
        opt = adamw(cosine_warmup(1e-2, 1, 4), state_dtype=state_dtype)
        params = {k: torch.tensor(v, device=dev) for k, v in tree.items()}
        state = opt.init(params)
        params, state = opt.update({k: torch.tensor(v, device=dev) for k, v in grads.items()},
                                   state, params)
        assert all(t.device == torch.device(dev) for t in list(params.values()) + list(state.m.values()))
        out[str(dev)] = params, state
    (p_cpu, s_cpu), (p_gpu, s_gpu) = out["cpu"], out[str(card)]
    for k in tree:
        scale = float(p_cpu[k].abs().max())
        assert float((p_gpu[k].cpu() - p_cpu[k]).abs().max()) <= 1e-6 * scale
        if state_dtype == "int8":
            assert int((s_gpu.m[k].cpu().int() - s_cpu.m[k].int()).abs().max()) <= 1
        else:
            torch.testing.assert_close(s_gpu.v[k].cpu().float(), s_cpu.v[k].float(),
                                       rtol=1e-6, atol=0)


@pytest.mark.gpu
def test_cuda_checkpoint_restores_onto_the_targets_device(card, tmp_path):
    from repro_torch.checkpoint import CheckpointManager

    g = torch.Generator(device=card).manual_seed(0)
    tree = {"a": torch.randn(8, 4, device=card, generator=g),
            "b": torch.randn(16, device=card, generator=g).to(torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tree, 3)
    mgr.wait()
    on_card, step, _ = mgr.restore({k: torch.empty_like(v) for k, v in tree.items()})
    on_host, _, _ = mgr.restore({k: torch.empty_like(v, device="cpu") for k, v in tree.items()})
    assert step == 3
    for k, v in tree.items():
        assert on_card[k].device == card and on_host[k].device.type == "cpu"
        assert on_card[k].dtype == v.dtype and torch.equal(on_card[k], v)
        assert torch.equal(on_host[k], v.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_xla_backward_matches_float64_on_the_host(card, dtype):
    """The recomputing backward on the card (bf16 products with float32
    results on the tensor cores) against the same function in float64."""
    from repro_torch.models.attention import flash_xla

    g = torch.Generator().manual_seed(0)
    b, s, h, kv, d = 2, 300, 8, 2, 64
    host = [torch.randn(b, s, n, d, generator=g, dtype=torch.float64) for n in (h, kv, kv)]
    dout = torch.randn(b, s, h, d, generator=g, dtype=torch.float64)
    pos = torch.arange(s)[None].expand(b, s)

    def grads(tensors, do, positions):
        leaves = [t.detach().requires_grad_() for t in tensors]
        out = flash_xla(*leaves, positions, None, True, None, 128)
        return torch.autograd.grad(out, leaves, do)

    want = grads(host, dout, pos)
    got = grads([t.to(card, dtype) for t in host], dout.to(card, dtype), pos.to(card))
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    for a, w in zip(got, want):
        err = float((a.double().cpu() - w).abs().max())
        assert err <= tol * float(w.abs().max()), err


@pytest.mark.gpu
def test_cuda_model_gradients_match_the_host(card):
    """A float32 SMOKE model's loss and gradients (remat on) on the card
    against the same model on the host."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import model_loss

    cfg = dataclasses.replace(get_config("granite-8b", smoke=True), remat="full")
    host = build_model(cfg, generator=torch.Generator().manual_seed(0))
    dev = build_model(cfg, device=card)
    dev.load_state_dict(host.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 33)))
    out = []
    for model in (host, dev):
        params = dict(model.named_parameters())
        t = toks.to(model.device)
        loss, _ = model_loss(model, params, t[:, :-1], t[:, 1:])
        out.append((loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))))
    (lh, gh), (ld, gd) = out
    assert abs(float(ld.detach()) - float(lh.detach())) <= 1e-5 * abs(float(lh.detach()))
    for k, g in gh.items():
        assert float((gd[k].cpu() - g).abs().max()) <= 1e-4 * float(g.abs().max()) + 1e-9, k


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A (1, 1) ("data", "model") mesh over a one-rank NCCL group (one card
    takes one rank); the group is destroyed after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cuda_mesh_train_step_matches_no_mesh(nccl_mesh, card):
    """The launcher's layout of a float32 SMOKE model: one AdamW step on the
    mesh equals the step with no mesh (the reference's tolerances)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import layout_params
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant
    from repro_torch.runtime import TrainConfig, build_train_step, init_state, model_loss

    cfg = dataclasses.replace(get_config("granite-8b", smoke=True), dtype=torch.float32)
    model = build_model(cfg, device=card)
    params = dict(model.named_parameters())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 33))).to(card)
    opt, tc = adamw(constant(1e-2)), TrainConfig()

    def loss(p, t, l):
        return model_loss(model, p, t, l)

    one, m1 = build_train_step(loss, opt, tc, donate=False)(init_state(params, opt, tc),
                                                            toks[:, :-1], toks[:, 1:])
    one = {k: v.detach().clone() for k, v in one.params.items()}
    rules, _, dparams = layout_params(model, params, nccl_mesh)
    two, m2 = build_train_step(loss, opt, tc, mesh=nccl_mesh, rules=rules)(
        init_state(dparams, opt, tc), toks[:, :-1], toks[:, 1:])
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for k, v in one.items():
        assert float((two.params[k].full_tensor() - v).abs().max()) < 1e-3, k


@pytest.mark.gpu
def test_cuda_ep_matches_capacity_and_moe_ref(nccl_mesh, card):
    """moe_apply_ep on the one-rank mesh: the capacity path's output (the
    same capacity, from the same token count) and moe_ref's, capacity large
    enough to keep every slot; one backward through the exchange."""
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.parallel.context import use_mesh, use_rules
    from repro_torch.parallel.sharding import make_rules

    cfg = moe.MoEConfig(d_model=64, d_ff=128, n_experts=8, top_k=2, capacity_factor=8.0,
                        moe_impl="ep")
    gen = torch.Generator(device=card).manual_seed(0)
    params = {k: v.requires_grad_() for k, v in
              init_params(moe.moe_defs(cfg), gen, dtype=torch.float32, device=card).items()}
    x = torch.randn((2, 32, 64), generator=gen, device=card)
    with use_mesh(nccl_mesh), use_rules(make_rules()):
        y, _ = moe.moe_apply(params, x, cfg)
        g = torch.autograd.grad(y.square().sum(), list(params.values()))
    y_cap, _ = moe.moe_apply_capacity(params, x, cfg)
    y_ref, _ = moe.moe_ref(params, x, cfg)
    g_ref = torch.autograd.grad(y_ref.square().sum(), list(params.values()))
    scale = float(y_ref.abs().max())
    assert float((y - y_cap).abs().max()) <= 1e-5 * scale
    assert float((y - y_ref).abs().max()) <= 1e-4 * scale
    for a, b in zip(g, g_ref):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-9
