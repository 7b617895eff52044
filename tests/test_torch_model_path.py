"""The port's model path held against the JAX package: the flash, gmm and
SSD kernels, the model registry, whole-model profiling and ``cuthermo model``.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the JAX package's Pallas kernels (interpret mode), its oracles and
the port.  The specs are held against a numpy emulation of the CUDA
kernels' thread-index arithmetic.  Under the TPU tile geometry the port's
engine, per-layer table and artifact reproduce the reference's whole-model
profiles exactly.  The CUDA kernels themselves run only on the card:
``test_torch_cuda.py``.
"""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
from repro.configs import archs as ref_archs
from repro.core import model_profile as ref_mp
from repro.core.collector import analyze as ref_analyze
from repro.core.patterns import detect_all as ref_detect_all
from repro.core.session import heatmaps_equal as ref_heatmaps_equal
from repro.core.session import load_iteration as ref_load_iteration
from repro.core.session import profile_kernel as ref_profile_kernel
from repro.core.trace import GridSampler as RefGridSampler
from repro.kernels import flash as ref_flash
from repro.kernels import gmm as ref_gmm
from repro.kernels import ref as ref_oracles
from repro.kernels import ssd as ref_ssd
from repro.models import registry as ref_registry
from repro_torch import cli
from repro_torch import kernels as kreg
from repro_torch.configs import archs
from repro_torch.core import model_profile as mp
from repro_torch.core.collector import analyze
from repro_torch.core.heatmap import Heatmap, RegionHeatmap
from repro_torch.core.patterns import FALSE_SHARING, HOT, detect_all
from repro_torch.core.session import (
    ProfiledKernel,
    ProfileSession,
    SessionError,
    _validate_layers,
    heatmaps_equal,
    load_iteration,
    profile_kernel,
    write_iteration,
)
from repro_torch.core.tiles import H100Sector
from repro_torch.core.trace import GridSampler, RegionInfo
from repro_torch.kernels import flash, gmm, ops, ref, ssd
from repro_torch.models.registry import (
    MODELS,
    apply_overrides,
    config_from_reference,
    get_model,
    kernel_kinds,
    kind_spec,
)

from torch_parity import heat_of_warps, to_port_spec


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dtype)


# -- kernel parity: the plain versions against Pallas (interpret) and ref.py --


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s, d, bq, bkv", [(128, 32, 64, 64), (256, 64, 128, 64)])
def test_flash_matches_pallas_kernel_and_oracle(causal, s, d, bq, bkv):
    q, k, v = (_rand(i, (4, s, d)) for i in range(3))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(ref_flash.flash_attention(jq, jk, jv, causal=causal, bq=bq, bkv=bkv))
    oracle = np.asarray(ref_oracles.flash_ref(jq, jk, jv, causal=causal))
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, bkv=bkv)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, s, d)
    # as tests/test_kernels.py: float32 softmax attention in another order
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-5, rtol=2e-4)
    assert ref.flash_ref is flash.flash_plain


def test_flash_bf16_matches_pallas_kernel():
    q, k, v = (_rand(i, (2, 128, 32)) for i in range(3))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref_flash.flash_attention(jq, jk, jv, causal=True, bq=64, bkv=64), np.float32)
    got = flash.flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    # as tests/test_kernels.py: bf16 inputs and output
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize(
    "dtype, off, old_bound",
    [(torch.float32, 1e-4, lambda want: 1e-4), (torch.bfloat16, 0.1, lambda want: 3e-2 * want.abs().max())],
)
def test_flash_tolerance_follows_each_row(dtype, off, old_bound):
    """Causal rows shrink as they see more keys, so the tolerance is a share
    of each row's largest |O|: an output whose late rows are ``off`` by a
    relative error (a mis-rescaled accumulator) fails it, though it passes a
    bound from the whole output's largest value; the exact product, rounded
    to the type, passes it."""
    q, k, v = (_t(_rand(i, (2, 1024, 64)), dtype) for i in range(3))
    want = flash.flash_plain(q, k, v, True).float()
    tol = flash.tolerance(want, q)
    exact = flash.flash_plain(*(t.double() for t in (q, k, v)), True).to(dtype).float()
    assert bool(((exact - want).abs() <= tol).all())
    wrong = want.clone()
    wrong[:, 512:] *= 1 + off
    assert float((wrong - want).abs().max()) <= old_bound(want)
    assert not bool(((wrong - want).abs() <= tol).all())


def test_reference_flash_ref_aligns_causal_mask_bottom_right_and_the_port_does_not():
    """A fact of the reference: its oracle masks key j > i + Skv - Sq, its
    Pallas kernel (and the port) key j > i.  At 64 queries over 128 keys
    the two differ by far more than any tolerance; at Sq = Skv they agree
    (the case above)."""
    q, k, v = _rand(0, (1, 64, 32)), _rand(1, (1, 128, 32)), _rand(2, (1, 128, 32))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(ref_flash.flash_attention(jq, jk, jv, causal=True, bq=32, bkv=32))
    oracle = np.asarray(ref_oracles.flash_ref(jq, jk, jv, causal=True))
    got = flash.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-4)
    assert np.abs(got - oracle).max() > 1.0
    # row 0 sees key 0 alone (top-left): its output is v[0]
    np.testing.assert_allclose(got[0, 0], v[0, 0], atol=1e-6)


@pytest.mark.parametrize("l, p, n", [(16, 8, 4), (32, 16, 8), (64, 64, 16)])
def test_ssd_matches_pallas_kernel_and_oracle(l, p, n):
    bh, c = 3, 4
    x, bm, cm = _rand(0, (bh, c, l, p)), _rand(2, (bh, c, l, n)), _rand(3, (bh, c, l, n))
    a = -np.abs(_rand(1, (bh, c, l))) * 0.4  # log-decays, as tests/test_kernels.py
    jargs = tuple(jnp.asarray(t) for t in (x, a, bm, cm))
    want = ref_ssd.ssd_chunk(*jargs, interpret=True)
    oracle = ref_oracles.ssd_chunk_ref(*jargs)
    y, s = ops.ssd_chunk(*(_t(t) for t in (x, a, bm, cm)))
    assert (tuple(y.shape), tuple(s.shape)) == ((bh, c, l, p), (bh, c, p, n))
    assert y.dtype == s.dtype == torch.float32
    for got, w, o in zip((y, s), want, oracle):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(o), atol=1e-4, rtol=1e-4)
    assert ref.ssd_chunk_ref is ssd.ssd_plain


def test_ssd_bf16_rounds_as_the_pallas_kernel():
    """The Pallas kernel rounds the scores and the decayed x to bf16 before
    its products; the port's plain version does too (the JAX oracle does
    not round, and lies further away)."""
    bh, c, l, p, n = 2, 2, 32, 16, 8
    x, bm, cm = _rand(0, (bh, c, l, p)), _rand(2, (bh, c, l, n)), _rand(3, (bh, c, l, n))
    a = -np.abs(_rand(1, (bh, c, l))) * 0.4
    jargs = tuple(jnp.asarray(t, jnp.bfloat16) for t in (x, a, bm, cm))
    want = ref_ssd.ssd_chunk(*jargs, interpret=True)
    oracle = ref_oracles.ssd_chunk_ref(*jargs)
    got = ssd.ssd_chunk(*(_t(t, torch.bfloat16) for t in (x, a, bm, cm)))
    for g, w, o in zip(got, want, oracle):
        w, o = np.asarray(w, np.float32), np.asarray(o, np.float32)
        scale = np.abs(w).max()
        # float32 sums of bf16-rounded products: one bf16 ulp of a score apart
        np.testing.assert_allclose(g.numpy(), w, atol=1e-2 * scale)
        assert np.abs(g.numpy() - w).max() <= np.abs(g.numpy() - o).max()


@pytest.mark.parametrize("groups", [[100, 28, 0, 130], [64, 64, 64, 64], [0, 0, 5, 1]])
def test_gmm_matches_pallas_kernel_and_oracle(groups):
    gs = np.asarray(groups)
    row_map, tile_ids, m = gmm.plan_groups(gs, bm=32)
    ref_map, ref_ids, ref_m = ref_gmm.plan_groups(gs, bm=32)
    np.testing.assert_array_equal(row_map, ref_map)
    np.testing.assert_array_equal(tile_ids, ref_ids)
    assert m == ref_m
    x, w = _rand(0, (m, 64)), _rand(1, (len(gs), 64, 48))
    want = np.asarray(ref_gmm.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(tile_ids), bm=32))
    oracle = np.asarray(ref_gmm.gmm_ref(jnp.asarray(x), jnp.asarray(w), tile_ids, bm=32))
    got = ops.grouped_matmul(_t(x), _t(w), torch.from_numpy(tile_ids), bm=32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, 48)
    # as tests/test_kernels.py: float32 sums of 64 products
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=1e-4)


def test_gmm_matches_ragged_dot():
    gs = np.asarray([32, 64, 32])
    _, tile_ids, m = gmm.plan_groups(gs, bm=32)
    assert m == 128  # already tile multiples
    x, w = _rand(0, (128, 32)), _rand(1, (3, 32, 16))
    want = np.asarray(ref_oracles.gmm_ragged_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs, np.int32)))
    got = gmm.gmm(_t(x), _t(w), torch.from_numpy(tile_ids), bm=32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ref.gmm_ragged_ref(_t(x), _t(w), gs).numpy(), want, atol=1e-5, rtol=1e-4)


def test_gmm_plain_gives_zeros_for_an_id_out_of_range_as_the_kernel_does():
    x, w = torch.randn(64, 8), torch.randn(2, 8, 4)
    out = gmm.gmm_plain(x, w, torch.tensor([1, 5], dtype=torch.int32), bm=32)
    torch.testing.assert_close(out[:32], x[:32] @ w[1])
    assert not out[32:].any()


@pytest.mark.parametrize(
    "fn, args, match",
    [
        (flash.flash_attention, (torch.randn(1, 4, 8),) * 3 + (True, 48), "bkv"),
        (flash.flash_attention, (torch.randn(1, 4, 130),) * 3, "d <= 128"),
        (flash.flash_attention, (torch.randn(1, 4, 8), torch.randn(1, 5, 8), torch.randn(1, 4, 8)), "k and v"),
        (gmm.gmm, (torch.randn(64, 8), torch.randn(2, 8, 4), torch.tensor([0, 1], dtype=torch.int32), 48), "multiple of 32"),
        (gmm.gmm, (torch.randn(40, 8), torch.randn(2, 8, 4), torch.tensor([0], dtype=torch.int32), 32), "multiple of bm"),
        (gmm.gmm, (torch.randn(64, 8), torch.randn(2, 8, 4), torch.tensor([0, 1]), 32), "int32"),
        (ssd.ssd_chunk, (torch.randn(1, 1, 256, 64), torch.randn(1, 1, 256), torch.randn(1, 1, 256, 381), torch.randn(1, 1, 256, 381)), "shared"),
        (ssd.ssd_chunk, (torch.randn(1, 1, 8, 130), torch.randn(1, 1, 8), torch.randn(1, 1, 8, 4), torch.randn(1, 1, 8, 4)), "p <= 128"),
        (ssd.ssd_chunk, (torch.randn(1, 1, 8, 4), torch.randn(1, 1, 8).double(), torch.randn(1, 1, 8, 4), torch.randn(1, 1, 8, 4)), "one dtype"),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(fn, args, match):
    with pytest.raises((ValueError, TypeError), match=match):
        fn(*args)


def test_ssd_refuses_mamba2_chunk_with_the_limit():
    """Mamba2-2.7b's chunk (L 256, P 64, N 128) was refused while the
    kernel staged all of C (336,000 B) and took 220,416 B with each warp
    staging its group's rows of C; with B and x walked through a ring of
    64-row tiles it needs 103,424 B in float32 (one stage) and 72,704 in
    bfloat16 and is taken, matching the plain version and the Pallas
    kernel (interpret mode, as tests/test_kernels.py runs it).  A chunk past
    the float32 limit (N 381) is still refused, naming the limit."""
    assert ssd.smem_bytes(256, 64, 128) == 103424 <= ssd.MAX_SMEM
    assert ssd.smem_bytes(256, 64, 128, torch.bfloat16) == 72704
    x, bm, cm = _rand(0, (1, 1, 256, 64)), _rand(2, (1, 1, 256, 128)), _rand(3, (1, 1, 256, 128))
    a = -np.abs(_rand(1, (1, 1, 256))) * 0.4
    y, s = ssd.ssd_chunk(*(_t(t) for t in (x, a, bm, cm)))
    want = ref_ssd.ssd_chunk(*(jnp.asarray(t) for t in (x, a, bm, cm)), interpret=True)
    plain = ssd.ssd_plain(*(_t(t) for t in (x, a, bm, cm)))
    for got, w, pl in zip((y, s), want, plain):
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, pl, atol=0, rtol=0)
        assert float(np.abs(got.numpy() - np.asarray(w)).max()) <= ssd.tolerance(pl, _t(x))
    past = (torch.randn(1, 1, 256, 64), -torch.rand(1, 1, 256), torch.randn(1, 1, 256, 381),
            torch.randn(1, 1, 256, 381))
    assert ssd.smem_bytes(256, 64, 381) > ssd.MAX_SMEM
    with pytest.raises(ValueError, match=str(ssd.MAX_SMEM)):
        ssd.ssd_chunk(*past)


def test_no_cpu_call_counts_a_launch():
    kreg.reset_launch_counts()
    flash.flash_attention(torch.randn(1, 8, 4), torch.randn(1, 8, 4), torch.randn(1, 8, 4))
    gmm.gmm(torch.randn(32, 4), torch.randn(1, 4, 4), torch.zeros(1, dtype=torch.int32), bm=32)
    ssd.ssd_chunk(torch.randn(1, 1, 4, 2), -torch.rand(1, 1, 4), torch.randn(1, 1, 4, 2), torch.randn(1, 1, 4, 2))
    assert flash.flash_attention.launches == gmm.gmm.launches == ssd.ssd_chunk.launches == 0


# -- the specs against an emulation of csrc/flash.cu, gmm.cu and ssd.cu --------


def _add(acc, name, key, idx):
    acc[name].setdefault(key, [np.empty(0, np.int64)]).append(np.asarray(idx, np.int64))


def _emulate_flash(bh, sq, skv, d, bkv, causal):
    """Per-warp flat indices of Q, K, V and O for flash_kernel, thread by
    thread: blocks of 128 threads per (head, 64-query tile), D zero-filled
    to DP = 64 or 128; lane l of warp w copies chunks l, l + 32, ... of its
    rows (16 bytes, 4 floats, when D is a multiple of 4, else one float):
    its 16 Q rows, rows 8w .. 8w+7 of every 32-row K and V stage up to the
    walk's end; lane (pr, pc) = divmod(lane, 16) stores rows 16w + 8pr ..
    +7, columns 4pc + 64h."""
    dp = 64 if d <= 64 else 128
    per = 4 if d % 4 == 0 else 1  # floats a copy
    chunks = dp // per
    acc = {n: {} for n in "QKVO"}

    def stage(key, name, lane, base_row, r0, nrows, live):
        for i in range(lane, nrows * chunks, 32):
            r, c = r0 + i // chunks, per * (i % chunks)
            if r < live and c < d:
                _add(acc, name, key, (base_row + r) * d + np.arange(c, c + per))

    for h in range(bh):
        for qt in range(math.ceil(sq / 64)):
            q0 = qt * 64
            tiles = math.ceil(skv / bkv)
            if causal:
                tiles = min(tiles, (min(q0 + 64, sq) - 1) // bkv + 1)
            kv_end = min(skv, tiles * bkv)
            for tid in range(128):
                w, lane = divmod(tid, 32)
                key = (h, qt, w)
                for name in "QKVO":
                    _add(acc, name, key, [])
                stage(key, "Q", lane, h * sq + q0, 16 * w, 16, sq - q0)
                for k0 in range(0, kv_end, 32):
                    for name in "KV":
                        stage(key, name, lane, h * skv + k0, 8 * w, 8, kv_end - k0)
                pr, pc = divmod(lane, 16)
                for i in range(8):
                    gq = q0 + 16 * w + 8 * pr + i
                    for c in range(4 * pc, dp, 64):
                        if gq < sq and c < d:
                            _add(acc, "O", key, (h * sq + gq) * d + np.arange(c, min(c + 4, d)))
    return acc


def _emulate_gmm(m, k, n, ids, bm):
    """Per-warp flat indices of X, W and O for gmm_kernel, thread by thread:
    a one-dimensional grid of blocks of BM rows (64 if bm allows, else 32)
    by BN columns (128 when that grid has a block for each of 132 SMs, else
    64), BM*BN/32 threads, rastered in groups of 8 row blocks that sweep
    the column slices; per K step of 16, lane l of warp w (of W) copies X
    rows (BM/W)w + l/4 + 8s, chunk l%4, and W rows l/wc + (32/wc)s, chunk
    l%wc of its BN/W columns (16 bytes when K, N are multiples of 4, else 4
    floats one by one); lane (rg, cg) = divmod(lane, 8) stores rows rg +
    4i, columns 4cg .. of the warp's 32 x 32 sub-tile."""
    rows = 64 if bm % 64 == 0 else 32
    cols = 128 if m // rows * math.ceil(n / 128) >= 132 else 64
    wn = cols // 32
    warps = rows // 32 * wn
    xrows, wcols = rows // warps, cols // warps
    wc = wcols // 4
    row_blocks, col_blocks = m // rows, math.ceil(n / cols)
    acc = {n_: {} for n_ in ("X", "W", "O")}
    launched = set()
    for bid in range(row_blocks * col_blocks):
        first = bid // (8 * col_blocks) * 8
        size = min(8, row_blocks - first)
        by, bx = first + (bid - first * col_blocks) % size, (bid - first * col_blocks) // size
        assert (by, bx) not in launched  # the raster launches each block once
        launched.add((by, bx))
        row0, col0 = by * rows, bx * cols
        ex = ids[row0 // bm]
        for tid in range(32 * warps):
            w, lane = divmod(tid, 32)
            key = (by, bx, w)
            for name in acc:
                _add(acc, name, key, [])
            for k0 in range(0, k, 16):
                for s_ in range(xrows * 4 // 32):
                    r, c = xrows * w + lane // 4 + 8 * s_, k0 + 4 * (lane % 4)
                    _add(acc, "X", key, (row0 + r) * k + np.arange(c, min(c + 4, k)))
                for s_ in range(16 // (32 // wc)):
                    r = k0 + lane // wc + (32 // wc) * s_
                    c = col0 + wcols * w + 4 * (lane % wc)
                    if r < k:
                        _add(acc, "W", key, (ex * k + r) * n + np.arange(c, min(c + 4, n)))
            rg, cg = divmod(lane, 8)
            gc = col0 + 32 * (w % wn) + 4 * cg
            for i in range(8):
                row = row0 + 32 * (w // wn) + rg + 4 * i
                _add(acc, "O", key, row * n + np.arange(gc, min(gc + 4, n)))
    return acc


def _emulate_ssd(bh, c, l, p, n, bf16=False):
    """Per-warp flat indices of X, A, B, C, Y and S for csrc/ssd.cu, thread
    by thread: ssd_tc_kernel (bf16: 128 threads, 16-byte chunks of 8) or
    ssd_chunk_kernel (256 threads, chunks of 4).  Block b of a cell is a
    state unit for b < units, else row tile tiles - 1 - (b - units); lane
    i of warp 0 reads a run of ceil(l / 32) of a, and thread t stages chunks
    t, t + threads, ... of each tile it walks."""
    threads, per = (128, 8) if bf16 else (256, 4)
    tiles, units_n = math.ceil(l / 64), math.ceil(n / 64)
    units = math.ceil(p / 64) * units_n
    b_width = (16 if bf16 else 4) * math.ceil(n / (16 if bf16 else 4))
    x_width = next(w for w in (16, 32, 64, 128) if p <= w)
    pc = x_width // 16  # float32: y columns a thread
    acc = {n_: {} for n_ in ("X", "A", "B", "C", "Y", "S")}

    def stage(key, name, tid, cell, row0, width, cols):
        cpr = width // per
        for k in range(tid, 64 * cpr, threads):
            r, ch = divmod(k, cpr)
            if row0 + r < l:
                e = np.arange(ch * per, min(ch * per + per, cols))
                _add(acc, name, key, (cell * l + row0 + r) * cols + e)

    for h in range(bh):
        for ch in range(c):
            cell = h * c + ch
            for b in range(units + tiles):
                state = b < units
                idx = b if state else tiles - 1 - (b - units)
                for tid in range(threads):
                    w, lane = divmod(tid, 32)
                    key = (h, ch, b, w)
                    for name in acc:
                        _add(acc, name, key, [])
                    if w == 0:
                        run = math.ceil(l / 32)
                        lo = min(lane * run, l)
                        _add(acc, "A", key, cell * l + np.arange(lo, min(lo + run, l)))
                    if not state:
                        stage(key, "C", tid, cell, 64 * idx, b_width, n)
                    for t in range(tiles if state else idx + 1):
                        stage(key, "B", tid, cell, 64 * t, b_width, n)
                        stage(key, "X", tid, cell, 64 * t, x_width, p)
                    if not state and bf16:
                        for row in (64 * idx + 16 * w + lane // 4, 64 * idx + 16 * w + lane // 4 + 8):
                            cols = np.arange(2 * (lane % 4), x_width, 8)
                            cols = np.stack([cols, cols + 1], 1).reshape(-1)
                            if row < l:
                                _add(acc, "Y", key, (cell * l + row) * p + cols[cols < p])
                    elif not state:
                        ty, tx = divmod(tid, 16)
                        q = np.arange(pc)
                        cols = 4 * tx + 64 * (q // 4) + q % 4 if pc >= 4 else pc * tx + q
                        for row in range(64 * idx + 4 * ty, 64 * idx + 4 * ty + 4):
                            if row < l:
                                _add(acc, "Y", key, (cell * l + row) * p + cols[cols < p])
                    p0, n0 = 64 * (idx // units_n), 64 * (idx % units_n)
                    if state and bf16 and p0 + 16 * w < p:
                        ntn = min(64, b_width - n0) // 8
                        cols = n0 + np.arange(2 * (lane % 4), 8 * ntn, 8)
                        cols = np.stack([cols, cols + 1], 1).reshape(-1)
                        for row in (p0 + 16 * w + lane // 4, p0 + 16 * w + lane // 4 + 8):
                            if row < p:
                                _add(acc, "S", key, (cell * p + row) * n + cols[cols < n])
                    elif state and not bf16:
                        tn, tp = math.ceil(min(64, n - n0) / 4), math.ceil(min(64, p - p0) / 4)
                        if tid < tp * tn:
                            pa, nb = p0 + 4 * (tid // tn), n0 + 4 * (tid % tn)
                            for row in range(pa, min(pa + 4, p)):
                                _add(acc, "S", key, (cell * p + row) * n + np.arange(nb, min(nb + 4, n)))
    return acc


def _assert_spec_matches(spec, acc, shapes, itemsize=4):
    """``itemsize``: one for every region, or a dict by region name."""
    hm = analyze(spec, GridSampler(None))
    assert sorted(hm.region_names()) == sorted(shapes)
    for name, shape in shapes.items():
        per_warp = {key: [np.concatenate(parts)] for key, parts in acc[name].items()}
        size = itemsize[name] if isinstance(itemsize, dict) else itemsize
        tags, wt, st, warps = heat_of_warps(per_warp, shape, size)
        rh = hm.region(name)
        np.testing.assert_array_equal(rh.tags_array, tags, err_msg=name)
        np.testing.assert_array_equal(rh.word_temps_matrix, wt, err_msg=name)
        np.testing.assert_array_equal(rh.sector_temps_array, st, err_msg=name)
        assert rh.n_programs == warps, name


@pytest.mark.parametrize(
    "bh, sq, skv, d, bkv, causal",
    [(2, 64, 64, 32, 32, True), (1, 100, 130, 20, 64, True), (2, 70, 130, 64, 32, False),
     (1, 40, 150, 16, 128, True), (1, 130, 130, 8, 64, True),
     # the ring over ten stages with a ragged last one, D off 16 bytes (one
     # float a copy); Sq != Skv at D = 128 (DP 128, two column groups a lane)
     (1, 200, 300, 33, 128, True), (1, 130, 70, 128, 32, True)],
)
def test_flash_spec_matches_kernel_thread_mapping(bh, sq, skv, d, bkv, causal):
    """Every case of the old mapping, and cases that reach the new ring's
    last stage and the 4-byte copies."""
    acc = _emulate_flash(bh, sq, skv, d, bkv, causal)
    spec = flash.flash_spec(bh, sq, skv, d, bkv=bkv, causal=causal)
    _assert_spec_matches(
        spec, acc, {"Q": (bh, sq, d), "K": (bh, skv, d), "V": (bh, skv, d), "O": (bh, sq, d)}
    )


@pytest.mark.parametrize(
    "groups, k, n, bm",
    [([100, 28, 0, 130], 40, 70, 32), ([64, 64, 64, 64], 16, 64, 64), ([10, 300], 33, 130, 128),
     # 26 row blocks: raster groups of 8, 8, 8 and a ragged 2, experts
     # changing inside a group, a ragged last column slice
     ([100, 28, 0, 130, 500], 20, 300, 32),
     # bm 64 with K off 16 bytes (4-byte copies)
     ([70, 200, 64], 18, 130, 64),
     # 128-column blocks (at least 132 of them), bm 32 and 64
     ([1100, 1000, 12], 8, 130, 32), ([1500, 1300], 12, 260, 64)],
)
def test_gmm_spec_matches_kernel_thread_mapping(groups, k, n, bm):
    _, ids, m = gmm.plan_groups(np.asarray(groups), bm)
    acc = _emulate_gmm(m, k, n, ids, bm)
    spec = gmm.gmm_spec(m, k, n, len(groups), ids, bm=bm)
    _assert_spec_matches(spec, acc, {"X": (m, k), "W": (len(groups), k, n), "O": (m, n)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "bh, c, l, p, n",
    [(2, 3, 16, 8, 4), (1, 2, 37, 20, 5), (1, 1, 300, 3, 2), (1, 1, 64, 100, 3),
     (1, 1, 32, 32, 16), (1, 1, 64, 64, 16)],
)
def test_ssd_spec_matches_kernel_thread_mapping(bh, c, l, p, n, dtype):
    """Both routes, at odd shapes, the tiny model's chunk (L 32, P 32, N
    16) and the model path's (L 64, P 64, N 16)."""
    bf16 = dtype == "bfloat16"
    acc = _emulate_ssd(bh, c, l, p, n, bf16=bf16)
    spec = ssd.ssd_chunk_spec(bh, c, l, p, n, dtype=dtype)
    assert spec.grid == (bh, c, ssd.units_of(p, n) + ssd.tiles_of(l), 4 if bf16 else 8)
    shapes = {"X": (bh, c, l, p), "A": (bh, c, l), "B": (bh, c, l, n), "C": (bh, c, l, n),
              "Y": (bh, c, l, p), "S": (bh, c, p, n)}
    size = 2 if bf16 else 4
    _assert_spec_matches(spec, acc, shapes, {"X": size, "A": size, "B": size, "C": size,
                                             "Y": 4, "S": 4})


def test_gmm_spec_rejects_ids_out_of_range():
    with pytest.raises(ValueError, match="lie in"):
        gmm.gmm_spec(64, 8, 8, 2, np.array([0, 2]), bm=32)


# -- story parity: the model families' pattern classes under the H100 geometry --


def _classes(hm):
    return {(r.region, r.pattern) for r in detect_all(hm)}


def _ref_classes(ref_name):
    spec, ctx = rk.build(ref_name)
    hm = ref_analyze(spec, sampler=rk.get(ref_name.split(":")[0]).sampler(), dynamic_context=ctx)
    return {(r.region, r.pattern) for r in ref_detect_all(hm)}


def test_model_family_pattern_divergences_are_the_recorded_ones():
    """Recorded in ROADMAP queue 3: the Pallas flash grid revisits its Q and
    O blocks at every KV step (hot Q, O), the CUDA block stages Q once and
    stores O once (the float32 route's 32-key stages stage each K and V
    row once a block, as its earlier whole tiles did, so its classes
    stayed); the CUDA gmm splits N over 64- or 128-column blocks, so X
    rows are re-read by every column block and each W slice by every row
    block of its expert (hot X, W), where a Pallas program takes all of N; a
    chunk's 128 log-decays share an (8, 128) TPU tile with seven other
    chunks (false sharing on A), and are 16 whole sectors read by warp 0 of
    each of the cell's blocks (two row tiles and a state unit at the
    registry's shape, which flags no hot A: three reads a word)."""
    port = {name: _classes(analyze(*kreg.build(name)[:1], GridSampler(None))) for name in ("flash", "gmm", "ssd")}
    assert port["flash"] == {("K", HOT), ("V", HOT)}
    assert _ref_classes("flash") == {("Q", HOT), ("K", HOT), ("V", HOT), ("O", HOT)}
    assert port["gmm"] == {("X", HOT), ("W", HOT)}
    assert _ref_classes("gmm") == set()
    assert port["ssd"] == set()
    assert _ref_classes("ssd") == {("A", FALSE_SHARING)}


# -- the registry ------------------------------------------------------------------


def test_model_families_keep_the_reference_names_and_shapes():
    for name in ("flash", "gmm", "ssd"):
        got, want = kreg.get(name), rk.get(name)
        assert got.variant_names() == want.variant_names()
        (variant,) = got.variants
        assert variant.kernel is not None and variant.plain is not None
    assert kreg.FLASH_SHAPE == (4, 1024, 1024, 128)
    assert kreg.GMM_SHAPE == (1024, 512, 512, 8)
    assert kreg.SSD_SHAPE == (4, 8, 128, 64, 64)
    np.testing.assert_array_equal(kreg._gmm_ids(), rk._gmm_ids())
    spec = kreg.build("gmm")[0]
    # bm = 128 tiles run in 64-row blocks; 64 blocks of 128 columns would
    # leave SMs idle, so 128 of 64 columns, 4 warps of 32 x 32 each
    assert spec.grid == (16, 8, 4)
    # 4 warps of 16 query rows a block (8 of 8 until the float32 redesign)
    assert kreg.build("flash")[0].grid == (4, 16, 4)
    # two row tiles of 128 and one state unit a cell, 8 warps a block
    assert kreg.build("ssd")[0].grid == (4, 8, 3, 8)


@pytest.mark.parametrize("ref_name", ["flash", "gmm", "ssd"])
def test_run_variant_on_cpu_runs_the_plain_version(ref_name):
    kreg.reset_launch_counts()
    variant = kreg.resolve(ref_name)[1]
    run = kreg.run_variant(variant, device="cpu")
    assert run["device"] == "cpu" and run["ms"] is None and run["launches"] == 0
    assert run["max_abs_err"] == 0.0
    assert run["shapes"] == [list(t.shape) for t in variant.inputs(torch.device("cpu"), torch.Generator())]


def test_run_variant_checks_every_output():
    """ssd returns (y, s): a kernel whose second output is off is caught."""
    variant = kreg.resolve("ssd")[1]

    def off(*args):
        y, s = ssd.ssd_plain(*args)
        return y, s + 1

    with pytest.raises(kreg.KernelMismatch, match="1.000e\\+00"):
        kreg.run_variant(dataclasses.replace(variant, kernel=off), device="cpu")


def test_model_refs_resolve_through_kernel_registry():
    entry = kreg.get("model.transformer-tiny.mlp")
    assert entry.name == "model.transformer-tiny.mlp"
    assert [v.role for v in entry.variants] == ["baseline", "optimized"]
    spec, ctx = kreg.build("model.transformer-tiny.mlp")
    assert ctx is None and spec.name == "gemm_v01"
    assert kreg.build("model.transformer-tiny.mlp:v02")[0].name == "gemm_v02"
    assert kreg.resolve("model.moe-tiny.moe:tile64")[1].kwargs == (("bm", 64),)
    assert kreg.resolve("model.transformer-tiny.attn:wide-kv")[1].kwargs == (
        ("causal", True), ("bkv", 64),
    )
    # model families are derived, not listed
    assert not any(n.startswith("model.") for n in kreg.names())


def test_model_refs_reject_unknowns():
    with pytest.raises(KeyError):
        kreg.get("model.transformer-tiny")  # malformed: no kind
    with pytest.raises(KeyError):
        kreg.get("model.nope.mlp")  # unknown model
    with pytest.raises(KeyError):
        kreg.get("model.mamba-tiny.mlp")  # kind the layout doesn't use


def test_model_rungs_launch_the_kernels_their_specs_describe():
    want = {
        "attn": (flash.flash_attention, "flash_attention"),
        "mlp": (kreg.gemm.gemm_v01, "gemm_v01"),
        "unembed": (kreg.gemm.gemm_v01, "gemm_v01"),
        "moe": (gmm.gmm, "gmm"),
        "ssm": (ssd.ssd_chunk, "ssd_chunk"),
    }
    for model_name, entry in MODELS.items():
        for kind in kernel_kinds(entry.config):
            fam = kreg.get(f"model.{model_name}.{kind}")
            kernel, spec_name = want[kind]
            assert fam.variants[0].kernel is kernel
            assert fam.variants[0].spec().name == spec_name
            run = kreg.run_variant(fam.variants[-1], device="cpu")
            assert run["max_abs_err"] == 0.0


def test_every_model_kind_has_a_ladder_improvement_or_single_rung():
    """The ladder precondition of the reference, priced by the port's own
    traced transfers (the port has no lint yet).  attn is the recorded
    divergence: a CUDA block reads each K/V row once whatever its tile
    width (the float32 route walks 32-key stages either way), so wide-kv
    moves no device traffic under the H100 geometry; moe keeps its
    direction, as a 64-row block of tile64 reads each W slice once for 64
    rows."""
    for model_name, entry in MODELS.items():
        for kind in kernel_kinds(entry.config):
            fam = kreg.get(f"model.{model_name}.{kind}")
            costs = [analyze(v.spec(), GridSampler(None)).sector_transactions() for v in fam.variants]
            if kind == "attn":
                assert costs[1] == costs[0], (model_name, costs)
            elif len(costs) > 1:
                assert min(costs[1:]) < costs[0], (model_name, kind, costs)


# -- configs: the port's copies equal the reference's ------------------------------


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    dtype = out.pop("dtype")
    return out, getattr(dtype, "__name__", str(dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", sorted(ref_archs.FULL))
def test_config_from_reference_on_the_published_configs(arch):
    want = ref_archs.FULL[arch]()
    got = config_from_reference(dataclasses.asdict(want))
    assert got == archs.get_config(arch)
    fields, dtype = _fields(got)
    ref_fields, ref_dtype = _fields(want)
    assert fields == ref_fields and dtype == ref_dtype == "bfloat16"
    assert [b.tag() for b in got.layout()] == [b.tag() for b in want.layout()]
    assert (got.padded_vocab, got.head_dim_) == (want.padded_vocab, want.head_dim_)
    assert kernel_kinds(got) == ref_registry.kernel_kinds(want)


@pytest.mark.parametrize("name", list(MODELS))
def test_config_from_reference_on_the_registry_models(name):
    want = ref_registry.get_model(name)
    got = get_model(name)
    assert config_from_reference(dataclasses.asdict(want.config)) == got.config
    assert (got.batch, got.seq, got.summary) == (want.batch, want.seq, want.summary)
    assert got.config.dtype == torch.float32


def test_apply_overrides_coerces_and_rejects():
    cfg = get_model("moe-tiny").config
    got = apply_overrides(cfg, ["n_layers=8", "capacity_factor=2", "use_rope=false", "dtype=bfloat16", "name=x"])
    assert (got.n_layers, got.capacity_factor, got.use_rope, got.dtype, got.name) == (
        8, 2.0, False, torch.bfloat16, "x",
    )
    for bad, match in (("bogus=1", "unknown config field"), ("n_layers", "key=value"),
                       ("n_layers=x", "expected int"), ("use_rope=maybe", "expected bool"),
                       ("dtype=float7", "torch dtype")):
        with pytest.raises(ValueError, match=match):
            apply_overrides(cfg, [bad])


def _jamba_overrides(n_layers=8):
    """Jamba-v0.1-52B's fields that layout() and kind_spec read, as -c
    overrides of moe-tiny, at a cut depth (one hybrid period)."""
    cfg = archs.jamba_52b()
    keys = ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim", "vocab_pad_multiple",
            "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_chunk", "hybrid_period",
            "hybrid_attn_index", "n_experts", "top_k", "moe_period", "n_dense_layers")
    return [f"{key}={getattr(cfg, key)}" for key in keys] + [f"n_layers={n_layers}"]


def test_jamba_cut_to_one_period_holds_every_kind_at_full_width():
    entry = get_model("moe-tiny")
    cfg = apply_overrides(entry.config, _jamba_overrides())
    found = mp.discover("moe-tiny", cfg, entry.batch, entry.seq, default_shapes=False)
    rows = {}
    for d in found:
        rows.setdefault(d.layer, []).append(d.kind)
    assert rows == {
        "layer0": ["ssm", "mlp"], "layer1": ["ssm", "moe"], "layer2": ["ssm", "mlp"],
        "layer3": ["ssm", "moe"], "layer4": ["attn", "mlp"], "layer5": ["ssm", "moe"],
        "layer6": ["ssm", "mlp"], "layer7": ["ssm", "moe"], "head": ["unembed"],
    }
    # the widths are Jamba's: 32 heads of 128, 128 SSD heads of 64 with
    # state 16, 16 experts of d_ff 14336, vocab 65536
    spec = {d.kind: d.spec for d in found}
    assert spec["attn"].operands[0].shape == (2 * 32, 64, 128)
    assert spec["ssm"].operands[0].shape == (2 * 128, 1, 64, 64)
    assert spec["ssm"].operands[2].shape == (2 * 128, 1, 64, 16)
    assert spec["moe"].operands[1].shape == (16, 4096, 14336)
    assert spec["mlp"].operands[1].shape == (4096, 14336)
    assert spec["unembed"].operands[1].shape == (4096, 65536)


# -- engine parity: the reference's whole-model profiles under TPUTile --------------


# per-layer transfers of the reference's ``cuthermo model NAME --no-hlo``
REF_TABLES = {
    "transformer-tiny": ({"layer0": 1072, "layer1": 1072, "head": 1104}, 3248),
    "moe-tiny": ({"layer0": 608, "layer1": 608, "head": 1104}, 2320),
    "mamba-tiny": ({"layer0": 672, "layer1": 672, "head": 1104}, 2448),
}


def _port_discovered(found):
    return [
        mp.DiscoveredKernel(
            name=d.name, layer=d.layer, kind=d.kind, family=d.family,
            spec=to_port_spec(d.spec), entry=d.entry, backward=d.backward,
        )
        for d in found
    ]


@pytest.mark.parametrize("name", list(REF_TABLES))
def test_engine_parity_on_reference_model_profiles(name, tmp_path):
    entry = ref_registry.get_model(name)
    found = ref_mp.discover(name, entry.config, entry.batch, entry.seq)
    want = [
        ref_profile_kernel(d.spec, RefGridSampler(None), None, name=d.name,
                           variant=f"{d.family}:fwd")
        for d in found
    ]
    want_table = ref_mp.layers_table(found, want)
    pfound = _port_discovered(found)
    got = [
        profile_kernel(d.spec, GridSampler(None), None, name=d.name, variant=f"{d.family}:fwd")
        for d in pfound
    ]
    table = mp.layers_table(pfound, got)
    assert table == want_table
    rows, total = REF_TABLES[name]
    assert {row["path"]: row["transactions"] for row in table} == rows
    layers = {"model": name, "batch": entry.batch, "seq": entry.seq, "overrides": [],
              "table": table}
    it = ProfileSession(tmp_path / "s").add_iteration(got, label=f"model-{name}", layers=layers)
    assert mp.iteration_transactions(it) == total
    assert json.loads((it.path / "manifest.json").read_text())["version"] == 6
    again = ref_load_iteration(it.path)
    assert again.layers == layers
    assert ref_mp.iteration_transactions(again) == total
    for a, b in zip(again.kernels, want):
        assert a.name == b.name
        assert ref_heatmaps_equal(a.heatmap, b.heatmap)


# -- ports of tests/test_model_profile.py --------------------------------------------


def test_intercept_records_only_scoped_builds():
    from repro_torch.kernels import gemm

    original = gemm.gemm_v01_spec
    with mp.intercept() as calls:
        gemm.gemm_v01_spec(16, 16, 16)  # no scope: invisible
        assert calls == []
        with mp.layer_scope("layer0"):
            spec = gemm.gemm_v01_spec(16, 16, 16)
        gemm.gemm_v01_spec(16, 16, 16)  # scope closed again
    assert len(calls) == 1
    (call,) = calls
    assert call.layer == "layer0"
    assert call.entry == "repro_torch.kernels.gemm:gemm_v01_spec"
    assert call.spec == spec
    assert gemm.gemm_v01_spec is original


def test_intercept_restores_on_error():
    from repro_torch.kernels import gemm

    pairs = ((flash, "flash_spec"), (gemm, "gemm_v01_spec"), (gemm, "gemm_v02_spec"),
             (gmm, "gmm_spec"), (ssd, "ssd_chunk_spec"))
    before = {(m.__name__, f): getattr(m, f) for m, f in pairs}
    with pytest.raises(RuntimeError):
        with mp.intercept():
            raise RuntimeError("boom")
    for m, f in pairs:
        assert getattr(m, f) is before[(m.__name__, f)], f


def test_nested_layer_scopes_attribute_innermost():
    from repro_torch.kernels import gemm

    with mp.intercept() as calls:
        with mp.layer_scope("outer"):
            with mp.layer_scope("inner"):
                gemm.gemm_v01_spec(16, 16, 16)
            gemm.gemm_v01_spec(16, 16, 16)
    assert [c.layer for c in calls] == ["inner", "outer"]


def test_discover_transformer_tiny_layers_and_stamps():
    entry = get_model("transformer-tiny")
    found = mp.discover("transformer-tiny", entry.config, entry.batch, entry.seq)
    assert [(d.name, d.layer, d.kind) for d in found] == [
        ("layer0.attn", "layer0", "attn"),
        ("layer0.mlp", "layer0", "mlp"),
        ("layer1.attn", "layer1", "attn"),
        ("layer1.mlp", "layer1", "mlp"),
        ("head.unembed", "head", "unembed"),
    ]
    for d in found:
        assert d.family == f"model.transformer-tiny.{d.kind}"
        assert isinstance(d.spec.source, str)
        assert d.spec.source.startswith(d.family + ":")
        want = kind_spec(entry.config, d.kind, entry.batch, entry.seq)
        assert d.spec.name == want.name
        assert d.spec.grid == want.grid
        # the stamp rebuilds the same spec through the registry
        assert kreg.build(d.spec.source)[0].grid == want.grid


def test_discover_with_non_default_shapes_uses_builder_triples():
    entry = get_model("transformer-tiny")
    cfg = dataclasses.replace(entry.config, d_ff=512)
    found = mp.discover("transformer-tiny", cfg, entry.batch, entry.seq, default_shapes=False)
    for d in found:
        fn_ref, args, kwargs = d.spec.source
        assert fn_ref == "repro_torch.models.registry:kind_spec"
        assert args == (cfg, d.kind, entry.batch, entry.seq)
        assert kwargs == {"rung": 0}


def test_discover_backward_appends_kind_swapped_mirrors():
    entry = get_model("mamba-tiny")
    found = mp.discover("mamba-tiny", entry.config, entry.batch, entry.seq, backward=True)
    fwd = [d for d in found if not d.backward]
    bwd = [d for d in found if d.backward]
    assert len(fwd) == len(bwd) == 3
    assert [d.name for d in bwd] == [f"{d.name}.bwd" for d in fwd]
    flipped = {"load": "store", "store": "load"}
    for f, b in zip(fwd, bwd):
        assert b.spec.name == f.spec.name + "_bwd"
        for fop, bop in zip(f.spec.operands, b.spec.operands):
            assert bop.kind == flipped.get(fop.kind, fop.kind), fop.name
        assert b.spec.source[0] == "repro_torch.core.model_profile:bwd_spec"


def test_bwd_spec_preserves_scratch():
    entry = get_model("transformer-tiny")
    fwd = kind_spec(entry.config, "attn", entry.batch, entry.seq)
    bwd = mp.bwd_spec(entry.config, "attn", entry.batch, entry.seq)
    assert bwd.scratch == fwd.scratch
    assert bwd.grid == fwd.grid
    # the index walks are direction-free too
    assert [name for name, _ in bwd.dynamic] == [name for name, _ in fwd.dynamic]


def _fake_profiled(name, sector_temps):
    """A minimal ProfiledKernel whose transactions == sum(sector_temps)."""
    temps = np.asarray(sector_temps, dtype=np.int64)
    region = RegionHeatmap(
        RegionInfo(name="x", geometry=H100Sector((16, 128), itemsize=4, name="x"), space="hbm"),
        n_programs=1,
        tags=np.arange(temps.size, dtype=np.int64),
        word_temps=np.zeros((temps.size, 8), dtype=np.int64),
        sector_temps=temps,
    )
    hm = Heatmap(kernel=name, grid=(1,), sampler="full", regions=(region,), n_records=1, dropped=0)
    return ProfiledKernel(name=name, variant="v00", heatmap=hm, reports=(), actions=())


def _rows_from_partition(kernels, assignment):
    rows = {}
    for pk in kernels:
        layer = assignment[pk.name]
        row = rows.setdefault(
            layer, {"path": layer, "kinds": [], "kernels": [], "transactions": 0, "patterns": []}
        )
        row["kernels"].append(pk.name)
        row["transactions"] += pk.transactions
    return list(rows.values())


def test_rollup_sums_to_iteration_total_for_any_partition():
    """Property: any partition of kernels into layers validates, and its
    per-layer totals sum exactly to the iteration total."""
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=50, deadline=None)
    @hypothesis.given(
        temps=st.lists(st.lists(st.integers(0, 9), min_size=1, max_size=4), min_size=1, max_size=6),
        layer_of=st.lists(st.integers(0, 3), min_size=6, max_size=6),
    )
    def _property(temps, layer_of):
        kernels = [_fake_profiled(f"k{i}", t) for i, t in enumerate(temps)]
        table = _rows_from_partition(
            kernels, {pk.name: f"layer{layer_of[i]}" for i, pk in enumerate(kernels)}
        )
        _validate_layers({"table": table}, kernels)
        assert sum(row["transactions"] for row in table) == sum(pk.transactions for pk in kernels)

    _property()


def test_rollup_partition_deterministic_fallback():
    kernels = [_fake_profiled("k0", [2, 3]), _fake_profiled("k1", [5]),
               _fake_profiled("k2", [1, 1, 1])]
    total = sum(pk.transactions for pk in kernels)
    assert total == 13
    for assignment in ({"k0": "a", "k1": "a", "k2": "a"}, {"k0": "a", "k1": "b", "k2": "c"},
                       {"k0": "a", "k1": "b", "k2": "a"}):
        table = _rows_from_partition(kernels, assignment)
        _validate_layers({"table": table}, kernels)
        assert sum(row["transactions"] for row in table) == total


def test_validate_layers_rejects_non_partitions():
    kernels = [_fake_profiled("k0", [2]), _fake_profiled("k1", [3])]
    ok = _rows_from_partition(kernels, {"k0": "a", "k1": "a"})
    with pytest.raises(SessionError, match="'table'"):
        _validate_layers({}, kernels)
    with pytest.raises(SessionError, match="malformed layer row"):
        _validate_layers({"table": [{"path": "a"}]}, kernels)
    with pytest.raises(SessionError, match="not.*profiled"):
        _validate_layers({"table": [dict(ok[0], kernels=["k0", "k1", "ghost"])]}, kernels)
    with pytest.raises(SessionError, match="both layer"):
        _validate_layers({"table": [dict(ok[0]), dict(ok[0], path="b")]}, kernels)
    with pytest.raises(SessionError, match="sum to"):
        _validate_layers({"table": [dict(ok[0], transactions=99)]}, kernels)
    with pytest.raises(SessionError, match="missing from the layer"):
        _validate_layers({"table": _rows_from_partition(kernels[:1], {"k0": "a"})}, kernels)
    # write_iteration validates before it writes anything
    with pytest.raises(SessionError, match="sum to"):
        write_iteration("unused-dir", kernels, layers={"table": [dict(ok[0], transactions=1)]})


def test_layers_table_matches_discovery_order():
    entry = get_model("transformer-tiny")
    found = mp.discover("transformer-tiny", entry.config, entry.batch, entry.seq)
    profiled = [_fake_profiled(d.name, [i + 1]) for i, d in enumerate(found)]
    table = mp.layers_table(found, profiled)
    assert [row["path"] for row in table] == ["layer0", "layer1", "head"]
    assert table[0]["kernels"] == ["layer0.attn", "layer0.mlp"]
    assert table[0]["kinds"] == ["attn", "mlp"]
    assert table[0]["transactions"] == 1 + 2
    _validate_layers({"table": table}, profiled)


def test_profile_model_end_to_end(tmp_path):
    kreg.reset_launch_counts()
    it = mp.profile_model("mamba-tiny", tmp_path / "sess", device="cpu")
    assert it.layers["model"] == "mamba-tiny"
    # the op-level sweep ran on the CPU and wrote the reference's block
    assert it.layers["hlo"]["source"] == "torch-ops"
    assert it.layers["hlo"]["backward"] is False and it.layers["hlo"]["cost"]["flops"] > 0
    table = it.layers["table"]
    assert [row["path"] for row in table] == ["layer0", "layer1", "head"]
    assert sum(row["transactions"] for row in table) == mp.iteration_transactions(it) > 0
    again = load_iteration(it.path)
    assert again.layers == it.layers
    assert again.version == 7  # H100 sectors: the JAX package rejects it
    for a, b in zip(it.kernels, again.kernels):
        assert heatmaps_equal(a.heatmap, b.heatmap)
    # one measurement per kind, the later kernels of a kind share it
    runs = {pk.name: pk.run for pk in again.kernels}
    assert runs["layer0.ssm"]["device"] == "cpu" and "shared_with" not in runs["layer0.ssm"]
    assert runs["layer1.ssm"]["shared_with"] == "layer0.ssm"
    assert runs["layer1.ssm"]["shapes"] == runs["layer0.ssm"]["shapes"] == [
        [16, 2, 32, 32], [16, 2, 32], [16, 2, 32, 16], [16, 2, 32, 16],
    ]
    assert runs["head.unembed"]["shapes"] == [[128, 128], [128, 512]]
    assert ssd.ssd_chunk.launches == 0


# -- ``cuthermo model``: ports of tests/test_model_cli.py ---------------------------


@pytest.fixture(scope="module")
def model_session(tmp_path_factory):
    """One profiled mamba-tiny session (the cheapest registered model)."""
    sess = tmp_path_factory.mktemp("model") / "sess"
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["model", "mamba-tiny", "--out", str(sess), "--no-hlo", "--report",
                       "--device", "cpu"])
    assert rc == 0
    return sess, out.getvalue()


def test_model_help_and_list(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["model", "--help"])
    assert e.value.code == 0
    assert "--max-transfers" in capsys.readouterr().out
    assert cli.main(["model", "--list"]) == 0
    out = capsys.readouterr().out
    for name in ("transformer-tiny", "moe-tiny", "mamba-tiny"):
        assert name in out


def test_model_exit_0_prints_per_layer_table(model_session):
    sess, out = model_session
    assert "# model mamba-tiny" in out
    for path in ("layer0", "layer1", "head", "total"):
        assert path in out
    assert "op sweep: skipped (--no-hlo)" in out
    assert (sess / "iter0").is_dir()


@pytest.mark.parametrize(
    "name, table",
    [("transformer-tiny", {"layer0": "attn, mlp", "layer1": "attn, mlp", "head": "unembed"}),
     ("moe-tiny", {"layer0": "attn, moe", "layer1": "attn, moe", "head": "unembed"})],
)
def test_model_exit_0_on_the_other_models(name, table, tmp_path, capsys):
    assert cli.main(["model", name, "--out", str(tmp_path / "s"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for path, kinds in table.items():
        assert any(line.split()[:1] == [path] and kinds in line for line in out.splitlines()), path
    it = load_iteration(tmp_path / "s" / "iter0")
    assert [pk.name for pk in it.kernels if pk.run and "shared_with" not in pk.run] == [
        "layer0.attn", f"layer0.{table['layer0'].split(', ')[1]}", "head.unembed",
    ]


def test_model_exit_2_on_unknown_model(tmp_path, capsys):
    assert cli.main(["model", "no-such-model", "--out", str(tmp_path / "s"), "--device", "cpu"]) == 2
    assert "unknown model" in capsys.readouterr().err


def test_model_exit_2_on_bad_override(tmp_path, capsys):
    argv = ["model", "mamba-tiny", "--out", str(tmp_path / "s"), "--device", "cpu"]
    assert cli.main([*argv, "-c", "bogus=1"]) == 2
    assert "unknown config field" in capsys.readouterr().err
    assert cli.main([*argv, "-c", "n_layers"]) == 2
    assert "key=value" in capsys.readouterr().err


def test_model_exit_2_without_a_name():
    assert cli.main(["model"]) == 2


def test_model_exit_2_without_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["model", "mamba-tiny", "--out", str(tmp_path / "s")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "s").exists()


def test_model_exit_1_when_budget_blown(tmp_path, capsys):
    sess = tmp_path / "s"
    argv = ["model", "mamba-tiny", "--out", str(sess), "--no-hlo", "-q", "--device", "cpu",
            "--max-transfers", "0"]
    assert cli.main(argv) == 1
    assert "budget blown" in capsys.readouterr().err
    assert (sess / "iter0").is_dir()


def test_model_artifact_carries_layers_with_exact_rollup(model_session):
    sess, _ = model_session
    manifest = json.loads((sess / "iter0" / "manifest.json").read_text())
    assert manifest["version"] == 7
    layers = manifest["layers"]
    assert layers["model"] == "mamba-tiny"
    it = load_iteration(sess / "iter0")
    assert it.layers == layers
    assert sum(row["transactions"] for row in layers["table"]) == mp.iteration_transactions(it)
    assert all(pk.variant.startswith("model.mamba-tiny.") for pk in it.kernels)


def test_model_artifact_round_trips_bit_identically(model_session, tmp_path):
    sess, _ = model_session
    it = load_iteration(sess / "iter0")
    write_iteration(tmp_path / "copy", it.kernels, label=it.label, note=it.note, layers=it.layers)
    again = load_iteration(tmp_path / "copy")
    assert again.layers == it.layers
    for a, b in zip(it.kernels, again.kernels):
        assert heatmaps_equal(a.heatmap, b.heatmap)
        assert a.run == b.run


def test_model_report_renders_per_layer_section(model_session, tmp_path):
    sess, _ = model_session
    md = (sess / "iter0" / "report" / "report.md").read_text()
    assert "## per-layer attribution — mamba-tiny" in md
    assert "| layer0 |" in md and "| **total** |" in md
    assert "per-layer attribution" in (sess / "iter0" / "report" / "index.html").read_text()
    # `report` on the stored iteration renders it too
    out = tmp_path / "bundle"
    assert cli.main(["report", str(sess / "iter0"), "--out", str(out)]) == 0
    assert "## per-layer attribution — mamba-tiny" in (out / "report.md").read_text()


def test_model_family_profiles_and_diffs(tmp_path, capsys):
    sess = tmp_path / "s"
    for rung in ("tile32", "tile64"):
        argv = ["profile", "-k", f"model.moe-tiny.moe:{rung}", "--device", "cpu", "-q", "--out", str(sess)]
        assert cli.main(argv) == 0
    assert cli.main(["diff", str(sess / "iter0"), str(sess / "iter1")]) == 0
    assert "[ improved] model.moe-tiny.moe: transfers 14336 -> 10240" in capsys.readouterr().out


def test_sampler_can_pin_leading_coordinates(tmp_path):
    sampler = cli._parse_sampler("window:8:2")
    assert (sampler.target, sampler.window) == ((0, 0), 8)
    assert cli._parse_sampler("window:4").target == (0,)
    for bad in ("window:0:2", "window:8:0", "window:8:2:1", "window"):
        with pytest.raises(SystemExit):
            cli._parse_sampler(bad)
    argv = ["model", "transformer-tiny", "--out", str(tmp_path / "s"), "--device", "cpu", "-q",
            "--sampler", "window:2:2"]
    assert cli.main(argv) == 0
    it = load_iteration(tmp_path / "s" / "iter0")
    assert {pk.heatmap.sampler for pk in it.kernels} == {"grid[0,0x2,...]"}
