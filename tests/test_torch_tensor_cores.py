"""The bfloat16 routes of flash and gmm (tensor cores) and the SSD chunk's
shared memory and pattern classes, on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).  Here
numpy emulations of their thread mappings, thread by thread, are held
against the spec builders that the profiler walks: ``flash_spec`` and
``gmm_spec`` with ``dtype`` bfloat16 describe ``flash_tc_kernel`` and
``gmm_tc_kernel``, and with float32 the CUDA-core kernels, as before.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch import kernels as kreg
from repro_torch.configs import archs
from repro_torch.core.collector import analyze
from repro_torch.core.patterns import HOT, detect_all
from repro_torch.core.trace import GridSampler
from repro_torch.kernels import flash, gmm, ssd

from torch_parity import heat_of_warps

BF16 = "bfloat16"


def _add(acc, name, key, idx):
    acc[name].setdefault(key, [np.empty(0, np.int64)]).append(np.asarray(idx, np.int64))


def _assert_spec_matches(spec, acc, shapes, itemsize):
    hm = analyze(spec, GridSampler(None))
    assert sorted(hm.region_names()) == sorted(shapes)
    for name, shape in shapes.items():
        per_warp = {key: [np.concatenate(parts)] for key, parts in acc[name].items()}
        tags, wt, st, warps = heat_of_warps(per_warp, shape, itemsize)
        rh = hm.region(name)
        np.testing.assert_array_equal(rh.tags_array, tags, err_msg=name)
        np.testing.assert_array_equal(rh.word_temps_matrix, wt, err_msg=name)
        np.testing.assert_array_equal(rh.sector_temps_array, st, err_msg=name)
        assert rh.n_programs == warps, name


def _chunk(row, col, row_len, cols):
    """Flat indices of the elements col .. col + 7 below ``cols`` of ``row``."""
    c = np.arange(col, min(col + 8, cols))
    return row * row_len + c


# -- flash_tc_kernel -----------------------------------------------------------


def _emulate_flash_tc(bh, sq, skv, d, bkv, causal):
    """Per-warp flat indices of Q, K, V and O for flash_tc_kernel: blocks
    of 128 threads per (64-query tile, head); thread t copies the 16-byte
    chunks t, t + 128, ... of each staged tile (rows of DP / 8 chunks, DP
    the least of 16, 32, 64, 128 that holds d); warp w stores its 16 rows."""
    dp = 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 128
    cpr = dp // 8
    acc = {n: {} for n in "QKVO"}
    for h in range(bh):
        for qt in range(math.ceil(sq / 64)):
            q0 = qt * 64
            tiles = math.ceil(skv / bkv)
            if causal:
                tiles = min(tiles, (min(q0 + 64, sq) - 1) // bkv + 1)
            for tid in range(128):
                w, lane = divmod(tid, 32)
                key = (h, qt, w)
                for name in "QKVO":
                    _add(acc, name, key, [])
                for i in range(tid, 64 * cpr, 128):
                    r, c = divmod(i, cpr)
                    if q0 + r < sq and 8 * c < d:
                        _add(acc, "Q", key, _chunk(h * sq + q0 + r, 8 * c, d, d))
                for t in range(tiles):
                    for i in range(tid, bkv * cpr, 128):
                        r, c = divmod(i, cpr)
                        if t * bkv + r < skv and 8 * c < d:
                            for name in "KV":
                                _add(acc, name, key, _chunk(h * skv + t * bkv + r, 8 * c, d, d))
                for i in range(lane, 16 * cpr, 32):
                    r = 16 * w + i // cpr
                    col = (i % cpr) * 8
                    if q0 + r < sq and col < d:
                        _add(acc, "O", key, _chunk(h * sq + q0 + r, col, d, d))
    return acc


@pytest.mark.parametrize(
    "bh, sq, skv, d, bkv, causal",
    [(2, 64, 64, 32, 32, True), (1, 100, 130, 20, 64, True), (2, 70, 130, 64, 32, False),
     (1, 40, 150, 16, 128, True), (1, 130, 130, 8, 64, True), (1, 70, 300, 128, 128, True),
     (1, 1, 1, 8, 32, True)],
)
def test_flash_bf16_spec_matches_tensor_core_thread_mapping(bh, sq, skv, d, bkv, causal):
    acc = _emulate_flash_tc(bh, sq, skv, d, bkv, causal)
    spec = flash.flash_spec(bh, sq, skv, d, bkv=bkv, causal=causal, dtype=torch.bfloat16)
    assert spec.grid == (bh, math.ceil(sq / 64), 4)
    _assert_spec_matches(
        spec, acc, {"Q": (bh, sq, d), "K": (bh, skv, d), "V": (bh, skv, d), "O": (bh, sq, d)}, 2
    )


# -- gmm_tc_kernel ---------------------------------------------------------------


def _emulate_gmm_tc(m, k, n, e, ids, bm):
    """Per-warp flat indices of X, W and O for gmm_tc_kernel: the plan cuts
    each run of tiles with one id into pieces of up to 128 rows; a block
    of 128 threads takes a piece and 128 columns; thread t copies the
    16-byte chunks t, t + 128, ... of each (128, 64) X tile and (64, 128)
    W tile of the piece's rows, when the id is in [0, e); warp w stores
    rows 32w .. 32w+31 of the piece."""
    pieces, t = [], 0
    while t < m // bm:
        u = t
        while u < m // bm and ids[u] == ids[t]:
            u += 1
        start, end = t * bm, u * bm
        while start < end:
            pieces.append((start, min(128, end - start), ids[t]))
            start += 128
        t = u
    acc = {n_: {} for n_ in ("X", "W", "O")}
    for c, (row0, rows, ex) in enumerate(pieces):
        for bx in range(math.ceil(n / 128)):
            col0 = bx * 128
            for tid in range(128):
                w, lane = divmod(tid, 32)
                key = (c, bx, w)
                for name in acc:
                    _add(acc, name, key, [])
                if 0 <= ex < e:
                    for k0 in range(0, k, 64):
                        for i in range(tid, 128 * 8, 128):
                            r, cc = divmod(i, 8)
                            if r < rows and k0 + 8 * cc < k:
                                _add(acc, "X", key, _chunk(row0 + r, k0 + 8 * cc, k, k))
                        for i in range(tid, 64 * 16, 128):
                            r, cc = divmod(i, 16)
                            if k0 + r < k and col0 + 8 * cc < n:
                                _add(acc, "W", key, _chunk(ex * k + k0 + r, col0 + 8 * cc, n, n))
                for i in range(lane, 32 * 16, 32):
                    r = 32 * w + i // 16
                    col = col0 + 8 * (i % 16)
                    if r < rows and col < n:
                        _add(acc, "O", key, _chunk(row0 + r, col, n, n))
    return acc, len(pieces)


def _planned(groups, bm):
    _, ids, m = gmm.plan_groups(np.asarray(groups), bm)
    return ids, m, len(groups)


@pytest.mark.parametrize(
    "case, k, n, bm",
    [
        ("groups [100, 28, 0, 130]", 40, 70, 32),
        ("groups [64, 64, 64, 64]", 16, 64, 64),
        ("groups [10, 300]", 33, 130, 128),
        ("groups [257, 0, 31, 600]", 48, 200, 32),
        # experts change inside 128-row lines, one expert in two runs, ids out of range
        ("ids [2, 2, 0, 1, 1, 5, 3, 0, -1, 2]", 33, 70, 32),
        ("ids [7, 7, 7, 7]", 16, 24, 32),
    ],
)
def test_gmm_bf16_spec_matches_tensor_core_thread_mapping(case, k, n, bm):
    kind, values = case.split(" ", 1)
    values = [int(v) for v in values.strip("[]").split(",")]
    if kind == "groups":
        ids, m, e = _planned(values, bm)
    else:
        ids, m, e = np.asarray(values, np.int32), len(values) * bm, 4
    acc, pieces = _emulate_gmm_tc(m, k, n, e, ids, bm)
    spec = gmm.gmm_spec(m, k, n, e, ids, bm=bm, dtype=torch.bfloat16)
    assert spec.grid == (pieces, math.ceil(n / 128), 4)
    _assert_spec_matches(spec, acc, {"X": (m, k), "W": (e, k, n), "O": (m, n)}, 2)


def test_expert_chunks_cut_each_run_into_128_row_pieces():
    ids = np.asarray([2, 2, 0, 1, 1, 5, 3, 0, -1, 2])
    assert gmm.expert_chunks(ids, 32, 320) == [
        (0, 64, 2), (64, 32, 0), (96, 64, 1), (160, 32, 5), (192, 32, 3), (224, 32, 0),
        (256, 32, -1), (288, 32, 2)]
    # tiles wider than a chunk, and a run of nine 32-row tiles
    assert gmm.expert_chunks(np.asarray([4, 4, 1]), 256, 768) == [
        (0, 128, 4), (128, 128, 4), (256, 128, 4), (384, 128, 4), (512, 128, 1), (640, 128, 1)]
    assert gmm.expert_chunks(np.zeros(9, np.int32), 32, 288) == [(0, 128, 0), (128, 128, 0), (256, 32, 0)]
    # the plan's scratch holds the most chunks any ids can give
    for m, bm in ((320, 32), (768, 256), (4096, 32), (96, 96)):
        worst = np.arange(m // bm)  # every tile a run of its own
        assert 1 + 2 * len(gmm.expert_chunks(worst, bm, m)) <= gmm.plan_ints(m, bm)


# -- the two routes, side by side --------------------------------------------------


def _classes(spec):
    hm = analyze(spec, GridSampler(None))
    return hm.sector_transactions(), {(r.region, r.pattern) for r in detect_all(hm)}


def test_bf16_pattern_classes_at_the_registry_shapes_are_pinned():
    """Recorded in ROADMAP queue 3 item 5, beside the float32 classes: at
    the registry's shapes the bf16 flash flags hot K, V (every query block
    of a head re-stages its KV rows), as the float32 route does, at half
    the transfers (2-byte elements); the bf16 gmm flags hot X only, where
    the float32 route flags hot X and W: a 128 x 128 block covers a whole
    bm = 128 tile, so each W slice is staged by one block, while X rows are
    still staged by each of the N/128 column blocks.  ssd flags nothing in
    either route, as the reference flags only A (false sharing of its TPU
    tile)."""
    f32 = _classes(flash.flash_spec(*kreg.FLASH_SHAPE, bkv=kreg.FLASH_BKV))
    bf = _classes(flash.flash_spec(*kreg.FLASH_SHAPE, bkv=kreg.FLASH_BKV, dtype=BF16))
    assert f32 == (1245184, {("K", HOT), ("V", HOT)})
    assert bf == (622592, {("K", HOT), ("V", HOT)})
    ids = kreg._gmm_ids()
    f32 = _classes(gmm.gmm_spec(*kreg.GMM_SHAPE, ids, bm=kreg.GMM_BM))
    bf = _classes(gmm.gmm_spec(*kreg.GMM_SHAPE, ids, bm=kreg.GMM_BM, dtype=BF16))
    assert f32 == (1114112, {("X", HOT), ("W", HOT)})
    assert bf == (294912, {("X", HOT)})
    # ssd (4, 8, 128, 64, 64): no class in either route; a cell's B and x
    # are staged by both row tiles and the state unit (transfers 147968 in
    # float32 while one block a cell staged them once), and the bf16 walk
    # moves 2-byte inputs through 128 threads a block
    f32 = _classes(ssd.ssd_chunk_spec(*kreg.SSD_SHAPE))
    bf = _classes(ssd.ssd_chunk_spec(*kreg.SSD_SHAPE, dtype=BF16))
    assert f32 == (247296, set())
    assert bf == (148224, set())


@pytest.mark.parametrize("dtype", [np.float32, "float32"])
def test_float32_specs_still_describe_the_cuda_core_kernels(dtype):
    """The profile path launches float32, so its rungs keep their specs."""
    a = flash.flash_spec(1, 100, 130, 20, bkv=32, causal=True, dtype=dtype)
    b = flash.cuda_core_spec(1, 100, 130, 20, bkv=32, causal=True, dtype=dtype)
    # 4 warps a block, each owning 16 query rows
    assert a.grid == b.grid == (1, 2, 4)
    ids, m, e = _planned([100, 28, 0, 130], 32)
    g = gmm.gmm_spec(m, 40, 70, e, ids, bm=32, dtype=dtype)
    # ten 32-row blocks leave SMs idle at 128 columns: 64-column blocks of
    # two 32 x 32 warps
    assert gmm.block_cols(m, 70, 32) == 64
    assert g.grid == gmm.cuda_core_spec(m, 40, 70, e, ids, bm=32).grid == (m // 32, 2, 2)
    assert _classes(a)[0] == _classes(b)[0]


def test_bf16_names_and_padding():
    for dt in (torch.bfloat16, "bfloat16", "torch.bfloat16", type("bfloat16", (), {})):
        assert flash.is_bf16(dt)
    assert flash.BF16_STORAGE.itemsize == 2
    for dt in (torch.float32, np.float32, "float32", np.float16):
        assert not flash.is_bf16(dt)
    assert [flash.padded_d(d) for d in (1, 8, 16, 17, 20, 32, 33, 64, 65, 96, 128)] == [
        16, 16, 16, 32, 32, 32, 64, 64, 128, 128, 128]
    # thread t of 128 copies chunks t, t + 128, ...: warp 1 of a (64, 16) tile
    r, c = flash.staged_chunks(1, 64, 16)
    assert r.tolist() == [2] * 16 + [3] * 16 + [10] * 16 + [11] * 16 + [18] * 16 + [19] * 16 + \
        [26] * 16 + [27] * 16 + [34] * 16 + [35] * 16 + [42] * 16 + [43] * 16 + [50] * 16 + \
        [51] * 16 + [58] * 16 + [59] * 16
    assert c.tolist() == list(range(16)) * 16


# -- the SSD chunk's shared memory -----------------------------------------------


def _ssd_layout(l, p, n, dtype):
    """The regions of csrc/ssd.cu's dynamic shared memory, in bytes, in the
    order the kernel carves them.  float32 (ssd_chunk_kernel): the ring's
    tiles of B (rows of N rounded up to 4, plus 4 where that is a multiple
    of 8) and of x (16, 32, 64 or 128 columns), two stages where two blocks
    an SM still fit (<= 115,712 B a block), else one; the row tile's C, the
    key-major 64 x 68 scores, cum and the end-state decays.  bfloat16
    (ssd_tc_kernel): two stages of B and x and C's rows, each row padded by
    8 bf16 (N rounded up to 16, P up to 16, 32, 64 or 128), then cum and the
    decays in float32."""
    lpad = 64 * math.ceil(l / 64)
    pw = next(w for w in (16, 32, 64, 128) if p <= w)
    if dtype == torch.bfloat16:
        ldn = 16 * math.ceil(n / 16) + 8
        return {"bs": 2 * 2 * 64 * ldn, "xs": 2 * 2 * 64 * (pw + 8), "cs": 2 * 64 * ldn,
                "cum": 4 * lpad, "wdec": 4 * lpad}
    n4 = 4 * math.ceil(n / 4)
    ldn = n4 if n4 % 8 else n4 + 4

    def layout(stages):
        return {"bs": 4 * stages * 64 * ldn, "xs": 4 * stages * 64 * pw, "cs": 4 * 64 * ldn,
                "ss": 4 * 64 * 68, "cum": 4 * lpad, "wdec": 4 * lpad}

    two = layout(2)
    return two if sum(two.values()) <= 115712 else layout(1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l, p, n", [(256, 64, 128), (256, 64, 16), (37, 20, 5), (1, 1, 1), (128, 64, 64)])
def test_ssd_smem_bytes_is_the_kernel_layout(l, p, n, dtype):
    assert ssd.smem_bytes(l, p, n, dtype) == sum(_ssd_layout(l, p, n, dtype).values())
    # float32 keeps two stages unless they would keep a second block off the SM
    assert ssd.f32_stages(l, p, n) == (1 if (l, p, n) == (256, 64, 128) else 2)


def test_ssd_published_chunks_launch_and_the_limit_is_named():
    """With B and x walked through a ring of 64-row tiles, Mamba2-2.7b's
    chunk needs 103,424 B in float32 (one stage, so that two blocks share
    an SM) and 72,704 in bfloat16 (220,416 while each warp staged its rows
    of C beside all of x and B), Jamba's 67,584 and 29,696 (91,392): no
    published config nears the 227 KB limit, and both launch in both
    routes.  At L 256, P 64 the largest state that launches is N = 380 in
    float32 and 544 in bfloat16; at P = 128, 348 and 496."""
    need = {}
    for arch, make in archs.FULL.items():
        cfg = make()
        if cfg.ssm_state:
            need[arch] = tuple(ssd.smem_bytes(cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state, dt)
                               for dt in (torch.float32, torch.bfloat16))
    assert need == {"mamba2-2.7b": (103424, 72704), "jamba-v0.1-52b": (67584, 29696)}
    assert max(max(v) for v in need.values()) <= ssd.MAX_SMEM
    for dt, p, n_max in ((torch.float32, 64, 380), (torch.float32, 128, 348),
                         (torch.bfloat16, 64, 544), (torch.bfloat16, 128, 496)):
        assert ssd.smem_bytes(256, p, n_max, dt) <= ssd.MAX_SMEM < ssd.smem_bytes(256, p, n_max + 1, dt)
    x = torch.randn(1, 1, 256, 128)
    bc = torch.randn(1, 1, 256, 349)
    with pytest.raises(ValueError, match=f"limit of {ssd.MAX_SMEM}"):
        ssd.ssd_chunk(x, -torch.rand(1, 1, 256), bc, bc)
    bc = torch.randn(1, 1, 256, 497, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"limit of {ssd.MAX_SMEM}"):
        ssd.ssd_chunk(x.bfloat16(), -torch.rand(1, 1, 256, dtype=torch.bfloat16), bc, bc)
