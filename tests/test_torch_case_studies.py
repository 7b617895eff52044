"""The port's GRAMSCHM and TTM case studies held against the JAX package.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the JAX package's Pallas kernels (interpret mode), its oracles and
the port.  The ``*_spec`` functions are held against a numpy emulation of the
CUDA kernels' thread-index arithmetic, and their pattern classes against
the reference rungs'.  The CUDA kernels themselves run only on the card:
``test_torch_cuda.py``.
"""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
from repro.core import analyze as ref_analyze
from repro.core.diff import diff as ref_diff
from repro.core.patterns import detect_all as ref_detect_all
from repro.kernels import gramschm as ref_gs
from repro.kernels import ref as ref_oracles
from repro.kernels import ttm as ref_ttm
from repro_torch import cli
from repro_torch import kernels as kreg
from repro_torch.core.collector import analyze
from repro_torch.core.diff import diff
from repro_torch.core.patterns import (
    FALSE_SHARING, HOT, SCRATCH_ABUSE, STRIDED, detect_all,
)
from repro_torch.core.trace import GridSampler
from repro_torch.kernels import gramschm, ops, ref, ttm

from torch_parity import heat_of_warps

CASE_REFS = ["gramschm:naive", "gramschm:opt", "ttm:scratch", "ttm:fused"]


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


# -- kernel parity: the port on the CPU against Pallas (interpret) and ref.py --


@pytest.mark.parametrize("k", [0, 3, 31])
def test_gramschm_k3_matches_pallas_kernels(k):
    q, a = _rand(0, (64, 32)), _rand(1, (64, 256))
    jq, ja = jnp.asarray(q), jnp.asarray(a)
    oracle = np.asarray(ref_oracles.gramschm_k3_ref(jq, ja, k))
    want = {
        True: np.asarray(ref_gs.gramschm_k3_naive(jq, ja, k, interpret=True)),
        False: np.asarray(ref_gs.gramschm_k3_opt(jq.T, ja, k, interpret=True)),
    }
    for naive, q_or_qt in ((True, q), (False, np.ascontiguousarray(q.T))):
        got = ops.gramschm_k3(torch.from_numpy(q_or_qt), torch.from_numpy(a), k, naive=naive)
        assert got.dtype == torch.float32 and tuple(got.shape) == (256,)
        # as tests/test_kernels.py: float32 sums of 64 products in another order
        np.testing.assert_allclose(got.numpy(), want[naive], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got.numpy(), oracle, atol=1e-4, rtol=1e-4)
    got_ref = ref.gramschm_k3_ref(torch.from_numpy(q), torch.from_numpy(a), k)
    np.testing.assert_allclose(got_ref.numpy(), oracle, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_scratch", [False, True])
@pytest.mark.parametrize("f, nf, r", [(16, 8, 32), (32, 4, 64)])
def test_ttm_matches_pallas_kernels(use_scratch, f, nf, r):
    vals, urows = _rand(0, (f, nf)), _rand(1, (f, nf, r))
    jv, ju = jnp.asarray(vals), jnp.asarray(urows)
    want = np.asarray(ref_ttm.ttm(jv, ju, use_scratch=use_scratch, interpret=True))
    oracle = np.asarray(ref_oracles.ttm_ref(jv, ju))
    got = ops.ttm(torch.from_numpy(vals), torch.from_numpy(urows), use_scratch=use_scratch)
    assert got.dtype == torch.float32 and tuple(got.shape) == (f, r)
    # as tests/test_kernels.py: float32 sums of nf products in another order
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=1e-4)
    got_ref = ref.ttm_ref(torch.from_numpy(vals), torch.from_numpy(urows))
    np.testing.assert_allclose(got_ref.numpy(), oracle, atol=1e-5, rtol=1e-4)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    kreg.reset_launch_counts()
    q, a = torch.randn(8, 4), torch.randn(8, 16)
    torch.testing.assert_close(
        gramschm.gramschm_k3_naive(q, a, 2), gramschm.gramschm_k3_plain(q, a, 2)
    )
    torch.testing.assert_close(
        gramschm.gramschm_k3_opt(q.t().contiguous(), a, 2),
        gramschm.gramschm_k3_plain(q, a, 2),
    )
    vals, urows = torch.randn(4, 3), torch.randn(4, 3, 5)
    for fn in ttm.KERNELS.values():
        torch.testing.assert_close(fn(vals, urows), ttm.ttm_plain(vals, urows))
    for fn in (*gramschm.KERNELS.values(), *ttm.KERNELS.values()):
        assert fn.launches == 0
    assert ref.gramschm_k3_ref is gramschm.gramschm_k3_plain
    assert ref.ttm_ref is ttm.ttm_plain


@pytest.mark.parametrize(
    "q, a, k, exc",
    [
        (torch.randn(4, 4, dtype=torch.float64), torch.randn(4, 4, dtype=torch.float64), 0, TypeError),
        (torch.randn(4, 4, dtype=torch.bfloat16), torch.randn(4, 4), 0, TypeError),
        (torch.randn(4), torch.randn(4, 4), 0, ValueError),
        (torch.randn(5, 5), torch.randn(4, 4), 0, ValueError),
        (torch.randn(4, 4), torch.randn(4, 4), 4, ValueError),
        (torch.randn(4, 4), torch.randn(4, 4), -1, ValueError),
        (torch.randn(4, 4), torch.randn(4, 4), 1.5, TypeError),
        (torch.randn(4, 4), torch.randn(4, 4).t(), 0, ValueError),
        (torch.randn(4, 4, device="meta"), torch.randn(4, 4, device="meta"), 0, ValueError),
        (torch.randn(0, 4), torch.randn(0, 4), 0, ValueError),
        (np.zeros((4, 4), np.float32), torch.randn(4, 4), 0, TypeError),
    ],
)
def test_gramschm_wrappers_reject_what_the_kernels_do_not_take(q, a, k, exc):
    for fn in gramschm.KERNELS.values():
        with pytest.raises(exc):
            fn(q, a, k)


@pytest.mark.parametrize(
    "vals, urows, exc",
    [
        (torch.randn(4, 2, dtype=torch.float64), torch.randn(4, 2, 3, dtype=torch.float64), TypeError),
        (torch.randn(4, 2), torch.randn(4, 2, 3, dtype=torch.bfloat16), TypeError),
        (torch.randn(4), torch.randn(4, 2, 3), ValueError),
        (torch.randn(4, 2), torch.randn(4, 6), ValueError),
        (torch.randn(4, 2), torch.randn(4, 3, 5), ValueError),
        (torch.randn(4, 2), torch.randn(4, 5, 2).transpose(1, 2), ValueError),
        (torch.randn(4, 2, device="meta"), torch.randn(4, 2, 3, device="meta"), ValueError),
        (torch.randn(0, 2), torch.randn(0, 2, 3), ValueError),
        (np.zeros((4, 2), np.float32), torch.randn(4, 2, 3), TypeError),
    ],
)
def test_ttm_wrappers_reject_what_the_kernels_do_not_take(vals, urows, exc):
    for fn in ttm.KERNELS.values():
        with pytest.raises(exc):
            fn(vals, urows)


def test_ttm_scratch_takes_what_fits_in_shared_memory():
    vals = torch.randn(2, 1)
    wide = torch.randn(2, 1, ttm.MAX_SCRATCH_R + 1)
    with pytest.raises(ValueError, match="shared"):
        ttm.ttm_scratch(vals, wide)
    assert ttm.ttm_fused(vals, wide).shape == (2, ttm.MAX_SCRATCH_R + 1)
    fits = torch.randn(2, 1, ttm.MAX_SCRATCH_R)
    torch.testing.assert_close(ttm.ttm_scratch(vals, fits), ttm.ttm_plain(vals, fits))


# -- the specs against an emulation of csrc/gramschm.cu and ttm.cu ------


def _emulate_gramschm(ni, nj, nk, k, transposed):
    """Per-warp flat indices of q (or qT), a and r for the naive kernel: 1-D
    blocks of 256 threads, thread j of the grid on column j."""
    acc = {"q": {}, "a": {}, "r": {}}
    i = np.arange(ni)
    for b in range(math.ceil(nj / 256)):
        for t in range(256):
            j = b * 256 + t
            if j >= nj:
                continue  # returns before touching memory
            warp = (b, t // 32)
            acc["q"].setdefault(warp, []).append(k * ni + i if transposed else i * nk + k)
            acc["a"].setdefault(warp, []).append(i * nj + j)
            acc["r"].setdefault(warp, []).append(np.array([j]))
    return acc


def _emulate_gramschm_opt(ni, nj, k):
    """Per-warp flat indices of qT, a, partials and r for the opt route,
    thread by thread: gramschm_k3_opt_kernel on a (strips, slices) grid of
    256 threads (lane l on columns 4l .. 4l+3 of the 128-column strip, warp
    w on rows (8 slice + w) RPW .. + RPW - 1, lane l loading word row0 + l
    of qT; warp 0 storing the block's row of partials), then
    gramschm_k3_sum_kernel (thread j on column j, every row of partials).
    Every launched warp is a program, whether or not it touches memory."""
    strips, slices, rpw = gramschm.opt_split(ni, nj)
    acc = {"qT": {}, "a": {}, "partials": {}, "r": {}}
    warp_id = 0

    def add(name, idx):
        acc[name].setdefault(warp_id, []).append(np.asarray(idx, np.int64))

    for sl in range(slices):
        for st in range(strips):
            for t in range(256):
                w, lane = divmod(t, 32)
                warp_id = (sl * strips + st) * 8 + w
                for name in acc:
                    add(name, [])
                row0 = (sl * 8 + w) * rpw
                nrows = max(0, min(rpw, ni - row0))
                if lane < nrows:
                    add("qT", [k * ni + row0 + lane])
                for c in range(st * 128 + 4 * lane, st * 128 + 4 * lane + 4):
                    if c >= nj:
                        continue
                    add("a", (row0 + np.arange(nrows)) * nj + c)
                    if w == 0:
                        add("partials", [sl * nj + c])
    base = slices * strips * 8
    for blk in range(math.ceil(nj / 256)):
        for t in range(256):
            warp_id = base + blk * 8 + t // 32
            for name in acc:
                add(name, [])
            j = blk * 256 + t
            if j < nj:
                add("partials", np.arange(slices) * nj + j)
                add("r", [j])
    return acc


def _emulate_ttm(f, nf, r):
    """Per-warp flat indices of vals, Urows, Y and the Y_shr slices for the
    ttm kernels: blocks of (32 lanes on c, 8 warps on fibers)."""
    acc = {"vals": {}, "Urows": {}, "Y": {}, "Y_shr": {}}
    n = np.arange(nf)
    for b in range(math.ceil(f / 8)):
        for w in range(8):
            fib = 8 * b + w
            if fib >= f:
                continue  # returns before touching memory
            for lane in range(32):
                for c in range(lane, r, 32):
                    acc["vals"].setdefault(fib, []).append(fib * nf + n)
                    acc["Urows"].setdefault(fib, []).append((fib * nf + n) * r + c)
                    acc["Y"].setdefault(fib, []).append(np.array([fib * r + c]))
                    # y_shr[w][c] of block b is row fib of the modeled buffer
                    acc["Y_shr"].setdefault(fib, []).append(np.array([fib * r + c]))
    return acc


def _assert_spec_matches(hm, acc, shapes):
    for name, shape in shapes.items():
        tags, wt, st, warps = heat_of_warps(acc[name], shape, 4)
        rh = hm.region(name)
        np.testing.assert_array_equal(rh.tags_array, tags, err_msg=name)
        np.testing.assert_array_equal(rh.word_temps_matrix, wt, err_msg=name)
        np.testing.assert_array_equal(rh.sector_temps_array, st, err_msg=name)
        assert rh.n_programs == warps, name


@pytest.mark.parametrize(
    "ni, nj, nk, k",
    # the last two: NJ % 4 != 0 (scalar loads), and NI not a multiple of a
    # slice (8 x 8 rows), with a strip past NJ's last column
    [(64, 256, 32, 3), (40, 300, 7, 6), (16, 44, 9, 0), (300, 77, 5, 2), (200, 260, 3, 1)],
)
@pytest.mark.parametrize("spec_fn", ["k3_naive_spec", "k3_naive_block_spec", "k3_opt_spec"])
def test_gramschm_spec_matches_kernel_thread_mapping(spec_fn, ni, nj, nk, k):
    transposed = spec_fn == "k3_opt_spec"
    if transposed:
        acc = _emulate_gramschm_opt(ni, nj, k)
        shapes = {"qT": (nk, ni), "a": (ni, nj), "r": (nj,),
                  "partials": (gramschm.opt_split(ni, nj)[1], nj)}
    else:
        acc = _emulate_gramschm(ni, nj, nk, k, transposed)
        shapes = {"q": (ni, nk), "a": (ni, nj), "r": (nj,)}
    hm = analyze(getattr(gramschm, spec_fn)(ni, nj, nk, k=k), GridSampler(None))
    assert sorted(hm.region_names()) == sorted(shapes)
    _assert_spec_matches(hm, acc, shapes)


def test_gramschm_opt_split_depends_on_the_shape_alone():
    """Strips of 128 columns, slices of 8 warps x RPW rows: 1024 blocks at
    4096^3 (~8 on each of 132 SMs), and one block at (1, 1)."""
    assert gramschm.opt_split(4096, 4096) == (32, 32, 16)
    assert gramschm.opt_split(512, 512) == (4, 8, 8)
    assert gramschm.opt_split(1, 1) == (1, 1, 8)
    assert gramschm.opt_split(300, 77) == (1, 5, 8)
    assert gramschm.opt_split(1 << 20, 128)[2] == 32


@pytest.mark.parametrize("f, nf, r", [(16, 8, 32), (13, 3, 70), (9, 4, 64), (5, 8, 12)])
@pytest.mark.parametrize("variant", ["scratch", "fused"])
def test_ttm_spec_matches_kernel_thread_mapping(variant, f, nf, r):
    acc = _emulate_ttm(f, nf, r)
    hm = analyze(getattr(ttm, f"ttm_{variant}_spec")(f, nf, r), GridSampler(None))
    shapes = {"vals": (f, nf), "Urows": (f, nf, r), "Y": (f, r)}
    if variant == "scratch":
        shapes["Y_shr"] = (f, r)
        assert hm.region("Y_shr").region.space == "vmem_scratch"
    else:
        assert "Y_shr" not in hm.region_names()
    _assert_spec_matches(hm, acc, shapes)


# -- story parity: the H100 rungs flag the reference rungs' pattern classes ------


def _classes(hm):
    return {(r.region, r.pattern) for r in detect_all(hm)}


def _port_heatmap(ref_name):
    spec, ctx = kreg.build(ref_name)
    return analyze(spec, GridSampler(None), ctx)


def _ref_heatmap(ref_name):
    entry = rk.get(ref_name.partition(":")[0])
    spec, ctx = rk.build(ref_name)
    return ref_analyze(spec, sampler=entry.sampler(), dynamic_context=ctx)


def _ref_classes(ref_name):
    return {(r.region, r.pattern) for r in ref_detect_all(_ref_heatmap(ref_name))}


@pytest.mark.parametrize("ref_name", CASE_REFS)
def test_h100_pattern_classes_match_reference(ref_name):
    assert _classes(_port_heatmap(ref_name)) == _ref_classes(ref_name)


def test_h100_pattern_classes_per_rung():
    assert _classes(_port_heatmap("gramschm:naive")) == {("q", STRIDED)}
    assert _classes(_port_heatmap("gramschm:opt")) == {("qT", HOT)}
    assert _classes(_port_heatmap("ttm:scratch")) == {("Y_shr", SCRATCH_ABUSE)}
    assert _classes(_port_heatmap("ttm:fused")) == set()


def test_cuszp_pattern_classes_diverge_from_reference():
    """Recorded divergence: an int8 TPU tile is (32, 128), so four 1024-byte
    program blocks of cmp_bytes share a tile (false sharing); a warp's
    1024 bytes are 32 whole 32 B sectors, shared with no other warp."""
    port = _classes(_port_heatmap("cuszp:like"))
    assert port == {("base_idx", SCRATCH_ABUSE), ("exel_sum", SCRATCH_ABUSE)}
    assert _ref_classes("cuszp:like") == port | {("cmp_bytes", FALSE_SHARING)}


@pytest.mark.parametrize(
    "family, before, after, tx, verdict",
    [
        ("gramschm", "naive", "opt", (41024, 34112), "improved"),
        ("ttm", "scratch", "fused", (18944, 18944), "unchanged"),
    ],
)
def test_story_parity_diff(family, before, after, tx, verdict):
    entry = kreg.get(family)
    rmap = dict(entry.region_map)
    d = diff(
        _port_heatmap(f"{family}:{before}"), _port_heatmap(f"{family}:{after}"), rmap
    )
    want = ref_diff(
        _ref_heatmap(f"{family}:{before}"), _ref_heatmap(f"{family}:{after}"), rmap
    )
    assert (d.fixed, d.introduced, d.persisting) == (
        want.fixed, want.introduced, want.persisting
    )
    assert (d.tx_before, d.tx_after) == tx
    assert d.verdict == verdict
    assert (d.verdict == "improved") == (want.tx_after < want.tx_before)


# -- the registry ------------------------------------------------------------------


def test_registry_semantics():
    assert kreg.names() == (
        "gemm", "spmv", "histogram", "gramschm", "ttm", "cuszp", "flash", "gmm", "ssd",
        "ragged_flash", "paged_attn",
    )
    entry, variant = kreg.resolve("gramschm")
    assert variant.name == "naive" and variant.role == "baseline"
    assert [v.name for _, v in entry.ladder()] == ["opt"]
    assert entry.region_map == (("q", "qT"),)
    assert variant.kernel is gramschm.gramschm_k3_naive
    assert kreg.resolve("gramschm:opt")[1].kernel is gramschm.gramschm_k3_opt
    assert variant.kwargs == (("k", kreg.GRAMSCHM_K),)
    spec, ctx = kreg.build("gramschm:naive")
    assert spec.grid == (16,) and ctx is None
    entry, variant = kreg.resolve("ttm")
    assert variant.name == "scratch" and [v.name for _, v in entry.ladder()] == ["fused"]
    assert kreg.resolve("ttm:fused")[1].kernel is ttm.ttm_fused
    assert kreg.build("ttm:fused")[0].grid == (512,)
    entry, variant = kreg.resolve("cuszp")
    assert entry.variant_names() == ("like",) and entry.ladder() == ()
    assert (variant.kernel, variant.plain, variant.inputs) == (None, None, None)
    assert kreg.build("cuszp")[0].name == "cuszp_compress_like"
    with pytest.raises(ValueError, match="no kernel"):
        kreg.run_variant(variant, device="cpu")


@pytest.mark.parametrize("ref_name", CASE_REFS)
def test_run_variant_on_cpu_runs_the_plain_version(ref_name):
    variant = kreg.resolve(ref_name)[1]
    run = kreg.run_variant(variant, device="cpu")
    family = ref_name.partition(":")[0]
    shapes = (
        [[512, 512], [512, 512]] if family == "gramschm" else [[512, 8], [512, 8, 32]]
    )
    want = {
        "device": "cpu", "shapes": shapes, "dtype": "float32",
        "max_abs_err": 0.0, "ms": None, "device_ms": None, "launches": 0,
    }
    if family == "gramschm":
        want["kwargs"] = {"k": 3}
    assert run == want


def test_run_variant_hands_the_integer_k_to_kernel_and_plain():
    import dataclasses

    seen = []

    def kernel(q, a, k):
        seen.append(("kernel", k))
        return gramschm.gramschm_k3_plain(q, a, k)

    def plain(q, a, k):
        seen.append(("plain", k))
        return gramschm.gramschm_k3_plain(q, a, k)

    variant = dataclasses.replace(
        kreg.resolve("gramschm:naive")[1], kernel=kernel, plain=plain,
        kwargs=(("k", 7),),
    )
    run = kreg.run_variant(variant, device="cpu")
    assert seen == [("plain", 7), ("kernel", 7)] and run["kwargs"] == {"k": 7}
    bad = dataclasses.replace(
        variant, kernel=lambda q, a, k: gramschm.gramschm_k3_plain(q, a, k + 1)
    )
    with pytest.raises(kreg.KernelMismatch, match="exceeds"):
        kreg.run_variant(bad, device="cpu")


# -- python -m repro_torch.cli on the CPU -----------------------------------------


@pytest.mark.parametrize(
    "family, lines",
    [
        (
            "gramschm",
            ["[ improved] gramschm: transfers 41024 -> 34112 (1.20x)",
             "[fixed] strided on q", "[INTRODUCED] hot on q"],
        ),
        (
            "ttm",
            ["[unchanged] ttm: transfers 18944 -> 18944 (1.00x)",
             "[fixed] scratch-abuse on Y_shr"],
        ),
    ],
)
def test_cli_profile_then_diff_shows_the_fix(family, lines, tmp_path, capsys):
    sess = tmp_path / "sess"
    for variant in kreg.get(family).variant_names():
        argv = ["profile", "-k", f"{family}:{variant}", "--device", "cpu", "-q"]
        assert cli.main([*argv, "--out", str(sess)]) == 0
    capsys.readouterr()
    assert cli.main(["diff", str(sess / "iter0"), str(sess / "iter1")]) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out
    manifest = json.loads((sess / "iter0" / "manifest.json").read_text())
    (entry,) = manifest["kernels"]
    assert entry["name"] == family and entry["run"]["launches"] == 0
    assert entry["run"]["device"] == "cpu"
    assert cli.main(["report", str(sess / "iter1")]) == 0


def test_cli_profiles_the_spec_only_cuszp(tmp_path):
    sess = tmp_path / "sess"
    assert cli.main(["profile", "-k", "cuszp", "--device", "cpu", "-q", "--out", str(sess)]) == 0
    (entry,) = json.loads((sess / "iter0" / "manifest.json").read_text())["kernels"]
    assert entry["name"] == "cuszp" and "run" not in entry
    assert {p["pattern"] for p in entry["patterns"]} == {SCRATCH_ABUSE}
