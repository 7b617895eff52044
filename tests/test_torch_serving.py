"""The port's serving families (ragged_flash, paged_attn) held against the
JAX package: the plain versions against the Pallas kernels (interpret mode)
and the jnp references, the seeded contexts, the empty-range answers, the
registry, the engine on the reference's specs, the port's own H100 specs
against an emulation of csrc/ragged_decode.cu and csrc/paged_decode.cu,
the pattern classes, and profile -> diff -> report on the CPU.  The cases
that need the card are in test_torch_cuda.py."""

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
from repro.core.session import profile_kernel as ref_profile_kernel
from repro.kernels import paged_attn as ref_pa
from repro.kernels import ragged_flash as ref_rf
from repro_torch import cli
from repro_torch import kernels as kreg
from repro_torch.core.collector import analyze
from repro_torch.core.diff import diff
from repro_torch.core.patterns import FALSE_SHARING, HOT, detect_all
from repro_torch.core.session import heatmaps_equal, profile_kernel
from repro_torch.core.trace import GridSampler
from repro_torch.kernels import flash, ops, paged_attn, ragged_flash, ref

from torch_parity import assert_heatmaps_match, heat_of_warps, to_port_spec

RAGGED_REFS = ("ragged_flash:decode", "ragged_flash:decode-ragged",
               "ragged_flash:prefill", "ragged_flash:prefill-ragged")
PAGED_REFS = ("paged_attn:decode", "paged_attn:decode-paged",
              "paged_attn:prefill", "paged_attn:prefill-paged")
SERVING_REFS = RAGGED_REFS + PAGED_REFS


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


# -- numerics: the plain versions against Pallas (interpret) and the jnp oracles --


@pytest.mark.parametrize("bkv", [32, 64])
def test_ragged_decode_matches_pallas_kernel_and_reference(bkv):
    b, h, s, d = 4, 4, 128, 32
    q, k, v = _rand(0, (b, h, d)), _rand(1, (b, s, d)), _rand(2, (b, s, d))
    ctx = ragged_flash.ragged_context(b, s)
    jargs = [jnp.asarray(a) for a in (q, k, v, ctx["starts"], ctx["ends"])]
    want = np.asarray(ref_rf.ragged_decode_attention(*jargs, bkv=bkv))
    oracle = np.asarray(ref_rf.ragged_decode_reference(*jargs))
    args = [_t(a) for a in (q, k, v, ctx["starts"], ctx["ends"])]
    got = ops.ragged_decode_attention(*args, bkv=bkv)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, d)
    # as tests/test_serving_kernels.py
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(ref.ragged_decode_ref(*args).numpy(), oracle, atol=2e-5, rtol=2e-4)
    dense = ragged_flash.ragged_decode_attention(*args, bkv=bkv, dense=True)
    assert torch.equal(dense, got)


def test_ragged_decode_block_size_invariance():
    # the online-softmax accumulation must not depend on the KV tiling
    b, h, s, d = 2, 4, 128, 32
    q, k, v = (_t(_rand(i, shape)) for i, shape in enumerate(((b, h, d), (b, s, d), (b, s, d))))
    starts = torch.tensor([0, 16], dtype=torch.int32)
    ends = torch.tensor([100, 128], dtype=torch.int32)
    outs = [ragged_flash.ragged_decode_attention(q, k, v, starts, ends, bkv=n)
            for n in ragged_flash.BKV_CHOICES]
    for other in outs[1:]:
        np.testing.assert_allclose(other.numpy(), outs[0].numpy(), atol=2e-5, rtol=2e-4)


def test_ragged_decode_bf16_rounds_as_the_pallas_kernel():
    b, h, s, d = 4, 4, 128, 32
    q, k, v = _rand(0, (b, h, d)), _rand(1, (b, s, d)), _rand(2, (b, s, d))
    ctx = ragged_flash.ragged_context(b, s)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(ref_rf.ragged_decode_attention(
        *jargs, jnp.asarray(ctx["starts"]), jnp.asarray(ctx["ends"]), bkv=32), np.float32)
    got = ragged_flash.ragged_decode_attention(
        *(_t(a, torch.bfloat16) for a in (q, k, v)), _t(ctx["starts"]), _t(ctx["ends"]), bkv=32)
    assert got.dtype == torch.bfloat16
    # bf16 inputs and output: as tests/test_kernels.py's flash bf16 case
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)


def _paged_inputs(b, h, d, pages, slots, page):
    q = _rand(0, (b, h, d))
    k_pages, v_pages = _rand(1, (1, pages, page, d)), _rand(2, (1, pages, page, d))
    ctx = paged_attn.paged_context(b, pages, slots, page)
    return q, k_pages, v_pages, ctx["block_tables"], ctx["context_lens"]


def _split_schedule(q, k, v, starts, ends, bkv, dense, route):
    """The split kernels' arithmetic in torch (csrc/split_decode.cuh): per
    split of ``split_len`` positions, an online softmax in log2 units over
    chunks of the route's rows (a chunk with no live key skipped; rows not
    staged zero, so the dense walk multiplies real V rows by p = 0 where
    the gated one multiplies zeros), p rounded to V's type before P V for
    bfloat16; then the combine over the live splits in split order."""
    b, h, d = q.shape
    s = k.shape[1]
    ch = ragged_flash.SPLIT_CHUNK[route]
    length = ragged_flash.split_len(s, bkv)
    scale = math.log2(math.e) / math.sqrt(d)
    out = torch.zeros((b, h, d), dtype=q.dtype)
    for bi in range(b):
        lo, hi = max(int(starts[bi]), 0), min(int(ends[bi]), s)
        recs = []
        for g0 in range(0, s, length):
            g1 = min(g0 + length, s)
            if max(lo, g0) >= min(hi, g1):
                continue  # the combine reads live splits only
            m = torch.full((h, 1), ragged_flash.NEG_INF)
            l = torch.zeros((h, 1))
            acc = torch.zeros((h, d))
            for c0 in range(g0, g1, ch):
                n = min(ch, g1 - c0)
                pos = torch.arange(c0, c0 + n)
                live = (pos >= lo) & (pos < hi)
                if not live.any():
                    continue
                vt = v[bi, c0:c0 + n].float()
                if not dense:
                    vt = torch.where(live[:, None], vt, torch.zeros(()))
                sc = (q[bi].float() @ k[bi, c0:c0 + n].float().T) * scale
                sc = torch.where(live, sc, torch.full((), ragged_flash.NEG_INF))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.where(live, torch.exp2(sc - m_new), torch.zeros(()))
                corr = torch.exp2(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(v.dtype).float() @ vt
                m = m_new
            recs.append((m, l, acc))
        if not recs:
            continue
        mx = torch.stack([r[0] for r in recs]).amax(0)
        wts = [torch.exp2(r[0] - mx) for r in recs]
        den = sum(w * r[1] for w, r in zip(wts, recs)).clamp_min(1e-30)
        out[bi] = (sum(w * r[2] for w, r in zip(wts, recs)) / den).to(q.dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bkv", [32, 64])
def test_split_schedule_matches_plain_version_and_pallas_kernel(bkv, dtype):
    """The split schedule within tolerance() of the plain version and of the
    Pallas kernel (interpret mode), dense and gated bit-equal, an empty row
    exactly 0: ranges over many splits, inside one, empty, past both ends."""
    b, h, s, d = 5, 4, 640, 32
    q, k, v = _rand(0, (b, h, d)), _rand(1, (b, s, d)), _rand(2, (b, s, d))
    starts = np.asarray([3, 250, 77, -9, 0], np.int32)
    ends = np.asarray([630, 260, 77, 9999, 640], np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = np.asarray(ref_rf.ragged_decode_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(starts), jnp.asarray(ends),
        bkv=bkv), np.float32)
    args = [_t(a, dtype) for a in (q, k, v)] + [_t(starts), _t(ends)]
    route = "float32" if dtype == torch.float32 else "bfloat16"
    gated = _split_schedule(*args, bkv, False, route)
    dense = _split_schedule(*args, bkv, True, route)
    assert gated.dtype == dtype and torch.equal(gated, dense)
    assert not gated[2].any()
    want = ragged_flash.ragged_decode_plain(*args, bkv=bkv).float()
    tol = ragged_flash.tolerance(want, args[0])
    assert bool(((gated.float() - want).abs() <= tol).all())
    # the Pallas kernel's empty-range answer is its tile's mean of V (see
    # test_empty_ragged_range_is_zero_in_the_port_and_bkv_dependent_in_the_reference)
    rows = [0, 1, 3, 4]
    assert bool(((gated.float()[rows] - torch.from_numpy(pallas[rows])).abs() <= tol[rows]).all())


def test_paged_decode_matches_pallas_kernel_and_reference():
    arrays = _paged_inputs(4, 4, 32, 16, 4, 32)
    jargs = [jnp.asarray(a) for a in arrays]
    want = np.asarray(ref_pa.paged_decode_attention(*jargs))
    oracle = np.asarray(ref_pa.paged_decode_reference(*jargs))
    args = [_t(a) for a in arrays]
    got = ops.paged_decode_attention(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(ref.paged_decode_ref(*args).numpy(), oracle, atol=2e-5, rtol=2e-4)
    assert torch.equal(paged_attn.paged_decode_attention(*args, dense=True), got)


def test_paged_decode_table_permutation_invariance():
    # physically relocating pages (and renaming them in the table) must
    # not change the attention output — the defining paged-cache property
    b, h, d, pages, page = 2, 4, 32, 8, 32
    q = _t(_rand(0, (b, h, d)))
    k_pages, v_pages = _t(_rand(1, (1, pages, page, d))), _t(_rand(2, (1, pages, page, d)))
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lens = torch.tensor([48, 64], dtype=torch.int32)
    base = paged_attn.paged_decode_attention(q, k_pages, v_pages, tables, lens)
    perm = np.asarray([5, 3, 7, 0, 2, 6, 1, 4])
    inv = np.argsort(perm)
    moved = paged_attn.paged_decode_attention(
        q, k_pages[:, perm].contiguous(), v_pages[:, perm].contiguous(),
        _t(inv[tables.numpy()].astype(np.int32)), lens,
    )
    np.testing.assert_allclose(base.numpy(), moved.numpy(), atol=2e-5, rtol=2e-4)


def test_paged_dense_sweep_of_the_gathered_cache_equals_the_gather():
    arrays = _paged_inputs(4, 4, 32, 16, 4, 32)
    q, k_pages, v_pages, tables, lens = (_t(a) for a in arrays)
    cache = [p[0][tables.long()].reshape(4, -1, 32) for p in (k_pages, v_pages)]
    (kc, ident), (vc, _) = (paged_attn.contiguous_pages(c, 32) for c in cache)
    assert kc.shape == (1, 16, 32, 32) and ident.tolist()[1] == [4, 5, 6, 7]
    want = paged_attn.paged_decode_attention(q, k_pages, v_pages, tables, lens)
    got = paged_attn.paged_decode_attention(q, kc, vc, ident, lens, dense=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-4)


def test_paged_page_id_out_of_range_adds_nothing():
    q, k_pages, v_pages, tables, lens = (_t(a) for a in _paged_inputs(2, 4, 32, 8, 4, 32))
    tables[0] = torch.tensor([3, 99, 5, 6], dtype=torch.int32)
    lens[:] = 64
    got = paged_attn.paged_decode_attention(q, k_pages, v_pages, tables, lens)
    one = paged_attn.paged_decode_attention(
        q[:1], k_pages, v_pages, tables[:1, :1].contiguous(), torch.tensor([32], dtype=torch.int32))
    np.testing.assert_allclose(got[:1].numpy(), one.numpy(), atol=2e-6, rtol=2e-5)


@pytest.mark.parametrize("b, s", [(4, 512), (4, 128), (2, 128), (64, 8192), (7, 300)])
def test_ragged_context_equals_the_reference(b, s):
    got, want = ragged_flash.ragged_context(b, s), ref_rf.ragged_context(b, s)
    assert sorted(got) == sorted(want) == ["ends", "starts"]
    for name in got:
        assert got[name].dtype == want[name].dtype == np.int32
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize(
    "b, pages, slots, page", [(4, 64, 8, 64), (4, 16, 4, 32), (64, 8192, 128, 64), (3, 20, 5, 16)]
)
def test_paged_context_equals_the_reference(b, pages, slots, page):
    got, want = paged_attn.paged_context(b, pages, slots, page), ref_pa.paged_context(b, pages, slots, page)
    assert sorted(got) == sorted(want) == ["block_tables", "context_lens"]
    for name in got:
        assert got[name].dtype == want[name].dtype == np.int32
        np.testing.assert_array_equal(got[name], want[name])


# -- the empty-range answers (ROADMAP: facts of the reference) --------------------


@pytest.mark.parametrize("bkv", [32, 64])
def test_empty_ragged_range_is_zero_in_the_port_and_bkv_dependent_in_the_reference(bkv):
    """starts == ends: the Pallas kernel's gate still admits the tile that
    holds ``start`` (unless it is a tile boundary), every score there is
    NEG_INF, so it returns the mean of V over that tile; the jnp reference
    the mean over all S; the port 0 in wrapper, plain version and oracle."""
    b, h, s, d = 3, 4, 128, 32
    q, k, v = _rand(0, (b, h, d)), _rand(1, (b, s, d)), _rand(2, (b, s, d))
    starts = np.asarray([40, 0, 5], np.int32)
    ends = np.asarray([40, 0, 100], np.int32)
    jargs = [jnp.asarray(a) for a in (q, k, v, starts, ends)]
    pallas = np.asarray(ref_rf.ragged_decode_attention(*jargs, bkv=bkv))
    oracle = np.asarray(ref_rf.ragged_decode_reference(*jargs))
    tile = 40 // bkv * bkv
    np.testing.assert_allclose(pallas[0], np.broadcast_to(v[0, tile:tile + bkv].mean(0), (h, d)), atol=1e-6)
    np.testing.assert_array_equal(pallas[1], 0)  # start on a boundary: no tile admitted
    np.testing.assert_allclose(oracle[0], np.broadcast_to(v[0].mean(0), (h, d)), atol=1e-6)
    np.testing.assert_allclose(oracle[1], np.broadcast_to(v[1].mean(0), (h, d)), atol=1e-6)
    args = [_t(a) for a in (q, k, v, starts, ends)]
    for got in (ragged_flash.ragged_decode_attention(*args, bkv=bkv),
                ragged_flash.ragged_decode_plain(*args, bkv=bkv, dense=True),
                ref.ragged_decode_ref(*args)):
        assert not got[:2].any()
        np.testing.assert_allclose(got[2].numpy(), oracle[2], atol=2e-5, rtol=2e-4)


def test_empty_paged_context_is_zero_in_the_port_and_the_pallas_kernel():
    q, k_pages, v_pages, tables, lens = _paged_inputs(3, 4, 32, 16, 4, 32)
    lens = lens.copy()
    lens[1] = 0
    jargs = [jnp.asarray(a) for a in (q, k_pages, v_pages, tables, lens)]
    pallas = np.asarray(ref_pa.paged_decode_attention(*jargs))
    oracle = np.asarray(ref_pa.paged_decode_reference(*jargs))
    np.testing.assert_array_equal(pallas[1], 0)
    gathered = v_pages[0][tables[1]].reshape(-1, 32)
    np.testing.assert_allclose(oracle[1], np.broadcast_to(gathered.mean(0), (4, 32)), atol=1e-6)
    args = [_t(a) for a in (q, k_pages, v_pages, tables, lens)]
    for got in (paged_attn.paged_decode_attention(*args), ref.paged_decode_ref(*args)):
        assert not got[1].any()
        np.testing.assert_allclose(got.numpy()[[0, 2]], pallas[[0, 2]], atol=2e-5, rtol=2e-4)


# -- wrappers ------------------------------------------------------------------


def _ragged_args(b=2, h=4, s=64, d=32):
    return (torch.randn(b, h, d), torch.randn(b, s, d), torch.randn(b, s, d),
            torch.zeros(b, dtype=torch.int32), torch.full((b,), s, dtype=torch.int32))


def _paged_args(b=2, h=4, d=32, pages=8, page=16, slots=4):
    return (torch.randn(b, h, d), torch.randn(1, pages, page, d), torch.randn(1, pages, page, d),
            torch.zeros(b, slots, dtype=torch.int32), torch.full((b,), 20, dtype=torch.int32))


def _replace(args, i, value):
    return args[:i] + (value,) + args[i + 1:]


@pytest.mark.parametrize(
    "fn, args, kwargs, match",
    [
        (ragged_flash.ragged_decode_attention, _ragged_args(), {"bkv": 48}, "bkv"),
        (ragged_flash.ragged_decode_attention, _ragged_args(h=65), {}, "h <= 64"),
        (ragged_flash.ragged_decode_attention, _ragged_args(d=130), {}, "d <= 128"),
        (ragged_flash.ragged_decode_attention, _replace(_ragged_args(), 1, torch.randn(2, 60, 32)), {}, "k, v"),
        (ragged_flash.ragged_decode_attention, _replace(_ragged_args(), 3, torch.zeros(2)), {}, "int32"),
        (ragged_flash.ragged_decode_attention, _replace(_ragged_args(), 4, torch.zeros(3, dtype=torch.int32)), {}, "shape"),
        (ragged_flash.ragged_decode_attention, _replace(_ragged_args(), 0, torch.randn(2, 4, 32).double()), {}, "one dtype"),
        (ragged_flash.ragged_decode_attention, _replace(_ragged_args(), 1, torch.randn(2, 32, 64).transpose(1, 2)), {}, "contiguous"),
        (paged_attn.paged_decode_attention, _paged_args(page=130), {}, "page <= 128"),
        (paged_attn.paged_decode_attention, _paged_args(h=70), {}, "h <= 64"),
        (paged_attn.paged_decode_attention, _replace(_paged_args(), 1, torch.randn(2, 8, 16, 32)), {}, "k_pages"),
        (paged_attn.paged_decode_attention, _replace(_paged_args(), 3, torch.zeros(2, 4)), {}, "block_tables"),
        (paged_attn.paged_decode_attention, _replace(_paged_args(), 4, torch.zeros(2)), {}, "context_lens"),
        (paged_attn.paged_decode_attention, _replace(_paged_args(), 0, torch.randn(2, 4, 16)), {}, "k_pages"),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(fn, args, kwargs, match):
    with pytest.raises((ValueError, TypeError), match=match):
        fn(*args, **kwargs)


def test_no_cpu_call_counts_a_launch_and_reset_reaches_both():
    ragged_flash.ragged_decode_attention.launches = 5
    paged_attn.paged_decode_attention.launches = 7
    kreg.reset_launch_counts()
    ragged_flash.ragged_decode_attention(*_ragged_args())
    paged_attn.paged_decode_attention(*_paged_args())
    ops.ragged_decode_attention(*_ragged_args(), dense=True)
    ops.paged_decode_attention(*_paged_args(), dense=True)
    assert ragged_flash.ragged_decode_attention.launches == paged_attn.paged_decode_attention.launches == 0
    assert ragged_flash.KERNELS == {"ragged_decode": ragged_flash.ragged_decode_attention}
    assert paged_attn.KERNELS == {"paged_decode": paged_attn.paged_decode_attention}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_follows_each_row(dtype):
    """A share of each (sequence, head) row's largest |O|: the exact answer
    rounded to the type passes it, an output off by 2% of a small row
    fails it, and an empty row must be exactly 0."""
    b, h, s, d = 4, 8, 256, 64
    args = [_t(_rand(i, shape), dtype) for i, shape in enumerate(((b, h, d), (b, s, d), (b, s, d)))]
    args += [torch.tensor([0, 0, 10, 7], dtype=torch.int32), torch.tensor([256, 3, 200, 7], dtype=torch.int32)]
    want = ragged_flash.ragged_decode_plain(*args).float()
    tol = ragged_flash.tolerance(want, args[0])
    exact = ref.ragged_decode_ref(*(a.double() if a.is_floating_point() else a for a in args)).to(dtype).float()
    assert bool(((exact - want).abs() <= tol).all())
    share = 2e-5 if dtype == torch.float32 else 2e-2
    wrong = want.clone()
    wrong[1] *= 1 + 2 * share
    assert not bool(((wrong - want).abs() <= tol).all())
    assert not want[3].any() and not tol[3].any()
    assert paged_attn.tolerance is ragged_flash.tolerance


# -- the registry ----------------------------------------------------------------


def test_serving_families_are_registered_as_the_reference():
    names = kreg.names()
    assert names[-2:] == ("ragged_flash", "paged_attn")
    for family in ("ragged_flash", "paged_attn"):
        got, want = kreg.get(family), rk.get(family)
        assert got.summary == want.summary
        assert got.variant_names() == want.variant_names()
        assert [v.role for v in got.variants] == [v.role for v in want.variants] == [
            "baseline", "optimized", "baseline", "optimized"
        ]
        assert [v.note for v in got.variants] == [v.note for v in want.variants]
        # the ladder proposes only the optimized rungs
        assert [v.name for _pos, v in got.ladder(0)] == [v.name for _pos, v in want.ladder(0)]
        assert all("-" in v.name for _pos, v in got.ladder(0))


def test_decode_rungs_launch_and_prefill_rungs_are_spec_only():
    kernels = {"ragged_flash": ragged_flash.ragged_decode_attention,
               "paged_attn": paged_attn.paged_decode_attention}
    for ref_name in SERVING_REFS:
        family, _, rung = ref_name.partition(":")
        variant = kreg.resolve(ref_name)[1]
        if rung.startswith("prefill"):
            assert (variant.kernel, variant.plain, variant.inputs) == (None, None, None)
            continue
        assert variant.kernel is kernels[family]
        assert callable(variant.atol)
        assert (("dense", True) in variant.kwargs) == (rung == "decode")


@pytest.mark.parametrize("ref_name", SERVING_REFS)
def test_serving_specs_build_and_trace_with_their_scalar_operands(ref_name):
    spec, ctx = kreg.build(ref_name)
    assert ctx is not None  # every serving variant carries its context
    pk = profile_kernel(spec, None, ctx, name=ref_name)
    assert pk.transactions > 0
    regions = {r.region.name for r in pk.heatmap.regions}
    scalars = {"starts", "ends"} if ref_name.startswith("ragged") else {"block_tables", "context_lens"}
    assert scalars <= regions


def test_decode_inputs_are_the_profiled_context():
    for ref_name, names in (("ragged_flash:decode", ("starts", "ends")),
                            ("ragged_flash:decode-ragged", ("starts", "ends")),
                            ("paged_attn:decode-paged", ("block_tables", "context_lens"))):
        variant = kreg.resolve(ref_name)[1]
        args = variant.inputs(torch.device("cpu"), torch.Generator().manual_seed(3))
        ctx = variant.dynamic_context()
        for tensor, name in zip(args[-2:], names):
            assert tensor.dtype == torch.int32
            np.testing.assert_array_equal(tensor.numpy(), ctx[name])
    q, kp, vp, tables, lens = kreg.resolve("paged_attn:decode")[1].inputs(
        torch.device("cpu"), torch.Generator().manual_seed(3))
    assert kp.shape == (1, 32, 64, 128)  # B * slots pages: the contiguous cache
    np.testing.assert_array_equal(tables.numpy(), np.arange(32).reshape(4, 8))
    np.testing.assert_array_equal(lens.numpy(), paged_attn.paged_context()["context_lens"])


@pytest.mark.parametrize("ref_name", [r for r in SERVING_REFS if ":decode" in r])
def test_run_variant_on_cpu_runs_the_plain_version(ref_name):
    kreg.reset_launch_counts()
    run = kreg.run_variant(kreg.resolve(ref_name)[1], device="cpu")
    assert run["device"] == "cpu" and run["ms"] is None and run["launches"] == 0
    assert run["max_abs_err"] == 0.0 and run["dtype"] == "float32"


# -- engine parity: the reference's specs under TPUTile ------------------------------


PINNED_REF = {
    ("ragged_flash:decode", "ragged_flash:decode-ragged"): (576, 154),
    ("ragged_flash:prefill", "ragged_flash:prefill-ragged"): (4224, 2522),
    ("paged_attn:decode", "paged_attn:decode-paged"): (640, 288),
    ("paged_attn:prefill", "paged_attn:prefill-paged"): (6400, 4944),
}


@pytest.mark.parametrize("pair", list(PINNED_REF))
def test_engine_parity_on_reference_serving_specs(pair):
    """The port's engine on the reference's specs (TPUTile) profiles what
    repro profiles, array for array, and keeps its pinned transfers."""
    got = []
    for ref_name in pair:
        spec, ctx = rk.build(ref_name)
        want = ref_profile_kernel(spec, None, ctx, name=ref_name)
        pk = profile_kernel(to_port_spec(spec), None, ctx, name=ref_name)
        assert_heatmaps_match(pk.heatmap, want.heatmap)
        assert pk.transactions == want.transactions
        got.append(pk.transactions)
    assert tuple(got) == PINNED_REF[pair]


# -- the port's own specs under H100Sector -------------------------------------------


PINNED_PORT = {
    ("ragged_flash:decode", "ragged_flash:decode-ragged"): (68824, 13104),
    # prefill: a 4-warp block of flash.cu's float32 route reads its
    # sequence's bounds once a warp (a block of 8 warps read 256 more each)
    ("ragged_flash:prefill", "ragged_flash:prefill-ragged"): (393472, 149440),
    ("paged_attn:decode", "paged_attn:decode-paged"): (71244, 23464),
    ("paged_attn:prefill", "paged_attn:prefill-paged"): (360704, 208704),
}


def _transactions(ref_name):
    spec, ctx = kreg.build(ref_name)
    return profile_kernel(spec, None, ctx, name=ref_name).transactions


@pytest.mark.parametrize("pair", list(PINNED_PORT))
def test_gated_rungs_are_strictly_cheaper_under_h100_sectors(pair):
    tx = tuple(_transactions(r) for r in pair)
    assert tx == PINNED_PORT[pair]
    assert tx[1] < tx[0]


def test_registry_dense_decode_reads_every_sector_of_the_cache():
    # 4 x 512 x 128 float32 K and V are 65,536 sectors; a sequence's 128 of Q
    # are staged by every walked split and O's 512 stored once; a split's workspace record,
    # 8 x 130 floats, is 130 sectors, stored by every walked split and read by
    # the combine for every live one; each of the 4 x (2 + 1) x 8 warps reads
    # one sector of starts and one of ends
    b, h, s, d, bkv = 4, 8, 512, 128, 128
    length = ragged_flash.split_len(s, bkv)
    assert (length, ragged_flash.n_splits(s, bkv)) == (256, 2)
    ctx = ragged_flash.ragged_context()
    live_splits = int(((ctx["ends"] - 1) // length - ctx["starts"] // length + 1).sum())
    live = int((ctx["ends"] - ctx["starts"]).sum())
    bounds = 2 * b * (2 + 1) * 8
    dense, gated = PINNED_PORT[("ragged_flash:decode", "ragged_flash:decode-ragged")]
    assert dense == 65536 + 128 * b * 2 + 512 + 130 * (b * 2 + live_splits) + bounds
    assert gated == 2 * 16 * live + 128 * live_splits + 512 + 130 * 2 * live_splits + bounds


@pytest.mark.parametrize("ref_name", ["ragged_flash:decode-ragged", "paged_attn:decode-paged",
                                      "ragged_flash:prefill-ragged", "paged_attn:prefill-paged"])
def test_serving_traces_are_deterministic(ref_name):
    spec, ctx = kreg.build(ref_name)
    a = profile_kernel(spec, None, ctx)
    spec, ctx = kreg.build(ref_name)
    b = profile_kernel(spec, None, ctx)
    assert heatmaps_equal(a.heatmap, b.heatmap)


def _add(acc, name, key, idx):
    acc[name].setdefault(key, []).append(np.asarray(idx, np.int64))


def _emulate_ragged(b, h, s, d, bkv, starts, ends, dense, route="float32"):
    """Per-warp flat indices of every operand of csrc/ragged_decode.cu,
    thread by thread: the split kernel's (splits, B) blocks (SplitWalk,
    run_split and the route's stage_f32 / stage_bf16 in split_decode.cuh),
    then split_combine_kernel's (Y, B) blocks of the same threads.  Warp
    (b, j, w) is warp w of split j's block, or of combine block j - G."""
    threads = ragged_flash.SPLIT_THREADS[route]
    ch = ragged_flash.SPLIT_CHUNK[route]
    elems, per_row = (8, flash.padded_d(d) // 8) if route == "bfloat16" else (4, -(-d // 4))
    length = ragged_flash.split_len(s, bkv)
    g_n = -(-s // length)
    hd, rec = h * d, h * (d + 2)
    y_n = -(-hd // (4 * threads))
    acc = {n: {} for n in ("Q", "K", "V", "starts", "ends", "ws", "O")}

    def stage(key, name, first_row, tile_rows, r_lo, r_hi, t):
        for i in range(t, tile_rows * per_row, threads):
            r, col = i // per_row, (i % per_row) * elems
            if r_lo <= r < r_hi and col < d:
                _add(acc, name, key, (first_row + r) * d + np.arange(col, min(col + elems, d)))

    for bi in range(b):
        lo, hi = max(int(starts[bi]), 0), min(int(ends[bi]), s)
        for g in range(g_n):
            g0, g1 = g * length, min((g + 1) * length, s)
            live = max(lo, g0) < min(hi, g1)
            if dense:
                chunks = range(-(-(g1 - g0) // ch))
            elif live:
                chunks = range((max(lo, g0) - g0) // ch, (min(hi, g1) - 1 - g0) // ch + 1)
            for t in range(threads):
                key = (bi, g, t // 32)
                for name in acc:
                    _add(acc, name, key, [])
                _add(acc, "starts", key, [bi])
                _add(acc, "ends", key, [bi])
                if not (dense or live):
                    continue  # returns after reading the bounds
                mp = -(-h // 16) * 16 if route == "bfloat16" else h
                stage(key, "Q", bi * h, mp, 0, h, t)
                for j in chunks:
                    c0 = g0 + j * ch
                    n = min(ch, g1 - c0)
                    r_lo, r_hi = (0, n) if dense else (max(lo - c0, 0), min(hi - c0, n))
                    for name in ("K", "V"):
                        stage(key, name, bi * s + c0, ch, r_lo, r_hi, t)
                _add(acc, "ws", key, (bi * g_n + g) * rec + np.arange(t, rec, threads))
        first = lo // length if lo < hi else 0
        nlive = (hi - 1) // length - first + 1 if lo < hi else 0
        recs = (bi * g_n + first + np.arange(nlive)) * rec
        for y in range(y_n):
            for t in range(threads):
                key = (bi, g_n + y, t // 32)
                for name in acc:
                    _add(acc, name, key, [])
                _add(acc, "starts", key, [bi])
                _add(acc, "ends", key, [bi])
                f = np.arange(t, nlive * 2 * h, threads)
                _add(acc, "ws", key, recs[f // (2 * h)] + hd + f % (2 * h))
                for u in range(4):
                    e = (4 * y + u) * threads + t
                    if e < hd:
                        _add(acc, "ws", key, recs + e)
                        _add(acc, "O", key, [bi * hd + e])
    return acc


def _emulate_paged(b, h, d, pages, page, slots, tables, lens, dense, route="float32"):
    """Per-warp flat indices of every operand of csrc/paged_decode.cu, thread
    by thread: the split kernel's (splits, B) blocks over the logical
    positions [0, slots * page) (SplitWalk over [0, ctx), run_split with
    PagedRows in split_decode.cuh: a thread reads the table entry of each
    row it stages, and the row's chunks when its page id lies in [0,
    pages); lane l of every warp reads the entries of the live rows l and
    l + 32 of each chunk it computes, for the presence mask), then
    split_combine_kernel's (Y, B) blocks with a null starts.  Warp (b, j, w)
    is warp w of split j's block, or of combine block j - G."""
    threads = ragged_flash.SPLIT_THREADS[route]
    ch = ragged_flash.SPLIT_CHUNK[route]
    elems, per_row = (8, flash.padded_d(d) // 8) if route == "bfloat16" else (4, -(-d // 4))
    s = slots * page
    length = ragged_flash.split_len(s, page)
    g_n = -(-s // length)
    hd, rec = h * d, h * (d + 2)
    y_n = -(-hd // (4 * threads))
    names = ("Q", "Kcache", "Vcache", "block_tables", "context_lens", "ws", "O")
    acc = {n: {} for n in names}

    def row(bi, p):
        """PagedRows::row: the slot of position p, and its pool row or -1."""
        slot = p // page
        phys = int(tables[bi][slot])
        return slot, phys * page + p - slot * page if 0 <= phys < pages else -1

    for bi in range(b):
        lo, hi = 0, min(int(lens[bi]), s)
        for g in range(g_n):
            g0, g1 = g * length, min((g + 1) * length, s)
            a, z = max(lo, g0), min(hi, g1)
            live = a < z
            if dense:
                chunks = range(-(-(g1 - g0) // ch))
            else:
                chunks = range((a - g0) // ch, (z - 1 - g0) // ch + 1) if live else range(0)
            for t in range(threads):
                key = (bi, g, t // 32)
                for name in names:
                    _add(acc, name, key, [])
                _add(acc, "context_lens", key, [bi])
                if not (dense or live):
                    continue  # returns after reading the length
                for i in range(t, h * per_row, threads):
                    col = (i % per_row) * elems
                    if col < d:
                        _add(acc, "Q", key, (bi * h + i // per_row) * d + np.arange(col, min(col + elems, d)))
                for j in chunks:
                    c0 = g0 + j * ch
                    n = min(ch, g1 - c0)
                    l_lo, l_hi = max(lo - c0, 0), min(hi - c0, n)
                    r_lo, r_hi = (0, n) if dense else (l_lo, l_hi)
                    for i in range(t, ch * per_row, threads):
                        r, col = i // per_row, (i % per_row) * elems
                        if not r_lo <= r < r_hi:
                            continue
                        slot, off = row(bi, c0 + r)
                        _add(acc, "block_tables", key, [bi * slots + slot])
                        if off >= 0 and col < d:
                            for name in ("Kcache", "Vcache"):
                                _add(acc, name, key, off * d + np.arange(col, min(col + elems, d)))
                    if l_lo < l_hi:  # computed: the presence mask
                        for half in range(ch // 32):
                            r = 32 * half + t % 32
                            if l_lo <= r < l_hi:
                                _add(acc, "block_tables", key, [bi * slots + row(bi, c0 + r)[0]])
                _add(acc, "ws", key, (bi * g_n + g) * rec + np.arange(t, rec, threads))
        first = lo // length if lo < hi else 0
        nlive = (hi - 1) // length - first + 1 if lo < hi else 0
        recs = (bi * g_n + first + np.arange(nlive)) * rec
        for y in range(y_n):
            for t in range(threads):
                key = (bi, g_n + y, t // 32)
                for name in names:
                    _add(acc, name, key, [])
                _add(acc, "context_lens", key, [bi])
                f = np.arange(t, nlive * 2 * h, threads)
                _add(acc, "ws", key, recs[f // (2 * h)] + hd + f % (2 * h))
                for u in range(4):
                    e = (4 * y + u) * threads + t
                    if e < hd:
                        _add(acc, "ws", key, recs + e)
                        _add(acc, "O", key, [bi * hd + e])
    return acc


def _emulate_prefill(b, sq, s, d, kv_chunks):
    """Per-warp flat indices of a flash.cu-shaped prefill (its float32
    route): blocks of 128 threads per (64-query tile, sequence), warp w
    staging and storing query rows ``16w .. 16w+15``.  ``kv_chunks(bi,
    qt)`` lists the (first flat row, n rows, staged rows) of each KV chunk
    the block walks; warp w stages its rows ``w*ceil(n/4) ..`` of each,
    when staged."""
    acc = {n: {} for n in ("Q", "K", "V", "O")}
    for bi in range(b):
        for qt in range(math.ceil(sq / 64)):
            chunks = kv_chunks(bi, qt)
            for tid in range(128):
                w, lane = divmod(tid, 32)
                key = (bi, qt, w)
                for name in acc:
                    _add(acc, name, key, [])
                cols = np.arange(lane, d, 32)
                for r in range(16):
                    gq = qt * 64 + 16 * w + r
                    if gq < sq:
                        _add(acc, "Q", key, (bi * sq + gq) * d + cols)
                        _add(acc, "O", key, (bi * sq + gq) * d + cols)
                for row0, n, staged in chunks:
                    rpw = -(-n // 4)
                    for r in range(w * rpw, min((w + 1) * rpw, n)):
                        if staged(r):
                            _add(acc, "K", key, (row0 + r) * d + cols)
                            _add(acc, "V", key, (row0 + r) * d + cols)
    return acc


def _assert_spec_matches(spec, ctx, acc, shapes, renames=(), itemsizes=None):
    hm = analyze(spec, GridSampler(None), ctx)
    names = dict(renames)
    assert sorted(hm.region_names()) == sorted(names.get(n, n) for n in shapes)
    for name, shape in shapes.items():
        per_warp = {key: [np.concatenate(parts)] for key, parts in acc[name].items()}
        tags, wt, st, warps = heat_of_warps(per_warp, shape, (itemsizes or {}).get(name, 4))
        rh = hm.region(names.get(name, name))
        np.testing.assert_array_equal(rh.tags_array, tags, err_msg=name)
        np.testing.assert_array_equal(rh.word_temps_matrix, wt, err_msg=name)
        np.testing.assert_array_equal(rh.sector_temps_array, st, err_msg=name)
        assert rh.n_programs == warps, name


RAGGED_CASES = [
    # (b, h, s, d, bkv, starts, ends): a partial last tile, a range inside one
    # tile, an empty range, bounds past either end, H not a multiple of 8; a
    # live range over many splits with S not a multiple of the split (64)
    (4, 8, 512, 128, 128, None, None),
    (3, 12, 200, 32, 64, [0, 17, 40], [200, 150, 41]),
    (3, 5, 77, 20, 32, [3, 10, -4], [3, 11, 999]),
    (2, 48, 300, 64, 128, [5, 100], [60, 300]),
    (2, 8, 1000, 32, 32, [10, 0], [900, 1000]),
    (3, 20, 700, 40, 64, [130, 0, 600], [610, 0, 2000]),
]


@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("dense", [True, False])
@pytest.mark.parametrize("b, h, s, d, bkv, starts, ends", RAGGED_CASES)
def test_ragged_decode_spec_matches_kernel_thread_mapping(b, h, s, d, bkv, starts, ends, dense, route):
    if starts is None:
        ctx = ragged_flash.ragged_context(b, s)
    else:
        ctx = {"starts": np.asarray(starts, np.int32), "ends": np.asarray(ends, np.int32)}
    build = ragged_flash.ragged_decode_spec if dense else ragged_flash.ragged_decode_ragged_spec
    acc = _emulate_ragged(b, h, s, d, bkv, ctx["starts"], ctx["ends"], dense, route)
    itemsize = 4 if route == "float32" else 2
    length = ragged_flash.split_len(s, bkv)
    shapes = {"Q": (b, h, d), "K": (b, s, d), "V": (b, s, d), "starts": (b,), "ends": (b,),
              "O": (b, h, d), "ws": (b, -(-s // length), h * (d + 2))}
    spec = build(b, h, s, d, bkv, dtype=getattr(torch, route))
    _assert_spec_matches(spec, ctx, acc, shapes,
                         itemsizes={n: itemsize for n in ("Q", "K", "V", "O")})


def test_split_len_depends_on_s_and_bkv_alone():
    """At least two tiles a split, at most 32 splits a sequence."""
    assert ragged_flash.split_len(8192, 128) == 256 and ragged_flash.n_splits(8192, 128) == 32
    assert ragged_flash.split_len(16384, 128) == 512 and ragged_flash.n_splits(16384, 128) == 32
    assert ragged_flash.split_len(512, 128) == 256 and ragged_flash.n_splits(512, 128) == 2
    assert ragged_flash.split_len(1000, 32) == 64 and ragged_flash.n_splits(1000, 32) == 16
    assert ragged_flash.split_len(77, 32) == 64 and ragged_flash.n_splits(77, 32) == 2
    for s in (1, 31, 4095, 8193, 100000):
        for bkv in ragged_flash.BKV_CHOICES:
            length = ragged_flash.split_len(s, bkv)
            assert length % bkv == 0 and length >= 2 * bkv
            assert ragged_flash.n_splits(s, bkv) <= ragged_flash.MAX_SPLITS


PAGED_CASES = [
    # (b, h, d, pages, page, slots, permute, holes): the registry's shape; a
    # page not a multiple of 8; a permuted table with a page id out of range;
    # pages of 16 (smaller than a chunk), 48 (a chunk crosses pages) and 128
    # (two bf16 chunks); slots [holes) of sequence 0 out of range, so that a
    # live split holds no page of the pool
    (4, 8, 128, 64, 64, 8, False, None),
    (3, 12, 32, 20, 20, 5, True, None),
    (2, 5, 40, 16, 32, 4, True, None),
    (3, 12, 32, 30, 16, 9, True, (0, 2)),
    (2, 6, 40, 12, 48, 5, True, (1, 3)),
    (2, 20, 64, 6, 128, 3, True, None),
]


def _paged_ctx(b, pages, slots, page, permute, holes):
    ctx = paged_attn.paged_context(b, pages, slots, page)
    if permute:
        ctx["block_tables"] = ctx["block_tables"][:, ::-1].copy()
        ctx["block_tables"][0, 0] = pages + 3
        ctx["context_lens"][-1] = slots * page - 1
    if holes is not None:
        ctx["block_tables"][0, holes[0]:holes[1]] = -1
        ctx["context_lens"][0] = slots * page
    return ctx


@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, h, d, pages, page, slots, permute, holes", PAGED_CASES)
def test_paged_decode_paged_spec_matches_kernel_thread_mapping(b, h, d, pages, page, slots, permute,
                                                               holes, route):
    ctx = _paged_ctx(b, pages, slots, page, permute, holes)
    acc = _emulate_paged(b, h, d, pages, page, slots, ctx["block_tables"], ctx["context_lens"],
                         False, route)
    length = ragged_flash.split_len(slots * page, page)
    shapes = {"Q": (b, h, d), "Kcache": (pages, page, d), "Vcache": (pages, page, d),
              "block_tables": (b, slots), "context_lens": (b,), "O": (b, h, d),
              "ws": (b, -(-slots * page // length), h * (d + 2))}
    itemsize = 4 if route == "float32" else 2
    spec = paged_attn.paged_decode_paged_spec(b, h, d, page, pages, slots, dtype=getattr(torch, route))
    _assert_spec_matches(spec, ctx, acc, shapes,
                         itemsizes={n: itemsize for n in ("Q", "Kcache", "Vcache", "O")})


@pytest.mark.parametrize("route", ["float32", "bfloat16"])
@pytest.mark.parametrize("b, h, d, pages, page, slots, permute, holes", PAGED_CASES)
def test_paged_decode_dense_spec_matches_kernel_thread_mapping(b, h, d, pages, page, slots, permute,
                                                               holes, route):
    """The dense rung runs on the contiguous cache under the identity table."""
    ctx = _paged_ctx(b, pages, slots, page, permute, holes)
    ident = np.arange(b * slots).reshape(b, slots)
    acc = _emulate_paged(b, h, d, b * slots, page, slots, ident, ctx["context_lens"], True, route)
    length = ragged_flash.split_len(slots * page, page)
    shapes = {"Q": (b, h, d), "Kcache": (b, slots * page, d), "Vcache": (b, slots * page, d),
              "block_tables": (b, slots), "context_lens": (b,), "O": (b, h, d),
              "ws": (b, -(-slots * page // length), h * (d + 2))}
    itemsize = 4 if route == "float32" else 2
    spec = paged_attn.paged_decode_spec(b, h, d, page, slots, dtype=getattr(torch, route))
    _assert_spec_matches(spec, ctx, acc, shapes,
                         itemsizes={n: itemsize for n in ("Q", "Kcache", "Vcache", "O")})


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("b, sq, s, d, bkv, starts, ends",
                         [(4, 512, 512, 128, 128, None, None), (2, 100, 130, 32, 64, [10, 0], [90, 5])])
def test_ragged_prefill_specs_are_flash_walks(b, sq, s, d, bkv, starts, ends, gated):
    """The spec-only prefill rungs: flash.cu's causal walk (as flash_spec:
    32-row stages up to the walk's end), and with the gate only the rows
    inside [starts[b], ends[b])."""
    if starts is None:
        ctx = ragged_flash.ragged_context(b, s)
    else:
        ctx = {"starts": np.asarray(starts, np.int32), "ends": np.asarray(ends, np.int32)}

    def chunks(bi, qt):
        lo, hi = (max(int(ctx["starts"][bi]), 0), min(int(ctx["ends"][bi]), s)) if gated else (0, s)
        end = flash.kv_walk_end(qt, sq, s, bkv, True)
        return [(bi * s + k0, 32, lambda r, k0=k0: lo <= k0 + r < min(hi, end))
                for k0 in range(0, end, 32)]

    acc = _emulate_prefill(b, sq, s, d, chunks)
    acc["starts"] = {key: [np.asarray([key[0]])] for key in acc["Q"]}
    acc["ends"] = acc["starts"]
    build = ragged_flash.ragged_prefill_ragged_spec if gated else ragged_flash.ragged_prefill_spec
    shapes = {"Q": (b, sq, d), "K": (b, s, d), "V": (b, s, d), "starts": (b,), "ends": (b,), "O": (b, sq, d)}
    _assert_spec_matches(build(b, sq, s, d, bkv), ctx, acc, shapes)
    if not gated:  # every row of flash's causal walk, as flash_spec models it
        fl = analyze(flash.flash_spec(b, sq, s, d, bkv=bkv, causal=True), GridSampler(None))
        hm = analyze(build(b, sq, s, d, bkv), GridSampler(None), ctx)
        for name in "QKVO":
            np.testing.assert_array_equal(hm.region(name).sector_temps_array,
                                          fl.region(name).sector_temps_array)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("b, sq, d, pages, page, slots", [(4, 512, 128, 64, 64, 8), (2, 150, 32, 12, 40, 5)])
def test_paged_prefill_specs_are_flash_walks_over_pages(b, sq, d, pages, page, slots, gated):
    ctx = paged_attn.paged_context(b, pages, slots, page)
    s = slots * page

    def chunks(bi, qt):
        n = min(slots, (min((qt + 1) * 64, sq) - 1) // page + 1)
        if not gated:
            return [(bi * s + j * page, page, lambda r: True) for j in range(n)]
        c = min(max(int(ctx["context_lens"][bi]), 0), s)
        return [(int(ctx["block_tables"][bi, j]) * page, page, lambda r, j=j: r < c - j * page)
                for j in range(min(n, -(-c // page)))]

    acc = _emulate_prefill(b, sq, s, d, chunks)
    acc["Kcache"], acc["Vcache"] = acc.pop("K"), acc.pop("V")
    acc["context_lens"] = {key: [np.asarray([key[0]])] for key in acc["Q"]}
    if gated:
        acc["block_tables"] = {key: [bi * slots + np.arange(len(chunks(bi, key[1])))]
                               for key in acc["Q"] for bi in [key[0]]}
        build = paged_attn.paged_prefill_paged_spec(b, sq, d, page, pages, slots)
        cache = (pages, page, d)
    else:
        acc["block_tables"] = {key: [key[0] * slots + np.arange(slots)] for key in acc["Q"]}
        build = paged_attn.paged_prefill_spec(b, sq, d, page, slots)
        cache = (b, s, d)
    shapes = {"Q": (b, sq, d), "Kcache": cache, "Vcache": cache, "block_tables": (b, slots),
              "context_lens": (b,), "O": (b, sq, d)}
    _assert_spec_matches(build, ctx, acc, shapes)


# -- story parity: the H100 rungs against the reference rungs' classes ---------------


def _classes(hm):
    return {(r.region, r.pattern) for r in detect_all(hm)}


def _port_heatmap(ref_name):
    spec, ctx = kreg.build(ref_name)
    return analyze(spec, GridSampler(None), ctx)


def _ref_heatmap(ref_name):
    entry = rk.get(ref_name.partition(":")[0])
    spec, ctx = rk.build(ref_name)
    return ref_analyze(spec, sampler=entry.sampler(), dynamic_context=ctx)


_BOUNDS = {("starts", HOT), ("ends", HOT)}
_LENS = {("block_tables", HOT), ("context_lens", HOT)}


@pytest.mark.parametrize(
    "ref_name, only_port, only_ref",
    [
        # the Pallas grid revisits Q and O at every KV step (hot); a CUDA block
        # stages Q once and stores O once.  Every warp of every block reads its
        # sequence's bounds: each bound word is warm in all of its sequence's
        # warps, evenly across the sector (hot: the hot rule reads sharing on
        # words, ROADMAP queue 3 item 12).
        # A live range clamps K and V at a row, mid-(8, 128) TPU tile
        # (misaligned); a 128-float row is 16 whole sectors.
        ("ragged_flash:decode", _BOUNDS, {("Q", HOT), ("O", HOT)}),
        ("ragged_flash:decode-ragged", _BOUNDS,
         {("Q", HOT), ("O", HOT), ("K", "misalignment"), ("V", "misalignment")}),
        ("ragged_flash:prefill", _BOUNDS, {("Q", HOT), ("O", HOT)}),
        ("ragged_flash:prefill-ragged", _BOUNDS,
         {("Q", HOT), ("O", HOT), ("K", "misalignment"), ("V", "misalignment")}),
        # The paged split blocks (split_decode.cuh) read the table entry of
        # each row they stage: in the dense sweep every split's warps read
        # only their own slots' words of the sequence's one table sector
        # (false sharing), and Q is staged by all 4 splits (hot, as the
        # reference's); the gated rung's live splits read Q at most twice and
        # share the live slots' words (hot).  Each table word the dense sweep
        # reads is warm in 8 warps, so it is hot beside its false sharing.
        ("paged_attn:decode", {("block_tables", FALSE_SHARING), ("context_lens", HOT)},
         {("O", HOT)}),
        ("paged_attn:decode-paged", {("context_lens", HOT)}, {("Q", HOT), ("O", HOT)}),
        ("paged_attn:prefill", {("context_lens", HOT)}, {("Q", HOT), ("O", HOT)}),
        ("paged_attn:prefill-paged", {("context_lens", HOT)}, {("Q", HOT), ("O", HOT)}),
    ],
)
def test_pattern_divergences_from_reference_are_the_recorded_ones(ref_name, only_port, only_ref):
    """ROADMAP queue 3: the classes each geometry alone flags."""
    port, want = _classes(_port_heatmap(ref_name)), _ref_classes(ref_name)
    assert (port - want, want - port) == (only_port, only_ref)
    if ref_name == "paged_attn:decode":
        assert port >= {("block_tables", FALSE_SHARING), ("block_tables", HOT),
                        ("context_lens", HOT)}
    else:
        assert port >= (_BOUNDS if ref_name.startswith("ragged") else _LENS)


def _ref_classes(ref_name):
    return {(r.region, r.pattern) for r in ref_detect_all(_ref_heatmap(ref_name))}


# the classes the port's gate fixes and introduces, where it moves any
PORT_STORY = {
    ("paged_attn:decode", "paged_attn:decode-paged"): (
        (("Q", HOT), ("block_tables", FALSE_SHARING)), ()),
}


@pytest.mark.parametrize("pair", list(PINNED_PORT))
def test_story_parity_diff(pair):
    """Dense -> gated is an improvement in both packages; the gate changes
    no class in the port but on the paged decode pair, whose dense split
    blocks read Q 4 times and each split's own table words (the table words
    are hot on both rungs); the reference gains misalignment on the ragged
    K and V, and moves no class on the paged pair."""
    d = diff(_port_heatmap(pair[0]), _port_heatmap(pair[1]))
    want = ref_diff(_ref_heatmap(pair[0]), _ref_heatmap(pair[1]))
    assert (d.tx_before, d.tx_after) == PINNED_PORT[pair]
    assert d.verdict == want.verdict == "improved"
    assert (d.fixed, d.introduced) == PORT_STORY.get(pair, ((), ()))
    assert want.fixed == ()


# -- python -m repro_torch.cli on the CPU -----------------------------------------


@pytest.mark.parametrize(
    "family, lines",
    [
        ("ragged_flash", {(0, 1): ["[ improved] ragged_flash: transfers 68824 -> 13104 (5.25x)",
                                   "[persisting] hot on starts"],
                          (2, 3): ["[ improved] ragged_flash: transfers 393472 -> 149440 (2.63x)"]}),
        ("paged_attn", {(0, 1): ["[ improved] paged_attn: transfers 71244 -> 23464 (3.04x)",
                                 "[persisting] hot on block_tables"],
                        (2, 3): ["[ improved] paged_attn: transfers 360704 -> 208704 (1.73x)"]}),
    ],
)
def test_cli_profile_then_diff_then_report(family, lines, tmp_path, capsys):
    sess = tmp_path / "sess"
    for variant in kreg.get(family).variant_names():
        argv = ["profile", "-k", f"{family}:{variant}", "--device", "cpu", "-q"]
        assert cli.main([*argv, "--out", str(sess)]) == 0
    for (a, b), want in lines.items():
        capsys.readouterr()
        assert cli.main(["diff", str(sess / f"iter{a}"), str(sess / f"iter{b}")]) == 0
        out = capsys.readouterr().out
        for line in want:
            assert line in out
    for i, variant in enumerate(kreg.get(family).variant_names()):
        (entry,) = json.loads((sess / f"iter{i}" / "manifest.json").read_text())["kernels"]
        assert entry["name"] == family
        if variant.startswith("decode"):
            assert entry["run"]["device"] == "cpu" and entry["run"]["launches"] == 0
            assert entry["run"]["max_abs_err"] == 0.0
        else:
            assert "run" not in entry
    assert cli.main(["report", str(sess / "iter1")]) == 0
    assert (sess / "iter1" / "report" / "report.md").is_file()
