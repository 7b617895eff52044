"""The port's attention held against the JAX package's: the chunked
online-softmax loop (``flash_xla``), its gradients, the KV caches and
their writes, RoPE / M-RoPE, GQA and MLA blocks.

The ports of ``tests/test_attention.py`` and of the ``update_seq_buffer``
cases of ``tests/test_extensions.py`` come first (a fixed grid where the
reference draws from hypothesis), then each function against its
reference counterpart on the same numpy inputs: float32, within 2e-5
absolute of the reference (observed <= 1e-6) unless a case says otherwise.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.models import layers
from repro_torch.models.attention import (
    AttnConfig,
    MLAConfig,
    attention_ref,
    attn_apply,
    attn_defs,
    cache_update,
    cross_attn_apply,
    flash_xla,
    init_cache,
    init_mla_cache,
    matmul_acc,
    mla_apply,
    mla_defs,
    update_seq_buffer,
)
from repro_torch.models.params import init_params

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _qkv(s=96, h=4, kv=2, d=16, b=2):
    q, k, v = _rand(0, b, s, h, d), _rand(1, b, s, kv, d), _rand(2, b, s, kv, d)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    return q, k, v, pos


def T(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a)).long() if a.dtype.kind == "i" else \
        torch.from_numpy(np.ascontiguousarray(a))


def _params(defs, seed):
    """The same numpy weights for both packages."""
    rng = np.random.default_rng(seed)
    tree = {}
    for key in sorted(defs):
        d = defs[key]
        std = 1.0 / np.sqrt(max(1, int(np.prod(d.shape[:-1])))) if len(d.shape) > 1 else 0.1
        base = 1.0 if d.init == "ones" else 0.0
        tree[key] = (base + std * rng.standard_normal(d.shape)).astype(np.float32)
    return tree


def _both(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}, {k: T(v) for k, v in tree.items()}


# -- ports of tests/test_attention.py -------------------------------------------------


@pytest.mark.parametrize("s, chunk, causal, window", list(itertools.product(
    [17, 64, 100], [16, 32, 512], [False, True], [None, 13])))
def test_flash_vs_ref_sweep(s, chunk, causal, window):
    q, k, v, pos = map(T, _qkv(s=s))
    got = flash_xla(q, k, v, pos, None, causal, window, chunk)
    want = attention_ref(q, k, v, pos, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)


def test_flash_autograd_matches_the_reference_custom_vjp():
    """Plain autograd through the chunk loop gives the reference's custom
    VJP gradients (within 5e-5 + 5e-4 relative, the reference's own
    custom-VJP-vs-autodiff tolerance)."""
    q, k, v, pos = _qkv(s=64)

    def f(q, k, v):
        return jnp.sum(ref_attn.flash_xla(q, k, v, jnp.asarray(pos), None, True, None, 16) ** 2)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (T(a).requires_grad_() for a in (q, k, v))
    (flash_xla(tq, tk, tv, T(pos), None, True, None, 16) ** 2).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4)


def test_flash_kv_length_mask():
    q, k, v, pos = map(T, _qkv(s=64))
    got = flash_xla(q, k, v, pos, 40, True, None, 16)
    want = attention_ref(q, k, v, pos, kv_length=40, causal=True)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-4)


def test_gqa_cache_decode_matches_full():
    cfg = AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, chunk=16)
    params = init_params(attn_defs(cfg), torch.Generator().manual_seed(0))
    x = T(_rand(1, 2, 12, 32))
    pos = torch.arange(12)[None].expand(2, 12)
    full, _ = attn_apply(params, x, pos, cfg)
    cache = init_cache(2, 16, 2, 8, torch.float32)
    y, cache = attn_apply(params, x[:, :6], pos[:, :6], cfg, cache)
    torch.testing.assert_close(y, full[:, :6], atol=1e-5, rtol=1e-4)
    for t in range(6, 12):
        y, cache = attn_apply(params, x[:, t : t + 1], pos[:, t : t + 1], cfg, cache)
    assert cache["length"] == 12
    torch.testing.assert_close(y[:, 0], full[:, -1], atol=1e-5, rtol=1e-4)


def test_sliding_window_cache_decode():
    cfg = AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, sliding_window=4, chunk=8)
    params = init_params(attn_defs(cfg), torch.Generator().manual_seed(0))
    x = T(_rand(1, 1, 10, 32))
    pos = torch.arange(10)[None]
    full, _ = attn_apply(params, x, pos, cfg)
    cache = init_cache(1, 16, 2, 8, torch.float32)
    _, cache = attn_apply(params, x[:, :9], pos[:, :9], cfg, cache)
    y, cache = attn_apply(params, x[:, 9:10], pos[:, 9:10], cfg, cache)
    torch.testing.assert_close(y[:, 0], full[:, -1], atol=1e-5, rtol=1e-4)


MLA = MLAConfig(d_model=32, n_heads=2, q_lora_rank=16, kv_lora_rank=16,
                qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, chunk=8)


def test_mla_decode_absorbed_matches_expanded():
    params = init_params(mla_defs(MLA), torch.Generator().manual_seed(0))
    x = T(_rand(1, 2, 9, 32))
    pos = torch.arange(9)[None].expand(2, 9)
    full, _ = mla_apply(params, x, pos, MLA)
    cache = init_mla_cache(2, 16, MLA, torch.float32)
    y, cache = mla_apply(params, x[:, :8], pos[:, :8], MLA, cache)
    torch.testing.assert_close(y, full[:, :8], atol=1e-5, rtol=1e-4)
    y, cache = mla_apply(params, x[:, 8:9], pos[:, 8:9], MLA, cache)
    torch.testing.assert_close(y[:, 0], full[:, 8], atol=1e-4, rtol=1e-3)


def test_mla_grads_flow():
    params = init_params(mla_defs(MLA), torch.Generator().manual_seed(0))
    for p in params.values():
        p.requires_grad_()
    x = T(_rand(1, 1, 8, 32))
    y, _ = mla_apply(params, x, torch.arange(8)[None], MLA)
    (y ** 2).sum().backward()
    gn = sum(float((p.grad ** 2).sum()) for p in params.values())
    assert gn > 0 and np.isfinite(gn)


# -- ports of tests/test_extensions.py: the seq-buffer writes --------------------------


def test_update_seq_buffer_onehot_matches_dus():
    buf = torch.zeros(2, 8, 3, 4)
    new = torch.ones(2, 1, 3, 4) * 7
    for idx in (0, 3, 7):
        got = update_seq_buffer(buf, new, idx)
        want = jax.lax.dynamic_update_slice(jnp.zeros((2, 8, 3, 4)), jnp.ones((2, 1, 3, 4)) * 7,
                                            (0, idx, 0, 0))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(buf.abs().sum()) == 0  # functional: the buffer is untouched


def test_update_seq_buffer_full_replace():
    new = torch.ones(2, 4, 3)
    assert torch.equal(update_seq_buffer(torch.zeros(2, 4, 3), new, 0), new)


def test_update_seq_buffer_partial_dus_fallback():
    got = update_seq_buffer(torch.zeros(1, 8, 2), torch.ones(1, 3, 2), 2)
    assert float(got[0, 1].sum()) == 0 and float(got[0, 2].sum()) == 2
    assert float(got[0, 4].sum()) == 2 and float(got[0, 5].sum()) == 0


@pytest.mark.parametrize("s, idx", [(1, -1), (1, 8), (1, 5), (3, 6), (3, -2), (3, 1)])
def test_update_seq_buffer_edges_match_reference(s, idx):
    """Out-of-range one-token writes write nothing; longer writes start
    where they fit (the reference's one-hot select and DUS clamping)."""
    buf = _rand(3, 2, 8, 3)
    new = _rand(4, 2, s, 3)
    want = ref_attn.update_seq_buffer(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(idx))
    got = update_seq_buffer(T(buf), T(new), idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cache_update_appends_and_counts():
    cache = init_cache(1, 6, 1, 2, torch.float32)
    cache = cache_update(cache, torch.ones(1, 2, 1, 2), 2 * torch.ones(1, 2, 1, 2))
    cache = cache_update(cache, 3 * torch.ones(1, 1, 1, 2), 4 * torch.ones(1, 1, 1, 2))
    assert cache["length"] == 3
    assert cache["k"][0, :, 0, 0].tolist() == [1, 1, 3, 0, 0, 0]
    assert cache["v"][0, :, 0, 0].tolist() == [2, 2, 4, 0, 0, 0]


# -- against the reference, function by function -----------------------------------------


@pytest.mark.parametrize("s, chunk, causal, window, kv_length", [
    (17, 16, True, None, None), (64, 16, True, 13, None), (100, 32, False, None, None),
    (100, 512, True, None, 70), (64, 64, False, 5, 40),
])
def test_flash_matches_reference(s, chunk, causal, window, kv_length):
    q, k, v, pos = _qkv(s=s)
    want = ref_attn.flash_xla(*map(jnp.asarray, (q, k, v, pos)),
                              None if kv_length is None else jnp.asarray(kv_length),
                              causal, window, chunk)
    got = flash_xla(T(q), T(k), T(v), T(pos), kv_length, causal, window, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    want = ref_attn.attention_ref(*map(jnp.asarray, (q, k, v, pos)), causal=causal, window=window)
    got = attention_ref(T(q), T(k), T(v), T(pos), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_fully_masked_rows_are_zero_as_in_the_reference():
    q, k, v, pos = _qkv(s=32)
    want = ref_attn.flash_xla(*map(jnp.asarray, (q, k, v, pos)), jnp.asarray(0), True, None, 8)
    got = flash_xla(T(q), T(k), T(v), T(pos), 0, True, None, 8)
    assert float(got.abs().max()) == 0.0 == float(jnp.abs(want).max())


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_reference(theta):
    x = _rand(5, 2, 9, 3, 16)
    pos = np.arange(9)[None].repeat(2, 0).astype(np.int32) + 5
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.apply_rope(T(x), T(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mrope_matches_reference_and_degenerates_to_rope():
    x = _rand(6, 2, 7, 3, 16)
    pos3 = np.random.default_rng(7).integers(0, 50, (2, 7, 3)).astype(np.int32)
    want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (4, 2, 2), 1e6)
    got = layers.apply_mrope(T(x), T(pos3), (4, 2, 2), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    text = np.repeat(np.arange(7)[None, :, None], 3, axis=2).repeat(2, 0).astype(np.int32)
    torch.testing.assert_close(layers.apply_mrope(T(x), T(text), (4, 2, 2), 1e6),
                               layers.apply_rope(T(x), T(text[..., 0]), 1e6))
    with pytest.raises(ValueError, match="sections"):
        layers.apply_mrope(T(x), T(pos3), (4, 2, 1))


@pytest.mark.parametrize("mrope, window", [(None, None), ((2, 1, 1), None), (None, 5)])
def test_attn_apply_matches_reference(mrope, window):
    cfg = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, chunk=8,
               mrope_sections=mrope, sliding_window=window)
    tree = _params(ref_attn.attn_defs(ref_attn.AttnConfig(**cfg)), 8)
    jp, tp = _both(tree)
    x = _rand(9, 2, 12, 32)
    pos = np.arange(12)[None].repeat(2, 0).astype(np.int32)
    if mrope:
        pos = np.repeat(pos[..., None], 3, axis=2)
        pos[..., 1] += 3
    want, _ = ref_attn.attn_apply(jp, jnp.asarray(x), jnp.asarray(pos), ref_attn.AttnConfig(**cfg))
    got, _ = attn_apply(tp, T(x), T(pos), AttnConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    enc = _rand(10, 2, 5, 32)
    want = ref_attn.cross_attn_apply(jp, jnp.asarray(x), jnp.asarray(enc), ref_attn.AttnConfig(**cfg))
    got = cross_attn_apply(tp, T(x), T(enc), AttnConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_mla_prefill_and_absorbed_decode_match_reference():
    ref_cfg = ref_attn.MLAConfig(**{f: getattr(MLA, f) for f in MLA.__dataclass_fields__})
    tree = _params(ref_attn.mla_defs(ref_cfg), 11)
    jp, tp = _both(tree)
    x = _rand(12, 2, 9, 32)
    pos = np.arange(9)[None].repeat(2, 0).astype(np.int32)
    want, _ = ref_attn.mla_apply(jp, jnp.asarray(x), jnp.asarray(pos), ref_cfg)
    got, _ = mla_apply(tp, T(x), T(pos), MLA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    rc = ref_attn.init_mla_cache(2, 16, ref_cfg, jnp.float32)
    _, rc = ref_attn.mla_apply(jp, jnp.asarray(x[:, :8]), jnp.asarray(pos[:, :8]), ref_cfg, rc)
    want, _ = ref_attn.mla_apply(jp, jnp.asarray(x[:, 8:]), jnp.asarray(pos[:, 8:]), ref_cfg, rc)
    tc = init_mla_cache(2, 16, MLA, torch.float32)
    _, tc = mla_apply(tp, T(x[:, :8]), T(pos[:, :8]), MLA, tc)
    got, tc = mla_apply(tp, T(x[:, 8:]), T(pos[:, 8:]), MLA, tc)
    assert tc["length"] == 9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_matmul_acc_returns_float32_of_half_operands():
    a = T(_rand(13, 3, 5, 7)).to(torch.bfloat16)
    b = T(_rand(14, 7, 4)).to(torch.bfloat16)
    got = matmul_acc(a, b)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, a.float() @ b.float())
    f32 = T(_rand(15, 2, 3))
    assert matmul_acc(f32, f32.T).dtype == torch.float32
    assert matmul_acc(f32.double(), f32.T.double()).dtype == torch.float64
