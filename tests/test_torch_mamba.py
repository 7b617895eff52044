"""The port's Mamba2 / SSD layer held against the JAX package's: the
chunked scan, its segment sums, the recurrent decode step, the causal
conv and its step, the whole layer with its caches.

The ports of ``tests/test_mamba.py`` come first (a fixed grid where the
reference draws from hypothesis), then each function against its
reference counterpart on the same numpy inputs: float32, within 1e-4 of
the reference (observed <= 1e-5).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_mamba
from repro_torch.models.mamba import (
    SSMConfig,
    _segsum,
    causal_conv,
    causal_conv_step,
    init_mamba_cache,
    mamba_apply,
    mamba_defs,
    ssd_decode_step,
    ssd_naive_ref,
    ssd_ref,
)
from repro_torch.models.params import init_params

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(b, s, h, p, n, decay=0.4):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, s, h))) * decay).astype(np.float32)
    bm = rng.standard_normal((b, s, h, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, h, n)).astype(np.float32)
    return x, a, bm, cm


def T(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


# -- ports of tests/test_mamba.py -------------------------------------------------------


@pytest.mark.parametrize("s, chunk, h", list(itertools.product([16, 32, 64], [8, 16, 32], [1, 3])))
def test_ssd_chunked_equals_sequential(s, chunk, h):
    if s % chunk:
        chunk = s
    x, a, bm, cm = T(*_ssd_inputs(2, s, h, 8, 4))
    y1, s1 = ssd_ref(x, a, bm, cm, chunk=chunk)
    y2, s2 = ssd_naive_ref(x, a, bm, cm)
    torch.testing.assert_close(y1, y2, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s1, s2, atol=1e-4, rtol=1e-4)


def test_ssd_initial_state_threading():
    x, a, bm, cm = T(*_ssd_inputs(1, 16, 2, 4, 4, decay=0.3))
    y_full, s_full = ssd_ref(x, a, bm, cm, chunk=8)
    y1, s1 = ssd_ref(x[:, :8], a[:, :8], bm[:, :8], cm[:, :8], chunk=8)
    y2, s2 = ssd_ref(x[:, 8:], a[:, 8:], bm[:, 8:], cm[:, 8:], chunk=8, initial_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s2, s_full, atol=1e-4, rtol=1e-4)


def test_ssd_refuses_a_ragged_chunk():
    x, a, bm, cm = T(*_ssd_inputs(1, 12, 1, 2, 2))
    with pytest.raises(ValueError, match="chunk"):
        ssd_ref(x, a, bm, cm, chunk=8)


def test_causal_conv_step_matches_full():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 10, 6)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((4, 6)) * 0.5).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(6) * 0.1).astype(np.float32))
    full = causal_conv(x, w, bias)
    state = torch.zeros(2, 3, 6)
    outs = []
    for t in range(10):
        y, state = causal_conv_step(state, x[:, t], w, bias)
        outs.append(y)
    torch.testing.assert_close(torch.stack(outs, 1), full, atol=1e-5, rtol=1e-5)


def test_mamba_layer_decode_matches_full():
    cfg = SSMConfig(d_model=32, d_state=8, head_dim=16, expand=2, chunk=4)
    params = init_params(mamba_defs(cfg), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, 32)).astype(np.float32))
    full, _ = mamba_apply(params, x, cfg)
    cache = init_mamba_cache(2, cfg, torch.float32)
    y, cache = mamba_apply(params, x[:, :4], cfg, cache)
    torch.testing.assert_close(y, full[:, :4], atol=1e-4, rtol=1e-3)
    for t in range(4, 8):
        y, cache = mamba_apply(params, x[:, t : t + 1], cfg, cache)
        torch.testing.assert_close(y[:, 0], full[:, t], atol=1e-4, rtol=1e-3)


def test_mamba_grads_finite():
    cfg = SSMConfig(d_model=16, d_state=4, head_dim=8, expand=2, chunk=4)
    params = init_params(mamba_defs(cfg), torch.Generator().manual_seed(0))
    for p in params.values():
        p.requires_grad_()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 16)).astype(np.float32))
    y, _ = mamba_apply(params, x, cfg)
    (y ** 2).sum().backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())


# -- against the reference ----------------------------------------------------------------


def test_segsum_matches_reference_with_its_minus_inf():
    x = np.random.default_rng(2).standard_normal((2, 3, 6)).astype(np.float32)
    want = np.asarray(ref_mamba._segsum(jnp.asarray(x)))
    got = _segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got[np.isfinite(want)], want[np.isfinite(want)], atol=1e-6)


@pytest.mark.parametrize("s, chunk", [(32, 8), (64, 64), (48, 16)])
def test_ssd_matches_reference(s, chunk):
    arrays = _ssd_inputs(2, s, 3, 8, 4)
    init = np.random.default_rng(5).standard_normal((2, 3, 8, 4)).astype(np.float32)
    want_y, want_s = ref_mamba.ssd_ref(*map(jnp.asarray, arrays), chunk=chunk,
                                       initial_state=jnp.asarray(init))
    got_y, got_s = ssd_ref(*T(*arrays), chunk=chunk, initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=TOL)
    x, a, bm, cm = arrays
    state = init
    want = ref_mamba.ssd_decode_step(*map(jnp.asarray, (state, x[:, 0], a[:, 0], bm[:, 0], cm[:, 0])))
    got = ssd_decode_step(*T(state, x[:, 0], a[:, 0], bm[:, 0], cm[:, 0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    want = ref_mamba.causal_conv(*map(jnp.asarray, (x, w, bias)))
    np.testing.assert_allclose(causal_conv(*T(x, w, bias)).numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_layer_and_its_caches_match_reference(groups):
    kw = dict(d_model=32, d_state=8, head_dim=16, expand=2, n_groups=groups, chunk=4)
    rng = np.random.default_rng(4)
    tree = {k: (rng.standard_normal(d.shape) * (0.3 if len(d.shape) > 1 else 0.5)
                + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)
            for k, d in ref_mamba.mamba_defs(ref_mamba.SSMConfig(**kw)).items()}
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    tp = {k: torch.from_numpy(v) for k, v in tree.items()}
    rc, pc = ref_mamba.SSMConfig(**kw), SSMConfig(**kw)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    apply = jax.jit(lambda p, x, c: ref_mamba.mamba_apply(p, x, rc, c))
    want, _ = apply(jp, jnp.asarray(x), None)
    got, _ = mamba_apply(tp, torch.from_numpy(x), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # prefill 4, then one decode step, caches and all
    ref_cache = ref_mamba.init_mamba_cache(2, rc, jnp.float32)
    cache = init_mamba_cache(2, pc, torch.float32)
    _, ref_cache = apply(jp, jnp.asarray(x[:, :4]), ref_cache)
    _, cache = mamba_apply(tp, torch.from_numpy(x[:, :4]), pc, cache)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(ref_cache[key]), atol=TOL)
    want, ref_cache = apply(jp, jnp.asarray(x[:, 4:5]), ref_cache)
    got, cache = mamba_apply(tp, torch.from_numpy(x[:, 4:5]), pc, cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(cache[key].numpy(), np.asarray(ref_cache[key]), atol=TOL)
