"""The port's MoE held against the JAX package's: routing (top-k and its
ties, the aux loss), the ragged and capacity dispatches (which tokens a
tight capacity drops), the dense oracle and the shared expert.

The ports of ``tests/test_moe.py`` come first (not the ``shard_map``
path: with no mesh ``moe_impl='ep'`` is the capacity path in both
packages), then each function against its reference counterpart on the
same numpy weights and inputs: float32, within 1e-5 absolute of the
reference (observed <= 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.models.moe import (
    MoEConfig,
    _router,
    capacity,
    moe_apply,
    moe_apply_capacity,
    moe_apply_ragged,
    moe_defs,
    moe_ref,
)
from repro_torch.models.params import init_params

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(**kw):
    cfg = MoEConfig(d_model=16, d_ff=32, n_experts=4, top_k=2, n_shared_experts=1, **kw)
    params = init_params(moe_defs(cfg), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32))
    return cfg, params, x


# -- ports of tests/test_moe.py ---------------------------------------------------------


def test_ragged_matches_dense_oracle():
    cfg, params, x = _setup()
    y, aux = moe_apply_ragged(params, x, cfg)
    y2, aux2 = moe_ref(params, x, cfg)
    torch.testing.assert_close(y, y2, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(aux, aux2, atol=1e-6, rtol=1e-5)


def test_capacity_high_cap_matches_oracle():
    cfg, params, x = _setup(capacity_factor=8.0, moe_impl="capacity")
    torch.testing.assert_close(moe_apply_capacity(params, x, cfg)[0], moe_ref(params, x, cfg)[0],
                               atol=1e-5, rtol=1e-4)


def test_capacity_drops_tokens_when_tight():
    cfg, params, x = _setup(capacity_factor=0.1, moe_impl="capacity")
    y_tight, _ = moe_apply_capacity(params, x, cfg)
    y_full, _ = moe_ref(params, x, cfg)
    assert bool(torch.isfinite(y_tight).all())
    assert float((y_tight - y_full).abs().max()) > 1e-6


def test_top1_and_no_shared():
    cfg = MoEConfig(d_model=16, d_ff=32, n_experts=4, top_k=1)
    params = init_params(moe_defs(cfg), torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 8, 16)).astype(np.float32))
    torch.testing.assert_close(moe_apply_ragged(params, x, cfg)[0], moe_ref(params, x, cfg)[0],
                               atol=1e-5, rtol=1e-4)


def test_aux_loss_positive_and_bounded():
    cfg, params, x = _setup()
    _, aux = moe_apply(params, x, cfg)
    assert 0.0 <= float(aux) < 1.0


def test_moe_grads_flow_through_dispatch():
    cfg, params, x = _setup()
    for p in params.values():
        p.requires_grad_()
    y, aux = moe_apply_ragged(params, x, cfg)
    ((y ** 2).sum() + aux).backward()
    gw = params["w_gate"].grad.abs().sum(dim=(1, 2))
    assert int((gw > 0).sum()) >= 2
    assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())


def test_ep_falls_back_without_mesh():
    cfg, params, x = _setup(moe_impl="ep", capacity_factor=8.0)
    torch.testing.assert_close(moe_apply(params, x, cfg)[0], moe_ref(params, x, cfg)[0],
                               atol=1e-5, rtol=1e-4)


# -- against the reference ----------------------------------------------------------------


def _pair(seed=0, **kw):
    cfg = dict(d_model=16, d_ff=32, n_experts=4, top_k=2, n_shared_experts=1, **kw)
    rng = np.random.default_rng(seed)
    tree = {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[-2] if len(d.shape) > 1 else 1))
            .astype(np.float32) for k, d in ref_moe.moe_defs(ref_moe.MoEConfig(**cfg)).items()}
    x = rng.standard_normal((3, 12, 16)).astype(np.float32)
    return (ref_moe.MoEConfig(**cfg), {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(x),
            MoEConfig(**cfg), {k: torch.from_numpy(v) for k, v in tree.items()}, torch.from_numpy(x))


def _close(got, want):
    y, aux = got
    wy, waux = want
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy), atol=TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


@pytest.mark.parametrize("factor", [0.3, 1.25, 8.0])
def test_dispatches_match_reference(factor):
    """Ragged, capacity (at capacity factors that drop many, some and no
    tokens: the same tokens are dropped) and the dense oracle."""
    rc, rp, rx, pc, pp, px = _pair(capacity_factor=factor)
    for port, ref in ((moe_apply_ragged, ref_moe.moe_apply_ragged),
                      (moe_apply_capacity, ref_moe.moe_apply_capacity),
                      (moe_ref, ref_moe.moe_ref)):
        _close(port(pp, px, pc), jax.jit(lambda p, x: ref(p, x, rc))(rp, rx))


def test_capacity_is_the_reference_formula():
    for s in (1, 7, 12, 64, 4096):
        for e, k, f in ((16, 2, 1.25), (4, 1, 0.1), (256, 8, 1.25)):
            cfg = MoEConfig(d_model=8, d_ff=8, n_experts=e, top_k=k, capacity_factor=f)
            assert capacity(cfg, s) == max(k, int(f * s * k / e))


def test_router_ties_take_the_lower_expert_as_top_k_does():
    """A zero router gives every expert the same probability: top-k picks
    experts 0..k-1, in that order, as jax.lax.top_k does."""
    rc, rp, rx, pc, pp, px = _pair()
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    pp = dict(pp, router=torch.zeros_like(pp["router"]))
    te, tw, aux = _router(pp, px.reshape(-1, 16), pc)
    re, rw, raux = ref_moe._router(rp, rx.reshape(-1, 16), rc)
    np.testing.assert_array_equal(te.numpy(), np.asarray(re))
    assert te[:, 0].eq(0).all() and te[:, 1].eq(1).all()
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw))
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    _close(moe_apply_capacity(pp, px, pc), ref_moe.moe_apply_capacity(rp, rx, rc))


def test_grads_match_reference():
    rc, rp, rx, pc, pp, px = _pair(capacity_factor=1.0)

    def f(p, x):
        y, aux = ref_moe.moe_apply_capacity(p, x, rc)
        return jnp.sum(y ** 2) + aux

    want = jax.jit(jax.grad(f, argnums=(0, 1)))(rp, rx)
    for p in pp.values():
        p.requires_grad_()
    px.requires_grad_()
    y, aux = moe_apply_capacity(pp, px, pc)
    ((y ** 2).sum() + aux).backward()
    for k, g in want[0].items():
        np.testing.assert_allclose(pp[k].grad.numpy(), np.asarray(g), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(want[1]), atol=1e-4, rtol=1e-4)
