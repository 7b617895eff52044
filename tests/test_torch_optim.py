"""The port's optimizers, schedules and clipping (``repro_torch.optim``).

The ports of ``tests/test_optim.py`` come first; then each optimizer and
state precision is held against ``repro.optim`` on the same tree and the
same three gradients (float32): parameters and moments within 1e-6 of
their largest value, int8 moments and their scales equal.  Clipping and
the schedules give the reference's values exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch.optim import (
    adamw,
    clip_by_global_norm,
    constant,
    cosine_warmup,
    global_norm,
    linear_warmup,
    lion,
)

REL_TOL = 1e-6  # of the largest |value| of each leaf, float32


def _rosenbrock_ish(params):
    x, y = params["x"], params["y"]
    return torch.sum((1 - x) ** 2) + 10 * torch.sum((y - x**2) ** 2)


# -- ports of tests/test_optim.py ---------------------------------------------


@pytest.mark.parametrize("make_opt", [
    lambda: adamw(constant(3e-2)),
    lambda: adamw(constant(3e-2), state_dtype="bf16"),
    lambda: adamw(constant(3e-2), state_dtype="int8"),
    lambda: lion(constant(3e-3)),
], ids=["adamw-f32", "adamw-bf16", "adamw-int8", "lion"])
def test_optimizer_minimizes(make_opt):
    opt = make_opt()
    params = {"x": torch.zeros(4, requires_grad=True), "y": torch.zeros(4, requires_grad=True)}
    state = opt.init(params)
    loss0 = float(_rosenbrock_ish(params).detach())
    for _ in range(200):
        loss = _rosenbrock_ish(params)
        g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        params, state = opt.update(g, state, params)
    assert float(loss.detach()) < 0.2 * loss0


def test_adamw_weight_decay_shrinks():
    opt = adamw(constant(1e-2), weight_decay=0.5)
    params = {"w": torch.ones(8) * 10.0}
    state = opt.init(params)
    zeros = {"w": torch.zeros(8)}
    for _ in range(10):
        params, state = opt.update(zeros, state, params)
    assert float(params["w"].abs().max()) < 10.0


def test_clip_by_global_norm():
    g = {"a": torch.ones(100) * 10.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) == pytest.approx(100.0, rel=1e-5)
    small = {"a": torch.ones(4) * 0.01}
    unclipped, _ = clip_by_global_norm(small, 1.0)
    torch.testing.assert_close(unclipped["a"], small["a"], rtol=1e-6, atol=0)


def test_schedules():
    cos = cosine_warmup(1.0, 10, 100, floor=0.1)
    assert float(cos(torch.tensor(0))) == 0.0
    assert float(cos(torch.tensor(10))) == pytest.approx(1.0)
    assert float(cos(torch.tensor(100))) == pytest.approx(0.1, abs=1e-6)
    lin = linear_warmup(2.0, 4)
    assert float(lin(torch.tensor(2))) == pytest.approx(1.0)
    assert float(lin(torch.tensor(8))) == pytest.approx(2.0)


def test_int8_state_memory_is_quarter():
    opt = adamw(constant(1e-3), state_dtype="int8")
    params = {"w": torch.zeros((128, 128))}
    st = opt.init(params)
    assert st.m["w"].dtype == torch.int8
    assert st.v["w"].dtype == torch.int8
    assert st.mu is not None and st.nu is not None


# -- against repro.optim ------------------------------------------------------------


def _tree(rng):
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal(16).astype(np.float32),
            "s": np.full((), rng.standard_normal(), np.float32)}


def _assert_close(got: torch.Tensor, want, name):
    want = np.asarray(want)
    if want.dtype == np.int8:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        return
    got = got.float().numpy()
    want = want.astype(np.float32)
    tol = REL_TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize("name, make", [
    ("adamw-f32", lambda o, lr: o.adamw(lr)),
    ("adamw-bf16", lambda o, lr: o.adamw(lr, state_dtype="bf16")),
    ("adamw-int8", lambda o, lr: o.adamw(lr, state_dtype="int8")),
    ("adamw-nodecay", lambda o, lr: o.adamw(lr, b2=0.999, weight_decay=0.0)),
    ("lion", lambda o, lr: o.lion(lr)),
])
def test_three_updates_match_the_reference(name, make):
    rng = np.random.default_rng(5)
    tree = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    import repro_torch.optim as port_optim

    ref = make(ref_optim, ref_optim.cosine_warmup(1e-2, 2, 10))
    port = make(port_optim, cosine_warmup(1e-2, 2, 10))
    rp = {k: jnp.asarray(v) for k, v in tree.items()}
    rs = ref.init(rp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    ps = port.init(pp)
    for g in grads:
        rp, rs = ref.update({k: jnp.asarray(v) for k, v in g.items()}, rs, rp)
        pp, ps = port.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ps, pp)
    assert int(ps.step) == int(rs.step) == 3
    for k in tree:
        _assert_close(pp[k], rp[k], f"{name} params[{k}]")
        _assert_close(ps.m[k], rs.m[k], f"{name} m[{k}]")
        if name != "lion":
            _assert_close(ps.v[k], rs.v[k], f"{name} v[{k}]")
        if ps.mu is not None:
            _assert_close(ps.mu[k], rs.mu[k], f"{name} mu[{k}]")
            _assert_close(ps.nu[k], rs.nu[k], f"{name} nu[{k}]")
    assert (ps.mu is None) == (rs.mu is None)


def _ulps(got: np.ndarray, want: np.ndarray) -> int:
    """The largest distance in float32 units in the last place."""
    a = np.asarray(got, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(want, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
@pytest.mark.parametrize("exact", [True, False], ids=["integers", "normal"])
def test_clip_by_global_norm_equals_the_reference(max_norm, exact):
    """Bit for bit where every square and partial sum is exact in float32
    (so that no summation order can round); within 2 ulps of the
    reference on normal draws, whose sums XLA reduces in its own order."""
    rng = np.random.default_rng(9)
    if exact:
        tree = {k: np.asarray(np.round(v * 8), np.float32) for k, v in _tree(rng).items()}
    else:
        tree = _tree(rng)
    want, want_norm = ref_optim.clip_by_global_norm({k: jnp.asarray(v) for k, v in tree.items()},
                                                    max_norm)
    got, norm = clip_by_global_norm({k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
    limit = 0 if exact else 2
    assert _ulps(norm.numpy(), np.asarray(want_norm)) <= limit
    for k in tree:
        assert _ulps(got[k].numpy(), np.asarray(want[k])) <= limit, k


@pytest.mark.parametrize("name, args", [
    ("constant", (0.3,)),
    ("linear_warmup", (2.0, 7)),
    ("cosine_warmup", (3e-3, 10, 100)),
    ("cosine_warmup", (1.0, 0, 50, 0.0)),
])
def test_schedules_equal_the_reference(name, args):
    """The same float32 arithmetic gives the same bits; the one exception
    is the cosine segment, where XLA's float32 ``cos`` and PyTorch's may
    differ in the last place: within 2 ulps of 1.0 times the peak, where
    the rate itself is near 0 several of its own ulps (observed: 3 of 130
    steps off)."""
    import repro_torch.optim as port_optim

    want = getattr(ref_optim, name)(*args)
    got = getattr(port_optim, name)(*args)
    off = []
    for step in range(0, 130):
        w = np.float32(want(jnp.asarray(step, jnp.int32)))
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32 and g.shape == ()
        if g.numpy() != w:
            off.append((step, abs(float(g) - float(w)) / args[0]))
    if name != "cosine_warmup":
        assert off == []
    else:
        warmup, total = args[1], args[2]
        assert all(warmup < step < total and err <= 2 ** -22 for step, err in off), off
