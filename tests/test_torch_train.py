"""The port's training step held against the JAX package's.

Three steps of ``build_train_step`` (AdamW, float32, the same batches)
on each registered model in both packages: the same loss and gradient
norm at every step (1e-5 relative), and the same parameters after the
third (1e-5 of the tree's largest |p|).  Gradient accumulation over two
microbatches equals one batch, ``remat="full"`` recomputes and gives
the gradients of ``"none"``, and ``flash_xla``'s backward equals the
reference's custom VJP while saving nothing of size Sq x Skv.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.models import attention as ref_attn
from repro.models import build_model as ref_build
from repro.models.params import is_def
from repro.models.registry import MODELS as REF_MODELS
from repro.runtime import TrainConfig as RefTrainConfig
from repro.runtime import build_train_step as ref_build_train_step
from repro.runtime import init_state as ref_init_state
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticSource, TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.attention import flash_xla
from repro_torch.models.model import params_from_reference, reference_plan
from repro_torch.models.params import leaves
from repro_torch.models.registry import config_from_reference
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.runtime import TrainConfig, build_train_step, init_state, model_loss

STEP_TOL = 1e-5  # loss and grad_norm, relative
PARAM_TOL = 1e-5  # of the tree's largest |p|, after three steps
GRAD_TOL = 1e-5  # remat against none, of each leaf's largest |grad|


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread is ~50x faster than a crowded pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(ref_model, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(d):
        if d.init in ("zeros", "ones"):
            base_value = 1.0 if d.init == "ones" else 0.0
            return (base_value + 0.1 * rng.standard_normal(d.shape)).astype(np.float32)
        std = d.scale if d.init == "embed" else d.scale / np.sqrt(d.fan_in())
        if d.init == "out_proj":
            std /= np.sqrt(2.0)
        return (np.clip(rng.standard_normal(d.shape), -2, 2) * std).astype(np.float32)

    return jax.tree.map(leaf, ref_model.param_defs(), is_leaf=is_def)


def _batches(vocab, n, b=4, s=32, seed=3):
    pipe = TokenPipeline(SyntheticSource(DataConfig(global_batch=b, seq_len=s, vocab=vocab,
                                                    seed=seed)))
    return [next(pipe) for _ in range(n)]


@pytest.mark.parametrize("name", list(REF_MODELS))
def test_three_train_steps_match_the_reference(name):
    ref_cfg = REF_MODELS[name].config
    ref_model = ref_build(ref_cfg)
    tree = numpy_tree(ref_model)
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    model = build_model(cfg)
    model.load_state_dict(params_from_reference(cfg, tree))

    # Adam divides each gradient by its own magnitude, so float32 rounding
    # in a near-zero gradient moves that element by up to the rate: a rate
    # of 1e-4 keeps three such steps inside PARAM_TOL
    ref_opt = ref_optim.adamw(ref_optim.cosine_warmup(1e-4, 1, 3))
    opt = adamw(cosine_warmup(1e-4, 1, 3))
    ref_step = ref_build_train_step(lambda p, t, l: ref_model.loss(p, t, l), ref_opt,
                                    RefTrainConfig(), donate=False)
    step = build_train_step(lambda p, t, l: model_loss(model, p, t, l), opt, TrainConfig())
    ref_state = ref_init_state(jax.tree.map(jnp.asarray, tree), ref_opt, RefTrainConfig())
    state = init_state(dict(model.named_parameters()), opt, TrainConfig())
    for toks, labels in _batches(cfg.vocab, 3):
        ref_state, want = ref_step(ref_state, jnp.asarray(toks), jnp.asarray(labels))
        state, got = step(state, torch.from_numpy(toks), torch.from_numpy(labels))
        for key in ("loss", "grad_norm"):
            w = float(want[key])
            assert abs(float(got[key]) - w) <= STEP_TOL * abs(w), (key, float(got[key]), w)
    flat = dict(leaves(jax.tree.map(np.asarray, ref_state.params)))
    scale = max(float(np.abs(a).max()) for a in flat.values())
    for pname, (path, index) in reference_plan(cfg).items():
        want = flat[path] if index is None else flat[path][index]
        err = float(np.abs(state.params[pname].detach().numpy() - want).max())
        assert err <= PARAM_TOL * scale, (pname, err, scale)


@pytest.mark.parametrize("name", ["transformer-tiny", "mamba-tiny"])
def test_grad_accum_two_equals_one(name):
    """(moe-tiny's load-balancing loss is not linear in the batch, in
    either package: two halves' mean differs from the whole's.)"""
    cfg = config_from_reference(dataclasses.asdict(REF_MODELS[name].config))
    toks, labels = _batches(cfg.vocab, 1)[0]
    t, l = torch.from_numpy(toks), torch.from_numpy(labels)
    out = []
    for accum in (1, 2):
        model = build_model(cfg, generator=torch.Generator().manual_seed(1))
        opt = adamw(cosine_warmup(1e-4, 1, 3))
        tc = TrainConfig(grad_accum=accum)
        step = build_train_step(lambda p, a, b: model_loss(model, p, a, b), opt, tc)
        state, metrics = step(init_state(dict(model.named_parameters()), opt, tc), t, l)
        out.append((state.params, metrics))
    (p1, m1), (p2, m2) = out
    # the loss of the mean of two halves' means: equal halves, equal weights
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= STEP_TOL * abs(float(m1["loss"]))
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) <= STEP_TOL * float(m1["grad_norm"])
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], atol=2e-6, rtol=2e-5)


def _grads(model, toks, labels):
    loss, _ = model.loss(toks, labels)
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True)))


@pytest.mark.parametrize("arch", ["granite-8b", "jamba-v0.1-52b", "deepseek-v3-671b",
                                  "whisper-base", "mamba2-2.7b"])
def test_remat_full_recomputes_and_gives_the_same_gradients(arch, monkeypatch):
    base = get_config(arch, smoke=True)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, base.vocab, (2, 16)))
    labels = torch.roll(toks, -1, dims=1)
    grads, saved = {}, {}
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        model = build_model(cfg, generator=torch.Generator().manual_seed(0))
        n_bytes = []

        def pack(t):
            n_bytes.append(t.numel() * t.element_size())
            return t

        calls.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = model.loss(toks, labels)
        names, params = zip(*model.named_parameters())
        grads[remat] = dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True)))
        saved[remat] = (sum(n_bytes), len(calls))
        # decode and prefill never checkpoint, whatever remat says
        calls.clear()
        caches = model.init_caches(2, 32, dtype=torch.float32)
        _, caches = model.prefill(toks, caches)
        model.decode_step(toks[:, :1], caches)
        assert calls == []
    n_blocks = base.n_layers + (base.n_encoder_layers if arch == "whisper-base" else 0)
    assert saved["none"][1] == 0 and saved["full"][1] == n_blocks
    assert saved["full"][0] < saved["none"][0]
    for k, g in grads["none"].items():
        h = grads["full"][k]
        if g is None:
            assert h is None
            continue
        err = float((g - h).abs().max())
        assert err <= GRAD_TOL * float(g.abs().max()) + 1e-12, (arch, k, err)


def _qkv(b=2, s=64, h=4, kv=2, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return q, k, v, pos


@pytest.mark.parametrize("s, chunk, causal, window, kv_length", [
    (64, 16, True, None, None),
    (64, 16, False, None, None),
    (50, 16, True, 13, None),  # a tail chunk shorter than the rest
    (64, 16, True, None, 40),
    (64, 64, True, None, None),
])
def test_flash_backward_equals_the_reference_vjp_and_saves_no_square(s, chunk, causal, window,
                                                                     kv_length):
    q, k, v, pos = _qkv(s=s)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)

    def f(q, k, v):
        kvl = None if kv_length is None else jnp.asarray(kv_length, jnp.int32)
        out = ref_attn.flash_xla(q, k, v, jnp.asarray(pos), kvl, causal, window, chunk)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                  lambda t: t):
        out = flash_xla(tq, tk, tv, torch.from_numpy(pos), kv_length, causal, window, chunk)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-5 * np.abs(w).max(), rtol=0)
    # the output, the logsumexp rows and the inputs: nothing of Sq x Skv
    b, h = q.shape[0], q.shape[2]
    assert saved and max(saved) <= q.size < b * h * s * s
