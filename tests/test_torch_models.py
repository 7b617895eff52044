"""The port's model forward held against the JAX package's.

Every reduced ``SMOKE`` config (all ten archs) and every registered
``cuthermo model`` config runs through ``repro.models`` and through
``repro_torch.models`` on the same parameters — a reference parameter
tree drawn with numpy from the reference's own defs and carried across
with ``params_from_reference`` — and the same numpy tokens.  Whole-model
logits agree within 1e-4 of max|logits| (float32; observed <= 2e-6).
Decode (prefill, then one token at a time) is held against the full
forward and against the reference's decode, the registered models' loss
and gradients against ``jax.grad``, and the ports of
``tests/test_models_smoke.py`` follow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import archs as ref_archs
from repro.configs import base as ref_base
from repro.models import build_model as ref_build
from repro.models import frontends as ref_frontends
from repro.models.params import is_def
from repro.models.registry import MODELS as REF_MODELS
from repro_torch.configs import ARCH_IDS, SHAPES, SUBQUADRATIC, base, get_config
from repro_torch.models import build_model, frontends
from repro_torch.models.model import params_from_reference, reference_plan
from repro_torch.models.params import ParamDef, init_params, leaves
from repro_torch.models.registry import MODELS, config_from_reference, get_model, model_names

LOGIT_TOL = 1e-4  # of max|logits|, float32 whole models
GRAD_TOL = 1e-4  # of max|grad| per leaf


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread is ~50x faster than a crowded pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(ref_model, seed=0):
    """A reference parameter tree drawn with numpy from the reference's
    defs: the init's scales, and norms and biases moved off 1 and 0 by
    N(0, 0.1^2) so that they are exercised too."""
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


def pair(ref_cfg, seed=0):
    """(reference model, its params, port model with the same params)."""
    ref_model = ref_build(ref_cfg)
    tree = numpy_tree(ref_model, seed)
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    model = build_model(cfg)
    model.load_state_dict(params_from_reference(cfg, tree))
    return ref_model, jax.tree.map(jnp.asarray, tree), model


def tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def frames(cfg, b, n=8, seed=2):
    return (0.02 * np.random.default_rng(seed).standard_normal((b, n, cfg.d_model))).astype(np.float32)


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"max|err| {err:.3e} > {tol} x {scale:.3e}"
    return err / scale


def forward_both(ref_model, ref_params, model, cfg, toks, fr=None):
    if fr is None:
        want, _, _ = jax.jit(lambda p, t: ref_model.apply(p, t))(ref_params, jnp.asarray(toks))
        got, _, _ = model.apply(torch.from_numpy(toks).long())
    else:
        want, _, _ = jax.jit(lambda p, t, f: ref_model.apply(p, t, embeddings=f))(
            ref_params, jnp.asarray(toks), jnp.asarray(fr))
        got, _, _ = model.apply(torch.from_numpy(toks).long(), embeddings=torch.from_numpy(fr))
    return got.detach().numpy(), np.asarray(want)


# -- logits against the reference ------------------------------------------------------


@pytest.mark.parametrize("arch_id", REF_ARCH_IDS)
def test_smoke_logits_match_reference(arch_id):
    ref_cfg = ref_archs.get_config(arch_id, smoke=True)
    ref_model, ref_params, model = pair(ref_cfg)
    b, s = 2, 16
    fr = frames(ref_cfg, b) if ref_cfg.family == "audio" else None
    got, want = forward_both(ref_model, ref_params, model, ref_cfg, tokens(ref_cfg, b, s), fr)
    assert got.shape == (b, s, ref_cfg.padded_vocab)
    close(got, want, LOGIT_TOL)


@pytest.mark.parametrize("name", list(REF_MODELS))
def test_registered_logits_match_reference(name):
    entry = REF_MODELS[name]
    ref_model, ref_params, model = pair(entry.config)
    got, want = forward_both(ref_model, ref_params, model, entry.config,
                             tokens(entry.config, entry.batch, entry.seq))
    close(got, want, LOGIT_TOL)


def test_last_only_is_the_forward_sliced():
    ref_cfg = ref_archs.get_config("granite-8b", smoke=True)
    ref_model, ref_params, model = pair(ref_cfg)
    toks = torch.from_numpy(tokens(ref_cfg, 2, 12)).long()
    full, _, _ = model.apply(toks)
    last, _, _ = model.apply(toks, last_only=True)
    assert last.shape == (2, 1, ref_cfg.padded_vocab)
    close(last.detach(), full[:, -1:].detach(), 1e-6)


# -- decode ---------------------------------------------------------------------------


def drop_free(cfg):
    """Capacity dispatch drops by the group's length, so a prefill of S-k
    tokens and a forward of S drop different tokens; at capacity factor
    n_experts / top_k every expert has a slot for every token."""
    if cfg.n_experts:
        return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts / cfg.top_k))
    return cfg


@pytest.mark.parametrize("arch_id", REF_ARCH_IDS)
def test_prefill_then_decode_matches_the_forward(arch_id):
    """prefill(S - 8) then 8 single-token decode steps give the full
    forward's logits at every position (within 1e-4 of max|logits|)."""
    cfg = drop_free(get_config(arch_id, smoke=True))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    b, s, k = 2, 16, 8
    toks = torch.from_numpy(tokens(cfg, b, s)).long()
    kw = {}
    if cfg.family == "audio":
        kw["embeddings"] = torch.from_numpy(frames(cfg, b))
    with torch.no_grad():
        full, _, _ = model.apply(toks, **kw)
        caches = model.init_caches(b, 32, dtype=torch.float32)
        out, caches = model.prefill(toks[:, : s - k], caches, **kw)
        steps = [out]
        for t in range(s - k, s):
            out, caches = model.decode_step(toks[:, t : t + 1], caches, **kw)
            steps.append(out)
    close(torch.cat(steps, dim=1), full, LOGIT_TOL)


@pytest.mark.parametrize("arch_id", ["granite-8b", "mamba2-2.7b", "jamba-v0.1-52b",
                                     "deepseek-v3-671b", "whisper-base"])
def test_smoke_decode_matches_reference(arch_id):
    """The port of test_models_smoke.test_smoke_decode, held to the
    reference: prefill 8 tokens, decode one, same logits both times."""
    ref_cfg = ref_archs.get_config(arch_id, smoke=True)
    ref_model, ref_params, model = pair(ref_cfg)
    b = 2
    toks = tokens(ref_cfg, b, 8)
    ref_caches = ref_model.init_caches(b, 32, dtype=jnp.float32)
    caches = model.init_caches(b, 32, dtype=torch.float32)
    t = torch.from_numpy(toks).long()
    if ref_cfg.family == "audio":
        fr = frames(ref_cfg, b)
        step = jax.jit(lambda p, t, c, f: ref_model.apply(p, t, caches=c, embeddings=f)[:2])
        want1, ref_caches = step(ref_params, jnp.asarray(toks), ref_caches, jnp.asarray(fr))
        want2, _ = step(ref_params, jnp.asarray(toks[:, :1]), ref_caches, jnp.asarray(fr))
        got1, caches, _ = model.apply(t, caches=caches, embeddings=torch.from_numpy(fr))
        got2, _ = model.decode_step(t[:, :1], caches, embeddings=torch.from_numpy(fr))
    else:
        step = jax.jit(lambda p, t, c: ref_model.apply(p, t, caches=c)[:2])
        want1, ref_caches = step(ref_params, jnp.asarray(toks), ref_caches)
        want2, _ = step(ref_params, jnp.asarray(toks[:, :1]), ref_caches)
        got1, caches = model.prefill(t, caches)
        got2, _ = model.decode_step(t[:, :1], caches)
    assert got2.shape[:2] == (b, 1) and bool(torch.isfinite(got2).all())
    close(got1.detach(), want1, LOGIT_TOL)
    close(got2.detach(), want2, LOGIT_TOL)


# -- loss and gradients against jax.grad ------------------------------------------------


@pytest.mark.parametrize("name", list(REF_MODELS))
def test_registered_loss_and_grads_match_jax(name):
    entry = REF_MODELS[name]
    ref_model, ref_params, model = pair(entry.config)
    toks = tokens(entry.config, entry.batch, entry.seq)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1  # the masked position

    def scalar(p):
        return ref_model.loss(p, jnp.asarray(toks), jnp.asarray(labels))[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(scalar))(ref_params)
    loss, _ = model.loss(torch.from_numpy(toks).long(), torch.from_numpy(labels).long())
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    flat = dict(leaves(jax.tree.map(np.asarray, want_grads)))
    cfg = config_from_reference(dataclasses.asdict(entry.config))
    grads = dict(model.named_parameters())
    for pname, (path, index) in reference_plan(cfg).items():
        want = flat[path] if index is None else flat[path][index]
        got = grads[pname].grad
        got = np.zeros_like(want) if got is None else got.numpy()
        err = float(np.abs(got - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()) + 1e-9, (pname, err)


def test_mtp_and_aux_loss_match_reference():
    """deepseek's smoke config: cross-entropy + MoE aux + the weighted MTP
    loss, each term against the reference's."""
    ref_cfg = ref_archs.get_config("deepseek-v3-671b", smoke=True)
    ref_model, ref_params, model = pair(ref_cfg)
    toks = tokens(ref_cfg, 2, 16)
    labels = np.roll(toks, -1, axis=1)
    _, want = jax.jit(ref_model.loss)(ref_params, jnp.asarray(toks), jnp.asarray(labels))
    _, got = model.loss(torch.from_numpy(toks).long(), torch.from_numpy(labels).long())
    assert set(got) == set(want) == {"ce", "aux", "mtp_ce", "loss"}
    for key in want:
        assert abs(float(got[key]) - float(want[key])) <= 1e-5 * abs(float(want[key])) + 1e-7, key


# -- the weights carried across ----------------------------------------------------------


@pytest.mark.parametrize("arch_id", REF_ARCH_IDS + list(REF_MODELS))
def test_params_from_reference_uses_every_leaf_once(arch_id):
    ref_cfg = (REF_MODELS[arch_id].config if arch_id in REF_MODELS
               else ref_archs.get_config(arch_id, smoke=True))
    ref_model = ref_build(ref_cfg)
    tree = numpy_tree(ref_model)
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    state = params_from_reference(cfg, tree)
    model = build_model(cfg)
    names = [n for n, _ in model.named_parameters()]
    # every port parameter filled exactly once
    assert sorted(state) == sorted(names) and len(names) == len(set(names))
    # every reference leaf used, each slice of a stacked one exactly once
    used = {}
    for path, index in reference_plan(cfg).values():
        used.setdefault(path, []).append(index)
    ref_leaves = dict(leaves(tree))
    assert set(used) == set(ref_leaves)
    for path, idx in used.items():
        want = [None] if idx == [None] else list(range(ref_leaves[path].shape[0]))
        assert sorted(idx, key=str) == sorted(want, key=str), path
    assert sum(v.numel() for v in state.values()) == sum(a.size for a in ref_leaves.values())


def test_params_from_reference_refuses_a_mismatched_tree():
    ref_cfg = ref_archs.get_config("jamba-v0.1-52b", smoke=True)
    tree = numpy_tree(ref_build(ref_cfg))
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    extra = dict(tree, stray={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray/w"):
        params_from_reference(cfg, extra)
    missing = dict(tree)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(cfg, missing)
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["embed"]["embedding"] = wrong["embed"]["embedding"][:-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_reference(cfg, wrong)


# -- configs and frontends ----------------------------------------------------------------


@pytest.mark.parametrize("arch_id", REF_ARCH_IDS)
def test_configs_equal_the_reference(arch_id):
    for smoke in (False, True):
        want = ref_archs.get_config(arch_id, smoke=smoke)
        assert get_config(arch_id, smoke=smoke) == config_from_reference(dataclasses.asdict(want))
    want = ref_archs.get_config(arch_id)
    assert get_config(arch_id).param_counts() == want.param_counts()
    assert get_config(arch_id).model_flops_decode(4) == want.model_flops_decode(4)
    assert get_config(arch_id).model_flops_train(2, 8) == want.model_flops_train(2, 8)


def test_base_grid_equals_the_reference():
    assert ARCH_IDS == ref_base.ARCH_IDS and SUBQUADRATIC == ref_base.SUBQUADRATIC
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in ref_base.SHAPES.items()}
    assert base.all_cells() == ref_base.all_cells()
    assert [c[:2] for c in base.skipped_cells()] == [c[:2] for c in ref_base.skipped_cells()]
    with pytest.raises(KeyError):
        get_config("nosuch", smoke=True)


def test_frontends_match_the_reference():
    got = frontends.mrope_positions_for_image(2, 5, 2, 3, 4)
    np.testing.assert_array_equal(got, ref_frontends.mrope_positions_for_image(2, 5, 2, 3, 4))
    spec = frontends.audio_frame_spec(2, 8, 64)
    assert spec.shape == ref_frontends.audio_frame_spec(2, 8, 64).shape == (2, 8, 64)
    assert frontends.vision_patch_spec(1, 9, 32).shape == (1, 9, 32)
    x = frontends.synth_frames(torch.Generator().manual_seed(3), 2, 8, 64)
    y = frontends.synth_frames(torch.Generator().manual_seed(3), 2, 8, 64)
    assert x.shape == (2, 8, 64) and x.dtype == torch.bfloat16 and torch.equal(x, y)
    assert 0.01 < float(x.float().std()) < 0.03


def test_init_draws_the_reference_distributions():
    defs = {
        "w": ParamDef((512, 256), ("embed", "mlp")),
        "o": ParamDef((512, 256), ("mlp", "embed"), init="out_proj"),
        "e": ParamDef((1024, 64), ("vocab", "embed"), init="embed", scale=0.02),
        "z": ParamDef((7,), ("embed",), init="zeros"),
        "one": ParamDef((7,), ("embed",), init="ones"),
    }
    p = init_params(defs, torch.Generator().manual_seed(0))
    # truncated N(0, 1) at +-2 has std 0.8796
    assert abs(float(p["w"].std()) / (0.8796 / np.sqrt(512)) - 1) < 0.02
    assert float(p["w"].abs().max()) <= 2 / np.sqrt(512) + 1e-7
    assert abs(float(p["o"].std()) / (0.8796 / np.sqrt(1024)) - 1) < 0.02
    assert abs(float(p["e"].std()) / 0.02 - 1) < 0.02
    assert torch.equal(p["z"], torch.zeros(7)) and torch.equal(p["one"], torch.ones(7))
    again = init_params(defs, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert again["w"].dtype == torch.bfloat16
    assert torch.equal(again["w"], p["w"].to(torch.bfloat16))


# -- ports of tests/test_models_smoke.py ---------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_smoke_forward_and_train_step(arch_id):
    cfg = get_config(arch_id, smoke=True)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    b, s = 2, 16
    toks = torch.from_numpy(tokens(cfg, b, s)).long()
    labels = torch.roll(toks, -1, dims=1)
    kw = {"frames": torch.zeros(b, 8, cfg.d_model)} if cfg.family == "audio" else {}
    logits, _, _ = model.apply(toks, embeddings=kw.get("frames"))
    assert logits.shape == (b, s, cfg.padded_vocab)
    assert not bool(torch.isnan(logits).any())
    # one plain SGD step
    before = [p.detach().clone() for p in model.parameters()]
    loss, _ = model.loss(toks, labels, **kw)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p -= 1e-3 * p.grad
    assert np.isfinite(float(loss))
    assert max(float((a - p).abs().max()) for a, p in zip(before, model.parameters())) > 0


def test_layouts_match_assignment():
    lo = get_config("deepseek-v3-671b").layout()
    assert len(lo) == 61 and all(k.mixer == "mla" for k in lo)
    assert [k.ffn for k in lo[:3]] == ["mlp"] * 3 and lo[3].ffn == "moe"
    lo = get_config("jamba-v0.1-52b").layout()
    assert len(lo) == 32
    assert sum(1 for k in lo if k.mixer == "attn") == 4
    assert sum(1 for k in lo if k.ffn == "moe") == 16
    assert lo[4].mixer == "attn"
    assert all(k.mixer == "mamba" and k.ffn == "none" for k in get_config("mamba2-2.7b").layout())


def test_param_counts_match_public_sizes():
    expect = {
        "granite-20b": (20.1e9, 0.06),
        "deepseek-v3-671b": (670.8e9, 0.02),
        "jamba-v0.1-52b": (51.2e9, 0.05),
        "mamba2-2.7b": (2.7e9, 0.1),
        "qwen2-vl-72b": (71.5e9, 0.05),
    }
    for arch, (want, tol) in expect.items():
        total, _ = get_config(arch).param_counts()
        assert abs(total - want) / want < tol, (arch, total)


def test_active_params_moe():
    _, active = get_config("deepseek-v3-671b").param_counts()
    assert 35e9 < active < 40e9
    _, active = get_config("llama4-scout-17b-a16e").param_counts()
    assert 14e9 < active < 19e9


def test_jamba_cut_to_eight_layers_is_26_gb_in_bf16():
    """The full-width cut the card runs: one hybrid period of Jamba."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    total, active = cfg.param_counts()
    assert (total, active) == (12_999_220_960, 3_134_217_952)
    assert round(2 * total / 1e9, 1) == 26.0
    assert {k.tag() for k in cfg.layout()} == {"mamba_mlp", "mamba_moe", "attn_mlp"}


def _registered(name, seed=0):
    entry = get_model(name)
    model = build_model(entry.config, generator=torch.Generator().manual_seed(seed))
    toks = torch.from_numpy(tokens(entry.config, entry.batch, entry.seq)).long()
    return entry, model, toks


@pytest.mark.parametrize("name", model_names())
def test_registered_model_forward_shape_and_dtype(name):
    entry, model, toks = _registered(name)
    logits, _, _ = model.apply(toks)
    assert logits.shape == (entry.batch, entry.seq, entry.config.padded_vocab)
    assert logits.dtype == entry.config.dtype
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("name", model_names())
def test_registered_model_grads_are_finite(name):
    _, model, toks = _registered(name)
    loss, _ = model.loss(toks, torch.roll(toks, -1, dims=1))
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    grads = [g for g in grads if g is not None]
    assert grads and np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("name", model_names())
def test_registered_model_forward_is_deterministic(name):
    _, model_a, toks_a = _registered(name)
    _, model_b, toks_b = _registered(name)
    assert torch.equal(toks_a, toks_b)
    for a, b in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(model_a.apply(toks_a)[0], model_b.apply(toks_b)[0])


def test_registered_model_shapes_are_ci_sized():
    for name, entry in MODELS.items():
        cfg = entry.config
        assert cfg.n_layers <= 4 and cfg.d_model <= 256, name
        assert entry.batch * entry.seq <= 512, name
