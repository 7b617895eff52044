"""The port's data pipeline and checkpoints (``repro_torch.data``,
``repro_torch.checkpoint``), held against the JAX package's.

The ports of ``tests/test_data_checkpoint.py`` come first.  Then: the
synthetic and memmap sources give the reference's batches bit for bit
for the same seed, step and host; a checkpoint of a SMOKE model's
parameters written by ``repro.checkpoint`` restores in the port (through
``params_from_reference``) to the same logits (1e-4 of max|logits|, the
forward's tolerance); and the port's own checkpoint has the reference's
layout, names and hashes and restores in the reference.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import data as ref_data
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.data import DataConfig, MemmapSource, SyntheticSource, TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.model import params_from_reference
from repro_torch.models.registry import config_from_reference

LOGIT_TOL = 1e-4  # of max|logits|, float32 whole models


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread is ~50x faster than a crowded pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- ports of tests/test_data_checkpoint.py ---------------------------------------


def test_synthetic_deterministic_and_resumable():
    dc = DataConfig(global_batch=4, seq_len=16, vocab=100, seed=7)
    p1 = TokenPipeline(SyntheticSource(dc))
    batches1 = [next(p1) for _ in range(5)]
    p2 = TokenPipeline(SyntheticSource(dc))
    p2.restore(3)
    t3, l3 = next(p2)
    np.testing.assert_array_equal(t3, batches1[3][0])
    np.testing.assert_array_equal(l3, batches1[3][1])


def test_labels_are_shifted_tokens():
    dc = DataConfig(global_batch=2, seq_len=8, vocab=50)
    tokens, labels = next(TokenPipeline(SyntheticSource(dc)))
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])
    assert tokens.max() < 50


def test_host_sharding_disjoint_streams():
    a = DataConfig(global_batch=8, seq_len=8, vocab=100, host_id=0, n_hosts=2)
    b = DataConfig(global_batch=8, seq_len=8, vocab=100, host_id=1, n_hosts=2)
    ta, _ = next(TokenPipeline(SyntheticSource(a)))
    tb, _ = next(TokenPipeline(SyntheticSource(b)))
    assert ta.shape == (4, 8)
    assert not np.array_equal(ta, tb)


def test_memmap_source(tmp_path):
    corpus = np.arange(10_000, dtype=np.uint16) % 512
    path = tmp_path / "tokens.bin"
    corpus.tofile(path)
    dc = DataConfig(global_batch=4, seq_len=32, vocab=512)
    src = MemmapSource(dc, str(path))
    b1 = src.batch(0)
    b2 = src.batch(0)
    np.testing.assert_array_equal(b1, b2)
    assert b1.shape == (4, 33)


def _tree():
    return {
        "layer": {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(4)},
        "step": torch.tensor(7),
    }


def _leaves(tree):
    from repro_torch.checkpoint.manager import _named_leaves

    return list(_named_leaves(tree))


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    save_tree(tree, str(tmp_path), 7)
    restored, step, _ = restore_tree(str(tmp_path), tree)
    assert step == 7
    for (na, a), (nb, b) in zip(_leaves(tree), _leaves(restored)):
        assert na == nb
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_hash_verification_catches_corruption(tmp_path):
    tree = _tree()
    path = save_tree(tree, str(tmp_path), 1)
    shard = os.path.join(path, "shard_h0.npz")
    with np.load(shard) as z:
        arrays = {k: z[k] for k in z.files}
    key = [k for k in arrays if k.endswith("w")][0]
    arrays[key] = arrays[key] + 1.0
    np.savez(shard, **arrays)
    with pytest.raises(IOError):
        restore_tree(str(tmp_path), tree, step=1)


def test_keep_n_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(_tree(), s, blocking=True)
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_")
    )
    assert steps == [3, 4]
    assert mgr.latest_step() == 4


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(_tree(), 5)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_partial_write_not_committed(tmp_path):
    os.makedirs(tmp_path / "step_00000009.tmp")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None


def test_restore_rejects_shape_mismatch(tmp_path):
    save_tree(_tree(), str(tmp_path), 1)
    bad_target = {
        "layer": {"w": torch.empty(4, 4), "b": torch.empty(4)},
        "step": torch.empty((), dtype=torch.int64),
    }
    with pytest.raises(ValueError):
        restore_tree(str(tmp_path), bad_target, step=1)


# -- against the JAX package ------------------------------------------------------------


@pytest.mark.parametrize("seed, host, n_hosts, zipf", [
    (0, 0, 1, 1.2), (7, 1, 2, 1.2), (123, 3, 4, 1.5),
])
def test_synthetic_batches_equal_the_reference(seed, host, n_hosts, zipf):
    kw = dict(global_batch=8, seq_len=24, vocab=300, seed=seed, host_id=host, n_hosts=n_hosts)
    want = ref_data.TokenPipeline(ref_data.SyntheticSource(ref_data.DataConfig(**kw), zipf))
    got = TokenPipeline(SyntheticSource(DataConfig(**kw), zipf))
    want.restore(5)
    got.restore(5)
    for _ in range(3):
        (wt, wl), (gt, gl) = next(want), next(got)
        assert gt.dtype == wt.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gl, wl)
    assert got.state() == want.state() == 8


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_memmap_batches_equal_the_reference(tmp_path, dtype):
    corpus = (np.random.default_rng(3).integers(0, 700, 20_000)).astype(dtype)
    path = str(tmp_path / "tokens.bin")
    corpus.tofile(path)
    kw = dict(global_batch=4, seq_len=40, vocab=512, seed=11)
    want = ref_data.MemmapSource(ref_data.DataConfig(**kw), path, dtype=dtype)
    got = MemmapSource(DataConfig(**kw), path, dtype=dtype)
    for step in (0, 1, 17):
        np.testing.assert_array_equal(got.batch(step), want.batch(step))


def _smoke_pair(arch="granite-8b"):
    ref_cfg = ref_get_config(arch, smoke=True)
    ref_model = ref_build(ref_cfg)
    params = ref_model.init(jax.random.key(0))
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    return ref_cfg, ref_model, params, cfg


def _tokens(cfg, b=2, s=16):
    return np.random.default_rng(1).integers(0, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["granite-8b", "jamba-v0.1-52b", "deepseek-v3-671b"])
def test_reference_checkpoint_restores_to_the_same_logits(tmp_path, arch):
    ref_cfg, ref_model, params, cfg = _smoke_pair(arch)
    ref_ckpt.save_tree({"params": params}, str(tmp_path), 3, extra={"data_step": 4})
    # the reference's tree, read by the port's restore into CPU tensors
    target = {"params": jax.tree.map(lambda a: torch.empty(a.shape, dtype=torch.float32), params)}
    restored, step, extra = restore_tree(str(tmp_path), target)
    assert (step, extra) == (3, {"data_step": 4})
    tree = jax.tree.map(lambda t: t.numpy(), restored["params"],
                        is_leaf=lambda x: isinstance(x, torch.Tensor))
    model = build_model(cfg)
    model.load_state_dict(params_from_reference(cfg, tree))
    toks = _tokens(cfg)
    want = np.asarray(ref_model.apply(params, jnp.asarray(toks))[0])
    with torch.no_grad():
        got = model.apply(torch.from_numpy(toks))[0].numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_port_checkpoint_has_the_reference_layout_and_restores_there(tmp_path):
    _, _, _, cfg = _smoke_pair()
    model = build_model(cfg, generator=torch.Generator().manual_seed(3))
    named = dict(model.named_parameters())
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    mgr.save({"params": named}, 12, extra={"data_step": 12})
    mgr.wait()
    step_dir = tmp_path / "step_00000012"
    assert sorted(os.listdir(step_dir)) == ["COMMITTED", "manifest.json", "shard_h0.npz"]
    assert (step_dir / "COMMITTED").read_text() == "ok"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    assert manifest["step"] == 12 and manifest["extra"] == {"data_step": 12}
    assert set(manifest["leaves"]) == {f"params/{k}" for k in named}
    # the reference reads it back, hashes verified, into the same names
    target = {"params": {k: jax.ShapeDtypeStruct(tuple(p.shape), jnp.float32)
                         for k, p in named.items()}}
    back, step, extra = ref_ckpt.restore_tree(str(tmp_path), target)
    assert step == 12 and extra == {"data_step": 12}
    for k, p in named.items():
        np.testing.assert_array_equal(np.asarray(back["params"][k]), p.detach().numpy())
    # and the port restores it in place of fresh parameters, bit for bit
    again, _, _ = mgr.restore({"params": {k: torch.empty_like(p) for k, p in named.items()}})
    for k, p in named.items():
        assert torch.equal(again["params"][k], p.detach())


def test_bfloat16_leaves_keep_their_bits_and_hashes(tmp_path):
    """numpy has no bfloat16: the port stores the 16-bit words, and the
    hash is that of the reference's bfloat16 array of the same values."""
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    save_tree({"w": x}, str(tmp_path / "port"), 1)
    manifest = json.loads((tmp_path / "port" / "step_00000001" / "manifest.json").read_text())
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    ref_path = ref_ckpt.save_tree({"w": jnp.asarray(x.float().numpy(), jnp.bfloat16)},
                                  str(tmp_path / "ref"), 1)
    with open(os.path.join(ref_path, "manifest.json")) as f:
        assert json.load(f)["leaves"]["w"]["sha"] == manifest["leaves"]["w"]["sha"]
    target = {"w": torch.empty(5, 7, dtype=torch.bfloat16)}
    back, _, _ = restore_tree(str(tmp_path / "port"), target)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
