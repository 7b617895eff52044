"""The port's multi-device stack on 4 gloo ranks, held against the JAX
package run on one device (CPU).

One spawn of 4 ranks (``tests/torch_ranks.py``) runs every check on a
2 x 2 (data, model) mesh: the placements of a dim split over two mesh
axes in both orders, ``constrain_logical``, a sharded AdamW step of the
reference test's model (``tests/test_sharding_multidevice.py``: 2
layers, d 64, 4 heads over 2 KV, d_ff 128, vocab 128, f32), expert
parallelism with the experts over ("model",) and ("model", "data"), the
level-3 heat block of a 2-layer EP MoE model's forward, the GPipe
pipeline over a (4,) stage mesh, and the training launcher.  The
parent process computes the JAX references and the single-process
launcher run.  Tolerances are the reference test's: loss 1e-4,
parameters 1e-3, EP outputs 1e-4, the pipeline 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.models import ModelConfig as RefModelConfig
from repro.models import build_model as ref_build_model
from repro.models.moe import MoEConfig as RefMoEConfig
from repro.models.moe import moe_defs as ref_moe_defs
from repro.models.moe import moe_ref as ref_moe_ref
from repro.models.params import init_params as ref_init_params
from repro.optim import adamw as ref_adamw
from repro.optim import constant as ref_constant
from repro.runtime import TrainConfig as RefTrainConfig
from repro.runtime import build_train_step as ref_build_train_step
from repro.runtime import init_state as ref_init_state
from repro_torch.launch import train as launch_train
from repro_torch.models.model import ModelConfig, params_from_reference

WORLD = 4
SPAWN_TIMEOUT = 240  # s; the spawn takes ~40-50 s on 4 ranks of an 8-core x86 CPU
TRAIN = dict(name="t", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=128, vocab=128)
MOE = dict(d_model=16, d_ff=32, n_experts=8, top_k=2, capacity_factor=8.0, moe_impl="ep")
# the heat block's model: two EP MoE layers, each of two all-to-alls of one
# (E, C, d) send buffer, on a batch that splits over "data" and a sequence
# over "model"
HEAT = dict(model_kwargs=dict(name="ep", family="moe", n_layers=2, d_model=32, n_heads=4,
                              n_kv_heads=2, d_ff=64, vocab=128, n_experts=8, top_k=2,
                              moe_impl="ep", capacity_factor=2.0),
            batch=4, seq=16)


@pytest.fixture(scope="module")
def reference():
    """The JAX package's single-device results, and the inputs the ranks get."""
    m = ref_build_model(RefModelConfig(**TRAIN, dtype=jnp.float32))
    params = m.init(jax.random.key(0))
    toks = jax.random.randint(jax.random.key(1), (8, 16), 0, 128)
    labs = jnp.roll(toks, -1, 1)
    opt, tc = ref_adamw(ref_constant(1e-2)), RefTrainConfig()
    step = ref_build_train_step(lambda p, t, l: m.loss(p, t, l), opt, tc, donate=False)
    st, met = step(ref_init_state(params, opt, tc), toks, labs)
    cfg = ModelConfig(**TRAIN, dtype=torch.float32)

    def to_state(tree):
        return {k: v.numpy() for k, v in params_from_reference(
            cfg, jax.tree.map(np.asarray, tree)).items()}

    moe_cfg = RefMoEConfig(**MOE)
    moe_params = ref_init_params(ref_moe_defs(moe_cfg), jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (4, 8, 16))
    y_ref, _ = ref_moe_ref(moe_params, x, moe_cfg)

    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((WORLD, 16, 16)) * 0.3).astype(np.float32)
    mbs = rng.standard_normal((8, 4, 16)).astype(np.float32)
    return dict(
        train_case=dict(cfg_kwargs=TRAIN, state_dict=to_state(params),
                        tokens=np.asarray(toks).astype(np.int64),
                        labels=np.asarray(labs).astype(np.int64)),
        train_loss=float(met["loss"]), train_params=to_state(st.params),
        ep_case=dict(moe_kwargs=MOE, params=jax.tree.map(np.asarray, moe_params),
                     x=np.asarray(x)),
        y_ref=np.asarray(y_ref),
        pipe_case=dict(ws=ws, mbs=mbs),
    )


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return torch_ranks.spawn(
        torch_ranks.multirank_checks, WORLD, tmp, SPAWN_TIMEOUT,
        train_case=reference["train_case"], ep_case=reference["ep_case"],
        pipe_case=reference["pipe_case"], heat_case=HEAT, ckpt=str(tmp / "ckpt"))


@pytest.mark.parametrize("order", [("data", "model"), ("model", "data")])
def test_a_dim_over_two_axes_gives_each_rank_jax_s_block(ranks, order):
    for rank, res in enumerate(ranks):
        got = res["placements"][order]
        assert got["local_is_jax_block"], (rank, got)
        assert got["full_is_input"], (rank, got)
    assert ranks[0]["placements"][("model", "data")]["placements"][0].startswith("_StridedShard")


def test_constrain_logical_lays_out_by_the_rules(ranks):
    for res in ranks:
        assert res["constrain"] == dict(placements=["Shard(dim=0)", "Shard(dim=2)"],
                                        equal=True, is_dtensor=True)


def test_sharded_train_step_matches_jax_single_device(ranks, reference):
    got = ranks[0]["train"]
    assert abs(got["loss_mesh"] - reference["train_loss"]) < 1e-4
    diff = max(float(np.abs(got["mesh"][k] - v).max())
               for k, v in reference["train_params"].items())
    assert diff < 1e-3
    for res in ranks:
        assert res["train"]["moments_sharded"]


def test_sharded_train_step_matches_the_port_on_one_device(ranks):
    for res in ranks:
        assert abs(res["train"]["loss_mesh"] - res["train"]["loss_one"]) < 1e-4
    got = ranks[0]["train"]
    assert max(float(np.abs(got["mesh"][k] - v).max()) for k, v in got["one"].items()) < 1e-3


@pytest.mark.parametrize("axes", [("model",), ("model", "data")])
def test_ep_matches_jax_moe_ref(ranks, reference, axes):
    y = ranks[0]["ep"][axes]["y"]
    assert float(np.abs(y - reference["y_ref"]).max()) < 1e-4
    auxes = {res["ep"][axes]["aux"] for res in ranks}
    assert len(auxes) == 1  # averaged over every rank


@pytest.mark.parametrize("axes", [("model",), ("model", "data")])
def test_ep_backward_through_the_exchange_matches_moe_ref(ranks, axes):
    for res in ranks:
        assert res["ep"][axes]["grad_err"] < 1e-5


def test_ep_heat_block_reports_the_all_to_alls_and_their_repeats(ranks):
    """Each rank's heat block: 2 all-to-alls a layer, each of the (E, C, d)
    buffer, (g - 1) / g of it on the wire over the model axis (g = 2), and
    that one signature listed under ``redundant`` with its count."""
    kw = HEAT["model_kwargs"]
    e, k, d = kw["n_experts"], kw["top_k"], kw["d_model"]
    g = 2  # the expert axis, ("model",): the batch splits over "data"
    t = HEAT["batch"] // 2 * (HEAT["seq"] // g)  # a rank's tokens
    cap = max(k, int(kw["capacity_factor"] * t * k / e))
    b = e * cap * d * 4
    n = 2 * kw["n_layers"]
    for res in ranks:
        heat, records = res["ep_heat"]["heat"], res["ep_heat"]["records"]
        assert set(heat) == {"collective_count", "collective_bytes", "bytes_by_op", "redundant"}
        a2a = [r for r in records if r["op"] == "all-to-all"]
        assert len(a2a) == n
        for r in a2a:
            assert r == dict(op="all-to-all", shape=f"f32[{e},{cap},{d}]", out_bytes=b,
                             group_size=g)
        assert heat["bytes_by_op"]["all-to-all"] == n * (g - 1) / g * b
        assert [f"all-to-all f32[{e},{cap},{d}]", n] in heat["redundant"]
        assert heat["collective_count"] == len(records)
        assert heat["collective_bytes"] == sum(heat["bytes_by_op"].values())


def test_pipeline_matches_sequential(ranks):
    for res in ranks:
        assert res["pipeline"]["err"] < 1e-5
        assert res["pipeline"]["err_full"] < 1e-5


def test_launcher_on_four_ranks_matches_one_process(ranks, tmp_path):
    argv = ["--smoke", "--device", "cpu", "--batch", "8", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    first = launch_train.main(argv + ["--steps", "3", "--ckpt-every", "2"])
    resumed = launch_train.main(argv + ["--steps", "1", "--resume"])
    for res in ranks:
        assert abs(res["launcher"]["first"]["final_loss"] - first["final_loss"]) < 1e-4
        assert abs(res["launcher"]["resumed"]["final_loss"] - resumed["final_loss"]) < 1e-4


def test_the_ranks_took_their_time(ranks):
    assert max(res["seconds"] for res in ranks) < SPAWN_TIMEOUT
