"""The port's sharding rules and specs against the JAX package's (CPU,
one process, no process group).

Every published arch x shape x production mesh: the port's dry-run
decisions give the reference's rules table, every parameter the
reference's fixed-up spec (the reference's stacked ``"layer"`` dim
dropped, through ``reference_plan``) and the same per-device bytes; the
decode cells' caches the reference's cache specs.  Then the reference's
in-process sharding tests, and the no-op paths of the constraints.
"""

import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_sharding_ref as ref
from repro.configs import ARCH_IDS, SHAPES
from repro.parallel.sharding import make_rules as ref_make_rules
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models.model import reference_plan
from repro_torch.parallel import pipeline
from repro_torch.parallel.context import constrain_logical, split_dim, use_mesh, use_rules
from repro_torch.parallel.sharding import (
    P,
    Rules,
    cache_specs,
    fixup_specs,
    local_shape,
    make_rules,
    merge_axes,
    merge_spec_tree,
    spec_bytes,
    specs_from_logical,
    splits_apart,
)

CELLS = [(a, s, multi) for a in ARCH_IDS for s in SHAPES for multi in (False, True)]
IDS = [f"{a}-{s}-{'2x16x16' if m else '16x16'}" for a, s, m in CELLS]


@pytest.mark.parametrize("arch,shape_name,multi", CELLS, ids=IDS)
def test_param_specs_equal_the_reference(arch, shape_name, multi):
    port_rules, _ = dryrun.cell_rules(get_config(arch), SHAPES[shape_name],
                                      ref.FakeMesh(multi))
    assert port_rules.table == ref.ref_rules(arch, shape_name, multi).table
    want = ref.ref_param_specs(arch, shape_name, multi)
    got = ref.port_param_specs(arch, shape_name, multi)
    plan = reference_plan(get_config(arch))
    assert set(got) == set(plan)
    for name, spec in got.items():
        path, index = plan[name]
        ref_spec, ref_shape, _ = want[path]
        ref_spec = tuple(ref_spec)
        if index is not None:  # the reference's stacked "layer" dim
            assert ref_spec[0] is None
            ref_spec = ref_spec[1:]
        assert tuple(spec) == ref_spec, (name, spec, ref_spec)
    named = dict(ref.port_model(arch).named_parameters())
    assert spec_bytes(named, got, ref.FakeMesh(multi)) == ref.ref_param_bytes(
        arch, shape_name, multi)


DECODE = [(a, s, multi) for a, s, multi in CELLS if SHAPES[s].kind == "decode"]


@pytest.mark.parametrize("arch,shape_name,multi", DECODE,
                         ids=[IDS[CELLS.index(c)] for c in DECODE])
def test_cache_specs_equal_the_reference(arch, shape_name, multi):
    want = ref.ref_cache_specs(arch, shape_name, multi)
    got = ref.port_cache_specs(arch, shape_name, multi)
    assert len(got) == len(want)
    for layer, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), layer
        for name, spec in g.items():
            if name == "length":  # a Python int in the port, a scalar there
                assert spec == P()
                continue
            assert tuple(spec) == w[name], (layer, name, spec, w[name])


# -- the reference's in-process tests (tests/test_sharding_multidevice.py) ------


def test_rules_lookup_and_dedup():
    rules = make_rules(data_axes=("pod", "data"), fsdp=True, fsdp_axes=("pod", "data"))
    assert rules.get("batch") == ("pod", "data")
    assert rules.get("mlp") == ("model",)
    assert rules.get("layer") == ()
    # duplicate axis use across dims is deduped (first dim wins)
    assert rules.spec(("embed", "mlp")) == P(("pod", "data"), "model")
    assert rules.spec(("mlp", "mlp")) == P("model", None)
    # the same table and specs as the reference's
    theirs = ref_make_rules(data_axes=("pod", "data"), fsdp=True, fsdp_axes=("pod", "data"))
    assert rules.table == theirs.table
    for logical in (("embed", "mlp"), ("mlp", "mlp"), ("vocab", "embed"), (None, "heads")):
        assert rules.spec(logical) == theirs.spec(logical)


def test_extra_rules_take_precedence():
    rules = make_rules(extra=(("act_seq", ("model",)),))
    assert rules.get("act_seq") == ("model",)


def test_fixup_drops_nondivisible():
    class FakeMesh:
        shape = {"model": 16, "data": 16}

    spec = P(None, "model", None)
    assert fixup_specs(spec, torch.empty(64, 8, 128, device="meta"), FakeMesh()) == P(
        None, None, None)
    assert fixup_specs(spec, torch.empty(64, 32, 128, device="meta"), FakeMesh()) == P(
        None, "model", None)
    # a prefix of a dim's axes that still divides is kept
    assert fixup_specs(P(("data", "model")), torch.empty(32, device="meta"),
                       FakeMesh()) == P("data")


def test_partition_spec_equality_is_jax_s():
    for parts in [(None, "model"), (("pod", "data"), None), (("data",), "model"), ()]:
        assert P(*parts) == JP(*parts) == tuple(JP(*parts))
    assert P(None, "model") != P(None, "model", None)


def test_specs_from_logical_and_local_shape():
    rules = make_rules()
    specs = specs_from_logical({"w": ("embed", "mlp"), "b": ("mlp",), "s": ()}, rules)
    assert specs == {"w": P("data", "model"), "b": P("model"), "s": P()}
    assert local_shape((64, 128), specs["w"], ref.FakeMesh(False)) == (4, 8)
    assert local_shape((64, 128), P(("pod", "data"), None), ref.FakeMesh(True)) == (2, 128)


@pytest.mark.parametrize("arch", ["granite-8b", "jamba-v0.1-52b", "deepseek-v3-671b"])
def test_count_local_of_a_plain_pass_is_count(arch):
    """On plain tensors the dry-run's counter counts what the op sweep's
    does: the same FLOPs (products from the same formulas) and bytes."""
    from repro_torch.core import op_cost
    from repro_torch.models import build_model

    model = build_model(get_config(arch, smoke=True), device="meta")
    toks = torch.zeros((2, 16), dtype=torch.long, device="meta")

    def run():
        loss, _ = model.loss(toks, toks)
        return torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)

    _, want = op_cost.count(run)
    _, got = op_cost.count_local(run)
    assert (got.flops, got.product_flops, got.bytes, got.ops) == (
        want.flops, want.product_flops, want.bytes, want.ops)
    assert got.by_collective == want.by_collective == {}


def test_cache_specs_without_a_mesh_shard_nothing():
    rules = make_rules(seq_shard_cache=True)
    caches = [{"k": torch.empty(8, 64, 4, 16), "v": torch.empty(8, 64, 4, 16), "length": 3}]
    assert cache_specs(caches, rules) == [{"k": P(None, None, None, None),
                                           "v": P(None, None, None, None), "length": P()}]


def test_constraints_are_no_ops_off_a_mesh():
    x = torch.randn(4, 6, 8)
    assert constrain_logical(x, ("act_batch", None, None)) is x
    with use_rules(make_rules()):
        assert constrain_logical(x, ("act_batch", None, None)) is x  # no mesh
        with use_mesh(object()):
            assert constrain_logical(x, ("act_batch", None, None)) is x  # plain tensor
    assert torch.equal(split_dim(torch.arange(24).reshape(2, 12), 1, (3, 4)),
                       torch.arange(24).reshape(2, 3, 4))


def test_bubble_fraction():
    assert pipeline.bubble_fraction(4, 8) == 3 / 11
    assert pipeline.bubble_fraction(1, 8) == 0.0


def test_logical_specs_name_every_parameter():
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        model = ref.port_build_model(cfg, device="meta")
        logical = model.logical_specs()
        assert set(logical) == set(reference_plan(cfg)) == set(dict(model.named_parameters()))
        for name, p in model.named_parameters():
            assert len(logical[name]) == p.dim(), name
    assert isinstance(make_rules(), Rules)


# -- the multi-pod mesh's flat view (launch/dryrun.py:flat_view) -------------------


@pytest.mark.parametrize("part, apart, merged", [
    (None, False, None),
    ("model", False, "model"),
    (("pod", "data"), False, "pod_data"),
    (("model", "pod", "data"), False, ("model", "pod_data")),
    (("pod", "data", "model"), False, ("pod_data", "model")),
    (("model", "data"), True, None),
    ("pod", True, None),
    (("data", "pod"), True, None),
    (("pod", "model", "data"), True, None),
])
def test_splits_apart_and_merge_axes(part, apart, merged):
    assert splits_apart(part, ("pod", "data")) is apart
    if not apart:
        assert merge_axes(part, ("pod", "data"), "pod_data") == merged


def test_rules_and_spec_trees_merge_the_data_axes():
    rules = make_rules(data_axes=("pod", "data"), fsdp_axes=("pod", "data"),
                       expert_axes=("model", "pod", "data"))
    flat = rules.merged(("pod", "data"), "pod_data")
    assert flat.get("batch") == flat.get("embed") == ("pod_data",)
    assert flat.get("expert") == ("model", "pod_data") and flat.get("mlp") == ("model",)
    tree = {"w": P(("pod", "data"), "model"), "c": [P(None, ("model", "pod", "data"))]}
    assert merge_spec_tree(tree, ("pod", "data"), "pod_data") == {
        "w": P("pod_data", "model"), "c": [P(None, ("model", "pod_data"))]}


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_multi_pod_cells_take_the_flat_view_unless_a_spec_splits_pod_from_data(arch, shape_name):
    """Every multi-pod cell's layout names pod only beside data, so its step
    can run on the (pod_data, model) view, but deepseek-v3's: its 256
    experts split over ("model", "data") and repeat over the pods."""
    rules, decided = dryrun.cell_rules(get_config(arch), SHAPES[shape_name], ref.FakeMesh(True))
    trees = [ref.port_param_specs(arch, shape_name, True)]
    if SHAPES[shape_name].kind != "train":
        trees.append(ref.port_cache_specs(arch, shape_name, True))
    assert dryrun.can_flatten(rules, trees) is (arch != "deepseek-v3-671b")
    if arch == "deepseek-v3-671b":
        assert decided["expert_axes"] == ("model", "data")
