"""The port's op-level sweep (the counterpart of the JAX package's HLO
sweep), its counters and the H100 roofline, held against the reference.

The forward FLOPs are held against ``repro.core.model_profile.hlo_sweep``
on each registered model: the matrix products' FLOPs against the
reference's dot FLOPs within 5% (observed equal to 1e-4), with the
surplus of the reference's dense CPU lowering of ``ragged_dot`` taken
off (``torch_sweep_table.ragged_excess``), and transformer-tiny's total
within 5%.  Totals that count elementwise results differ by more
(materialized broadcasts count in XLA's HLO, views do not here): the
table script prints them beside the reference's, with the backward
counts, and PERF.md explains the gap.
"""

import dataclasses
import json
import socket
import types

import numpy as np
import pytest
import torch

from repro.core import hlo_thermo as ref_thermo
from repro.core import model_profile as ref_mp
from repro.core import roofline as ref_roofline
from repro.models.registry import MODELS as REF_MODELS
from repro_torch import cli
from repro_torch.core import op_cost, roofline
from repro_torch.core.model_profile import op_sweep, profile_model
from repro_torch.configs.archs import get_config
from repro_torch.core.render import _hlo_line
from repro_torch.models import build_model
from repro_torch.models.registry import get_model

from torch_sweep_table import dots_only, ragged_excess

SWEEP_TOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the sweep against the reference's ------------------------------------------------------


@pytest.mark.parametrize("name", list(REF_MODELS))
def test_sweep_forward_flops_match_the_reference(name):
    entry = REF_MODELS[name]
    with dots_only():
        ref_dots = ref_mp.hlo_sweep(entry.config, entry.batch, entry.seq)["cost"]["flops"]
    want = ref_dots - ragged_excess(entry.config, entry.batch, entry.seq)
    port_entry = get_model(name)
    got = op_sweep(port_entry.config, port_entry.batch, port_entry.seq)
    assert got["source"] == "torch-ops" and got["backward"] is False
    assert abs(got["cost"]["product_flops"] / want - 1) <= SWEEP_TOL
    assert got["heat"]["collective_count"] == 0 and got["cost"]["wire_bytes"] == 0
    assert got["cost"]["flops"] >= got["cost"]["product_flops"] > 0 and got["cost"]["bytes"] > 0
    if name == "transformer-tiny":
        ref_total = ref_mp.hlo_sweep(entry.config, entry.batch, entry.seq)["cost"]["flops"]
        assert abs(got["cost"]["flops"] / ref_total - 1) <= SWEEP_TOL


def test_sweep_backward_is_recorded():
    """forward+backward counts (recorded beside the reference's by the
    table script, not held): about three times the forward."""
    entry = get_model("transformer-tiny")
    fwd = op_sweep(entry.config, entry.batch, entry.seq)
    bwd = op_sweep(entry.config, entry.batch, entry.seq, backward=True)
    assert bwd["backward"] is True
    assert 2.5 < bwd["cost"]["product_flops"] / fwd["cost"]["product_flops"] < 3.5


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("name", list(REF_MODELS))
def test_sweep_on_meta_counts_what_a_pass_with_values_dispatches(name, backward):
    """The sweep runs on meta tensors; the same pass on the CPU, with
    seeded parameters and tokens (the dropless MoE's groups then come
    from the routing), counts the same FLOPs and bytes to the unit."""
    entry = get_model(name)
    gen = torch.Generator().manual_seed(3)
    model = build_model(entry.config, device="cpu", generator=gen)
    tokens = torch.randint(0, entry.config.vocab, (entry.batch, entry.seq), generator=gen)
    labels = torch.randint(0, entry.config.vocab, tokens.shape, generator=gen)
    if backward:
        def run():
            loss, _ = model.loss(tokens, labels)
            return torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    else:
        def run():
            with torch.no_grad():
                return model.apply(tokens)[0]
    _, cost = op_cost.count(run)
    assert op_sweep(entry.config, entry.batch, entry.seq, backward=backward)["cost"] == cost.as_dict()


def test_sweep_of_a_model_larger_than_memory_allocates_nothing():
    """Jamba-v0.1-52B at all 32 layers (51.6e9 parameters, 206 GB in
    float32) at 1 x 4096: counted on meta tensors in seconds; its products
    hold at least the active parameters' 2 FLOPs per token."""
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), dtype=torch.float32)
    total, active = cfg.param_counts()
    assert total * 4 > 200e9
    got = op_sweep(cfg, 1, 4096)["cost"]
    assert got["product_flops"] >= 2 * active * 4096 and got["bytes"] > total * 4


# -- the counters ----------------------------------------------------------------------------


def test_count_of_one_product():
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    out, cost = op_cost.count(lambda: a @ b)
    assert torch.equal(out, torch.full((8, 4), 16.0))
    assert cost.product_flops == 2 * 8 * 16 * 4 and cost.elementwise_flops == 0
    assert cost.bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)


def test_bmm_with_a_float32_result_is_counted():
    """The attention's half-precision products on the card (``bmm`` with
    ``out_dtype``), shown on meta tensors: the CPU has no such kernel."""
    a = torch.empty(3, 4, 5, device="meta", dtype=torch.bfloat16)
    b = torch.empty(3, 5, 6, device="meta", dtype=torch.bfloat16)
    out, cost = op_cost.count(lambda: torch.bmm(a, b, out_dtype=torch.float32))
    assert out.dtype == torch.float32 and cost.product_flops == 2 * 3 * 4 * 5 * 6


def test_views_move_nothing_and_elementwise_results_count_one_flop_each():
    x = torch.ones(6, 10)
    _, cost = op_cost.count(lambda: x.reshape(60)[:5].unsqueeze(0).t())
    assert cost.bytes == 0 and cost.flops == 0 and cost.ops >= 1
    # a reshape that must copy is a copy
    _, cost = op_cost.count(lambda: x.t().reshape(60))
    assert cost.bytes == 2 * 60 * 4 and cost.elementwise_flops == 60
    _, cost = op_cost.count(lambda: torch.exp(x))
    assert cost.flops == cost.elementwise_flops == 60 and cost.bytes == 2 * 60 * 4
    # an in-place op's destination is read and written once
    _, cost = op_cost.count(lambda: x.add_(1.0))
    assert cost.bytes == 60 * 4


def test_collectives_are_counted_with_their_wire_bytes():
    import torch.distributed as dist

    sock = socket.socket()
    sock.bind(("localhost", 0))
    port = sock.getsockname()[1]
    sock.close()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        x = torch.ones(1000)
        _, cost = op_cost.count(lambda: dist.all_reduce(x))
        assert cost.collective_count == 1 and cost.wire_bytes == 4000
        assert cost.flops == 0 and cost.bytes == 0
    finally:
        dist.destroy_process_group()


# -- the level-3 heat block ------------------------------------------------------------------

HEAT_KEYS = {"collective_count", "collective_bytes", "bytes_by_op", "redundant"}


@pytest.mark.parametrize("name", list(REF_MODELS))
def test_sweep_heat_block_equals_the_reference_s_on_one_device(name):
    entry = REF_MODELS[name]
    want = ref_mp.hlo_sweep(entry.config, entry.batch, entry.seq)["heat"]
    port_entry = get_model(name)
    got = op_sweep(port_entry.config, port_entry.batch, port_entry.seq)["heat"]
    assert set(got) == set(want) == HEAT_KEYS
    assert got == want
    assert got == {"collective_count": 0, "collective_bytes": 0, "bytes_by_op": {},
                   "redundant": []}


@pytest.mark.parametrize("group", [1, 2, 4, 16])
@pytest.mark.parametrize("op", ref_thermo.COLLECTIVE_OPS)
def test_ring_cost_from_shapes_matches_the_reference(op, group):
    out_bytes = 8 * 64 * 4  # f32[8,64]
    got = op_cost.Collective(op, "f32[8,64]", out_bytes, group).wire_bytes_per_device
    want = ref_thermo.CollectiveStats(op, "c", out_bytes, group).wire_bytes_per_device
    assert got == want
    assert set(op_cost.HLO_NAMES.values()) == set(ref_thermo.COLLECTIVE_OPS)


def test_heat_block_equals_the_reference_walker_on_the_same_collectives():
    """The same collectives as records and as HLO instructions (the
    reference's shape text, without a layout): the same block, repeats
    under ``redundant`` in the order first seen."""
    seen = [("all-gather", (8, 64), 4), ("all-to-all", (16, 32), 2),
            ("all-gather", (8, 64), 4), ("all-reduce", (1024,), 8),
            ("collective-permute", (4, 4), 2), ("all-to-all", (16, 32), 2),
            ("reduce-scatter", (2, 64), 4), ("all-gather", (8, 64), 2),
            ("all-to-all", (16, 32), 2)]
    lines, records = ["HloModule m", "ENTRY e {"], []
    for i, (op, shape, g) in enumerate(seen):
        text = f"f32[{','.join(map(str, shape))}]"
        groups = ",".join(map(str, range(g)))
        lines.append(f"  %c.{i} = {text} {op}(f32[2] %p), replica_groups={{{{{groups}}}}}")
        records.append(op_cost.Collective(op, text, 4 * int(np.prod(shape)), g))
    want = ref_thermo.analyze_hlo("\n".join(lines + ["}"])).as_dict()
    got = op_cost.OpCost(collectives=records).heat()
    assert got == want
    assert got["redundant"] == [["all-gather f32[8,64]", 2], ["all-to-all f32[16,32]", 3]]


def test_c10d_ops_are_recorded_by_the_reference_s_names(tmp_path):
    """Each functional collective, and the process-group all-reduce, on a
    one-rank group: recorded under the reference's name with its output's
    shape and the group's size (ring cost 0 on one rank); a broadcast,
    none of the five kinds, is counted as a collective but not recorded."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        name = dist.group.WORLD.group_name
        fc = torch.ops._c10d_functional
        x = torch.ones(4, 8)

        def run():
            for t in (fc.all_gather_into_tensor(x, 1, name), fc.reduce_scatter_tensor(x, "sum", 1, name),
                      fc.all_reduce(x, "sum", name), fc.all_to_all_single(x, [4], [4], name)):
                fc.wait_tensor(t)
            dist.all_reduce(x)
            dist.broadcast(x, 0)

        _, cost = op_cost.count(run)
    finally:
        dist.destroy_process_group()
    assert [(c.op, c.shape, c.out_bytes, c.group_size) for c in cost.collectives] == [
        (op, "f32[4,8]", 128, 1)
        for op in ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", "all-reduce")]
    assert cost.collective_count == 6
    assert cost.heat() == {"collective_count": 5, "collective_bytes": 0.0,
                           "bytes_by_op": {"all-gather": 0.0, "reduce-scatter": 0.0,
                                           "all-reduce": 0.0, "all-to-all": 0.0},
                           "redundant": [["all-reduce f32[4,8]", 2]]}


# -- cuthermo model ------------------------------------------------------------------------


def test_model_prints_the_op_sweep_and_writes_the_block(tmp_path, capsys):
    sess = tmp_path / "s"
    assert cli.main(["model", "transformer-tiny", "--device", "cpu", "--out", str(sess)]) == 0
    out = capsys.readouterr().out
    assert "  op sweep (forward): 1.1e+08 flops, " in out
    assert "not ported" not in out
    layers = json.loads((sess / "iter0" / "manifest.json").read_text())["layers"]
    hlo = layers["hlo"]
    assert hlo["source"] == "torch-ops" and hlo["backward"] is False
    assert set(hlo["cost"]) >= {"flops", "bytes", "wire_bytes"}
    assert hlo["heat"] == {"collective_count": 0, "collective_bytes": 0, "bytes_by_op": {},
                           "redundant": []}
    assert _hlo_line(hlo) in out


def test_model_backward_sweeps_the_gradients(tmp_path, capsys):
    argv = ["model", "transformer-tiny", "--device", "cpu", "--out", str(tmp_path / "s"),
            "--backward", "-q"]
    assert cli.main(argv) == 0
    # the attention backward recomputes each chunk's scores, as the
    # reference's custom VJP does: 2 layers x 2.1e6 FLOPs more than autograd
    assert "  op sweep (forward+backward): 3.35e+08 flops, " in capsys.readouterr().out


def test_no_hlo_omits_the_block(tmp_path, capsys):
    sess = tmp_path / "s"
    argv = ["model", "transformer-tiny", "--device", "cpu", "--out", str(sess), "--no-hlo"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "op sweep: skipped (--no-hlo)" in out and "flops" not in out
    assert "hlo" not in json.loads((sess / "iter0" / "manifest.json").read_text())["layers"]
    it = profile_model("mamba-tiny", tmp_path / "t", device="cpu", hlo=False)
    assert "hlo" not in it.layers


def test_no_hlo_help_describes_the_sweep(capsys):
    with pytest.raises(SystemExit):
        cli.main(["model", "--help"])
    out = " ".join(capsys.readouterr().out.split())
    assert "skip the op-level sweep" in out and "no sweep yet" not in out
    assert "meta tensors" in out


def test_sweep_line_labels_its_source():
    cost = {"flops": 1.5e9, "bytes": 2e6, "wire_bytes": 0}
    port = {"backward": False, "source": "torch-ops", "cost": cost, "heat": {"collective_count": 0}}
    ref = {"backward": True, "cost": cost, "heat": {"collective_count": 2}}
    assert _hlo_line(port) == ("op sweep (forward): 1.5e+09 flops, 2e+06 bytes, 0 wire bytes, "
                               "0 collectives")
    assert _hlo_line(ref).startswith("HLO sweep (forward+backward): 1.5e+09 flops")
    assert _hlo_line(ref).endswith("2 collectives")
    # repeated signatures are counted after the collectives, as the
    # reference's report does
    ref["heat"]["redundant"] = [["all-to-all f32[8,8,32]", 4]]
    assert _hlo_line(ref).endswith("2 collectives, 1 redundant")


# -- the roofline -----------------------------------------------------------------------------


def test_h100_terms_are_the_datasheet_s():
    assert roofline.PEAK_FLOPS_BF16 == 989e12 and roofline.PEAK_FLOPS_F32 == 67e12
    assert roofline.HBM_BW == 3.35e12 and roofline.HBM_PER_CHIP == 80e9
    assert roofline.NVLINK_BW_BIDIR == 900e9 and roofline.LINK_BW == 450e9


def test_from_raw_terms_follow_the_reference_formulas():
    args = ("x", 1, 2.57e13, 2.6e10, 9e8)
    got = roofline.from_raw(*args, model_flops=2.5e13)
    want = ref_roofline.from_raw(*args, model_flops=2.5e13)
    assert got.compute_s == pytest.approx(want.compute_s * ref_roofline.PEAK_FLOPS_BF16 / 989e12)
    assert got.memory_s == pytest.approx(want.memory_s * ref_roofline.HBM_BW / 3.35e12)
    assert got.collective_s == pytest.approx(9e8 / 450e9)
    assert got.bound == "compute" and got.step_s == got.compute_s
    assert got.roofline_fraction == 1.0
    assert got.mfu == pytest.approx(2.5e13 / 2.57e13)
    assert got.useful_flop_fraction == pytest.approx(2.5e13 / 2.57e13)
    assert got.share_of_bound(2 * got.step_s) == pytest.approx(0.5)
    assert set(got.as_dict()) >= set(want.as_dict())
    assert "compute-bound" in got.summary()
    f32 = roofline.from_raw("y", 1, 6.7e12, 0.0, 0.0, peak_flops=roofline.PEAK_FLOPS_F32)
    assert f32.compute_s == pytest.approx(0.1)
    mem = roofline.from_raw("z", 1, 1e9, 3.35e12, 0.0)
    assert mem.bound == "memory" and mem.step_s == pytest.approx(1.0)


def test_from_heatmap_counts_hbm_sectors():
    def region(space, temps, sector):
        return types.SimpleNamespace(
            region=types.SimpleNamespace(space=space, geometry=types.SimpleNamespace(sector_bytes=sector)),
            sector_temps_array=np.asarray(temps))

    hm = types.SimpleNamespace(regions=[region("hbm", [3, 4], 32), region("vmem_scratch", [9], 32)])
    terms = roofline.from_heatmap("k", hm, flops=1e6)
    assert terms.hlo_bytes == 7 * 32 and terms.hlo_flops == 1e6
