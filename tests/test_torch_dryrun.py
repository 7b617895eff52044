"""The port's dry-run on placeholder ranks (a ``"fake"`` process group with
meta tensors), held against the JAX package's sharding specs.

One subprocess (a process group of its own) runs ``run_cell`` on
granite-3-2b x decode_32k, the reference test's cell
(``tests/test_dryrun.py``), on the 16 x 16 mesh and then the 2 x 16 x 16
one, and ``main`` on an unknown arch.  Each cell must finish, count
FLOPs, hold per device the parameter bytes the reference's specs give,
and count, summed over the chips, at least the model's FLOPs in matrix
products; its counts are the ones recorded in ``DECODE_32K``.  A second
subprocess runs granite-3-2b x train_4k at depth 1 on 2 x 16 x 16, which
the step's flat view of the mesh (``launch/dryrun.py:flat_view``) makes
finish (ROADMAP queue 3 item 11).
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import torch_sharding_ref as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120  # s; the subprocess takes ~25-30 s on an 8-core x86 CPU

SCRIPT = textwrap.dedent("""
    import json, sys, time
    from repro_torch.launch import dryrun
    out = {}
    for multi in (False, True):
        dryrun.fake_world(512 if multi else 256)
        t0 = time.perf_counter()
        res = dryrun.run_cell("granite-3-2b", "decode_32k", multi, verbose=False,
                              out_dir=sys.argv[1] + ("/multi" if multi else "/single"))
        res["wall_s"] = time.perf_counter() - t0
        out["multi" if multi else "single"] = res
    try:
        dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                     "--out", sys.argv[1] + "/bad"])
        out["bad_exit"] = 0
    except SystemExit as e:
        out["bad_exit"] = e.code
    print(json.dumps(out))
""")


TRAIN_SCRIPT = textwrap.dedent("""
    import json, sys, time
    import torch_views
    from repro_torch.launch import dryrun

    # the ops torch 2.11's DTensor refuses, a view that merges a split dim
    # into the dim before it among them (torch 2.13 lays it out as
    # _StridedShard)
    refused = torch_views.watch()
    dryrun.fake_world(512)
    t0 = time.perf_counter()
    res = dryrun.run_cell("granite-3-2b", "train_4k", True, verbose=False, layers=1,
                          out_dir=sys.argv[1])
    res["wall_s"] = time.perf_counter() - t0
    res["refused_views"] = refused
    print(json.dumps(res))
""")

# granite-3-2b x decode_32k on both meshes as the dry-run counted it before
# the multi-pod step's flat view (a decode cell keeps the 3-D mesh)
DECODE_32K = {
    "16x16": {
        "cost": {"flops": 160849123348.0, "bytes": 516860410080.0,
                 "product_flops": 9164554240.0, "ops": 8515},
        "by_op": {"all_gather_into_tensor": 1439252480.0, "reduce_scatter_tensor": 1310720.0,
                  "all_reduce": 15056896.0},
        "memory": {"argument_size_in_bytes": 1816989760.0,
                   "output_size_in_bytes": 1342279680.0,
                   "alias_size_in_bytes": 1342177280.0, "peak_bytes": 2622412820.0},
        "param_bytes_per_device": 474812416,
    },
    "2x16x16": {
        "cost": {"flops": 145807106632.0, "bytes": 459349568096.0,
                 "product_flops": 4582277120.0, "ops": 9155},
        "by_op": {"all_gather_into_tensor": 726179840.0, "reduce_scatter_tensor": 655360.0,
                  "all_reduce": 7528448.0},
        "memory": {"argument_size_in_bytes": 1145901088.0,
                   "output_size_in_bytes": 671139840.0,
                   "alias_size_in_bytes": 671088640.0, "peak_bytes": 1548612628.0},
        "param_bytes_per_device": 474812416,
    },
}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp)], capture_output=True,
                         text=True, env=env, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["dir"] = tmp
    return res


@pytest.mark.parametrize("multi", [False, True], ids=["single16x16", "multi2x16x16"])
def test_one_cell_runs_on_placeholder_ranks(cells, multi):
    res = cells["multi" if multi else "single"]
    assert res["ok"]
    assert res["chips"] == (512 if multi else 256)
    assert res["mesh"] == ("2x16x16" if multi else "16x16")
    assert res["cost"]["flops"] > 0
    assert res["cost"]["product_flops"] * res["chips"] >= res["model_flops"]
    assert res["collectives"]["total_wire_bytes_per_device"] == sum(
        res["collectives"]["by_op"].values())
    assert res["weight_stationary"]


@pytest.mark.parametrize("multi", [False, True], ids=["single16x16", "multi2x16x16"])
def test_per_device_parameter_bytes_are_the_reference_specs(cells, multi):
    res = cells["multi" if multi else "single"]
    assert res["param_bytes_per_device"] == ref.ref_param_bytes("granite-3-2b", "decode_32k",
                                                                multi)
    mem = res["memory"]
    assert mem["argument_size_in_bytes"] >= res["param_bytes_per_device"]
    assert mem["peak_bytes"] >= res["param_bytes_per_device"]
    assert res["per_device_bytes"] == (mem["argument_size_in_bytes"]
                                       + mem["output_size_in_bytes"]
                                       - mem["alias_size_in_bytes"])


@pytest.mark.parametrize("multi", [False, True], ids=["single16x16", "multi2x16x16"])
def test_artifact_has_the_reference_keys(cells, multi):
    path = cells["dir"] / ("multi" if multi else "single") / "granite-3-2b__decode_32k.json"
    with open(path) as f:
        d = json.load(f)
    for key in ("roofline", "memory", "collectives", "bound", "model_flops",
                "per_device_bytes", "cost", "lower_s", "compile_s"):
        assert key in d
    assert d["roofline"]["chips"] == d["chips"]


def test_main_reports_a_failing_cell_and_exits_1(cells):
    assert cells["bad_exit"] == 1


def test_each_cell_is_quick(cells):
    assert cells["single"]["wall_s"] < TIMEOUT / 2
    assert cells["multi"]["wall_s"] < TIMEOUT / 2


@pytest.mark.parametrize("multi", [False, True], ids=["single16x16", "multi2x16x16"])
def test_decode_cell_counts_are_the_recorded_ones(cells, multi):
    res = cells["multi" if multi else "single"]
    want = DECODE_32K[res["mesh"]]
    assert res["cost"] == want["cost"]
    assert res["collectives"]["by_op"] == want["by_op"]
    assert {k: res["memory"][k] for k in want["memory"]} == want["memory"]
    assert res["param_bytes_per_device"] == want["param_bytes_per_device"]
    assert res["mesh_view"] == res["mesh"]


@pytest.fixture(scope="module")
def train_cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_train")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")]))
    out = subprocess.run([sys.executable, "-c", TRAIN_SCRIPT, str(tmp)], capture_output=True,
                         text=True, env=env, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["dir"] = tmp
    return res


def test_multi_pod_train_cell_finishes_on_the_flat_view(train_cell):
    """2 x 16 x 16 train_4k at depth 1: 887 s on the 3-D mesh (DTensor's
    strategy search over strided placements), ~13 s on its 32 x 16 view."""
    res = train_cell
    assert res["ok"] and res["chips"] == 512
    assert (res["mesh"], res["mesh_view"]) == ("2x16x16", "32x16")
    assert res["wall_s"] < TIMEOUT
    assert res["cost"]["flops"] > 0 and res["collectives"]["total_wire_bytes_per_device"] > 0
    assert (res["dir"] / "granite-3-2b__train_4k.json").is_file()


def test_multi_pod_train_cell_holds_the_reference_s_parameter_blocks(train_cell):
    """Each rank's blocks on the flat view, read off its DTensors, are the
    bytes the reference's specs give on the 3-D mesh."""
    assert train_cell["param_bytes_per_device"] == ref.ref_param_bytes(
        "granite-3-2b", "train_4k", True, layers=1)


def test_multi_pod_train_step_makes_no_view_torch_2_11_refuses(train_cell):
    """Each block's normed input is gathered over the sequence before its
    products, and each product's output laid out as the residual stream
    before the add, so no product flattens a sequence split over the model
    axis into the batch (the card's torch 2.11 refuses such a view)."""
    assert train_cell["refused_views"] == []
