"""The port's dry-run on placeholder ranks (a ``"fake"`` process group with
meta tensors), held against the JAX package's sharding specs.

One subprocess (a process group of its own) runs ``run_cell`` on
granite-3-2b x decode_32k, the reference test's cell
(``tests/test_dryrun.py``), on the 16 x 16 mesh and then the 2 x 16 x 16
one, and ``main`` on an unknown arch.  Each cell must finish, count
FLOPs, hold per device the parameter bytes the reference's specs give,
and count, summed over the chips, at least the model's FLOPs in matrix
products.
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
