"""The port's dry-run of the MLA path on the 2 x 16 x 16 mesh of
placeholder ranks, held to torch 2.11's DTensor and to the JAX package's
sharding specs: deepseek-v3's dense prefix and one MoE layer, its train
step and its prefill, each in a process of its own.

Its experts split over ("model", "data"), so its steps keep the 3-D mesh
(``launch/dryrun.py:flat_view``), where torch 2.13 plans each op over
three mesh dims: ~50 s for the train step alone on an 8-core x86 CPU.
The other families' cases are in ``test_torch_dryrun_families.py``; the
full depth runs on the card's host (``chip_smoke.py`` phase 10 (c)).
"""

import pytest

from test_torch_dryrun_families import check_step

TIMEOUT = 120  # s a case: room for the suite's other workers on the CPU

# (path, shape, depth): the dense prefix (3 layers) and one MoE layer
CASES = [
    ("mla_moe", "train_4k", 4),
    ("mla_prefill", "prefill_32k", 4),
]


@pytest.mark.parametrize("path,shape,layers", CASES, ids=[c[0] for c in CASES])
def test_mla_step_on_the_multi_pod_mesh(path, shape, layers):
    check_step("deepseek-v3-671b", shape, layers, TIMEOUT)
