"""The port's dry-run train step of each model family but MLA's on the
2 x 16 x 16 mesh of placeholder ranks, held to torch 2.11's DTensor and to
the JAX package's sharding specs.

One case per path the families take through the step, each cut in depth
and run in a process of its own (a ``"fake"`` process group of 512 ranks)
under its own timeout: the MoE (llama4-scout, expert parallelism), Mamba
(mamba2), the hybrid (one period of jamba), the encoder-decoder
(whisper-base) and the VL model (qwen2-vl-72b).  The MLA cases, slower
under torch 2.13, are in ``test_torch_dryrun_mla.py``.  Each step must
make no op that torch 2.11's DTensor refuses (``tests/torch_views.py``),
and each rank must hold the parameter bytes the reference's specs give
(``tests/torch_sharding_ref.py``).  The cells at full depth run on the
card's host (``chip_smoke.py`` phase 10 (c)).
"""

import pytest

import torch_sharding_ref as ref
import torch_views

TIMEOUT = 90  # s a case; each takes 6-17 s alone on an 8-core x86 CPU

# (path, arch, shape, depth)
CASES = [
    ("moe", "llama4-scout-17b-a16e", "train_4k", 1),
    ("mamba", "mamba2-2.7b", "train_4k", 1),
    ("hybrid", "jamba-v0.1-52b", "train_4k", 8),
    ("encdec", "whisper-base", "train_4k", 1),
    ("vl", "qwen2-vl-72b", "train_4k", 1),
]


def check_step(arch: str, shape: str, layers: int, timeout: float) -> None:
    """The cell cut to ``layers`` on 2 x 16 x 16: it finishes, makes no op
    torch 2.11 refuses, and holds the reference's parameter blocks."""
    res = torch_views.run_cell(arch, shape, True, layers, timeout)
    assert res["ok"] and res["chips"] == 512 and res["mesh"] == "2x16x16"
    assert res["refused"] == []
    assert res["param_bytes_per_device"] == ref.ref_param_bytes(arch, shape, True,
                                                                layers=layers)
    assert res["cost"]["flops"] > 0
    assert res["collectives"]["total_wire_bytes_per_device"] == sum(
        res["collectives"]["by_op"].values())


@pytest.mark.parametrize("path,arch,shape,layers", CASES, ids=[c[0] for c in CASES])
def test_family_step_on_the_multi_pod_mesh(path, arch, shape, layers):
    check_step(arch, shape, layers, TIMEOUT)
