"""The port's CUDA kernels on the card (marked ``gpu``; they skip elsewhere).

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as kreg
from repro_torch.kernels import gemm

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "mnk", [(32, 64, 32), (64, 64, 64), (128, 128, 64), (40, 72, 24), (1, 1, 1)]
)
def test_cuda_kernels_match_plain_version(card, dtype, mnk):
    m, n, k = mnk
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32)).to(card, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(card, dtype)
    want = gemm.gemm_plain(a, b).float()
    for fn in gemm.KERNELS.values():
        before = fn.launches
        got = fn(a, b)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == dtype and got.device == a.device
        tol = TOL[dtype] * k
        torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_cuda_wrappers_reject_mixed_devices(card):
    for fn in gemm.KERNELS.values():
        with pytest.raises(ValueError, match="device"):
            fn(torch.randn(4, 4, device=card), torch.randn(4, 4))


@pytest.mark.gpu
@pytest.mark.parametrize("ref", ["gemm:v00", "gemm:v01", "gemm:v02"])
def test_run_variant_launches_and_times_on_the_card(card, ref):
    variant = kreg.resolve(ref)[1]
    run = kreg.run_variant(variant, device=card, iters=3)
    assert run["device"] == torch.cuda.get_device_name(card)
    assert run["launches"] == 1 + 2 + 3  # the check, the warm-up, the timed runs
    assert run["ms"] > 0 and run["max_abs_err"] <= variant.atol
