"""The port's GEMM ladder: wrappers, plain versions and the registry.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the JAX package's Pallas kernels (interpret mode) and the port.
The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gemm as ref_gemm
from repro.kernels import ref as ref_oracles
from repro_torch import kernels as kreg
from repro_torch.kernels import _build, gemm, ops, ref

# as tests/test_kernels.py: the sums run in another order
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [(32, 64, 32), (64, 64, 64), (128, 128, 64)]


def _inputs(m, n, k, dtype):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    if dtype == "float32":
        return (jnp.asarray(a), jnp.asarray(b)), (torch.from_numpy(a), torch.from_numpy(b))
    return (
        (jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16)),
        (torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)),
    )


def _pallas(variant, a, b):
    if variant == "v00":
        return ref_gemm.gemm_v00(a, b, interpret=True)
    if variant == "v01":
        return ref_gemm.gemm_v01(a, b, bm=8, interpret=True)
    return ref_gemm.gemm_v02(a, b, bm=32, bn=32, bk=32, interpret=True)


@pytest.mark.parametrize("variant", ["v00", "v01", "v02"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mnk", SHAPES)
def test_matmul_matches_pallas_kernel(variant, dtype, mnk):
    m, n, k = mnk
    (ja, jb), (ta, tb) = _inputs(m, n, k, dtype)
    want = np.asarray(_pallas(variant, ja, jb).astype(jnp.float32))
    oracle = np.asarray(ref_oracles.gemm_ref(ja, jb).astype(jnp.float32))
    got = ops.matmul(ta, tb, variant=variant)
    assert got.dtype == ta.dtype and tuple(got.shape) == (m, n)
    got = got.float().numpy()
    tol = TOL[dtype] * k
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    gemm.reset_launch_counts()
    a, b = torch.randn(8, 4), torch.randn(4, 8)
    for fn in gemm.KERNELS.values():
        torch.testing.assert_close(fn(a, b), gemm.gemm_plain(a, b))
        assert fn.launches == 0
    assert ref.gemm_ref is gemm.gemm_plain


@pytest.mark.parametrize(
    "a, b, exc",
    [
        (torch.randn(4, 4, dtype=torch.float16), torch.randn(4, 4, dtype=torch.float16), TypeError),
        (torch.randn(4, 4), torch.randn(4, 4, dtype=torch.bfloat16), TypeError),
        (torch.randn(4), torch.randn(4, 4), ValueError),
        (torch.randn(4, 3), torch.randn(4, 4), ValueError),
        (torch.randn(4, 4).t(), torch.randn(4, 4), ValueError),
        (torch.randn(4, 4, device="meta"), torch.randn(4, 4, device="meta"), ValueError),
        (torch.randn(0, 4), torch.randn(4, 4), ValueError),
        (np.zeros((4, 4), np.float32), torch.randn(4, 4), TypeError),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(a, b, exc):
    for fn in gemm.KERNELS.values():
        with pytest.raises(exc):
            fn(a, b)


def test_matmul_unknown_variant():
    with pytest.raises(ValueError, match="v03"):
        ops.matmul(torch.randn(2, 2), torch.randn(2, 2), variant="v03")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc"):
        _build.build(["gemm"])
    assert not (tmp_path / "build").exists()


def test_library_name_tracks_the_source():
    assert set(_build.sources()) == {
        "flash", "gemm", "gmm", "gramschm", "histogram", "paged_decode", "ragged_decode",
        "spmv", "ssd", "ttm",
    }
    path = _build.library_path("gemm")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libgemm-") and path.suffix == ".so"


def test_registry_semantics():
    entry, variant = kreg.resolve("gemm")
    assert variant.name == "v00" and variant.role == "baseline"
    assert [v.name for _, v in entry.ladder()] == ["v01", "v02"]
    assert [pos for pos, _ in entry.ladder(2)] == [2]
    assert kreg.resolve("gemm:v02")[1].kernel is gemm.gemm_v02
    spec, ctx = kreg.build("gemm:v01")
    assert spec.name == "gemm_v01" and ctx is None
    assert spec.grid == (1024, 32)
    with pytest.raises(KeyError, match="known: gemm"):
        kreg.resolve("nosuch")
    with pytest.raises(KeyError, match="no variant"):
        kreg.resolve("gemm:v09")


def test_run_variant_on_cpu_runs_the_plain_version():
    gemm.reset_launch_counts()
    run = kreg.run_variant(kreg.resolve("gemm:v01")[1], device="cpu")
    assert run == {
        "device": "cpu",
        "shapes": [[1024, 1024], [1024, 1024]],
        "dtype": "float32",
        "max_abs_err": 0.0,
        "ms": None,
        "device_ms": None,
        "launches": 0,
    }


def test_run_variant_rejects_a_mismatch():
    import dataclasses

    variant = dataclasses.replace(
        kreg.resolve("gemm:v00")[1], kernel=lambda a, b: gemm.gemm_plain(a, b) + 1
    )
    with pytest.raises(kreg.KernelMismatch, match="exceeds"):
        kreg.run_variant(variant, device="cpu")
