#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases:

1. Print the card's name and power limit, then build every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` and print the build time and the
   compiler's register/spill report.
2. For each GEMM kernel (v00, v01, v02) at the registry's 1024^3 shape,
   in float32 and bfloat16 on inputs from a fixed numpy seed: launch on
   the card, compare with the plain PyTorch version (float32 max abs
   error <= 1e-3; bfloat16 within 1e-2 of max|C|) and with the float64
   product on the host (within 1e-2 of max|C|), and time the kernel,
   the plain version and ``torch.matmul`` (the library yardstick, which
   the port never calls) as medians of CUDA-event-timed runs.
   Then the same for the GRAMSCHM kernels (naive, opt) and the TTM
   kernels (scratch, fused), each at the registry's shape and at a
   timing shape whose operands exceed the card's 50 MB L2: compare with
   the plain version (GRAMSCHM max abs error <= 1e-3, TTM <= 1e-5 of
   max|Y|) and, at the registry's shape, with the float64 product on the
   host (the same tolerances); time the kernel, the plain version and
   the library yardstick (``torch.mv``, ``torch.bmm``).
3. For each family (gemm, gramschm, ttm): set every launch count to 0
   and drive the port's main path in process, through the CLI entry
   point: ``profile`` each rung into the family's session, then ``diff``
   the first two iterations and ``report`` the second.  Each must exit
   0, the diff must show the family's pattern fixed (false sharing on C,
   strided on q, scratch abuse on Y_shr), and every kernel of the family
   must have been launched by that run.
4. Print one JSON line describing every kernel, then the result line.

There is no fallback: without a CUDA device, or outside a checkout of
the repository, the script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SHAPE = (1024, 1024, 1024)  # (m, n, k): the registry's gemm shape
ITERS = 30  # CUDA-event-timed runs per median

# Published peaks of an H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): device memory rate, and the peak rate for each input type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

REPLACES = {
    "v00": "src/repro/kernels/gemm.py:40",
    "v01": "src/repro/kernels/gemm.py:81",
    "v02": "src/repro/kernels/gemm.py:123",
    "gramschm_k3_naive": "src/repro/kernels/gramschm.py:29",
    "gramschm_k3_opt": "src/repro/kernels/gramschm.py:60",
    "ttm_scratch": "src/repro/kernels/ttm.py:36",
    "ttm_fused": "src/repro/kernels/ttm.py:46",
}
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"

# the case-study families' timing shapes, beside the registry's: their
# operands exceed the 50 MB L2, so a launch streams from device memory
TIMING_SHAPES = {
    "gramschm": (4096, 4096, 4096),  # (ni, nj, nk)
    "ttm": (262144, 8, 32),  # (f, nf, r)
}

# the story each family's diff must tell (phase 3)
FIXED = {
    "gemm": "[fixed] false-sharing on C",
    "gramschm": "[fixed] strided on q",
    "ttm": "[fixed] scratch-abuse on Y_shr",
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound_of(n_bytes: int, ops: int, dtype: str = "float32"):
    """(bound_ms, bound_by): the least time for work that must move
    ``n_bytes`` and do ``ops`` operations of ``dtype`` on this card."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bound(m: int, n: int, k: int, dtype: str, itemsize: int):
    """(bound_ms, bound_by): the least time for C = A·B on this card."""
    return bound_of((m * k + k * n + m * n) * itemsize, 2 * m * n * k, dtype)


def case_inputs(family: str, shape, dev):
    """One family's case at ``shape``, on inputs from a fixed numpy seed:
    {kernel name: (wrapper, args, kwargs)}, the float64 host product, the
    plain and library calls, and the bytes and FLOPs of the work."""
    import numpy as np
    import torch

    from repro_torch.kernels import GRAMSCHM_K, gramschm, ttm

    rng = np.random.default_rng(1)
    if family == "gramschm":
        ni, nj, nk = shape
        k = GRAMSCHM_K
        q_np = rng.standard_normal((ni, nk), dtype=np.float32)
        a_np = rng.standard_normal((ni, nj), dtype=np.float32)
        q = torch.from_numpy(q_np).to(dev)
        qt = q.t().contiguous()
        a = torch.from_numpy(a_np).to(dev)
        qk = q[:, k].contiguous()
        return dict(
            kernels={
                "gramschm_k3_naive": (gramschm.gramschm_k3_naive, (q, a), {"k": k}),
                "gramschm_k3_opt": (gramschm.gramschm_k3_opt, (qt, a), {"k": k}),
            },
            exact=lambda: q_np[:, k].astype(np.float64) @ a_np.astype(np.float64),
            plain=lambda: gramschm.gramschm_k3_plain(q, a, k),
            library=lambda: torch.mv(a.t(), qk),
            bytes=4 * (ni * nj + ni + nj),
            flops=2 * ni * nj,
            source="src/repro_torch/kernels/csrc/gramschm.cu",
        )
    f, nf, r = shape
    vals_np = rng.standard_normal((f, nf), dtype=np.float32)
    urows_np = rng.standard_normal((f, nf, r), dtype=np.float32)
    vals = torch.from_numpy(vals_np).to(dev)
    urows = torch.from_numpy(urows_np).to(dev)
    return dict(
        kernels={
            "ttm_scratch": (ttm.ttm_scratch, (vals, urows), {}),
            "ttm_fused": (ttm.ttm_fused, (vals, urows), {}),
        },
        exact=lambda: np.einsum(
            "fn,fnr->fr", vals_np.astype(np.float64), urows_np.astype(np.float64)
        ),
        plain=lambda: ttm.ttm_plain(vals, urows),
        library=lambda: torch.bmm(vals.unsqueeze(1), urows).squeeze(1),
        bytes=4 * (f * nf + f * nf * r + f * r),
        flops=2 * f * nf * r,
        source="src/repro_torch/kernels/csrc/ttm.cu",
    )


def check_cases(kreg, dev):
    """Phase 2 for the case-study kernels: {kernel name: record}, or a
    failure message."""
    import numpy as np
    import torch

    rows = {}
    registry_shapes = {"gramschm": kreg.GRAMSCHM_SHAPE, "ttm": kreg.TTM_SHAPE}
    for family, large in TIMING_SHAPES.items():
        for which, shape in (("registry", registry_shapes[family]), ("large", large)):
            case = case_inputs(family, shape, dev)
            want = case["plain"]()
            library = case["library"]()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            # GRAMSCHM: float32 sums of up to 4096 N(0,1) products in another
            # order; TTM: sums of 8 products, so the error is relative to |Y|
            tol = 1e-3 if family == "gramschm" else 1e-5 * scale
            exact = case["exact"]() if which == "registry" else None
            err_lib = float((library - want).abs().max())
            if not err_lib <= tol:
                return f"{family} {shape}: library call off by {err_lib} > {tol}"
            plain_ms = kreg.cuda_time_ms(case["plain"], ITERS)
            library_ms = kreg.cuda_time_ms(case["library"], ITERS)
            bms, bby = bound_of(case["bytes"], case["flops"])
            for name, (fn, args, kwargs) in case["kernels"].items():
                got = fn(*args, **kwargs)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.float32:
                    return f"{name} {shape}: output {tuple(got.shape)} {got.dtype}"
                if not bool(torch.isfinite(got).all()):
                    return f"{name} {shape}: non-finite output"
                err = float((got - want).abs().max())
                rec = dict(
                    shape=list(shape), max_abs_err=err,
                    ms=kreg.cuda_time_ms(lambda: fn(*args, **kwargs), ITERS),
                    plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                    library_ms=library_ms,
                )
                line = (
                    f"{name} {which} {shape}: max|err| {err:.3e} (tol {tol:.3e})"
                )
                if exact is not None:
                    rec["max_abs_err_vs_float64"] = float(
                        np.abs(got.double().cpu().numpy() - exact).max()
                    )
                    line += f", vs float64 {rec['max_abs_err_vs_float64']:.3e}"
                print(
                    f"{line}, median {rec['ms']:.4f} ms over {ITERS}, plain "
                    f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
                    f"{bms:.5f} ms ({bby}), {bms / rec['ms']:.1%} of bound"
                )
                if not err <= tol:
                    return f"{name} {shape}: max|err| {err} > {tol}"
                if exact is not None and not rec["max_abs_err_vs_float64"] <= tol:
                    return f"{name} {shape}: vs float64 {rec['max_abs_err_vs_float64']} > {tol}"
                if which == "registry":
                    rows[name] = dict(source=case["source"], **rec)
                else:
                    rows[name]["large"] = rec
            del case, want, library
            torch.cuda.empty_cache()
    return rows


def run_cli(cli, argv):
    """Run one CLI command in process; returns (exit code, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print(f"$ cuthermo {' '.join(argv)}  -> exit {rc}")
    print(out.rstrip())
    return rc, out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import cli
    from repro_torch import kernels as kreg
    from repro_torch.core.session import load_iteration
    from repro_torch.kernels import _build, gemm, gramschm, ttm

    # -- phase 1: the card, and the build ----------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, {card}")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        for line in Path(f"{path}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- phase 2: each kernel against its plain version ----------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    m, n, k = SHAPE
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((m, k), dtype=np.float32)
    b_np = rng.standard_normal((k, n), dtype=np.float32)
    rows = {}
    # bring the card to its working clocks before the first timed call
    warm = torch.from_numpy(a_np).to(dev)
    kreg.cuda_time_ms(lambda: torch.matmul(warm, warm), iters=200)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        a = torch.from_numpy(a_np).to(dev, dtype)
        b = torch.from_numpy(b_np).to(dev, dtype)
        want = gemm.gemm_plain(a, b)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        tol = 1e-3 if dtype == torch.float32 else 1e-2 * scale
        # an independent yardstick: the float64 product on the host, so a
        # kernel and a plain version that agree are also right
        exact = a.double().cpu().numpy() @ b.double().cpu().numpy()
        tol_exact = 1e-2 * scale
        plain_ms = kreg.cuda_time_ms(lambda: gemm.gemm_plain(a, b), ITERS)
        library_ms = kreg.cuda_time_ms(lambda: torch.matmul(a, b), ITERS)
        bms, bby = bound(m, n, k, dname, a.element_size())
        for v, fn in gemm.KERNELS.items():
            got = fn(a, b)
            torch.cuda.synchronize()
            if tuple(got.shape) != (m, n) or got.dtype != dtype:
                return fail(f"gemm_{v} {dname}: output {got.shape} {got.dtype}")
            if not bool(torch.isfinite(got).all()):
                return fail(f"gemm_{v} {dname}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            err_exact = float(np.abs(got.double().cpu().numpy() - exact).max())
            ms = kreg.cuda_time_ms(lambda: fn(a, b), ITERS)
            rows[(v, dname)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=bby, library_ms=library_ms,
                max_abs_err_vs_float64=err_exact,
            )
            print(
                f"gemm_{v} {dname} {m}x{n}x{k}: max|err| {err:.3e} "
                f"(tol {tol:.3e}), vs float64 {err_exact:.3e} (tol "
                f"{tol_exact:.3e}), launches so far {fn.launches}, "
                f"median {ms:.4f} ms over {ITERS}, plain {plain_ms:.4f} ms, "
                f"torch.matmul {library_ms:.4f} ms, bound {bms:.4f} ms "
                f"({bby}), {bms / ms:.1%} of bound"
            )
            if not err <= tol:
                return fail(f"gemm_{v} {dname}: max|err| {err} > {tol}")
            if not err_exact <= tol_exact:
                return fail(f"gemm_{v} {dname}: vs float64 {err_exact} > {tol_exact}")

    cases = check_cases(kreg, dev)
    if isinstance(cases, str):
        return fail(cases)

    # -- phase 3: the main path, profile -> diff -> report --------------------
    families = {
        "gemm": {f"gemm_{v}": (f"gemm:{v}", fn) for v, fn in gemm.KERNELS.items()},
        "gramschm": {
            f"gramschm_k3_{v}": (f"gramschm:{v}", fn)
            for v, fn in gramschm.KERNELS.items()
        },
        "ttm": {f"ttm_{v}": (f"ttm:{v}", fn) for v, fn in ttm.KERNELS.items()},
    }
    launches = {}
    for family, members in families.items():
        sess = ROOT / "build" / "chip_smoke_session" / family
        shutil.rmtree(sess, ignore_errors=True)
        kreg.reset_launch_counts()
        for ref, _ in members.values():
            rc, _ = run_cli(cli, ["profile", "-k", ref, "--out", str(sess), "-q"])
            if rc != 0:
                return fail(f"profile {ref} exited {rc}")
        counts = {name: fn.launches for name, (_, fn) in members.items()}
        rc, out = run_cli(cli, ["diff", str(sess / "iter0"), str(sess / "iter1")])
        if rc != 0:
            return fail(f"diff {family} exited {rc}")
        if FIXED[family] not in out:
            return fail(f"diff {family} does not show {FIXED[family]!r}")
        rc, _ = run_cli(cli, ["report", str(sess / "iter1")])
        if rc != 0:
            return fail(f"report {family} exited {rc}")
        print(f"main-path launches ({family}): {counts}")
        for name, count in counts.items():
            if count < 1:
                return fail(f"{name} was not launched by the main path")
        launches.update(counts)
        for i, (ref, _) in enumerate(members.values()):
            pk = load_iteration(sess / f"iter{i}").kernels[0]
            classes = sorted(f"{r.pattern}@{r.region}" for r in pk.reports)
            print(
                f"{ref} modeled transfers {pk.transactions}, patterns "
                f"{classes}, measured {pk.run['ms']:.4f} ms on {pk.run['device']}"
            )

    # -- phase 4: the record --------------------------------------------------
    kernels = []
    for v in gemm.KERNELS:
        row = rows[(v, "float32")]
        kernels.append(
            dict(
                name=f"gemm_{v}", route="cuda", source=SOURCE,
                replaces=REPLACES[v], launches=launches[f"gemm_{v}"], **row,
                bf16=rows[(v, "bfloat16")],
            )
        )
    for name, row in cases.items():
        kernels.append(
            dict(
                name=name, route="cuda", replaces=REPLACES[name],
                launches=launches[name], **row,
            )
        )
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": card,
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
