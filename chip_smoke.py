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
3. Set every launch count to 0 and drive the port's main path in
   process, through the CLI entry point: ``profile`` gemm:v00, v01 and
   v02 into one session, then ``diff`` iter0 iter1 and ``report`` iter1.
   Each must exit 0, the diff must show false sharing on C fixed, and
   every kernel must have been launched by that run.
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
}
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound(m: int, n: int, k: int, dtype: str, itemsize: int):
    """(bound_ms, bound_by): the least time for C = A·B on this card."""
    bytes_ms = (m * k + k * n + m * n) * itemsize / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2 * m * n * k / PEAK_OPS_PER_S[dtype] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


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
    from repro_torch.kernels import _build, gemm

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

    # -- phase 3: the main path, profile -> diff -> report --------------------
    sess = ROOT / "build" / "chip_smoke_session"
    shutil.rmtree(sess, ignore_errors=True)
    gemm.reset_launch_counts()
    for v in gemm.KERNELS:
        rc, _ = run_cli(cli, ["profile", "-k", f"gemm:{v}", "--out", str(sess), "-q"])
        if rc != 0:
            return fail(f"profile gemm:{v} exited {rc}")
    launches = {v: fn.launches for v, fn in gemm.KERNELS.items()}
    rc, out = run_cli(cli, ["diff", str(sess / "iter0"), str(sess / "iter1")])
    if rc != 0:
        return fail(f"diff exited {rc}")
    if "[fixed] false-sharing on C" not in out:
        return fail("diff gemm:v00 -> v01 does not show false sharing on C fixed")
    rc, _ = run_cli(cli, ["report", str(sess / "iter1")])
    if rc != 0:
        return fail(f"report exited {rc}")
    print(f"main-path launches: {launches}")
    for v, count in launches.items():
        if count < 1:
            return fail(f"gemm_{v} was not launched by the main path")
    for i, v in enumerate(gemm.KERNELS):
        pk = load_iteration(sess / f"iter{i}").kernels[0]
        classes = sorted(f"{r.pattern}@{r.region}" for r in pk.reports)
        print(
            f"gemm:{v} modeled transfers {pk.transactions}, patterns "
            f"{classes}, measured {pk.run['ms']:.4f} ms on {pk.run['device']}"
        )

    # -- phase 4: the record --------------------------------------------------
    kernels = []
    for v in gemm.KERNELS:
        row = rows[(v, "float32")]
        kernels.append(
            dict(
                name=f"gemm_{v}", route="cuda", source=SOURCE,
                replaces=REPLACES[v], launches=launches[v], **row,
                bf16=rows[(v, "bfloat16")],
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
