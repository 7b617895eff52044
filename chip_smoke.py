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
   Then the same for the three histogram kernels (naive, opt, opt2; bit
   for bit against the plain version and ``np.bincount``, yardstick
   ``torch.bincount``) and ``spmv_ell`` through ``ops.spmv`` (within
   1e-5 of max|y| of the plain version and of the float64 CSR product,
   yardstick ``torch.linalg.vecdot``), at the registry's size and at a
   timing size larger than L2; and every histogram kernel must drop ids
   outside [0, n_bins).
3. For each family (gemm, spmv, histogram, gramschm, ttm): set every
   launch count to 0 and drive the port's main path in process, through
   the CLI entry point: ``profile`` each rung into the family's session,
   then ``diff`` the family's pairs of iterations and ``report`` the
   last.  Each must exit 0, each diff must show the family's story (false
   sharing on C, misalignment on rowOffsets_shift1, false sharing on
   cell_count, strided on q, scratch abuse on Y_shr fixed), and every
   kernel of the family must have been launched by that run (spmv is
   spec-only: it has no kernel).  Then set the counts to 0 again and
   drive ``ops.spmv``, the entry point of ``spmv_ell``, once.
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
    "hist_naive": "src/repro/kernels/histogram.py:38",
    "hist_opt": "src/repro/kernels/histogram.py:72",
    "hist_opt2": "src/repro/kernels/histogram.py:97",
    "spmv_ell": "src/repro/kernels/spmv.py:31",
}
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"

# the case-study families' timing shapes, beside the registry's: their
# operands exceed the 50 MB L2, so a launch streams from device memory
TIMING_SHAPES = {
    "gramschm": (4096, 4096, 4096),  # (ni, nj, nk)
    "ttm": (262144, 8, 32),  # (f, nf, r)
    "histogram": (16777216, 2048),  # (cells, n_bins): 64 MiB of ids
    "spmv": (1048576, 32),  # (rows, ELL width): 256 MiB of vals and xg
}
SPMV_COLS = 36417  # the registry's column count
SPMV_WIDTH = 16  # ELL width at the registry's 65,536 rows

# the story each family's diffs must tell (phase 3), by pair of iterations;
# the histogram's and spmv's classes under the H100 geometry are ROADMAP
# queue 3 items 3 and 4
STORIES = {
    "gemm": {(0, 1): ["[fixed] false-sharing on C"]},
    "spmv": {(0, 1): ["[fixed] misalignment on rowOffsets_shift1"]},
    "histogram": {
        (0, 1): ["[fixed] false-sharing on cell_count",
                 "[INTRODUCED] false-sharing on partials"],
        (0, 2): ["[fixed] false-sharing on cell_count"],
    },
    "gramschm": {(0, 1): ["[fixed] strided on q"]},
    "ttm": {(0, 1): ["[fixed] scratch-abuse on Y_shr"]},
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

    from repro_torch.kernels import GRAMSCHM_K, gramschm, histogram, ops, ref, ttm

    rng = np.random.default_rng(1)
    if family == "histogram":
        n, n_bins = shape
        cells_np = rng.integers(0, n_bins, size=n).astype(np.int32)
        cells = torch.from_numpy(cells_np).to(dev)
        return dict(
            kernels={
                f"hist_{v}": (getattr(histogram, f"hist_{v}"), (cells,), {"n_bins": n_bins})
                for v in ("naive", "opt", "opt2")
            },
            exact=lambda: np.bincount(cells_np, minlength=n_bins),
            plain=lambda: histogram.hist_plain(cells, n_bins),
            library=lambda: torch.bincount(cells, minlength=n_bins),
            # integer counts below 2**24 are exact in float32 in any order
            tol=lambda scale: 0.0,
            bytes=4 * (n + n_bins),
            flops=n,
            source="src/repro_torch/kernels/csrc/histogram.cu",
        )
    if family == "spmv":
        rows, width = shape
        vals, xg, csr = spmv_inputs(rows, width, dev, rng)
        k = vals.shape[1]
        return dict(
            kernels={"spmv_ell": (ops.spmv, (vals, xg), {})},
            exact=lambda: ref.spmv_csr_ref(*csr),
            plain=lambda: ref.spmv_ref(vals, xg),
            library=lambda: torch.linalg.vecdot(vals, xg, dim=1),
            # float32 sums of up to 32 products in another order
            tol=lambda scale: 1e-5 * scale,
            bytes=4 * (2 * rows * k + rows),
            flops=2 * rows * k,
            source="src/repro_torch/kernels/csrc/spmv.cu",
        )
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
            # float32 sums of up to 4096 N(0,1) products in another order
            tol=lambda scale: 1e-3,
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
        # sums of 8 products, so the error is relative to |Y|
        tol=lambda scale: 1e-5 * scale,
        bytes=4 * (f * nf + f * nf * r + f * r),
        flops=2 * f * nf * r,
        source="src/repro_torch/kernels/csrc/ttm.cu",
    )


def spmv_inputs(rows: int, width: int, dev, rng):
    """A seeded CSR matrix of ``rows`` rows with 1 to ``width`` nonzeros
    each over the registry's columns, as ELL ``vals`` and ``xg`` on the
    card (x gathered in PyTorch, outside the kernel), and its float64 CSR
    arrays on the host."""
    import numpy as np
    import torch

    from repro_torch.kernels import spmv

    counts = rng.integers(1, width + 1, size=rows)
    row_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    col_indices = rng.integers(0, SPMV_COLS, size=int(row_offsets[-1])).astype(np.int32)
    values = rng.standard_normal(col_indices.size, dtype=np.float32)
    x = rng.standard_normal(SPMV_COLS, dtype=np.float32)
    idx, val = spmv.csr_to_ell(row_offsets, col_indices, values, rows)
    vals = torch.from_numpy(val).to(dev)
    xg = torch.from_numpy(x).to(dev)[torch.from_numpy(idx).to(dev).long()]
    csr = (row_offsets, col_indices, values.astype(np.float64), x.astype(np.float64))
    return vals, xg.contiguous(), csr


def launch_count(name: str) -> int:
    """Launches so far of the case-study kernel ``name``'s counting wrapper."""
    from repro_torch.kernels import gramschm, histogram, spmv, ttm

    for module in (gramschm, histogram, spmv, ttm):
        if hasattr(module, name):
            return getattr(module, name).launches
    raise KeyError(name)


def check_out_of_range(dev):
    """Every histogram kernel drops ids outside [0, n_bins): 1024 ids of
    which 384 are -1, 64 or 70, into 64 bins.  Returns a failure message
    or None."""
    import torch

    from repro_torch.kernels import histogram

    cells = torch.tensor([-1, 0, 1, 63, 64, 70, 5, 5] * 128, dtype=torch.int32, device=dev)
    want = histogram.hist_plain(cells, 64)
    for name, fn in histogram.KERNELS.items():
        got = fn(cells, 64)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or float(got.sum()) != 640 or float(got[63]) != 128:
            return f"histogram {name}: out-of-range ids were counted (total {float(got.sum())})"
    print("histogram kernels drop ids outside [0, n_bins): total 640 of 1024 ids, as the plain version")
    return None


def check_cases(kreg, dev):
    """Phase 2 for the case-study kernels: {kernel name: record}, or a
    failure message."""
    import numpy as np
    import torch

    rows = {}
    registry_shapes = {
        "gramschm": kreg.GRAMSCHM_SHAPE,
        "ttm": kreg.TTM_SHAPE,
        "histogram": kreg.HIST_SHAPE,
        "spmv": (kreg.SPMV_SHAPE[0], SPMV_WIDTH),
    }
    for family, large in TIMING_SHAPES.items():
        for which, shape in (("registry", registry_shapes[family]), ("large", large)):
            case = case_inputs(family, shape, dev)
            want = case["plain"]()
            library = case["library"]()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            tol = case["tol"](scale)
            exact = case["exact"]() if which == "registry" else None
            err_lib = float((library.float() - want).abs().max())
            if not err_lib <= tol:
                return f"{family} {shape}: library call off by {err_lib} > {tol}"
            plain_ms = kreg.cuda_time_ms(case["plain"], ITERS)
            library_ms = kreg.cuda_time_ms(case["library"], ITERS)
            bms, bby = bound_of(case["bytes"], case["flops"])
            for name, (fn, args, kwargs) in case["kernels"].items():
                before = launch_count(name)
                got = fn(*args, **kwargs)
                torch.cuda.synchronize()
                if launch_count(name) != before + 1:
                    return f"{name} {shape}: the call did not launch the kernel"
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
    from repro_torch.kernels import _build, gemm, gramschm, histogram, ops, ref, spmv, ttm

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
    msg = check_out_of_range(dev)
    if msg:
        return fail(msg)

    # -- phase 3: the main path, profile -> diff -> report --------------------
    # family -> [(registry ref, kernel name or None, counting wrapper or None)]
    families = {
        "gemm": [(f"gemm:{v}", f"gemm_{v}", fn) for v, fn in gemm.KERNELS.items()],
        "spmv": [(f"spmv:{v}", None, None) for v in kreg.get("spmv").variant_names()],
        "histogram": [
            (f"histogram:{v}", fn.__name__, fn) for v, fn in histogram.KERNELS.items()
        ],
        "gramschm": [
            (f"gramschm:{v}", f"gramschm_k3_{v}", fn)
            for v, fn in gramschm.KERNELS.items()
        ],
        "ttm": [(f"ttm:{v}", f"ttm_{v}", fn) for v, fn in ttm.KERNELS.items()],
    }
    launches = {}
    for family, members in families.items():
        sess = ROOT / "build" / "chip_smoke_session" / family
        shutil.rmtree(sess, ignore_errors=True)
        kreg.reset_launch_counts()
        for kref, _, _ in members:
            rc, _ = run_cli(cli, ["profile", "-k", kref, "--out", str(sess), "-q"])
            if rc != 0:
                return fail(f"profile {kref} exited {rc}")
        counts = {name: fn.launches for _, name, fn in members if fn is not None}
        for (a, b), lines in STORIES[family].items():
            rc, out = run_cli(cli, ["diff", str(sess / f"iter{a}"), str(sess / f"iter{b}")])
            if rc != 0:
                return fail(f"diff {family} iter{a} iter{b} exited {rc}")
            for line in lines:
                if line not in out:
                    return fail(f"diff {family} iter{a} iter{b} does not show {line!r}")
        rc, _ = run_cli(cli, ["report", str(sess / f"iter{len(members) - 1}")])
        if rc != 0:
            return fail(f"report {family} exited {rc}")
        print(f"main-path launches ({family}): {counts}")
        for name, count in counts.items():
            if count < 1:
                return fail(f"{name} was not launched by the main path")
        launches.update(counts)
        for i, (kref, _, _) in enumerate(members):
            pk = load_iteration(sess / f"iter{i}").kernels[0]
            classes = sorted(f"{r.pattern}@{r.region}" for r in pk.reports)
            measured = (
                f"measured {pk.run['ms']:.4f} ms on {pk.run['device']}"
                if pk.run else "spec only"
            )
            print(f"{kref} modeled transfers {pk.transactions}, patterns {classes}, {measured}")

    # spmv_ell's entry point is ops.spmv (the spmv family is spec-only)
    vals, xg, csr = spmv_inputs(
        kreg.SPMV_SHAPE[0], SPMV_WIDTH, dev, np.random.default_rng(2)
    )
    kreg.reset_launch_counts()
    y = ops.spmv(vals, xg)
    torch.cuda.synchronize()
    launches["spmv_ell"] = spmv.spmv_ell.launches
    print(f"main-path launches (ops.spmv): {{'spmv_ell': {launches['spmv_ell']}}}")
    if launches["spmv_ell"] < 1:
        return fail("spmv_ell was not launched by ops.spmv")
    want = ref.spmv_ref(vals, xg)
    tol = 1e-5 * float(want.abs().max())
    if tuple(y.shape) != (vals.shape[0],) or not bool(torch.isfinite(y).all()):
        return fail(f"ops.spmv: output {tuple(y.shape)} is not finite of {vals.shape[0]} rows")
    err = float((y - want).abs().max())
    err_exact = float(np.abs(y.double().cpu().numpy() - ref.spmv_csr_ref(*csr)).max())
    print(f"ops.spmv {tuple(vals.shape)}: max|err| {err:.3e}, vs float64 CSR {err_exact:.3e} (tol {tol:.3e})")
    if not (err <= tol and err_exact <= tol):
        return fail(f"ops.spmv: max|err| {err}, vs float64 {err_exact} > {tol}")

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
