"""Quickstart: the paper's tuning loop through the session API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The paper's Fig. 2 workflow end to end on the GEMM case study —
profile -> heat map -> pattern -> fix -> re-profile — with every
iteration persisted to a session directory that the ``cuthermo`` CLI
(and any later process) can reload, re-render and diff:

    python -m repro_torch.cli diff <out>/iter0 <out>/iter1

The heat maps describe the hand-written CUDA kernels' warps under the
H100 sector geometry; step 4 launches those kernels through
``repro_torch.kernels.ops`` (on the CPU, their plain versions).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.core import api
from repro_torch.core.render import ReportEntry, render_ascii, write_report_bundle
from repro_torch.examples import add_common_args, card_label, device_of
from repro_torch.kernels import ops
from repro_torch.kernels.gemm import gemm_v00_spec, gemm_v01_spec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "cuthermo-quickstart"),
                    help="the session directory (replaced)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    m = n = k = 1024
    shutil.rmtree(args.out, ignore_errors=True)
    sess = api.ProfileSession(args.out)

    print("== step 1: profile the naive kernel (gemm_v00) -> iter0 ==")
    it0 = sess.profile(
        [gemm_v00_spec(m, n, k)],
        names={"gemm_v00": "gemm"},
        variants={"gemm_v00": "v00"},
        note="baseline: a warp's lanes on 32 rows of one column of C",
    )
    gemm0 = it0.kernel("gemm")
    print(api.format_report(gemm0.heatmap))
    print("\nheat map (first rows):")
    print(render_ascii(gemm0.heatmap, max_rows_per_region=4))

    print("== step 2: apply the top action (coalesce: a warp's lanes on 32 "
          "columns of one row) -> gemm_v01 -> iter1 ==")
    it1 = sess.profile(
        [gemm_v01_spec(m, n, k)],
        names={"gemm_v01": "gemm"},
        variants={"gemm_v01": "v01"},
        note="fix: the thread indices swapped",
    )

    print("== step 3: diff the iterations (the tuning-loop verdict) ==")
    sd = sess.diff(it0, it1)
    print(sd.summary())
    v = sd.verdicts[0]
    print(f"\nmodeled transfer speedup: {v.speedup_estimate:.1f}x "
          "(paper measured 7.2x cycle speedup for this fix)")

    print("\n== step 4: the kernels still agree ==")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    a = torch.randn((256, 256), generator=gen, device=dev)
    b = torch.randn((256, 256), generator=gen, device=dev)
    d0 = ops.matmul(a, b, variant="v00")
    d1 = ops.matmul(a, b, variant="v01")
    diff = float((d0 - d1).abs().max())
    print(f"max |v00 - v01| = {diff} ({card_label(dev)})")

    entries = [ReportEntry.from_profiled(pk) for pk in it1.kernels]
    written = write_report_bundle(entries, os.path.join(args.out, "report"),
                                  title="quickstart — iter1")
    print(f"\nsession persisted to {args.out} "
          f"(report bundle: {written['index.html']})")
    return {
        "transfers": {"v00": gemm0.transactions, "v01": it1.kernel("gemm").transactions},
        "patterns": {
            rung: sorted(f"{r.pattern}@{r.region}" for r in it.kernel("gemm").reports)
            for rung, it in (("v00", it0), ("v01", it1))
        },
        "speedup_estimate": v.speedup_estimate,
        "max_abs_diff": diff,
        "device": card_label(dev),
        "session": args.out,
        "report": written["index.html"],
    }


if __name__ == "__main__":
    main()
