"""Rebuild the port's committed CI baseline (artifacts/ci-baseline-torch).

The counterpart of ``tools/make_ci_baseline.py`` for ``repro_torch``.  The
port's ``check-smoke`` CI job (``.github/workflows/ci-torch.yml``) and
``chip_smoke.py``'s phase 12 profile the same three optimized rungs fresh
and gate them with ``cuthermo-torch check --baseline`` against the
iteration this script writes.  Profiling is integer arithmetic over seeded
contexts under the port's default ``H100Sector`` geometry, so a fresh
profile on any host (the CPU or the card) matches the committed baseline
exactly: only the manifest's timestamps and ``wall_s`` differ between
runs.  Any other drift is what the gate exists to catch.

Regenerate (only after a deliberate change to the profiler's modeled
counts or the registry's kernels) with::

    PYTHONPATH=src python tools/make_ci_baseline_torch.py

then commit the updated ``artifacts/ci-baseline-torch``.  ``--out DIR``
writes elsewhere (the tests write to a temporary directory).  No kernel
runs: the baseline holds heat maps only, so the writer needs no card.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch import kernels as kreg  # noqa: E402
from repro_torch.core.session import profile_kernel, write_iteration  # noqa: E402

#: The baseline rungs, the reference's own: family name -> registry ref.
#: Each is stored under its family name, the name ``profile --kernel REF``
#: gives it and ``check`` aligns on.
BASELINE_REFS = {
    "gemm": "gemm:v01",
    "gramschm": "gramschm:opt",
    # the transformer-tiny FFN GEMM on its blocked rung, synthesized by
    # repro_torch.models.registry.kernel_entry
    "model.transformer-tiny.mlp": "model.transformer-tiny.mlp:v02",
}

OUT = Path(__file__).resolve().parent.parent / "artifacts" / "ci-baseline-torch"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(OUT),
                        help=f"iteration directory to write (default {OUT})")
    args = parser.parse_args(argv)
    profiled = []
    for name, ref in BASELINE_REFS.items():
        # as `profile --kernel REF` profiles it: the entry's own sampler
        # and region map; no kernel runs
        entry, variant = kreg.resolve(ref)
        spec, ctx = kreg.build(ref)
        pk = profile_kernel(
            spec,
            entry.sampler(),
            ctx,
            name=name,
            variant=variant.name,
            region_map=entry.region_map,
        )
        profiled.append(pk)
        print(f"profiled {ref} as {name!r}: {pk.transactions} transfers, "
              f"{len(pk.reports)} patterns", file=sys.stderr)
    write_iteration(
        args.out,
        profiled,
        label="ci-baseline-torch",
        note="committed baseline for the port's check-smoke gate "
        "(tools/make_ci_baseline_torch.py)",
    )
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
