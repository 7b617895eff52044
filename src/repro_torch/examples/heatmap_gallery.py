"""Generate the heat-map GUI artifacts (paper Fig. 5) for every case
study through the session subsystem, into artifacts/heatmaps_torch/.

    PYTHONPATH=src python -m repro_torch.examples.heatmap_gallery [--device cpu]

Builds ONE profiling session with two iterations — iter0 profiles every
registered family's baseline rung, iter1 its last (most-optimized) rung —
then diffs them (the paper's before/after Table III) and writes a
self-contained report bundle per iteration.  Each rung that has a
hand-written kernel also launches it on the registry's seeded inputs,
held to its plain version and timed on the card, as ``cuthermo profile``
does; its record goes beside the heat map.  The same artifacts are
reachable from the command line:

    python -m repro_torch.cli profile --all --out artifacts/heatmaps_torch/session
    python -m repro_torch.cli report  artifacts/heatmaps_torch/session/iter0
"""

from __future__ import annotations

import argparse
import os
import shutil
from pathlib import Path

from repro_torch import kernels as kreg
from repro_torch.core.render import ReportEntry, run_text, write_report_bundle
from repro_torch.core.session import ProfileSession, profile_kernel
from repro_torch.examples import add_common_args, device_of

OUT = Path(__file__).resolve().parents[3] / "artifacts" / "heatmaps_torch"


def _profile(entry, variant, dev, seed):
    run = None if variant.kernel is None else kreg.run_variant(variant, dev, seed=seed)
    if run is not None:
        print(f"{entry.name}:{variant.name}: {run_text(run)}")
    return profile_kernel(
        variant.spec(),
        entry.sampler(),
        variant.dynamic_context(),
        name=entry.name,
        variant=variant.name,
        region_map=entry.region_map,
        run=run,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--out", default=str(OUT), help="the gallery's directory")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    out = os.path.normpath(args.out)
    os.makedirs(out, exist_ok=True)
    sess_dir = os.path.join(out, "session")
    shutil.rmtree(sess_dir, ignore_errors=True)
    sess = ProfileSession(sess_dir)

    # iter0: every baseline; iter1: the last (most-optimized) variant.
    # Region renames (gramschm q -> qT) ride along on each ProfiledKernel
    # and align the diff automatically.
    baselines, optimized = [], []
    for name in kreg.names():
        entry = kreg.get(name)
        baselines.append(_profile(entry, entry.variants[0], dev, args.seed))
        optimized.append(_profile(entry, entry.variants[-1], dev, args.seed))
    it0 = sess.add_iteration(baselines, label="baseline")
    it1 = sess.add_iteration(optimized, label="optimized")

    bundles = {}
    for it in (it0, it1):
        entries = [ReportEntry.from_profiled(pk) for pk in it.kernels]
        bundles[it.label] = write_report_bundle(
            entries, os.path.join(str(it.path), "report"),
            title=f"cuthermo gallery — {it.label}",
        )

    sd = sess.diff(it0, it1)
    with open(os.path.join(out, "gallery_diff.txt"), "w") as f:
        f.write(sd.summary() + "\n")
    print(sd.summary())
    print(f"\nwrote session + report bundles under {sess_dir}")
    return {
        "session": sess_dir,
        "rungs": {it.label: [(pk.name, pk.variant) for pk in it.kernels] for it in (it0, it1)},
        "runs": {f"{pk.name}:{pk.variant}": pk.run for it in (it0, it1) for pk in it.kernels
                 if pk.run is not None},
        "bundles": {label: written["index.html"] for label, written in bundles.items()},
        "summary": sd.summary(),
    }


if __name__ == "__main__":
    main()
