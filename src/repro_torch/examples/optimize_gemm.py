"""The full performance-tuning iteration of the paper (Fig. 2), three rounds:

    v00 --(false sharing on C)--> v01 --(hot B)--> v02 (blocked tiles)

    PYTHONPATH=src python -m repro_torch.examples.optimize_gemm [--device cpu]

Each round: profile -> detect -> act -> re-profile, with the modeled
transfers per row of C printed per round, and the rung's hand-written
kernel launched on seeded 1024^3 inputs and held to its plain version
(timed with CUDA events on the card).  The first two rounds admit the
programs of the first 32 coordinates of the grid's leading axis
(``GridSampler((0,), window=32)``), the third the whole grid; a round's
rows of C are those its admitted programs store.
"""

from __future__ import annotations

import argparse

from repro_torch import kernels as kreg
from repro_torch.core import api
from repro_torch.core.trace import GridSampler
from repro_torch.examples import add_common_args, card_label, device_of
from repro_torch.kernels.gemm import gemm_v00_spec, gemm_v01_spec, gemm_v02_spec

M = N = K = 1024


def c_rows(hm) -> float:
    """Rows of C (in whole rows' worth of elements) the admitted programs
    store: the words of C touched, in elements, over N."""
    rh = hm.region("C")
    geometry = rh.region.geometry
    words = int((rh.word_temps_matrix > 0).sum())
    return words * geometry.word_bytes / geometry.itemsize / N


def round_report(title, spec, sampler):
    hm = api.heatmap(spec, sampler)
    pats = api.detect_all(hm)
    tx = hm.sector_transactions() / c_rows(hm)
    print(f"\n--- {title}: {tx:.0f} transfers per C row ---")
    for p in pats:
        print(f"  [{p.pattern}] {p.region}: {p.evidence[0][:90]}")
    acts = api.advise(hm)
    if acts:
        print(f"  next action -> {acts[0].kind}({acts[0].region}): "
              f"{acts[0].description[:90]}")
    return hm, pats, tx


def launch(rung: str, dev, seed: int) -> dict:
    """The rung's kernel on the registry's seeded inputs, against its
    plain version (and timed, on the card)."""
    run = kreg.run_variant(kreg.get("gemm").variant(rung), dev, seed=seed)
    where = card_label(dev)
    timed = (f"{run['device_ms']:.4f} ms a call on the card ({run['ms']:.4f} ms with host issue)"
             if run["ms"] is not None else "the plain version")
    print(f"  ran gemm_{rung} {run['launches']}x: {timed} on {where}, "
          f"max |err| vs plain {run['max_abs_err']:.2e}")
    return dict(run, card=where)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    s32 = GridSampler((0,), window=32)
    rounds = {}
    for rung, title, spec, sampler in (
        ("v00", "round 0: gemm_v00 (a warp's lanes on 32 rows of one column)",
         gemm_v00_spec(M, N, K), s32),
        ("v01", "round 1: gemm_v01 (a warp's lanes on 32 columns of one row)",
         gemm_v01_spec(M, N, K), s32),
        ("v02", "round 2: gemm_v02 (blocked tiles of 64 x 128, K looped in the block)",
         gemm_v02_spec(M, N, K), GridSampler(None)),
    ):
        hm, pats, tx = round_report(title, spec, sampler)
        rounds[rung] = dict(
            transfers=hm.sector_transactions(), per_row=tx, c_rows=c_rows(hm),
            patterns=sorted(f"{p.pattern}@{p.region}" for p in pats),
            run=launch(rung, dev, args.seed),
        )
    tx0, tx1, tx2 = (rounds[r]["per_row"] for r in ("v00", "v01", "v02"))
    print(f"\ncumulative: {tx0:.0f} -> {tx1:.0f} -> {tx2:.0f} transfers/row "
          f"({tx0 / tx2:.0f}x total reduction)")
    print("paper's ladder: +721.79% (v00->v01), +26.07% (v01->v02 on GPU, "
          "L1-capped); the H100's times of these rungs are in PERF.md, section 6")
    return rounds


if __name__ == "__main__":
    main()
