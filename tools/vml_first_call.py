"""Count fresh processes whose first CPU ``exp`` is off.

Each child process computes the port's plain SSD chunk twice on the
mamba-tiny registry inputs (``model mamba-tiny``'s ``chunk`` kernel) and
reports whether the two calls differ, in which intermediate, and by how
much.  Half the children first call ``repro_torch.cpu_math.prepare()``
(the VML set-up the port makes on import), half do not; they run
``--at-once`` at a time, interleaved, to load the host alike.

    PYTHONPATH=src python tools/vml_first_call.py --procs 960 --at-once 16

Prints one line per child that differs, then the counts.
"""

from __future__ import annotations

import argparse
import subprocess
import sys


def child(prepared: bool) -> None:
    import torch

    if prepared:
        from repro_torch import cpu_math

        cpu_math.prepare()
    gen = torch.Generator().manual_seed(0)
    bh, c, l, p, n = 16, 2, 32, 32, 16  # mamba-tiny's chunk: batch 2 x 8 heads
    x = torch.randn(bh, c, l, p, generator=gen)
    a = -torch.randn(bh, c, l, generator=gen).abs() * 0.4
    b = torch.randn(bh, c, l, n, generator=gen)
    cc = torch.randn(bh, c, l, n, generator=gen)

    def steps():  # ssd_plain's y, step by step
        cum = torch.cumsum(a, dim=-1)
        seg = cum[..., :, None] - cum[..., None, :]
        keep = torch.ones(l, l, dtype=torch.bool).tril()
        dec = torch.exp(seg.masked_fill(~keep, 0.0)).masked_fill(~keep, 0.0)
        sc = torch.matmul(cc, b.transpose(-1, -2))
        y = torch.matmul(sc * dec, x)
        return dict(cum=cum, dec=dec, sc=sc, y=y)

    first, second = steps(), steps()
    off = {k: float((first[k] - second[k]).abs().max()) for k in first
           if not torch.equal(first[k], second[k])}
    print(repr(off))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=960)
    ap.add_argument("--at-once", type=int, default=16)
    ap.add_argument("--child", choices=("cold", "prepared"))
    args = ap.parse_args()
    if args.child:
        child(args.child == "prepared")
        return 0
    counts = {"cold": [0, 0], "prepared": [0, 0]}
    for start in range(0, args.procs, args.at_once):
        kinds = ["cold" if i % 2 == 0 else "prepared"
                 for i in range(start, min(start + args.at_once, args.procs))]
        procs = [subprocess.Popen([sys.executable, __file__, "--child", k],
                                  stdout=subprocess.PIPE, text=True) for k in kinds]
        for kind, proc in zip(kinds, procs):
            out = proc.communicate()[0].strip()
            counts[kind][1] += 1
            if proc.returncode != 0 or out != "{}":
                counts[kind][0] += 1
                print(f"{kind}: rc {proc.returncode}, first vs second call: {out}", flush=True)
    for kind, (bad, total) in counts.items():
        print(f"{kind}: {bad} of {total} processes had a first call that differs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
