#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of several checkouts in turn on one card.

Each checkout's script runs in a fresh process from the checkout's root,
one after another, so the runs share a host and a card; give two trees
twice in swapped order (A B B A) to see what a change moves past the
host's drift.  Every line a run prints is kept with the host's seconds
since that run started, so a command's cost can be read off the stamp of
the line it printed last against the one before it.

    python3 tools/chip_smoke_pair.py --out build/pair build/parent . build/parent .

Writes ``<out>/<i>_<label>.log`` (stamped lines) and ``<out>/pair.json``
({label, seconds, rc, phases}), and prints one table of phase times
(the ``phase N took X s`` lines every run prints) with a column a run.
Exits 1 when any run fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

PHASE = re.compile(r"^phase (\d+) took ([0-9.]+) s")
TOTAL = re.compile(r"^chip_smoke\.py took ([0-9.]+) s")


def run_one(tree: Path, log: Path) -> dict:
    """Run ``tree``'s chip_smoke.py; stamp and keep its output in ``log``."""
    phases, total = {}, None
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-u", "chip_smoke.py"], cwd=tree,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for line in proc.stdout:
            fh.write(f"{time.perf_counter() - t0:9.2f} {line}")
            m = PHASE.match(line)
            if m:
                phases[m.group(1)] = float(m.group(2))
            m = TOTAL.match(line)
            if m:
                total = float(m.group(1))
        rc = proc.wait()
    return dict(seconds=time.perf_counter() - t0, rc=rc, script_s=total, phases=phases)


def table(runs) -> str:
    keys = sorted({k for r in runs for k in r["phases"]}, key=int)
    head = "| phase | " + " | ".join(r["label"] for r in runs) + " |"
    lines = [head, "|" + " --- |" * (len(runs) + 1)]
    for k in keys:
        lines.append(f"| {k} | " + " | ".join(
            f"{r['phases'][k]:.1f}" if k in r["phases"] else "-" for r in runs) + " |")
    lines.append("| total | " + " | ".join(
        f"{r['script_s']:.1f}" if r["script_s"] else f"rc {r['rc']}" for r in runs) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, required=True, help="directory for the logs")
    p.add_argument("trees", nargs="+", type=Path, help="checkout roots, run in this order")
    args = p.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        label = f"{i}_{tree.resolve().name}"
        rec = dict(label=label, tree=str(tree), **run_one(tree, args.out / f"{label}.log"))
        runs.append(rec)
        print(f"{label}: rc {rec['rc']}, {rec['seconds']:.1f} s, phases {rec['phases']}",
              flush=True)
    (args.out / "pair.json").write_text(json.dumps(dict(card=smi, runs=runs), indent=1))
    print(table(runs))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
