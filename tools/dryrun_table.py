"""Print the port's dry-run artifacts as a markdown table, one row per
(arch, shape) with both meshes' values, and where a second set of
artifacts counts other bytes for a cell, the collectives that differ.

    PYTHONPATH=src python tools/dryrun_table.py [DIR] [--against DIR2]

DIR holds ``single_16x16/`` and ``multi_2x16x16/`` as
``python -m repro_torch.launch.dryrun --all --mesh both --out DIR`` writes
them (default ``artifacts/dryrun_torch``).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

MESHES = ("single_16x16", "multi_2x16x16")
WIRE = (("all_gather_into_tensor", "AG"), ("reduce_scatter_tensor", "RS"),
        ("all_reduce", "AR"), ("all_to_all_single", "A2A"))


def load(root: str) -> dict:
    """(arch, shape) -> {mesh dir: artifact}."""
    cells: dict = collections.defaultdict(dict)
    for mesh in MESHES:
        folder = os.path.join(root, mesh)
        for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else []:
            if name.endswith(".json"):
                with open(os.path.join(folder, name)) as f:
                    d = json.load(f)
                cells[(d["arch"], d["shape"])][mesh] = d
    return cells


def _both(by_mesh: dict, fn) -> str:
    return " / ".join(fn(by_mesh[m]) if m in by_mesh else "—" for m in MESHES)


def _wire(d: dict) -> str:
    by_op = d["collectives"]["by_op"]
    parts = [f"{short} {by_op[op]:.4g}" for op, short in WIRE if by_op.get(op)]
    return ", ".join(parts) or "0"


def _counted_apart(d: dict, e: dict) -> bool:
    return (d["cost"]["bytes"], d["collectives"]["by_op"]) != (
        e["cost"]["bytes"], e["collectives"]["by_op"])


def table(cells: dict, other: dict = None) -> str:
    """One row per (arch, shape), each value ``16x16 / 2x16x16``; with
    ``other``, a last column of its bytes and wire bytes where they differ
    ("=" where they do not)."""
    head = ["arch × shape", "ok", "wall s", "per-device B", "parameter B", "FLOPs",
            "ops' bytes", "wire B by collective (a device)", "bound"]
    if other is not None:
        head.append("the other set's ops' bytes; wire B, where apart")
    rows = ["| " + " | ".join(head) + " |", "|" + " --- |" * len(head)]
    for key, by_mesh in sorted(cells.items()):
        row = [
            f"{key[0]} × {key[1]}",
            _both(by_mesh, lambda d: "ok" if d["ok"] else "FAIL"),
            _both(by_mesh, lambda d: f"{d['wall_s']:.1f}"),
            _both(by_mesh, lambda d: f"{d['per_device_bytes']:.4g}"),
            _both(by_mesh, lambda d: f"{d['param_bytes_per_device']:.4g}"),
            _both(by_mesh, lambda d: f"{d['cost']['flops']:.4g}"),
            _both(by_mesh, lambda d: f"{d['cost']['bytes']:.4g}"),
            _both(by_mesh, _wire),
            _both(by_mesh, lambda d: d["bound"]),
        ]
        if other is not None:
            theirs = other.get(key, {})
            row.append(" / ".join(
                "—" if m not in by_mesh or m not in theirs
                else f"{theirs[m]['cost']['bytes']:.4g}; {_wire(theirs[m])}"
                if _counted_apart(by_mesh[m], theirs[m]) else "=" for m in MESHES))
        rows.append("| " + " | ".join(row) + " |")
    return "\n".join(rows)


def differences(cells: dict, other: dict) -> str:
    """Each cell whose bytes or wire bytes differ between the two sets,
    with the collectives (kind, shape, group) whose counts differ."""
    lines = []
    for key, by_mesh in sorted(cells.items()):
        for mesh, d in by_mesh.items():
            e = other.get(key, {}).get(mesh)
            if e is None:
                continue
            if not _counted_apart(d, e):
                continue
            lines.append(f"{key[0]} × {key[1]} ({mesh}): bytes {d['cost']['bytes']:.6g} / "
                         f"{e['cost']['bytes']:.6g}; wire {d['collectives']['by_op']} / "
                         f"{e['collectives']['by_op']}")
            a = collections.Counter(d["collectives"].get("by_shape", {}))
            b = collections.Counter(e["collectives"].get("by_shape", {}))
            for sig in sorted(set(a) | set(b)):
                if a[sig] != b[sig]:
                    lines.append(f"    {sig}: {a[sig]} / {b[sig]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir", nargs="?", default=os.path.join("artifacts", "dryrun_torch"))
    ap.add_argument("--against", default=None,
                    help="a second set of artifacts (another torch's run of the grid)")
    args = ap.parse_args(argv)
    cells = load(args.dir)
    other = load(args.against) if args.against else None
    print(table(cells, other))
    n = sum(len(v) for v in cells.values())
    print(f"\n{n} artifacts, {sum(d['ok'] for v in cells.values() for d in v.values())} ok")
    if other is not None:
        print("\ncells counted apart (this set / the other):")
        print(differences(cells, other) or "none")
    return 0


if __name__ == "__main__":
    sys.exit(main())
