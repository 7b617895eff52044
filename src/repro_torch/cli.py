"""``cuthermo`` for the PyTorch/CUDA port, run as ``python -m repro_torch.cli``.

Subcommands:

* ``kernels`` — list the registered kernels and their ladder variants.
* ``profile --kernel gemm --out sess/`` — profile kernels into the next
  iteration of a session directory.  Each variant's heat map is modeled
  from its spec, and its kernel is launched on seeded inputs at the
  registry's shapes, checked against its plain version and timed with
  CUDA events (``--device cuda``, the default).  ``--device cpu`` runs
  the plain version instead and times nothing.
* ``report sess/iter0`` — write the report bundle (HTML gallery,
  markdown digest, CSVs) for a stored iteration.
* ``diff sess/iter0 sess/iter1`` — align two iterations and print
  per-kernel improved/regressed/fixed-pattern verdicts.

Exit codes: 0 success, 1 a gate failed (``diff --fail-on-regression``,
or a kernel that disagrees with its plain version), 2 usage or load
error.  There is no fallback: ``--device cuda`` without a card is exit 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def _build_parser() -> argparse.ArgumentParser:
    """Construct the argparse tree for every subcommand."""
    p = argparse.ArgumentParser(
        prog="cuthermo",
        description="GPU memory heat-map profiler (CUTHERMO reproduction, "
        "PyTorch/CUDA port): profile kernels, detect inefficiency "
        "patterns, and track tuning iterations.",
    )
    sub = p.add_subparsers(dest="command", metavar="command")

    k = sub.add_parser(
        "kernels", help="list registered kernels and their variants"
    )
    k.set_defaults(func=_cmd_kernels)

    pr = sub.add_parser(
        "profile",
        help="profile kernels into the next iteration of a session",
    )
    pr.add_argument(
        "--kernel",
        "-k",
        action="append",
        default=[],
        metavar="NAME[:VARIANT]",
        help="kernel to profile (repeatable); 'gemm' uses the baseline "
        "variant, 'gemm:v01' a specific one",
    )
    pr.add_argument(
        "--all", action="store_true", help="profile every registered kernel"
    )
    pr.add_argument(
        "--out",
        "-o",
        default="cuthermo-session",
        metavar="DIR",
        help="session directory (created on first use; default: "
        "./cuthermo-session)",
    )
    pr.add_argument(
        "--sampler",
        default=None,
        metavar="SPEC",
        help="grid sampler: 'full', or 'window:N' (pin the leading grid "
        "coordinate, admit N programs); default: per-kernel registry choice",
    )
    pr.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where each kernel runs on its seeded inputs (default: cuda; "
        "'cpu' runs the plain version and times nothing)",
    )
    pr.add_argument("--label", default=None, help="iteration label")
    pr.add_argument("--note", default="", help="free-form iteration note")
    pr.add_argument(
        "--quiet", "-q", action="store_true",
        help="suppress per-kernel text reports",
    )
    pr.set_defaults(func=_cmd_profile)

    rp = sub.add_parser(
        "report", help="write the report bundle for a stored iteration"
    )
    rp.add_argument(
        "iteration",
        help="iteration directory (sess/iter0), or a session directory "
        "(its latest iteration is used)",
    )
    rp.add_argument(
        "--out",
        "-o",
        default=None,
        metavar="DIR",
        help="bundle output directory (default: <iteration>/report)",
    )
    rp.add_argument("--title", default=None, help="report title")
    rp.set_defaults(func=_cmd_report)

    df = sub.add_parser(
        "diff", help="compare two stored iterations kernel-by-kernel"
    )
    df.add_argument("before", help="baseline iteration directory")
    df.add_argument("after", help="candidate iteration directory")
    df.add_argument(
        "--region-map",
        action="append",
        default=[],
        metavar="KERNEL:OLD=NEW",
        help="rename a region between iterations (repeatable)",
    )
    df.add_argument(
        "--fail-on-regression",
        action="store_true",
        help="exit 1 when any kernel regressed (CI gating)",
    )
    df.set_defaults(func=_cmd_diff)
    return p


def _error(msg: object) -> int:
    print(f"cuthermo: {msg}", file=sys.stderr)
    return 2


def _parse_sampler(spec: Optional[str]):
    """Parse a ``--sampler`` value into a GridSampler (None = registry's)."""
    if spec is None:
        return None
    from repro_torch.core.trace import GridSampler

    if spec == "full":
        return GridSampler(None)
    if spec.startswith("window:"):
        try:
            window = int(spec.split(":", 1)[1])
        except ValueError:
            window = 0
        if window >= 1:
            return GridSampler((0,), window=window)
    _error(f"bad --sampler {spec!r} (use 'full' or 'window:N' with N >= 1)")
    raise SystemExit(2)


def _cmd_kernels(args: argparse.Namespace) -> int:
    """Handler for ``cuthermo kernels``."""
    from repro_torch import kernels as kreg

    for name in kreg.names():
        entry = kreg.get(name)
        variants = ", ".join(
            v.name + ("*" if i == 0 else "")
            for i, v in enumerate(entry.variants)
        )
        print(f"{name:<12} [{variants}]  {entry.summary}")
        for v in entry.variants:
            print(f"  {v.name:<10} {v.role:<9} {v.note}")
    print("(* = default/baseline variant)")
    return 0


def _cmd_profile(args: argparse.Namespace) -> int:
    """Handler for ``cuthermo profile``."""
    import torch

    from repro_torch import kernels as kreg
    from repro_torch.core.advisor import format_report
    from repro_torch.core.render import run_text
    from repro_torch.core.session import ProfileSession, SessionError, profile_kernel

    refs = list(args.kernel)
    if args.all:
        refs += [n for n in kreg.names() if n not in refs]
    if not refs:
        return _error("nothing to profile (pass --kernel NAME[:VARIANT] or --all)")
    override = _parse_sampler(args.sampler)
    try:
        resolved = [kreg.resolve(ref) for ref in refs]
    except KeyError as e:
        return _error(e.args[0])
    if args.device == "cuda" and not torch.cuda.is_available():
        return _error(
            "no CUDA device: pass --device cpu to run the plain versions"
        )
    # drop repeated refs, keeping first-occurrence order
    uniq, seen = [], set()
    for entry, variant in resolved:
        if (entry.name, variant.name) not in seen:
            seen.add((entry.name, variant.name))
            uniq.append((entry, variant))
    # kernel names are the iteration's alignment keys; qualify them when
    # one invocation profiles several variants of the same family
    families = [entry.name for entry, _ in uniq]
    try:
        sess = ProfileSession(args.out)
    except SessionError as e:
        return _error(e)
    profiled = []
    for entry, variant in uniq:
        ref = f"{entry.name}:{variant.name}"
        run = None
        if variant.kernel is not None:
            try:
                run = kreg.run_variant(variant, args.device)
            except kreg.KernelMismatch as e:
                print(f"cuthermo: {ref}: {e}", file=sys.stderr)
                return 1
        spec, ctx = kreg.build(ref)
        pk = profile_kernel(
            spec,
            override or entry.sampler(),
            ctx,
            name=entry.name if families.count(entry.name) == 1 else ref,
            variant=variant.name,
            region_map=entry.region_map,
            run=run,
        )
        profiled.append(pk)
        if not args.quiet:
            print(f"# {ref}")
            print(format_report(pk.heatmap))
            if run is not None:
                print(run_text(run))
            print()
    try:
        it = sess.add_iteration(profiled, label=args.label, note=args.note)
    except SessionError as e:
        return _error(e)
    print(f"wrote {it.path} ({len(profiled)} kernels)")
    return 0


def _resolve_iteration_dir(path: str):
    """Accept an iteration dir, or a session dir (use its last iteration)."""
    import os

    from repro_torch.core.session import ProfileSession, SessionError, load_iteration

    if os.path.isfile(os.path.join(path, "session.json")):
        sess = ProfileSession(path, create=False)
        if not sess.iteration_names():
            raise SessionError(f"{path}: session has no iterations yet")
        return sess.iteration(-1)
    return load_iteration(path)


def _cmd_report(args: argparse.Namespace) -> int:
    """Handler for ``cuthermo report``."""
    import os

    from repro_torch.core.render import ReportEntry, write_report_bundle
    from repro_torch.core.session import SessionError

    try:
        it = _resolve_iteration_dir(args.iteration)
    except SessionError as e:
        return _error(e)
    entries = [ReportEntry.from_profiled(pk) for pk in it.kernels]
    out = args.out or os.path.join(str(it.path), "report")
    title = args.title or f"cuthermo report — {it.label}"
    written = write_report_bundle(
        entries, out, title=title, faults=list(it.faults) or None
    )
    print(f"wrote {written['index.html']}")
    print(f"wrote {written['report.md']}")
    return 0


def _parse_region_maps(specs):
    """Parse repeated ``--region-map KERNEL:OLD=NEW`` flags (None if bad)."""
    region_maps: dict = {}
    for spec in specs:
        try:
            kernel, rename = spec.split(":", 1)
            old, new = rename.split("=", 1)
        except ValueError:
            _error(f"bad --region-map {spec!r} (expected KERNEL:OLD=NEW)")
            return None
        region_maps.setdefault(kernel, {})[old] = new
    return region_maps


def _cmd_diff(args: argparse.Namespace) -> int:
    """Handler for ``cuthermo diff``: 0 no regression, 1 regression under
    ``--fail-on-regression``, 2 usage or load error."""
    from repro_torch.core.session import SessionError, diff_iterations, load_iteration

    region_maps = _parse_region_maps(args.region_map)
    if region_maps is None:
        return 2
    try:
        before = load_iteration(args.before)
        after = load_iteration(args.after)
    except SessionError as e:
        return _error(e)
    sd = diff_iterations(before, after, region_maps=region_maps)
    print(sd.summary())
    if args.fail_on_regression and sd.regressed:
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """Entry point: parse ``argv`` and run the subcommand."""
    parser = _build_parser()
    args = parser.parse_args(argv)
    if not getattr(args, "func", None):
        parser.print_help()
        return 2
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
