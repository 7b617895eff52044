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
* ``model NAME --out sess/`` — whole-model profiling: every kernel of a
  registered model's forward (and ``--backward``) pass into one iteration
  with per-layer attribution, each forward kind launched on the card at
  the model's shapes.

Exit codes: 0 success, 1 a gate failed (``diff --fail-on-regression``,
``model --max-transfers``, or a kernel that disagrees with its plain
version), 2 usage or load error.  There is no fallback: ``--device cuda``
without a card is exit 2.
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
        help=_SAMPLER_HELP + "; default: per-kernel registry choice",
    )
    _add_device(pr)
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

    mo = sub.add_parser(
        "model",
        help="whole-model profiling: discover and profile every kernel "
        "of a registered model into one per-layer-attributed iteration",
    )
    mo.add_argument(
        "name",
        nargs="?",
        default=None,
        metavar="NAME",
        help="registered model (see `model --list`): transformer-tiny, "
        "moe-tiny, mamba-tiny",
    )
    mo.add_argument(
        "--list", action="store_true", help="list registered models and exit"
    )
    mo.add_argument(
        "--config",
        "-c",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="override a model config field (repeatable), e.g. "
        "-c n_layers=4 -c d_ff=512; unknown keys exit 2",
    )
    mo.add_argument(
        "--backward",
        action="store_true",
        help="also profile the backward-pass kernels (store-heavy mirrors "
        "of each forward kernel; modeled, never launched)",
    )
    mo.add_argument(
        "--out",
        "-o",
        default="cuthermo-session",
        metavar="DIR",
        help="session directory (created on first use; default: "
        "./cuthermo-session)",
    )
    mo.add_argument(
        "--sampler",
        default=None,
        metavar="SPEC",
        help=_SAMPLER_HELP + "; default: full",
    )
    mo.add_argument(
        "--max-transfers",
        type=int,
        default=None,
        metavar="N",
        help="CI budget: exit 1 when the iteration's total modeled "
        "transfers exceed N",
    )
    mo.add_argument(
        "--no-hlo",
        action="store_true",
        help="skip the HLO-level sweep (the port has no sweep yet: every "
        "run is a --no-hlo run)",
    )
    mo.add_argument(
        "--report",
        action="store_true",
        help="write the report bundle (with the per-layer section) to "
        "<iteration>/report afterwards",
    )
    mo.add_argument("--label", default=None, help="iteration label")
    mo.add_argument("--note", default="", help="free-form iteration note")
    mo.add_argument(
        "--quiet", "-q", action="store_true", help="suppress the per-layer table"
    )
    _add_device(mo)
    mo.set_defaults(func=_cmd_model)
    return p


_SAMPLER_HELP = (
    "grid sampler: 'full', or 'window:N[:D]' (pin the leading D grid "
    "coordinates, default 1, and admit N programs along the last of them)"
)


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where each kernel runs on its seeded inputs (default: cuda; "
        "'cpu' runs the plain version and times nothing)",
    )


def _no_card(args: argparse.Namespace) -> bool:
    import torch

    return args.device == "cuda" and not torch.cuda.is_available()


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
    parts = spec.split(":")
    if parts[0] == "window" and len(parts) in (2, 3):
        try:
            window, depth = int(parts[1]), int(parts[2]) if len(parts) == 3 else 1
        except ValueError:
            window = depth = 0
        if window >= 1 and depth >= 1:
            return GridSampler((0,) * depth, window=window)
    _error(
        f"bad --sampler {spec!r} (use 'full' or 'window:N[:D]' with N, D >= 1)"
    )
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
    if _no_card(args):
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
        entries, out, title=title, faults=list(it.faults) or None,
        layers=it.layers,
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


def _cmd_model(args: argparse.Namespace) -> int:
    """Handler for ``cuthermo model``: 0 profiled (and under budget), 1 the
    ``--max-transfers`` budget is blown or a kernel disagrees with its
    plain version, 2 usage or load error (no NAME, unknown model, bad
    ``--config`` override, no card for ``--device cuda``)."""
    import os

    from repro_torch import kernels as kreg
    from repro_torch.core.model_profile import iteration_transactions, profile_model
    from repro_torch.core.render import ReportEntry, run_text, write_report_bundle
    from repro_torch.core.session import SessionError
    from repro_torch.models.registry import MODELS

    if args.list:
        for name, entry in MODELS.items():
            cfg = entry.config
            print(
                f"{name:<18} batch={entry.batch} seq={entry.seq} "
                f"layers={cfg.n_layers} d_model={cfg.d_model}  {entry.summary}"
            )
        return 0
    if not args.name:
        return _error("model: pass a model NAME (or --list)")
    sampler = _parse_sampler(args.sampler)
    if _no_card(args):
        return _error("no CUDA device: pass --device cpu to run the plain versions")
    try:
        it = profile_model(
            args.name,
            args.out,
            overrides=args.config,
            backward=args.backward,
            sampler=sampler,
            label=args.label,
            note=args.note,
            device=args.device,
        )
    except kreg.KernelMismatch as e:
        print(f"cuthermo: {e}", file=sys.stderr)
        return 1
    except (KeyError, ValueError, SessionError) as e:
        return _error(e.args[0] if e.args else e)
    total = iteration_transactions(it)
    layers = it.layers or {}
    if not args.quiet:
        print(
            f"# model {args.name} (batch {layers.get('batch')}, seq "
            f"{layers.get('seq')})" + (" forward+backward" if args.backward else "")
        )
        for row in layers.get("table", ()):
            pats = ", ".join(f"{p}@{r}" for _k, r, p in row.get("patterns", ()))
            print(
                f"  {row['path']:<10} {', '.join(row['kinds']):<14} "
                f"{row['transactions']:>8} transfers" + (f"  [{pats}]" if pats else "")
            )
        print(f"  {'total':<10} {'':<14} {total:>8} transfers")
        for pk in it.kernels:
            if pk.run and not pk.run.get("shared_with"):
                print(f"  {pk.name}: {pk.run.get('shapes')} {run_text(pk.run)}")
    print(
        "hlo sweep: not ported (it compiles the model's forward, which the "
        "port does not have yet); per-layer table only"
    )
    if args.report:
        written = write_report_bundle(
            [ReportEntry.from_profiled(pk) for pk in it.kernels],
            os.path.join(str(it.path), "report"),
            title=f"cuthermo model report — {it.label}",
            layers=layers or None,
        )
        print(f"wrote {written['index.html']}")
    print(f"wrote {it.path} ({len(it.kernels)} kernels, {total} transfers)")
    if args.max_transfers is not None and total > args.max_transfers:
        print(
            f"cuthermo: transfer budget blown: {total} > {args.max_transfers}",
            file=sys.stderr,
        )
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
