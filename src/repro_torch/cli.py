"""``cuthermo`` for the PyTorch/CUDA port, run as ``python -m repro_torch.cli``.

Subcommands:

* ``kernels`` — list the registered kernels and their ladder variants
  (``--lint`` adds each variant's static lint verdict).
* ``lint NAME[:VARIANT] | --all`` — predict heat-map patterns from the
  specs alone: no kernel runs, no traces.
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
* ``tune gemm --out sess/`` — close the paper's loop unattended: profile
  the baseline, try the ladder's rungs and generated candidates, keep
  what improves, every step an iteration.  Rungs with a kernel launch it
  as ``profile`` does.
* ``check sess/iter1 --baseline sess/iter0`` — the regression gate
  (``--anomaly`` bands a session's own history; ``--static`` compares
  two registry refs' lint reports).

``profile``, ``model`` and ``tune`` take ``--cache DIR``, a
content-addressed store of heat maps: an unchanged walk is served from
it bit-identically.  The kernel's run on the card is measured every time.
They also take ``--workers N`` (the walks shard over N spawn worker
processes; heat maps stay bit-identical) and ``--inject-faults SPEC``
(deterministic worker crashes and hangs the walk recovers from); ``model``
and ``tune --all`` take ``--resume`` after a SIGTERM/SIGINT.

Exit codes: 0 success, 1 a gate failed (``diff --fail-on-regression``,
``model --max-transfers``, ``check``, ``lint`` findings, or a kernel that
fails to build, launch or agree with its plain version), 2 usage or load
error, 3 preempted (``model``, ``tune --all``: the journal is kept, finish
with ``--resume``).  There is no fallback: ``--device cuda`` without a
card is exit 2, and fault recovery covers the walk, never a kernel.
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
    k.add_argument(
        "--lint",
        action="store_true",
        help="add each variant's static lint verdict (clean/dirty/error) "
        "and predicted pattern classes; no kernels are run",
    )
    k.set_defaults(func=_cmd_kernels)

    ln = sub.add_parser(
        "lint",
        help="statically predict heat-map inefficiencies from specs "
        "alone (no runs, no traces; exit 0 clean / 1 findings / 2 error)",
    )
    ln.add_argument(
        "ref",
        nargs="*",
        metavar="NAME[:VARIANT]",
        help="registry refs to lint ('gemm' lints the baseline variant)",
    )
    ln.add_argument(
        "--all", action="store_true",
        help="lint every variant of every registered kernel",
    )
    ln.add_argument(
        "--strict",
        action="store_true",
        help="promote warning-level findings to failures (exit 1); "
        "error-level findings always fail",
    )
    ln.add_argument(
        "--json",
        default=None,
        metavar="PATH",
        help="write the schema-versioned JSON lint document to PATH "
        "('-' for stdout; the human summary then moves to stderr)",
    )
    ln.add_argument(
        "--quiet", "-q", action="store_true",
        help="suppress the human summary (exit code + JSON only)",
    )
    ln.set_defaults(func=_cmd_lint)

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
    _add_cache(pr)
    _add_scale_out(pr, resume=None)
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
        help="skip the op-level sweep (the port's HLO sweep: one forward, "
        "with --backward the loss and its gradients, counted op by op on "
        "meta tensors, which hold shapes and no values; no layers.hlo block)",
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
    _add_cache(mo)
    _add_scale_out(
        mo,
        resume="resume a preempted run from the session's model journal: "
        "kernels the preempted run flushed (and their runs on the card) "
        "are reused verbatim, only the rest is profiled",
    )
    mo.set_defaults(func=_cmd_model)

    ck = sub.add_parser(
        "check",
        help="gate a candidate iteration against a baseline artifact "
        "and/or its own session history (exit 0 pass / 1 fail / 2 error)",
    )
    ck.add_argument(
        "candidate",
        help="candidate iteration directory, or a session directory "
        "(its latest iteration is gated; --anomaly needs a session)",
    )
    ck.add_argument(
        "--baseline",
        "-b",
        default=None,
        metavar="DIR",
        help="baseline iteration (or session) directory to gate against",
    )
    ck.add_argument(
        "--static",
        action="store_true",
        help="no-trace gate: candidate and --baseline are registry refs "
        "(NAME[:VARIANT]) compared on their static lint reports "
        "(incompatible with --anomaly and --region-map)",
    )
    ck.add_argument(
        "--anomaly",
        action="store_true",
        help="also flag kernels whose latest heat map leaves their own "
        "rolling median/MAD history bands (candidate must be a session "
        "directory with enough iterations)",
    )
    ck.add_argument(
        "--threshold",
        "-t",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="gate budget (repeatable): transfer-pct, aggregate-pct, "
        "scratch-pct, severity (floats); new-patterns, missing (on|off); "
        "allow-pattern=NAME (exempt a pattern class); defaults are "
        "strict (zero tolerated growth)",
    )
    ck.add_argument(
        "--region-map",
        action="append",
        default=[],
        metavar="KERNEL:OLD=NEW",
        help="rename a region between baseline and candidate (repeatable)",
    )
    ck.add_argument(
        "--json",
        default=None,
        metavar="PATH",
        help="write the schema-versioned JSON report to PATH "
        "('-' for stdout; the human summary then moves to stderr)",
    )
    ck.add_argument(
        "--min-history",
        type=int,
        default=None,
        metavar="N",
        help="anomaly bands need N prior iterations (default: 3)",
    )
    ck.add_argument(
        "--nmads",
        type=float,
        default=None,
        metavar="X",
        help="anomaly band half-width in scaled MADs (default: 4.0)",
    )
    ck.add_argument(
        "--include-rejected",
        action="store_true",
        help="band anomaly history over tuner-rejected candidates too",
    )
    ck.add_argument(
        "--quiet", "-q", action="store_true",
        help="suppress the human summary (exit code + JSON only)",
    )
    ck.set_defaults(func=_cmd_check)

    tn = sub.add_parser(
        "tune",
        help="autotune kernels: profile, apply advisor actions, re-profile",
    )
    tn.add_argument(
        "kernel",
        nargs="*",
        metavar="NAME[:VARIANT]",
        help="kernel families to tune (the given variant is the starting "
        "rung; default: the family's baseline)",
    )
    tn.add_argument(
        "--all",
        action="store_true",
        help="tune the listed families (or the whole registry when none "
        "are listed) under ONE global --budget, their walks concurrent; "
        "deterministic per --seed",
    )
    tn.add_argument(
        "--budget",
        "-b",
        type=int,
        default=None,  # resolved to tuner.DEFAULT_BUDGET in the handler
        metavar="N",
        help="max candidate re-profiles per family, or the global total "
        "across families with --all (default: 8)",
    )
    tn.add_argument(
        "--target-pattern",
        action="append",
        default=[],
        metavar="PATTERN",
        # repro_torch.core.patterns.ALL_PATTERNS, inlined so --help needs
        # no numpy import; a typo must fail loudly, not tune nothing
        choices=(
            "hot", "hot-random", "scratch-abuse", "false-sharing",
            "misalignment", "strided",
        ),
        help="only chase actions for this pattern (repeatable): hot, "
        "hot-random, false-sharing, misalignment, strided, scratch-abuse",
    )
    tn.add_argument(
        "--out",
        "-o",
        default="cuthermo-session",
        metavar="DIR",
        help="session directory the trajectory is persisted into "
        "(default: ./cuthermo-session)",
    )
    tn.add_argument(
        "--seed",
        type=int,
        default=0,
        help="candidate tie-break seed (same seed => same trajectory)",
    )
    tn.add_argument(
        "--no-generated",
        action="store_true",
        help="only try registry ladder variants, no generated candidates",
    )
    tn.add_argument(
        "--no-prescreen",
        action="store_true",
        help="disable the static pre-screen (profile even candidates the "
        "linter prices as strictly worse than the incumbent)",
    )
    tn.add_argument(
        "--report",
        action="store_true",
        help="write the report bundle (with the tuning trajectory) to "
        "<out>/report afterwards",
    )
    tn.add_argument(
        "--quiet", "-q", action="store_true",
        help="suppress per-step progress lines",
    )
    _add_device(tn)
    _add_cache(tn)
    _add_scale_out(
        tn,
        resume="(with --all) resume a preempted run: replay the journaled "
        "arguments deterministically; completed walks come back "
        "bit-identical from the cache when one is given",
    )
    tn.set_defaults(func=_cmd_tune)
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


def _add_cache(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--cache",
        default=None,
        metavar="DIR",
        help="content-addressed collection cache directory: an unchanged "
        "walk returns its bit-identical stored heat map instead of "
        "re-tracing (created on first use); kernel runs are measured "
        "every time",
    )


def _add_scale_out(
    parser: argparse.ArgumentParser, resume: Optional[str]
) -> None:
    """``--workers`` and ``--inject-faults``, and ``--resume`` (with its
    help text) where the command keeps a journal."""
    parser.add_argument(
        "--workers",
        "-w",
        type=int,
        default=1,
        metavar="N",
        help="shard the walks across N spawn worker processes (default: 1, "
        "serial); heat maps are bit-identical for traces within the "
        "record cap, artifacts gain per-shard provenance.  Kernels still "
        "run in this process",
    )
    parser.add_argument(
        "--inject-faults",
        default=None,
        metavar="SPEC",
        help="deterministically inject worker crashes and hangs into the "
        "sharded walk (e.g. 'seed=7' or 'seed=7,timeouts=0'); recovery is "
        "recorded as FaultEvent provenance and the heat maps stay "
        "bit-identical to a clean run",
    )
    if resume is not None:
        parser.add_argument("--resume", action="store_true", help=resume)


def _parse_fault_plan(spec: Optional[str]):
    """Parse a ``--inject-faults`` value into a FaultPlan (None = off)."""
    if spec is None:
        return None
    from repro_torch.core.faultinject import FaultInjectError, FaultPlan

    try:
        plan = FaultPlan.parse(spec)
    except FaultInjectError as e:
        _error(e)
        raise SystemExit(2)
    print(f"fault injection armed: {plan.describe()}", file=sys.stderr)
    return plan


def _print_fault_summary(faults) -> None:
    """One stderr line summarizing an iteration's recovery provenance."""
    if not faults:
        return
    from repro_torch.core.resilience import FaultEvent, summarize_faults

    events = tuple(
        FaultEvent.from_dict({k: v for k, v in f.items() if k != "kernel"})
        for f in faults
    )
    print(f"recovered faults: {summarize_faults(events)}", file=sys.stderr)


def _cache_stats_line(cache) -> str:
    st = cache.stats
    return (
        f"cache: {st.hits} hits ({st.memory_hits} memory, {st.disk_hits} "
        f"disk), {st.misses} misses"
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
    from repro_torch.core.lint import lint_ref

    for name in kreg.names():
        entry = kreg.get(name)
        variants = ", ".join(
            v.name + ("*" if i == 0 else "")
            for i, v in enumerate(entry.variants)
        )
        print(f"{name:<12} [{variants}]  {entry.summary}")
        for v in entry.variants:
            if not args.lint:
                print(f"  {v.name:<10} {v.role:<9} {v.note}")
                continue
            rep = lint_ref(f"{name}:{v.name}")
            preds = ", ".join(f"{f.pattern}({f.region})" for f in rep.findings)
            tx = (
                "dynamic"
                if rep.static_transactions is None
                else f"{rep.static_transactions} transfers"
            )
            print(
                f"  {v.name:<10} {rep.verdict():<6} {tx}"
                + (f"  [{preds}]" if preds else "")
            )
    print("(* = default/baseline variant)")
    if args.lint:
        print("(static lint verdicts: no kernels were run or traced)")
    return 0


def _cmd_lint(args: argparse.Namespace) -> int:
    """Handler for ``cuthermo lint``: 0 clean (or warnings only without
    ``--strict``), 1 findings gate the run (any error-level finding;
    warnings too under ``--strict``), 2 usage error (no refs, unknown
    ref)."""
    from repro_torch import kernels as kreg
    from repro_torch.core.lint import LintError, lint_document, lint_ref

    refs = list(args.ref)
    if args.all:
        for name in kreg.names():
            for v in kreg.get(name).variants:
                ref = f"{name}:{v.name}"
                if ref not in refs:
                    refs.append(ref)
    if not refs:
        return _error("lint: nothing to lint (pass NAME[:VARIANT] refs or --all)")
    reports = []
    for ref in refs:
        try:
            reports.append(lint_ref(ref))
        except (KeyError, LintError) as e:
            return _error(e.args[0] if e.args else e)
    doc = lint_document(reports, strict=args.strict)
    human = "\n\n".join(rep.summary() for rep in reports)
    if not doc["passed"]:
        n = len(doc["failures"])
        human += f"\nlint FAILED ({n} finding{'s' if n != 1 else ''} gate)"
    _emit(doc, human, args.json, args.quiet)
    return 0 if doc["passed"] else 1


def _emit(doc, human: str, json_path: Optional[str], quiet: bool) -> None:
    """Write a JSON document (to a file, or stdout with ``-``, the human
    summary then on stderr) and the human summary."""
    import json

    if json_path == "-":
        print(json.dumps(doc, indent=2))
        if not quiet:
            print(human, file=sys.stderr)
        return
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(doc, fh, indent=2)
            fh.write("\n")
    if not quiet:
        print(human)


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
    plan = _parse_fault_plan(args.inject_faults)
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
        sess = ProfileSession(args.out, cache=args.cache, fault_plan=plan)
    except SessionError as e:
        return _error(e)
    profiled = []
    try:
        # one warm pool shared by every kernel of this invocation, owned
        # (and closed) by the session
        collector = sess.collector(max(1, args.workers))
        for entry, variant in uniq:
            ref = f"{entry.name}:{variant.name}"
            run = None
            if variant.kernel is not None:
                try:
                    run = kreg.run_variant(variant, args.device)
                except kreg.KernelMismatch as e:
                    print(f"cuthermo: {ref}: {e}", file=sys.stderr)
                    return 1
            # built through the registry, so the spec is source-stamped:
            # that ref is what shard workers rebuild it from
            spec, ctx = kreg.build(ref)
            pk = profile_kernel(
                spec,
                override or entry.sampler(),
                ctx,
                name=entry.name if families.count(entry.name) == 1 else ref,
                variant=variant.name,
                region_map=entry.region_map,
                run=run,
                collector=collector,
                cache=sess.cache,
            )
            profiled.append(pk)
            if not args.quiet:
                print(f"# {ref}")
                if pk.cached:
                    print("(heat map served from the collection cache)")
                if pk.shards:
                    print(
                        f"(collected in {len(pk.shards)} shards: "
                        + ", ".join(
                            f"#{s.shard} {s.records} records"
                            for s in pk.shards
                        )
                        + ")"
                    )
                print(format_report(pk.heatmap))
                if run is not None:
                    print(run_text(run))
                print()
        try:
            it = sess.add_iteration(profiled, label=args.label, note=args.note)
        except SessionError as e:
            return _error(e)
    finally:
        sess.close()
    if sess.cache is not None:
        print(_cache_stats_line(sess.cache))
    _print_fault_summary(it.faults)
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
    """Handler for ``cuthermo report``.

    Pointed at a session that holds tuning runs, the bundle gains each
    run's trajectory, and its body is each run's winning iteration when
    the latest iteration belongs to a run.  A ``check.json`` beside the
    iteration folds in the regression gate's verdict, and each kernel's
    registry ref is linted again for the predicted-vs-observed table.
    """
    import dataclasses
    import json
    import os

    from repro_torch.core.lint import LintError, lint_ref, predicted_vs_observed
    from repro_torch.core.render import ReportEntry, write_report_bundle
    from repro_torch.core.session import ProfileSession, SessionError, load_iteration
    from repro_torch.core.tuner import trajectories_from_session

    try:
        it = _resolve_iteration_dir(args.iteration)
    except SessionError as e:
        return _error(e)
    tuning = None
    kernels = list(it.kernels)
    if os.path.isfile(os.path.join(args.iteration, "session.json")):
        sess = ProfileSession(args.iteration, create=False)
        tuning = trajectories_from_session(sess) or None
        # the latest iteration may be a rejected candidate: show each run's
        # winner, but only when the latest iteration is part of a run
        if tuning and it.tuning is not None:
            best = []
            for traj in tuning:
                try:
                    best.extend(load_iteration(sess.root / traj["best"]["iteration"]).kernels)
                except (SessionError, TypeError):
                    best = []  # incomplete provenance: keep the default
                    break
            if best:
                kernels = best
                it = dataclasses.replace(it, label=f"{it.label} (tuned)")
    check = None
    check_path = it.path / "check.json"
    if check_path.is_file():
        try:
            doc = json.loads(check_path.read_text())
        except (OSError, ValueError):
            doc = None  # a foreign or torn file adds no section
        if isinstance(doc, dict) and doc.get("format") == "cuthermo-check":
            check = doc
    lint = []
    for pk in kernels:
        ref = f"{pk.name.partition(':')[0]}:{pk.variant}"
        try:
            rep = lint_ref(ref)
        except (KeyError, LintError):
            continue  # a tuner-generated variant has no registry ref
        lint.append(
            {
                "kernel": pk.name,
                "ref": ref,
                "verdict": rep.verdict(),
                "static_transactions": rep.static_transactions,
                "rows": predicted_vs_observed(rep, pk.reports),
            }
        )
    entries = [ReportEntry.from_profiled(pk) for pk in kernels]
    out = args.out or os.path.join(str(it.path), "report")
    title = args.title or f"cuthermo report — {it.label}"
    written = write_report_bundle(
        entries, out, title=title, faults=list(it.faults) or None,
        layers=it.layers, tuning=tuning, check=check, lint=lint or None,
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
    ``--config`` override, invalid ``--resume``, no card for ``--device
    cuda``), 3 preempted: a SIGTERM/SIGINT flushed a partial iteration and
    left a journal; re-run with ``--resume`` and the same flags."""
    import os
    import signal

    from repro_torch import kernels as kreg
    from repro_torch.core.cache import CollectionCache
    from repro_torch.core.model_profile import iteration_transactions, profile_model
    from repro_torch.core.render import ReportEntry, _hlo_line, run_text, write_report_bundle
    from repro_torch.core.session import SessionError
    from repro_torch.models.registry import MODELS
    from repro_torch.runtime.fault import Preempted, PreemptionHandler

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
    plan = _parse_fault_plan(args.inject_faults)
    if _no_card(args):
        return _error("no CUDA device: pass --device cpu to run the plain versions")
    cache = CollectionCache(args.cache) if args.cache else None
    # SIGTERM/SIGINT flip a flag; profile_model sees it at the next kernel
    # boundary, flushes a partial iteration and raises Preempted
    handler = PreemptionHandler().register((signal.SIGTERM, signal.SIGINT))
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
            cache=cache,
            workers=max(1, args.workers),
            fault_plan=plan,
            preemption=handler,
            resume=args.resume,
            hlo=not args.no_hlo,
        )
    except Preempted as e:
        print(f"cuthermo: {e}", file=sys.stderr)
        return 3
    except kreg.KernelMismatch as e:
        print(f"cuthermo: {e}", file=sys.stderr)
        return 1
    except (KeyError, ValueError, SessionError) as e:
        return _error(e.args[0] if e.args else e)
    finally:
        handler.unregister()
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
    hlo = layers.get("hlo")
    print(f"  {_hlo_line(hlo)}" if hlo else "  op sweep: skipped (--no-hlo)")
    if args.report:
        written = write_report_bundle(
            [ReportEntry.from_profiled(pk) for pk in it.kernels],
            os.path.join(str(it.path), "report"),
            title=f"cuthermo model report — {it.label}",
            layers=layers or None,
            faults=list(it.faults) or None,
        )
        print(f"wrote {written['index.html']}")
    if cache is not None:
        print(_cache_stats_line(cache))
    _print_fault_summary(it.faults)
    print(f"wrote {it.path} ({len(it.kernels)} kernels, {total} transfers)")
    if args.max_transfers is not None and total > args.max_transfers:
        print(
            f"cuthermo: transfer budget blown: {total} > {args.max_transfers}",
            file=sys.stderr,
        )
        return 1
    return 0


def _cmd_check(args: argparse.Namespace) -> int:
    """Handler for ``cuthermo check``: 0 every gate held, 1 at least one
    gate failed (threshold blown, new/worsened pattern, missing kernel,
    anomaly flag), 2 usage or load error (bad flags, unreadable or
    malformed artifacts)."""
    import json
    import os

    from repro_torch.core.check import (
        CheckError,
        CheckThresholds,
        check_iterations,
        check_session_anomalies,
        check_static,
        merge_reports,
    )
    from repro_torch.core.session import ProfileSession, SessionError

    if not args.baseline and not args.anomaly:
        return _error(
            "check: nothing to gate against (pass --baseline DIR and/or --anomaly)"
        )
    region_maps = _parse_region_maps(args.region_map)
    if region_maps is None:
        return 2
    try:
        thresholds = CheckThresholds.from_specs(args.threshold)
    except CheckError as e:
        return _error(e)
    candidate_it = None
    try:
        if args.static:
            if args.anomaly or args.region_map:
                return _error(
                    "check: --static takes registry refs and is incompatible "
                    "with --anomaly / --region-map (the family's registry "
                    "region_map applies automatically)"
                )
            if not args.baseline:
                return _error("check: --static needs --baseline NAME[:VARIANT]")
            report = check_static(args.candidate, args.baseline, thresholds=thresholds)
        else:
            report = None
            if args.baseline:
                baseline = _resolve_iteration_dir(args.baseline)
                candidate_it = _resolve_iteration_dir(args.candidate)
                report = check_iterations(
                    baseline, candidate_it, thresholds=thresholds,
                    region_maps=region_maps,
                )
            if args.anomaly:
                if not os.path.isfile(os.path.join(args.candidate, "session.json")):
                    return _error(
                        f"--anomaly needs a session directory, and "
                        f"{args.candidate!r} has no session.json"
                    )
                kwargs = {"include_rejected": args.include_rejected}
                if args.min_history is not None:
                    kwargs["min_history"] = args.min_history
                if args.nmads is not None:
                    kwargs["nmads"] = args.nmads
                anomaly = check_session_anomalies(
                    ProfileSession(args.candidate, create=False), **kwargs
                )
                report = anomaly if report is None else merge_reports(report, anomaly)
    except (CheckError, SessionError) as e:
        return _error(e)
    doc = report.as_dict()
    # a copy beside the candidate lets `report` fold the verdict in; a
    # read-only artifact tree must not turn a clean gate into an error
    if candidate_it is not None:
        try:
            (candidate_it.path / "check.json").write_text(json.dumps(doc, indent=2) + "\n")
        except OSError:
            pass
    _emit(doc, report.summary(), args.json, args.quiet)
    return 0 if report.passed else 1


def _cmd_tune(args: argparse.Namespace) -> int:
    """Handler for ``cuthermo tune``: 0 tuned, 1 a rung's kernel fails to
    build, launch or agree with its plain version, 2 usage or load error
    (nothing to tune, unknown family, ``--resume`` without ``--all`` or
    without a journal, no card for ``--device cuda``), 3 preempted: with
    ``--all``, a SIGTERM/SIGINT stopped the scheduler at a round boundary
    (committed iterations are durable, the run journal stays); ``tune
    --all --resume`` replays the journaled run deterministically."""
    import json
    import os
    import signal

    from repro_torch import kernels as kreg
    from repro_torch.core.render import ReportEntry, write_report_bundle
    from repro_torch.core.session import ProfileSession, SessionError
    from repro_torch.core.tuner import DEFAULT_BUDGET, TuneError, tune_all
    from repro_torch.runtime.fault import Preempted, PreemptionHandler

    if not args.kernel and not args.all:
        return _error("tune: nothing to do (pass NAME[:VARIANT] families or --all)")
    if args.resume and not args.all:
        return _error(
            "tune: --resume requires --all (single-family tune has no run "
            "journal)"
        )
    plan = _parse_fault_plan(args.inject_faults)
    if _no_card(args):
        return _error("no CUDA device: pass --device cpu to run the plain versions")
    try:
        sess = ProfileSession(args.out, cache=args.cache, fault_plan=plan)
    except SessionError as e:
        return _error(e)
    progress = None if args.quiet else (lambda msg: print(f"  {msg}"))
    budget = DEFAULT_BUDGET if args.budget is None else max(0, args.budget)
    workers = max(1, args.workers)
    results = []
    try:
        if args.all:
            run = {
                "format": "cuthermo-tune-journal",
                "version": 1,
                "kernels": list(args.kernel),
                "budget": budget,
                "seed": args.seed,
                "target_patterns": list(args.target_pattern),
                "use_generated": not args.no_generated,
                "static_prescreen": not args.no_prescreen,
            }
            jpath = sess.root / "tune.journal.json"
            if args.resume:
                # resume by replay: the journal's arguments, not the
                # command line's, define the run; re-executing them is
                # deterministic (seeded tie-breaks, ordered commitment)
                try:
                    run = json.loads(jpath.read_text())
                except (OSError, json.JSONDecodeError) as e:
                    return _error(f"nothing to resume ({jpath}: {e})")
                if run.get("format") != "cuthermo-tune-journal":
                    return _error(f"{jpath} is not a tune journal")
                print(
                    f"resuming journaled tune --all (seed {run['seed']}, "
                    f"budget {run['budget']})",
                    file=sys.stderr,
                )
            else:
                tmp = jpath.with_name(jpath.name + ".tmp")
                tmp.write_text(json.dumps(run, indent=2) + "\n")
                os.replace(tmp, jpath)
            handler = PreemptionHandler().register(
                (signal.SIGTERM, signal.SIGINT)
            )
            try:
                res_all = tune_all(
                    run["kernels"] or None,
                    budget=int(run["budget"]),
                    target_patterns=run["target_patterns"] or None,
                    seed=int(run["seed"]),
                    use_generated=bool(run["use_generated"]),
                    static_prescreen=bool(run["static_prescreen"]),
                    session=sess,
                    collector=sess.collector(workers),
                    cache=sess.cache,
                    progress=progress,
                    device=args.device,
                    preemption=handler,
                )
            except Preempted as e:
                print(f"cuthermo: {e}", file=sys.stderr)
                print(
                    "cuthermo: run journal kept; finish with "
                    "`tune --all --resume`",
                    file=sys.stderr,
                )
                return 3
            finally:
                handler.unregister()
            jpath.unlink(missing_ok=True)
            results = list(res_all.results)
            print(res_all.summary())
            print()
        else:
            for ref in args.kernel:
                if not args.quiet:
                    print(f"# tuning {ref}")
                res = sess.tune(
                    ref,
                    budget=budget,
                    workers=workers,
                    target_patterns=args.target_pattern or None,
                    seed=args.seed,
                    use_generated=not args.no_generated,
                    static_prescreen=not args.no_prescreen,
                    progress=progress,
                    device=args.device,
                )
                results.append(res)
                print(res.summary())
                print()
    except kreg.KernelMismatch as e:
        print(f"cuthermo: {e}", file=sys.stderr)
        return 1
    except (TuneError, SessionError) as e:
        return _error(e)
    finally:
        sess.close()
    if sess.cache is not None:
        print(_cache_stats_line(sess.cache))
    faults = [
        dict(e.as_dict(), kernel=r.kernel)
        for r in results
        for e in r.faults
    ]
    if args.report:
        written = write_report_bundle(
            [ReportEntry.from_profiled(r.best) for r in results],
            os.path.join(args.out, "report"),
            title="cuthermo tune report",
            tuning=[r.as_dict() for r in results],
            faults=faults or None,
        )
        print(f"wrote {written['index.html']}")
    improved = sum(1 for r in results if r.improved)
    fixed = sum(len(r.fixed_patterns) for r in results)
    print(
        f"tuned {len(results)} kernel(s): {improved} improved, "
        f"{fixed} patterns fixed (trajectory in {sess.root})"
    )
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
