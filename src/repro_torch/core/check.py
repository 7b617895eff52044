"""Regression gating: ``cuthermo check`` as a first-class subsystem.

The paper's tuning loop compares heat maps across versions to decide
whether a change helped; this module turns that comparison into a
*thresholded, machine-readable gate* a CI job can run on every PR:

* :func:`check_iterations` evaluates a candidate iteration against a
  baseline artifact under :class:`CheckThresholds` — modeled-HBM-
  transfer delta budgets (per kernel and aggregate), new/worsened
  inefficiency-pattern classes, and scratch (shared-memory) growth — and
  returns a :class:`CheckReport`.
* :func:`detect_anomalies` layers *cross-iteration anomaly detection*
  on a multi-iteration :class:`~repro_torch.core.session.ProfileSession`:
  each kernel's latest heat map is compared against robust
  median/MAD bands over its own rolling history (modeled transfers,
  pattern counts, scratch words), so long-running services catch
  regressions without a hand-picked baseline.  The bands are pure
  integer/float arithmetic over manifest metrics — deterministic for a
  fixed profiling seed.
* :class:`CheckReport` serializes to a schema-versioned JSON document
  (:data:`CHECK_SCHEMA_VERSION`) and renders a human summary; the
  ``cuthermo check`` CLI maps it onto a strict exit-code contract —
  0 pass / 1 gate failure / 2 usage-or-load error (the JAX package's
  contract, see docs/check.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .diff import diff as diff_heatmaps
from .patterns import ALL_PATTERNS
from .session import (
    HistoryPoint,
    Iteration,
    ProfileSession,
    _effective_region_map,
)

#: Version stamp of the check-report JSON document.  Bump on any change
#: to the document's key layout; consumers (a CI gate, any
#: dashboard ingesting gate results) key on this.
CHECK_SCHEMA_VERSION = 1

CHECK_FORMAT = "cuthermo-check"

#: MAD-to-sigma consistency constant for normally-distributed data; the
#: conventional scale that makes ``nmads`` read like "number of sigmas".
MAD_SCALE = 1.4826


class CheckError(RuntimeError):
    """Raised for check usage errors (bad thresholds, unusable inputs).

    The CLI maps this (and :class:`~repro_torch.core.session.SessionError`)
    to exit code 2 — never to the gate-failure code 1.
    """


def pct_delta(before: float, after: float) -> Optional[float]:
    """Percentage growth from ``before`` to ``after``.

    Returns ``None`` when ``before == 0 < after`` — growth from zero is
    unbounded and always exceeds any finite percentage budget (JSON
    carries it as ``null``).  ``0.0`` when both are zero.
    """
    if before > 0:
        return 100.0 * (after - before) / before
    return None if after > 0 else 0.0


def _exceeds(delta_pct: Optional[float], budget_pct: float) -> bool:
    """True when a percentage delta blows a percentage budget.

    A ``None`` delta (growth from zero) exceeds every finite budget;
    an infinite budget (``--threshold scratch-pct=inf``) disables the
    gate entirely, including for growth from zero.
    """
    if math.isinf(budget_pct) and budget_pct > 0:
        return False
    return delta_pct is None or delta_pct > budget_pct


def _fmt_pct(delta_pct: Optional[float]) -> str:
    if delta_pct is None:
        return "new (was 0)"
    return f"{delta_pct:+.1f}%"


# ---------------------------------------------------------------------------
# thresholds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CheckThresholds:
    """Configurable budgets of the regression gate (defaults are strict).

    Every budget is an *allowed growth*: the gate fails only when a
    candidate exceeds it.  The defaults — zero tolerated growth, any new
    pattern fails, any missing kernel fails — make an unconfigured
    ``cuthermo check`` equivalent to "no heat-map regression at all".
    """

    #: per-kernel allowed modeled-transfer growth, in percent
    max_transfer_pct: float = 0.0
    #: whole-iteration (sum over compared kernels) transfer budget, percent
    max_aggregate_pct: float = 0.0
    #: per-kernel allowed scratch word-touch growth, percent
    max_scratch_pct: float = 0.0
    #: allowed severity growth of a persisting pattern before it counts
    #: as worsened (severities are 0..1)
    max_severity_increase: float = 0.05
    #: fail on inefficiency patterns present only in the candidate
    fail_on_new_patterns: bool = True
    #: fail when a baseline kernel is missing from the candidate
    fail_on_missing: bool = True
    #: pattern classes exempt from the new/worsened rules
    allowed_patterns: Tuple[str, ...] = ()

    _KEYS = {
        "transfer-pct": ("max_transfer_pct", float),
        "aggregate-pct": ("max_aggregate_pct", float),
        "scratch-pct": ("max_scratch_pct", float),
        "severity": ("max_severity_increase", float),
        "new-patterns": ("fail_on_new_patterns", None),  # on|off
        "missing": ("fail_on_missing", None),  # on|off
        "allow-pattern": ("allowed_patterns", None),  # repeatable
    }

    @classmethod
    def from_specs(cls, specs: Sequence[str]) -> "CheckThresholds":
        """Parse repeated ``--threshold KEY=VALUE`` flags.

        Keys: ``transfer-pct``, ``aggregate-pct``, ``scratch-pct``,
        ``severity`` (floats); ``new-patterns``, ``missing``
        (``on``/``off``); ``allow-pattern`` (repeatable pattern class).
        Unknown keys, unparsable values, and unknown pattern names raise
        :class:`CheckError` — a typo must fail the run as a usage error,
        not silently loosen the gate.
        """
        values: Dict[str, object] = {}
        allowed: List[str] = []
        for spec in specs:
            key, sep, raw = spec.partition("=")
            if not sep or key not in cls._KEYS:
                known = ", ".join(sorted(cls._KEYS))
                raise CheckError(
                    f"bad --threshold {spec!r} (expected KEY=VALUE with "
                    f"KEY one of: {known})"
                )
            field, cast = cls._KEYS[key]
            if key == "allow-pattern":
                if raw not in ALL_PATTERNS:
                    raise CheckError(
                        f"--threshold allow-pattern={raw!r}: unknown "
                        f"pattern (have {', '.join(ALL_PATTERNS)})"
                    )
                allowed.append(raw)
            elif cast is None:  # on|off switches
                if raw not in ("on", "off"):
                    raise CheckError(
                        f"--threshold {key}={raw!r}: expected 'on' or 'off'"
                    )
                values[field] = raw == "on"
            else:
                try:
                    values[field] = cast(raw)
                except ValueError:
                    raise CheckError(
                        f"--threshold {key}={raw!r}: expected a number"
                    ) from None
        if allowed:
            values["allowed_patterns"] = tuple(dict.fromkeys(allowed))
        return cls(**values)  # type: ignore[arg-type]

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready view (stored verbatim in the check report)."""
        return {
            "max_transfer_pct": self.max_transfer_pct,
            "max_aggregate_pct": self.max_aggregate_pct,
            "max_scratch_pct": self.max_scratch_pct,
            "max_severity_increase": self.max_severity_increase,
            "fail_on_new_patterns": self.fail_on_new_patterns,
            "fail_on_missing": self.fail_on_missing,
            "allowed_patterns": list(self.allowed_patterns),
        }


# ---------------------------------------------------------------------------
# per-kernel and aggregate results
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelCheck:
    """One kernel's gate outcome against the baseline."""

    kernel: str
    status: str  # 'pass' | 'fail' | 'missing' | 'added'
    verdict: str = ""  # underlying HeatmapDiff verdict ('' when no diff)
    failures: Tuple[str, ...] = ()
    transactions_before: int = 0
    transactions_after: int = 0
    transactions_delta_pct: Optional[float] = 0.0
    scratch_before: int = 0
    scratch_after: int = 0
    scratch_delta_pct: Optional[float] = 0.0
    new_patterns: Tuple[Tuple[str, str], ...] = ()  # (region, pattern)
    fixed_patterns: Tuple[Tuple[str, str], ...] = ()
    worsened_patterns: Tuple[Tuple[str, str, float, float], ...] = ()

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready view of this kernel's row in the report."""
        return {
            "kernel": self.kernel,
            "status": self.status,
            "verdict": self.verdict,
            "failures": list(self.failures),
            "transactions_before": self.transactions_before,
            "transactions_after": self.transactions_after,
            "transactions_delta_pct": self.transactions_delta_pct,
            "scratch_before": self.scratch_before,
            "scratch_after": self.scratch_after,
            "scratch_delta_pct": self.scratch_delta_pct,
            "new_patterns": [list(p) for p in self.new_patterns],
            "fixed_patterns": [list(p) for p in self.fixed_patterns],
            "worsened_patterns": [list(p) for p in self.worsened_patterns],
        }


@dataclasses.dataclass(frozen=True)
class AggregateCheck:
    """Whole-iteration transfer budget over the compared kernels."""

    transactions_before: int
    transactions_after: int
    delta_pct: Optional[float]
    budget_pct: float
    failures: Tuple[str, ...] = ()

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready view of the aggregate row."""
        return {
            "transactions_before": self.transactions_before,
            "transactions_after": self.transactions_after,
            "delta_pct": self.delta_pct,
            "budget_pct": self.budget_pct,
            "failures": list(self.failures),
        }


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One kernel metric outside its rolling median/MAD band."""

    kernel: str
    metric: str  # 'transactions' | 'patterns' | 'scratch_words'
    value: float
    median: float
    mad: float
    lo: float
    hi: float
    n_history: int
    iteration: str = ""

    def describe(self) -> str:
        """One-line human form of this flag (summary + failure lists)."""
        return (
            f"{self.kernel}: {self.metric} {self.value:g} outside "
            f"[{self.lo:g}, {self.hi:g}] (median {self.median:g} over "
            f"{self.n_history} iterations)"
        )

    def as_dict(self) -> Dict[str, object]:
        """JSON-ready view of this anomaly flag."""
        return {
            "kernel": self.kernel,
            "metric": self.metric,
            "value": self.value,
            "median": self.median,
            "mad": self.mad,
            "lo": self.lo,
            "hi": self.hi,
            "n_history": self.n_history,
            "iteration": self.iteration,
        }


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CheckReport:
    """The full outcome of one ``cuthermo check`` evaluation.

    ``mode`` records which gates ran: ``baseline`` (candidate vs
    baseline thresholds), ``anomaly`` (rolling-history bands), or
    ``baseline+anomaly``.  :meth:`as_dict` is the schema-versioned
    machine-readable document; :meth:`summary` the human one; the CLI
    derives its exit code from :attr:`passed`.
    """

    mode: str
    candidate: str
    baseline: str = ""
    thresholds: Optional[CheckThresholds] = None
    kernels: Tuple[KernelCheck, ...] = ()
    aggregate: Optional[AggregateCheck] = None
    anomalies: Tuple[Anomaly, ...] = ()
    anomaly_meta: Optional[Mapping[str, object]] = None

    @property
    def failures(self) -> Tuple[str, ...]:
        """Every gate failure, kernel-qualified, in report order."""
        out: List[str] = []
        for kc in self.kernels:
            out.extend(f"{kc.kernel}: {f}" for f in kc.failures)
        if self.aggregate is not None:
            out.extend(f"aggregate: {f}" for f in self.aggregate.failures)
        out.extend(f"anomaly: {a.describe()}" for a in self.anomalies)
        return tuple(out)

    @property
    def passed(self) -> bool:
        """True when every gate held (the CLI's exit-0 condition)."""
        return not self.failures

    def as_dict(self) -> Dict[str, object]:
        """The schema-versioned machine-readable report document."""
        doc: Dict[str, object] = {
            "format": CHECK_FORMAT,
            "schema_version": CHECK_SCHEMA_VERSION,
            "passed": self.passed,
            "mode": self.mode,
            "candidate": self.candidate,
            "baseline": self.baseline,
            "thresholds": (
                self.thresholds.as_dict() if self.thresholds else None
            ),
            "kernels": [kc.as_dict() for kc in self.kernels],
            "aggregate": (
                self.aggregate.as_dict() if self.aggregate else None
            ),
            "anomalies": {
                "meta": dict(self.anomaly_meta) if self.anomaly_meta else None,
                "flags": [a.as_dict() for a in self.anomalies],
            },
            "failures": list(self.failures),
        }
        return doc

    def summary(self) -> str:
        """Multi-line human summary (the ``cuthermo check`` stdout body)."""
        head = f"== cuthermo check: {self.candidate}"
        if self.baseline:
            head += f" vs baseline {self.baseline}"
        lines = [head + f" [{self.mode}] =="]
        for kc in self.kernels:
            mark = "FAIL" if kc.status == "fail" else kc.status
            if kc.status in ("pass", "fail"):
                lines.append(
                    f"[{mark:>7}] {kc.kernel}: transfers "
                    f"{kc.transactions_before} -> {kc.transactions_after} "
                    f"({_fmt_pct(kc.transactions_delta_pct)}), scratch "
                    f"{kc.scratch_before} -> {kc.scratch_after}"
                )
            else:
                lines.append(f"[{mark:>7}] {kc.kernel}")
            for region, pattern in kc.new_patterns:
                lines.append(f"          [new] {pattern} on {region}")
            for region, pattern, sb, sa in kc.worsened_patterns:
                lines.append(
                    f"          [worsened] {pattern} on {region} "
                    f"(severity {sb:.2f} -> {sa:.2f})"
                )
            for f in kc.failures:
                lines.append(f"          !! {f}")
        if self.aggregate is not None:
            agg = self.aggregate
            ok = "within" if not agg.failures else "OVER"
            lines.append(
                f"aggregate: transfers {agg.transactions_before} -> "
                f"{agg.transactions_after} ({_fmt_pct(agg.delta_pct)}) "
                f"{ok} +{agg.budget_pct:g}% budget"
            )
        if self.anomaly_meta is not None:
            meta = self.anomaly_meta
            if self.anomalies:
                lines.append(f"anomalies: {len(self.anomalies)} flagged")
                for a in self.anomalies:
                    lines.append(f"  !! {a.describe()}")
            else:
                lines.append(
                    "anomalies: none "
                    f"({meta.get('kernels_scanned', 0)} kernels against "
                    f"median/MAD bands, {meta.get('nmads')} MADs)"
                )
        n = len(self.failures)
        lines.append(
            "check passed" if self.passed
            else f"check FAILED ({n} failure{'s' if n != 1 else ''})"
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the baseline gate
# ---------------------------------------------------------------------------


def _severity_map(pk, inv_rename: Mapping[str, str]) -> Dict[Tuple[str, str], float]:
    """(region, pattern) -> severity, regions renamed back to before-names."""
    return {
        (inv_rename.get(r.region, r.region), r.pattern): float(r.severity)
        for r in pk.reports
    }


def _check_kernel(
    base_pk, cand_pk, thresholds: CheckThresholds,
    rename: Mapping[str, str],
) -> KernelCheck:
    """Evaluate one baseline/candidate kernel pair against the gate."""
    eff = _effective_region_map(rename, base_pk.heatmap, cand_pk.heatmap)
    d = diff_heatmaps(base_pk.heatmap, cand_pk.heatmap, region_map=eff)
    failures: List[str] = []
    tx_delta = pct_delta(d.tx_before, d.tx_after)
    if d.tx_after > d.tx_before and _exceeds(
        tx_delta, thresholds.max_transfer_pct
    ):
        failures.append(
            f"modeled transfers {d.tx_before} -> {d.tx_after} "
            f"({_fmt_pct(tx_delta)} > +{thresholds.max_transfer_pct:g}% "
            "budget)"
        )
    allowed = set(thresholds.allowed_patterns)
    new_patterns = tuple(
        (r, p) for r, p in d.introduced if p not in allowed
    )
    if new_patterns and thresholds.fail_on_new_patterns:
        failures.extend(
            f"new pattern: {p} on {r}" for r, p in new_patterns
        )
    inv = {v: k for k, v in eff.items()}
    base_sev = _severity_map(base_pk, {})
    cand_sev = _severity_map(cand_pk, inv)
    worsened = []
    for r, p in d.persisting:
        if p in allowed:
            continue
        sb = base_sev.get((r, p))
        sa = cand_sev.get((r, p))
        if sb is None or sa is None:
            continue
        if sa - sb > thresholds.max_severity_increase:
            worsened.append((r, p, sb, sa))
            failures.append(
                f"worsened pattern: {p} on {r} "
                f"(severity {sb:.2f} -> {sa:.2f}, "
                f"+{sa - sb:.2f} > +{thresholds.max_severity_increase:g})"
            )
    scratch_b = base_pk.heatmap.scratch_words()
    scratch_a = cand_pk.heatmap.scratch_words()
    scratch_delta = pct_delta(scratch_b, scratch_a)
    if scratch_a > scratch_b and _exceeds(
        scratch_delta, thresholds.max_scratch_pct
    ):
        failures.append(
            f"scratch words {scratch_b} -> {scratch_a} "
            f"({_fmt_pct(scratch_delta)} > +{thresholds.max_scratch_pct:g}% "
            "budget)"
        )
    return KernelCheck(
        kernel=base_pk.name,
        status="fail" if failures else "pass",
        verdict=d.verdict,
        failures=tuple(failures),
        transactions_before=d.tx_before,
        transactions_after=d.tx_after,
        transactions_delta_pct=tx_delta,
        scratch_before=scratch_b,
        scratch_after=scratch_a,
        scratch_delta_pct=scratch_delta,
        new_patterns=new_patterns,
        fixed_patterns=tuple(d.fixed),
        worsened_patterns=tuple(worsened),
    )


def check_iterations(
    baseline: Iteration,
    candidate: Iteration,
    thresholds: Optional[CheckThresholds] = None,
    region_maps: Optional[Mapping[str, Mapping[str, str]]] = None,
) -> CheckReport:
    """Gate a candidate iteration against a baseline artifact.

    Kernels are aligned by manifest name (the same alignment
    ``diff_iterations`` uses), region renames come from each baseline
    kernel's persisted ``region_map`` overridable per kernel through
    ``region_maps``, and every pair is evaluated under ``thresholds``
    (strict defaults).  Kernels only in the candidate are reported as
    ``added`` (informational); kernels missing from the candidate fail
    the gate unless ``fail_on_missing`` is off.  Raises
    :class:`CheckError` when the two iterations share no kernel at all
    — a gate that compares nothing must not report success.
    """
    thresholds = thresholds or CheckThresholds()
    region_maps = region_maps or {}
    checks: List[KernelCheck] = []
    cand_names = set(candidate.kernel_names())
    agg_before = agg_after = 0
    compared = 0
    for base_pk in baseline.kernels:
        if base_pk.name not in cand_names:
            failures = (
                ("kernel present in baseline but missing from candidate",)
                if thresholds.fail_on_missing
                else ()
            )
            checks.append(
                KernelCheck(
                    kernel=base_pk.name,
                    status="missing",
                    failures=failures,
                    transactions_before=base_pk.transactions,
                )
            )
            continue
        cand_pk = candidate.kernel(base_pk.name)
        rename = region_maps.get(base_pk.name)
        if rename is None:
            rename = dict(base_pk.region_map)
        kc = _check_kernel(base_pk, cand_pk, thresholds, rename)
        checks.append(kc)
        agg_before += kc.transactions_before
        agg_after += kc.transactions_after
        compared += 1
    base_names = set(baseline.kernel_names())
    for cand_pk in candidate.kernels:
        if cand_pk.name not in base_names:
            checks.append(
                KernelCheck(
                    kernel=cand_pk.name,
                    status="added",
                    transactions_after=cand_pk.transactions,
                )
            )
    if compared == 0:
        raise CheckError(
            f"baseline {baseline.label!r} and candidate "
            f"{candidate.label!r} share no kernel; a gate that compares "
            "nothing cannot pass (check the iteration names)"
        )
    agg_delta = pct_delta(agg_before, agg_after)
    agg_failures: Tuple[str, ...] = ()
    if agg_after > agg_before and _exceeds(
        agg_delta, thresholds.max_aggregate_pct
    ):
        agg_failures = (
            f"total modeled transfers {agg_before} -> {agg_after} "
            f"({_fmt_pct(agg_delta)} > +{thresholds.max_aggregate_pct:g}% "
            "budget)",
        )
    return CheckReport(
        mode="baseline",
        candidate=candidate.label,
        baseline=baseline.label,
        thresholds=thresholds,
        kernels=tuple(checks),
        aggregate=AggregateCheck(
            transactions_before=agg_before,
            transactions_after=agg_after,
            delta_pct=agg_delta,
            budget_pct=thresholds.max_aggregate_pct,
            failures=agg_failures,
        ),
    )


# ---------------------------------------------------------------------------
# the static gate (no traces: lint reports on registry refs)
# ---------------------------------------------------------------------------


def _static_rename(
    family_map: Sequence[Tuple[str, str]],
    base_regions: Sequence[str],
    cand_regions: Sequence[str],
) -> Dict[str, str]:
    """Orient a registry region_map for a baseline->candidate lint pair.

    Registry region maps are written ladder-upward (e.g. gramschm's
    ``q -> qT``); a static check may compare in either direction, so
    each pair is applied in whichever orientation matches the regions
    the two lint reports actually carry.
    """
    base, cand = set(base_regions), set(cand_regions)
    rename: Dict[str, str] = {}
    for b, c in family_map:
        if b in base and c in cand:
            rename[b] = c
        elif c in base and b in cand:
            rename[c] = b
    return rename


def check_static(
    candidate_ref: str,
    baseline_ref: str,
    thresholds: Optional[CheckThresholds] = None,
) -> CheckReport:
    """Gate a candidate registry ref against a baseline ref *statically*.

    Both refs (``family:variant`` or bare family) are linted with
    :func:`repro_torch.core.lint.lint_ref` — no kernel runs, no traces, no
    session artifacts — and the two :class:`~repro_torch.core.lint.LintReport`
    objects are compared under the same :class:`CheckThresholds`
    vocabulary the dynamic gate uses:

    * modeled-transfer growth against ``max_transfer_pct`` (the linter's
      exact replay of the collector's transaction model; for specs with
      dynamic operands the partial static floor over modeled operands
      stands in),
    * new / worsened / fixed findings by ``(region, pattern)`` class,
      with the family's registry ``region_map`` applied in whichever
      orientation matches when both refs belong to one family,
    * candidate *error*-level findings (out-of-bounds origins, dead
      operands) always fail, independent of thresholds.

    Returns a :class:`CheckReport` with ``mode='static'``.  Unknown
    refs raise :class:`CheckError` (CLI exit 2, never gate-failure 1).
    """
    from repro_torch import kernels as kreg

    from . import lint as lint_mod

    thresholds = thresholds or CheckThresholds()
    reports = {}
    for label, ref in (("baseline", baseline_ref), ("candidate", candidate_ref)):
        try:
            reports[label] = lint_mod.lint_ref(ref)
        except (KeyError, lint_mod.LintError) as exc:
            raise CheckError(f"{label} ref {ref!r}: {exc}") from exc
    base, cand = reports["baseline"], reports["candidate"]

    base_family = base.kernel.partition(":")[0]
    cand_family = cand.kernel.partition(":")[0]
    rename: Dict[str, str] = {}
    if base_family == cand_family:
        family_map = getattr(kreg.get(base_family), "region_map", ())
        rename = _static_rename(
            family_map,
            [ov.region for ov in base.operands],
            [ov.region for ov in cand.operands],
        )
    inv = {v: k for k, v in rename.items()}

    def _tx(report) -> int:
        if report.static_transactions is not None:
            return report.static_transactions
        return sum(
            ov.modeled_transactions
            for ov in report.operands
            if ov.modeled_transactions is not None
        )

    tx_before, tx_after = _tx(base), _tx(cand)
    tx_delta = pct_delta(tx_before, tx_after)
    failures: List[str] = []
    if tx_after > tx_before and _exceeds(tx_delta, thresholds.max_transfer_pct):
        failures.append(
            f"modeled transfers {tx_before} -> {tx_after} "
            f"({_fmt_pct(tx_delta)} > +{thresholds.max_transfer_pct:g}% "
            "budget, static model)"
        )

    for f in cand.errors:
        failures.append(f"lint error: {f.rule} on {f.region} — {f.evidence[0]}")

    base_sev = {(f.region, f.pattern): float(f.severity) for f in base.findings}
    cand_sev = {
        (inv.get(f.region, f.region), f.pattern): float(f.severity)
        for f in cand.findings
    }
    allowed = set(thresholds.allowed_patterns)
    new_patterns = tuple(
        (r, p) for r, p in sorted(cand_sev)
        if (r, p) not in base_sev and p not in allowed
    )
    if new_patterns and thresholds.fail_on_new_patterns:
        failures.extend(f"new pattern: {p} on {r}" for r, p in new_patterns)
    fixed = tuple(
        (r, p) for r, p in sorted(base_sev) if (r, p) not in cand_sev
    )
    worsened = []
    for (r, p), sb in sorted(base_sev.items()):
        if p in allowed or (r, p) not in cand_sev:
            continue
        sa = cand_sev[(r, p)]
        if sa - sb > thresholds.max_severity_increase:
            worsened.append((r, p, sb, sa))
            failures.append(
                f"worsened pattern: {p} on {r} "
                f"(severity {sb:.2f} -> {sa:.2f}, "
                f"+{sa - sb:.2f} > +{thresholds.max_severity_increase:g})"
            )

    kc = KernelCheck(
        kernel=f"{base.kernel} -> {cand.kernel}",
        status="fail" if failures else "pass",
        verdict=cand.verdict(),
        failures=tuple(failures),
        transactions_before=tx_before,
        transactions_after=tx_after,
        transactions_delta_pct=tx_delta,
        new_patterns=new_patterns,
        fixed_patterns=fixed,
        worsened_patterns=tuple(worsened),
    )
    agg_failures: Tuple[str, ...] = ()
    if tx_after > tx_before and _exceeds(tx_delta, thresholds.max_aggregate_pct):
        agg_failures = (
            f"total modeled transfers {tx_before} -> {tx_after} "
            f"({_fmt_pct(tx_delta)} > +{thresholds.max_aggregate_pct:g}% "
            "budget)",
        )
    return CheckReport(
        mode="static",
        candidate=cand.kernel,
        baseline=base.kernel,
        thresholds=thresholds,
        kernels=(kc,),
        aggregate=AggregateCheck(
            transactions_before=tx_before,
            transactions_after=tx_after,
            delta_pct=tx_delta,
            budget_pct=thresholds.max_aggregate_pct,
            failures=agg_failures,
        ),
    )


# ---------------------------------------------------------------------------
# cross-iteration anomaly detection
# ---------------------------------------------------------------------------

#: Minimum history points (excluding the latest) an anomaly band needs.
MIN_HISTORY = 3

#: Default band half-width in scaled MADs.
DEFAULT_NMADS = 4.0

#: Relative band floor: bands never get tighter than this fraction of
#: the median, so integer metrics with zero spread (MAD 0) still admit
#: rounding-level wiggle.
DEFAULT_REL_FLOOR = 0.02


def _median(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return float(s[mid]) if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def robust_band(
    values: Sequence[float],
    nmads: float = DEFAULT_NMADS,
    rel_floor: float = DEFAULT_REL_FLOOR,
) -> Tuple[float, float, float, float]:
    """(median, MAD, lo, hi) band over a metric history.

    The band is ``median ± max(nmads * 1.4826 * MAD, rel_floor *
    max(|median|, 1))`` — the MAD term adapts to genuine run-to-run
    spread, the relative floor keeps zero-spread integer histories from
    flagging every ±1 wiggle.  Pure arithmetic: deterministic for a
    fixed history.
    """
    if not values:
        raise CheckError("robust_band needs at least one history value")
    med = _median(values)
    mad = _median([abs(v - med) for v in values])
    half = max(nmads * MAD_SCALE * mad, rel_floor * max(abs(med), 1.0))
    return med, mad, med - half, med + half


def detect_anomalies(
    history: Mapping[str, Sequence[HistoryPoint]],
    min_history: int = MIN_HISTORY,
    nmads: float = DEFAULT_NMADS,
    rel_floor: float = DEFAULT_REL_FLOOR,
) -> Tuple[Tuple[Anomaly, ...], Dict[str, object]]:
    """Flag kernels whose latest iteration left their own history band.

    ``history`` maps kernel name to :class:`HistoryPoint` sequences in
    iteration order (``ProfileSession.history()``).  For every kernel
    with at least ``min_history`` points *before* its latest, the latest
    modeled-transfer count, pattern count, and (when the artifacts carry
    it) scratch-word count are tested against :func:`robust_band` over
    the preceding points.  Returns the flagged anomalies plus a metadata
    dict (band parameters, kernels scanned/skipped) for the report.
    """
    flags: List[Anomaly] = []
    scanned = skipped = 0
    for kernel in sorted(history):
        points = list(history[kernel])
        if len(points) < min_history + 1:
            skipped += 1
            continue
        scanned += 1
        past, latest = points[:-1], points[-1]
        metrics: List[Tuple[str, List[float], float]] = [
            (
                "transactions",
                [float(p.transactions) for p in past],
                float(latest.transactions),
            ),
            (
                "patterns",
                [float(p.n_patterns) for p in past],
                float(latest.n_patterns),
            ),
        ]
        scratch_hist = [p.scratch_words for p in past]
        if latest.scratch_words is not None and all(
            s is not None for s in scratch_hist
        ):
            metrics.append(
                (
                    "scratch_words",
                    [float(s) for s in scratch_hist],
                    float(latest.scratch_words),
                )
            )
        for metric, values, value in metrics:
            med, mad, lo, hi = robust_band(values, nmads, rel_floor)
            if not (lo <= value <= hi):
                flags.append(
                    Anomaly(
                        kernel=kernel,
                        metric=metric,
                        value=value,
                        median=med,
                        mad=mad,
                        lo=lo,
                        hi=hi,
                        n_history=len(past),
                        iteration=latest.iteration,
                    )
                )
    meta: Dict[str, object] = {
        "min_history": min_history,
        "nmads": nmads,
        "rel_floor": rel_floor,
        "kernels_scanned": scanned,
        "kernels_skipped": skipped,
    }
    return tuple(flags), meta


def check_session_anomalies(
    session: ProfileSession,
    min_history: int = MIN_HISTORY,
    nmads: float = DEFAULT_NMADS,
    rel_floor: float = DEFAULT_REL_FLOOR,
    include_rejected: bool = False,
) -> CheckReport:
    """Anomaly-only check over a session's own rolling history.

    Iterations the autotuner profiled and rejected are excluded by
    default (they are *deliberately* bad candidates); pass
    ``include_rejected=True`` to band over everything.
    """
    history = session.history(include_rejected=include_rejected)
    if not history:
        raise CheckError(
            f"{session.root}: session has no iterations to scan"
        )
    flags, meta = detect_anomalies(
        history, min_history=min_history, nmads=nmads, rel_floor=rel_floor
    )
    return CheckReport(
        mode="anomaly",
        candidate=str(session.root),
        anomalies=flags,
        anomaly_meta=meta,
    )


def merge_reports(baseline_report: CheckReport, anomaly_report: CheckReport) -> CheckReport:
    """Combine a baseline gate and an anomaly scan into one report."""
    return dataclasses.replace(
        baseline_report,
        mode="baseline+anomaly",
        anomalies=anomaly_report.anomalies,
        anomaly_meta=anomaly_report.anomaly_meta,
    )


__all__ = [
    "CHECK_FORMAT",
    "CHECK_SCHEMA_VERSION",
    "DEFAULT_NMADS",
    "DEFAULT_REL_FLOOR",
    "MIN_HISTORY",
    "AggregateCheck",
    "Anomaly",
    "CheckError",
    "CheckReport",
    "CheckThresholds",
    "KernelCheck",
    "check_iterations",
    "check_session_anomalies",
    "check_static",
    "detect_anomalies",
    "merge_reports",
    "pct_delta",
    "robust_band",
]
