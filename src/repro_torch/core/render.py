"""Heat-map rendering: CSV (paper Fig. 5 layout), ANSI terminal, HTML.

The vertical layout matches CUTHERMO's GUI: one row per sector tag,
word temperatures left-to-right, the whole-sector temperature in the
last column.  Consecutive rows with identical signatures are compressed
and annotated with their repetition count (paper Fig. 4).

Beyond single-heat-map rendering, this module builds *report bundles*
for whole iterations (see :mod:`repro_torch.core.session`): a
self-contained HTML gallery plus a markdown digest with, per kernel,
the heat maps, detected patterns, advisor actions, the kernel's
measured run where the profile launched it, and a device-memory
traffic chart (modeled bytes moved vs the demand floor).  Word and
sector sizes come from each region's geometry.
"""

from __future__ import annotations

import dataclasses
import html as _html
import io
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .advisor import Action
from .heatmap import Heatmap, HeatRow, RegionHeatmap, compress_region
from .patterns import PatternReport

# ANSI 256-color heat ramp (cold -> hot)
_RAMP = [17, 19, 26, 32, 37, 71, 106, 142, 178, 208, 202, 196]


def _heat_color(temp: int, max_temp: int) -> int:
    if temp <= 0:
        return 236  # grey for untouched
    frac = min(1.0, temp / max(1, max_temp))
    return _RAMP[min(len(_RAMP) - 1, int(frac * (len(_RAMP) - 1)))]


def render_csv(hm: Heatmap, compress: bool = True) -> str:
    """CSV rows: region,tag,repeat,w0..wN,sector (paper's CSV artifact)."""
    out = io.StringIO()
    for rh in hm.regions:
        wps = rh.words_per_sector()
        header = ",".join(
            ["region", "sector_tag", "repeat"]
            + [f"w{i}" for i in range(wps)]
            + ["sector"]
        )
        out.write(header + "\n")
        rows: Sequence[Tuple[HeatRow, int]]
        rows = compress_region(rh) if compress else [(r, 1) for r in rh.rows]
        for row, rep in rows:
            out.write(
                ",".join(
                    [rh.region.name, f"0x{row.tag:x}", str(rep)]
                    + [str(t) for t in row.word_temps]
                    + [str(row.sector_temp)]
                )
                + "\n"
            )
    return out.getvalue()


def render_ascii(
    hm: Heatmap,
    color: bool = False,
    max_rows_per_region: int = 24,
) -> str:
    """Terminal heat map: the paper's Fig. 5 vertical layout."""
    out = io.StringIO()
    out.write(
        f"kernel={hm.kernel} grid={hm.grid} sampler={hm.sampler} "
        f"records={hm.n_records}"
        + (f" dropped={hm.dropped}" if hm.dropped else "")
        + "\n"
    )
    for rh in hm.regions:
        max_temp = max(rh.max_sector_temp, 1)
        wps = rh.words_per_sector()
        out.write(
            f"-- region {rh.region.name} [{rh.region.space}] "
            f"{rh.region.geometry.shape} x{rh.region.geometry.itemsize}B "
            f"({rh.touched_sectors} sectors touched, "
            f"{rh.n_programs} programs, max temp {rh.max_sector_temp}) --\n"
        )
        header = " " * 28 + " ".join(f"w{i:<2}" for i in range(wps)) + " | sect"
        out.write(header + "\n")
        shown = 0
        for row, rep in compress_region(rh):
            if shown >= max_rows_per_region:
                out.write(f"  ... ({rh.touched_sectors - shown} more sectors)\n")
                break
            label = f"{rh.region.name[:12]:<12} 0x{row.tag:08x}"
            cells = []
            for t in row.word_temps:
                cell = f"{t:<3}"
                if color:
                    cell = f"\x1b[38;5;{_heat_color(t, max_temp)}m{cell}\x1b[0m"
                cells.append(cell)
            sect = f"{row.sector_temp}"
            if color:
                sect = (
                    f"\x1b[38;5;{_heat_color(row.sector_temp, max_temp)}m"
                    f"{sect}\x1b[0m"
                )
            suffix = f"  x{rep}" if rep > 1 else ""
            out.write(f"{label:<27} {' '.join(cells)} | {sect}{suffix}\n")
            shown += rep
    return out.getvalue()


_HTML_STYLE = (
    "<style>body{font-family:monospace;background:#111;color:#ddd;"
    "margin:24px}"
    "table{border-collapse:collapse;margin:12px 0}"
    "td{padding:2px 6px;border:1px solid #222;text-align:center}"
    "th{padding:2px 6px;color:#999}"
    "h2,h3,h4{color:#eee}a{color:#7ab}"
    ".verdict-improved{color:#7c7}.verdict-regressed{color:#c77}"
    ".card{border:1px solid #333;padding:8px 16px;margin:16px 0;"
    "border-radius:4px}"
    ".evidence{color:#aaa;margin:2px 0 2px 18px}"
    "</style>"
)


def _heat_cell_html(t: int, max_temp: int) -> str:
    frac = min(1.0, t / max_temp) if t > 0 else 0.0
    r = int(40 + 215 * frac)
    b = int(80 * (1 - frac)) + 20
    bg = f"rgb({r},{int(40 + 60 * (1 - frac))},{b})" if t else "#1a1a1a"
    return f"<td style='background:{bg}'>{t}</td>"


def _region_table_html(
    rh: RegionHeatmap, max_runs: Optional[int] = None
) -> str:
    """One region's heat map as an HTML table (compressed rows)."""
    max_temp = max(rh.max_sector_temp, 1)
    wps = rh.words_per_sector()
    parts = [
        f"<h4>region {_html.escape(rh.region.name)} "
        f"[{rh.region.space}] {rh.region.geometry.shape} "
        f"&middot; {rh.touched_sectors} sectors, "
        f"{rh.n_programs} programs</h4><table>",
        "<tr><th>sector</th><th>rep</th>"
        + "".join(f"<th>w{i}</th>" for i in range(wps))
        + "<th>sector&deg;</th></tr>",
    ]
    runs = compress_region(rh)
    shown = runs if max_runs is None else runs[:max_runs]
    for row, rep in shown:
        cells = [
            _heat_cell_html(t, max_temp)
            for t in row.word_temps + (row.sector_temp,)
        ]
        parts.append(
            f"<tr><td>0x{row.tag:x}</td><td>{rep}</td>{''.join(cells)}</tr>"
        )
    parts.append("</table>")
    if max_runs is not None and len(runs) > max_runs:
        parts.append(
            f"<p class='evidence'>... {len(runs) - max_runs} more "
            "compressed runs (full map in the CSV artifact)</p>"
        )
    return "".join(parts)


def render_html(hm: Heatmap) -> str:
    """Standalone HTML heat map (the GUI artifact)."""
    parts: List[str] = [
        "<!doctype html><meta charset='utf-8'>",
        f"<title>thermo: {_html.escape(hm.kernel)}</title>",
        _HTML_STYLE,
        f"<h2>kernel {_html.escape(hm.kernel)} grid={hm.grid} "
        f"sampler={_html.escape(hm.sampler)}</h2>",
    ]
    for rh in hm.regions:
        parts.append(_region_table_html(rh))
    return "".join(parts)


def save(hm: Heatmap, path: str, fmt: Optional[str] = None) -> None:
    """Write one heat map to ``path`` as 'html' or 'csv' (from the suffix)."""
    fmt = fmt or ("html" if path.endswith(".html") else "csv")
    text = render_html(hm) if fmt == "html" else render_csv(hm)
    with open(path, "w") as f:
        f.write(text)


# ---------------------------------------------------------------------------
# session report bundles
# ---------------------------------------------------------------------------

_SAFE_STEM = re.compile(r"[^A-Za-z0-9._-]+")


def slugify(name: str) -> str:
    """File-system-safe stem for a kernel name (shared artifact policy)."""
    return _SAFE_STEM.sub("_", name) or "kernel"


def dedupe_stem(stem: str, seen: Dict[str, int]) -> str:
    """Disambiguate a repeated filename stem with a numeric suffix.

    Returned stems are guaranteed unique across all calls sharing the
    same ``seen`` dict — including against suffixed stems handed out
    earlier (``a``, ``a_1`` and a literal later ``a_1`` never collide).
    """
    if stem not in seen:
        seen[stem] = 0
        return stem
    while True:
        seen[stem] += 1
        candidate = f"{stem}_{seen[stem]}"
        if candidate not in seen:
            seen[candidate] = 0
            return candidate


@dataclasses.dataclass(frozen=True)
class ReportEntry:
    """One kernel's slice of a report bundle (heat map + derived views)."""

    heatmap: Heatmap
    reports: Tuple[PatternReport, ...] = ()
    actions: Tuple[Action, ...] = ()
    name: Optional[str] = None  # display name; defaults to heatmap.kernel
    variant: str = ""
    wall_s: float = 0.0
    run: Optional[Mapping] = None  # the profile's measured kernel launch

    @property
    def title(self) -> str:
        """Display name of this entry (registry name or kernel name)."""
        return self.name or self.heatmap.kernel

    @property
    def shards(self):
        """Per-shard collection provenance of this entry's heat map."""
        return self.heatmap.shards

    @property
    def merge_stats(self) -> str:
        """One-line sharded-collection summary ('' for serial profiles).

        Reports the shard count and the merged record/drop totals — the
        numbers that prove the shards cover the whole sampled grid once.
        """
        shards = self.shards
        if not shards:
            return ""
        records = sum(s.records for s in shards)
        dropped = sum(s.dropped for s in shards)
        programs = sum(s.programs for s in shards)
        out = (
            f"collected in {len(shards)} shards: {programs} programs, "
            f"{records} records merged exactly"
        )
        if dropped:
            out += f", {dropped} dropped"
        return out

    @classmethod
    def from_profiled(cls, pk) -> "ReportEntry":
        """Build an entry from a session ``ProfiledKernel`` (duck-typed)."""
        return cls(
            heatmap=pk.heatmap,
            reports=tuple(pk.reports),
            actions=tuple(pk.actions),
            name=pk.name,
            variant=pk.variant,
            wall_s=pk.wall_s,
            run=pk.run,
        )


def _traffic_bytes(hm: Heatmap) -> Tuple[int, int]:
    """(moved_bytes, demanded_bytes) across the device-memory boundary.

    Moved: every sector transaction drags a whole sector.  Demanded:
    only the word transactions software actually asked for.  Their ratio
    is the heat map's waste ratio; their absolute placement is what the
    bundle's traffic chart shows.
    """
    moved = 0
    demanded = 0
    for rh in hm.regions:
        if rh.region.space != "hbm":
            continue
        geom = rh.region.geometry
        moved += int(rh.sector_temps_array.sum()) * geom.sector_bytes
        demanded += int(rh.word_temps_matrix.sum()) * geom.word_bytes
    return moved, demanded


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} GiB"


def _traffic_chart_svg(entries: Sequence[ReportEntry]) -> str:
    """Horizontal traffic chart: moved bytes per kernel, demand floor shaded.

    The filled span of each bar is the demand floor (bytes software asked
    for); the hollow remainder is sector-granularity waste.  A kernel whose
    bar is all filled sits on the memory roofline's achievable floor.
    """
    rows = []
    stats = [(e, *_traffic_bytes(e.heatmap)) for e in entries]
    max_moved = max((m for _, m, _ in stats), default=0)
    if max_moved == 0:
        return ""
    width, bar_h, gap, label_w = 720, 18, 8, 220
    height = len(stats) * (bar_h + gap) + gap
    rows.append(
        f"<svg width='{width}' height='{height}' "
        "xmlns='http://www.w3.org/2000/svg' "
        "style='font-family:monospace;font-size:12px'>"
    )
    span = width - label_w - 140
    for i, (e, moved, demanded) in enumerate(stats):
        y = gap + i * (bar_h + gap)
        w_moved = max(2, int(span * moved / max_moved))
        w_useful = 0 if moved == 0 else int(w_moved * demanded / moved)
        byte_waste = moved / demanded if demanded else 1.0
        rows.append(
            f"<text x='{label_w - 8}' y='{y + bar_h - 5}' fill='#ccc' "
            f"text-anchor='end'>{_html.escape(e.title)}</text>"
            f"<rect x='{label_w}' y='{y}' width='{w_moved}' "
            f"height='{bar_h}' fill='#1a1a1a' stroke='#c75'/>"
            f"<rect x='{label_w}' y='{y}' width='{w_useful}' "
            f"height='{bar_h}' fill='#2a6'/>"
            f"<text x='{label_w + w_moved + 6}' y='{y + bar_h - 5}' "
            f"fill='#999'>{_fmt_bytes(moved)} moved / "
            f"{_fmt_bytes(demanded)} demanded "
            f"({byte_waste:.2f}x)</text>"
        )
    rows.append("</svg>")
    return "".join(rows)


def _faults_section_html(faults: Sequence[Mapping]) -> str:
    """Recovered-fault provenance section of the HTML bundle (artifact v6).

    ``faults`` is the iteration manifest's top-level ``faults`` block:
    one dict per recorded ``FaultEvent`` (kind, shard, attempt, wall
    time, detail), stamped with the kernel it was collected under.  The
    section exists so a bundle reader can tell a clean run from one
    that survived worker crashes, hung shards, or corrupt cache entries
    — the merged heat maps are bit-identical either way, which is the
    point.
    """
    if not faults:
        return ""
    parts = [
        "<h3>fault recovery</h3>",
        "<p class='evidence'>faults recovered during collection; every "
        "recovery re-executed the affected shards, so the merged heat "
        "maps are bit-identical to a fault-free run.</p>",
        "<table><tr><th>kernel</th><th>kind</th><th>where</th>"
        "<th>shard</th><th>attempt</th><th>wall</th><th>detail</th></tr>",
    ]
    for f in faults:
        shard = f.get("shard", -1)
        parts.append(
            f"<tr><td>{_html.escape(str(f.get('kernel', '')))}</td>"
            f"<td class='verdict-regressed'>"
            f"{_html.escape(str(f.get('kind', '?')))}</td>"
            f"<td>{_html.escape(str(f.get('where', '')))}</td>"
            f"<td>{'&mdash;' if shard < 0 else shard}</td>"
            f"<td>{f.get('attempt', 0)}</td>"
            f"<td>{float(f.get('wall_s', 0.0)) * 1e3:.0f} ms</td>"
            f"<td>{_html.escape(str(f.get('detail', '')))}</td></tr>"
        )
    parts.append("</table>")
    return "".join(parts)


def _faults_section_markdown(faults: Sequence[Mapping]) -> List[str]:
    """Markdown lines of the recovered-fault provenance section."""
    if not faults:
        return []
    lines = [
        "",
        f"## fault recovery — {len(faults)} event(s)",
        "",
        "every recovery re-executed the affected shards; the merged "
        "heat maps are bit-identical to a fault-free run.",
        "",
        "| kernel | kind | where | shard | attempt | wall | detail |",
        "|---|---|---|---:|---:|---:|---|",
    ]
    for f in faults:
        shard = f.get("shard", -1)
        lines.append(
            f"| {f.get('kernel', '')} | {f.get('kind', '?')} "
            f"| {f.get('where', '')} | {'—' if shard < 0 else shard} "
            f"| {f.get('attempt', 0)} "
            f"| {float(f.get('wall_s', 0.0)) * 1e3:.0f} ms "
            f"| {f.get('detail', '')} |"
        )
    return lines


def run_text(run: Optional[Mapping]) -> str:
    """One-line summary of a profile's measured kernel launch ('' if none):
    the card's time of a call first, then the time with host issue."""
    if not run:
        return ""
    shared = (
        f" (shared with {run['shared_with']}: same kernel, same shapes)"
        if run.get("shared_with") else ""
    )
    if run.get("ms") is None:
        return (
            f"ran the plain version on {run.get('device')} "
            f"(no kernel launched, not timed){shared}"
        )
    device_ms = run.get("device_ms")
    on_card = (
        f"{float(device_ms):.4f} ms a call on the card" if device_ms is not None
        else "time on the card not measured"
    )
    return (
        f"launched {run.get('launches')}x on {run.get('device')}: {on_card} "
        f"({float(run['ms']):.4f} ms with host issue), max |err| vs plain "
        f"{float(run.get('max_abs_err', 0.0)):.2e}{shared}"
    )


def _hlo_line(hlo: Mapping) -> str:
    """The sweep summary of a model artifact's ``layers.hlo`` block: the
    port's op-level sweep (``"source": "torch-ops"``) or a JAX-package
    artifact's HLO sweep."""
    cost = hlo.get("cost") or {}
    heat = hlo.get("heat") or {}
    return (
        ("op sweep" if hlo.get("source") == "torch-ops" else "HLO sweep")
        + (" (forward+backward)" if hlo.get("backward") else " (forward)")
        + f": {cost.get('flops', 0):.3g} flops, "
        f"{cost.get('bytes', 0):.3g} bytes, "
        f"{cost.get('wire_bytes', 0):.3g} wire bytes, "
        f"{heat.get('collective_count', 0)} collectives"
        + (f", {len(heat['redundant'])} redundant" if heat.get("redundant") else "")
    )


def _layers_heading(layers: Mapping) -> str:
    return f"batch {layers.get('batch')}, seq {layers.get('seq')}" + (
        f", overrides: {', '.join(map(str, layers.get('overrides')))}"
        if layers.get("overrides") else ""
    )


def _step_action_label(step: Mapping) -> str:
    """Provenance label ('kind(region) <- pattern') of one step's spawner."""
    action = (step.get("candidate") or {}).get("action") or {}
    if not action:
        return "—"
    return (
        f"{_html.escape(str(action.get('kind', '?')))}"
        f"({_html.escape(str(action.get('region', '?')))}) "
        f"&larr; {_html.escape(str(action.get('pattern', '?')))}"
    )


def _tuning_section_html(trajectories: Sequence[Mapping]) -> str:
    """Tuning-trajectory section of the HTML bundle (one card per family).

    ``trajectories`` are JSON-shaped trajectory dicts — exactly what
    ``TuneResult.as_dict()`` produces, or what
    ``repro_torch.core.tuner.trajectories_from_session`` recovers from
    stored provenance.  Each card walks the steps: candidate, the advisor
    action that spawned it, transfers, verdict, accepted/rejected, and
    the rung's measured run where it launched a kernel.
    """
    if not trajectories:
        return ""
    parts = ["<h3>tuning trajectory</h3>"]
    for t in trajectories:
        base_tx = (t.get("baseline") or {}).get("transactions", 0)
        best = t.get("best") or {}
        run = t.get("run") or ""
        title = str(t.get("kernel")) + (f" — {run}" if run else "")
        parts.append(
            f"<div class='card'><h4>{_html.escape(title)}"
            f"</h4><p class='evidence'>baseline {base_tx} transfers "
            f"&rarr; best <b>{_html.escape(str(best.get('label', '?')))}"
            f"</b> {best.get('transactions', base_tx)} transfers "
            f"({float(t.get('speedup', 1.0)):.2f}x modeled), "
            f"{t.get('candidates_tried', len(t.get('steps', ())))} "
            "candidates tried</p>"
            "<table><tr><th>step</th><th>candidate</th>"
            "<th>spawned by</th><th>transfers</th><th>verdict</th>"
            "<th>fixed</th><th>kept</th><th>measured</th></tr>"
        )
        for s in t.get("steps", ()):
            cand = s.get("candidate") or {}
            verdict = str(s.get("verdict", ""))
            vclass = (
                f" class='verdict-{verdict}'"
                if verdict in ("improved", "regressed")
                else ""
            )
            fixed = (
                ", ".join(
                    f"{_html.escape(str(p))} on {_html.escape(str(r))}"
                    for r, p in s.get("fixed", ())
                )
                or "&mdash;"
            )
            parts.append(
                f"<tr><td>{s.get('step')}</td>"
                f"<td>{_html.escape(str(cand.get('label', '?')))}</td>"
                f"<td>{_step_action_label(s)}</td>"
                f"<td>{s.get('transactions')}</td>"
                f"<td{vclass}>{_html.escape(verdict)}</td>"
                f"<td>{fixed}</td>"
                f"<td>{'accepted' if s.get('accepted') else 'rejected'}</td>"
                f"<td>{_html.escape(run_text(s.get('run'))) or '&mdash;'}"
                "</td></tr>"
            )
        parts.append("</table></div>")
    return "".join(parts)


def _check_section_html(check: Mapping) -> str:
    """Check-verdict section of the HTML bundle.

    ``check`` is a check-report document — ``CheckReport.as_dict()``
    output, or the ``check.json`` that ``cuthermo check`` drops next to
    the candidate iteration.  Renders the gate outcome, the per-kernel
    rows, and any anomaly flags.
    """
    if not check:
        return ""
    passed = bool(check.get("passed"))
    vclass = "verdict-improved" if passed else "verdict-regressed"
    verdict = "passed" if passed else "FAILED"
    parts = [
        "<h3>regression check</h3>",
        f"<div class='card'><p>gate <b class='{vclass}'>{verdict}</b> "
        f"[{_html.escape(str(check.get('mode', '')))}] "
        f"candidate <b>{_html.escape(str(check.get('candidate', '')))}</b>"
        + (
            f" vs baseline "
            f"<b>{_html.escape(str(check.get('baseline')))}</b>"
            if check.get("baseline")
            else ""
        )
        + "</p>",
    ]
    kernels = check.get("kernels") or ()
    if kernels:
        parts.append(
            "<table><tr><th>kernel</th><th>status</th><th>transfers</th>"
            "<th>&Delta;</th><th>scratch</th><th>new patterns</th></tr>"
        )
        for kc in kernels:
            status = str(kc.get("status", ""))
            sclass = (
                " class='verdict-regressed'" if status == "fail"
                else (" class='verdict-improved'" if status == "pass" else "")
            )
            delta = kc.get("transactions_delta_pct")
            delta_s = "new (was 0)" if delta is None else f"{delta:+.1f}%"
            news = (
                ", ".join(
                    f"{_html.escape(str(p))} on {_html.escape(str(r))}"
                    for r, p in kc.get("new_patterns", ())
                )
                or "&mdash;"
            )
            parts.append(
                f"<tr><td>{_html.escape(str(kc.get('kernel')))}</td>"
                f"<td{sclass}>{_html.escape(status)}</td>"
                f"<td>{kc.get('transactions_before')} &rarr; "
                f"{kc.get('transactions_after')}</td>"
                f"<td>{delta_s}</td>"
                f"<td>{kc.get('scratch_before')} &rarr; "
                f"{kc.get('scratch_after')}</td><td>{news}</td></tr>"
            )
        parts.append("</table>")
    flags = (check.get("anomalies") or {}).get("flags") or ()
    for a in flags:
        parts.append(
            f"<p class='evidence verdict-regressed'>anomaly: "
            f"{_html.escape(str(a.get('kernel')))} "
            f"{_html.escape(str(a.get('metric')))} {a.get('value')} "
            f"outside [{a.get('lo')}, {a.get('hi')}] "
            f"(median {a.get('median')} over {a.get('n_history')} "
            "iterations)</p>"
        )
    for f in check.get("failures") or ():
        parts.append(f"<p class='evidence'>!! {_html.escape(str(f))}</p>")
    parts.append("</div>")
    return "".join(parts)


def _check_section_markdown(check: Mapping) -> List[str]:
    """Markdown lines of the check-verdict section."""
    if not check:
        return []
    verdict = "passed" if check.get("passed") else "FAILED"
    lines = [
        "",
        f"## regression check — {verdict}",
        "",
        f"candidate `{check.get('candidate', '')}`"
        + (
            f" vs baseline `{check.get('baseline')}`"
            if check.get("baseline")
            else ""
        )
        + f" [{check.get('mode', '')}]",
        "",
    ]
    kernels = check.get("kernels") or ()
    if kernels:
        lines += [
            "| kernel | status | transfers | Δ | scratch |",
            "|---|---|---:|---:|---:|",
        ]
        for kc in kernels:
            delta = kc.get("transactions_delta_pct")
            delta_s = "new (was 0)" if delta is None else f"{delta:+.1f}%"
            lines.append(
                f"| {kc.get('kernel')} | {kc.get('status')} "
                f"| {kc.get('transactions_before')} → "
                f"{kc.get('transactions_after')} | {delta_s} "
                f"| {kc.get('scratch_before')} → "
                f"{kc.get('scratch_after')} |"
            )
    for f in check.get("failures") or ():
        lines.append(f"- !! {f}")
    return lines


def _lint_section_html(lint: Sequence[Mapping]) -> str:
    """Predicted-vs-observed cross-tab of the HTML bundle.

    ``lint`` is a sequence of per-kernel dicts carrying the static lint
    verdict plus ``predicted_vs_observed`` rows (see
    ``repro.core.lint.predicted_vs_observed``): each row lines one
    ``(region, pattern)`` class up across the two pipelines — ``agree``
    (both saw it), ``static-only`` (the linter predicted something the
    trace could not confirm), ``dynamic-only`` (the trace found
    something the affine model cannot see, e.g. data-dependent maps).
    """
    if not lint:
        return ""
    parts = [
        "<h3>static lint: predicted vs observed</h3>",
        "<p class='evidence'>the linter's no-trace predictions "
        "(affine index-map model) lined up against the traced "
        "detections; dynamic-only rows are what static analysis "
        "fundamentally cannot see.</p>",
    ]
    for entry in lint:
        rows = entry.get("rows") or ()
        tx = entry.get("static_transactions")
        tx_s = "dynamic (no static total)" if tx is None else f"{tx} transfers"
        parts.append(
            f"<div class='card'><h4>{_html.escape(str(entry.get('kernel')))}"
            f" &middot; lint {_html.escape(str(entry.get('verdict', '')))}"
            f" &middot; {_html.escape(tx_s)}</h4>"
        )
        if rows:
            parts.append(
                "<table><tr><th>pattern</th><th>region</th><th>status</th>"
                "<th>predicted sev</th><th>observed sev</th><th>rule</th>"
                "</tr>"
            )
            for r in rows:
                status = str(r.get("status", ""))
                sclass = (
                    " class='verdict-improved'" if status == "agree"
                    else (
                        " class='verdict-regressed'"
                        if status == "dynamic-only" else ""
                    )
                )
                ps, os_ = r.get("predicted_severity"), r.get("observed_severity")
                parts.append(
                    f"<tr><td>{_html.escape(str(r.get('pattern')))}</td>"
                    f"<td>{_html.escape(str(r.get('region')))}</td>"
                    f"<td{sclass}>{_html.escape(status)}</td>"
                    f"<td>{'&mdash;' if ps is None else f'{ps:.2f}'}</td>"
                    f"<td>{'&mdash;' if os_ is None else f'{os_:.2f}'}</td>"
                    f"<td>{_html.escape(str(r.get('rule') or '—'))}</td></tr>"
                )
            parts.append("</table>")
        else:
            parts.append(
                "<p class='evidence'>clean both ways: nothing predicted, "
                "nothing observed</p>"
            )
        parts.append("</div>")
    return "".join(parts)


def _lint_section_markdown(lint: Sequence[Mapping]) -> List[str]:
    """Markdown lines of the predicted-vs-observed cross-tab."""
    if not lint:
        return []
    lines = ["", "## static lint: predicted vs observed", ""]
    for entry in lint:
        tx = entry.get("static_transactions")
        tx_s = "dynamic" if tx is None else f"{tx} transfers"
        lines += [
            f"### {entry.get('kernel')} — lint {entry.get('verdict', '')}, "
            f"{tx_s}",
            "",
        ]
        rows = entry.get("rows") or ()
        if not rows:
            lines += ["clean both ways: nothing predicted, nothing observed",
                      ""]
            continue
        lines += [
            "| pattern | region | status | predicted sev | observed sev |",
            "|---|---|---|---:|---:|",
        ]
        for r in rows:
            ps, os_ = r.get("predicted_severity"), r.get("observed_severity")
            lines.append(
                f"| {r.get('pattern')} | {r.get('region')} "
                f"| {r.get('status')} "
                f"| {'—' if ps is None else f'{ps:.2f}'} "
                f"| {'—' if os_ is None else f'{os_:.2f}'} |"
            )
        lines.append("")
    return lines



def _layers_section_html(layers: Mapping) -> str:
    """Per-layer attribution section of the HTML bundle.

    ``layers`` is the iteration manifest's ``layers`` mapping written by
    whole-model profiling: the per-layer rollup table (an exact partition
    of the iteration's kernels, validated on write), and the sweep
    summary when the run made one (the port's op sweep, or a JAX-package
    artifact's HLO sweep).
    """
    if not layers:
        return ""
    parts = [
        "<h3>per-layer attribution</h3>",
        f"<div class='card'><p>model <b>{_html.escape(str(layers.get('model', '')))}</b> "
        f"({_html.escape(_layers_heading(layers))})</p>",
        "<table><tr><th>layer</th><th>kinds</th><th>kernels</th>"
        "<th>sector transfers</th><th>patterns</th></tr>",
    ]
    table = layers.get("table") or ()
    total = sum(int(row.get("transactions", 0)) for row in table)
    for row in table:
        pats = (
            ", ".join(
                f"{_html.escape(str(p))} on {_html.escape(str(r))}"
                for _k, r, p in row.get("patterns", ())
            )
            or "&mdash;"
        )
        parts.append(
            f"<tr><td>{_html.escape(str(row.get('path')))}</td>"
            f"<td>{_html.escape(', '.join(row.get('kinds', ())))}</td>"
            f"<td>{_html.escape(', '.join(row.get('kernels', ())))}</td>"
            f"<td>{row.get('transactions')}</td><td>{pats}</td></tr>"
        )
    parts.append(
        f"<tr><td><b>total</b></td><td></td><td></td>"
        f"<td><b>{total}</b></td><td></td></tr></table>"
    )
    if layers.get("hlo"):
        parts.append(f"<p class='evidence'>{_html.escape(_hlo_line(layers['hlo']))}</p>")
    parts.append("</div>")
    return "".join(parts)


def _layers_section_markdown(layers: Mapping) -> List[str]:
    """Markdown lines of the per-layer attribution section."""
    if not layers:
        return []
    lines = [
        "",
        f"## per-layer attribution — {layers.get('model', '')}",
        "",
        _layers_heading(layers),
        "",
        "| layer | kinds | kernels | sector transfers | patterns |",
        "|---|---|---|---:|---|",
    ]
    table = layers.get("table") or ()
    total = sum(int(row.get("transactions", 0)) for row in table)
    for row in table:
        pats = (
            ", ".join(f"{p} on {r}" for _k, r, p in row.get("patterns", ()))
            or "-"
        )
        lines.append(
            f"| {row.get('path')} | {', '.join(row.get('kinds', ()))} "
            f"| {', '.join(row.get('kernels', ()))} "
            f"| {row.get('transactions')} | {pats} |"
        )
    lines.append(f"| **total** | | | {total} | |")
    if layers.get("hlo"):
        lines += ["", _hlo_line(layers["hlo"])]
    return lines


def render_session_html(
    entries: Sequence[ReportEntry],
    title: str = "cuthermo report",
    max_runs_per_region: int = 64,
    faults: Optional[Sequence[Mapping]] = None,
    layers: Optional[Mapping] = None,
    tuning: Optional[Sequence[Mapping]] = None,
    check: Optional[Mapping] = None,
    lint: Optional[Sequence[Mapping]] = None,
) -> str:
    """Self-contained HTML gallery for one profiled iteration.

    Contains, for every entry: the per-region heat-map tables (compressed
    to at most ``max_runs_per_region`` runs), the detected patterns with
    their evidence lines, the advisor's actions, the measured kernel
    launch where the profile made one, and at the top a summary table
    plus the device-memory traffic chart.  ``tuning``, ``check`` and
    ``lint`` add their sections (see :func:`write_report_bundle`).
    ``faults`` (an artifact-v6
    recovered-fault block) adds the fault-recovery table, and ``layers``
    (a whole-model profile's per-layer attribution) the per-layer table.  The output
    embeds no external resources — one file opens anywhere.
    """
    parts: List[str] = [
        "<!doctype html><meta charset='utf-8'>",
        f"<title>{_html.escape(title)}</title>",
        _HTML_STYLE,
        f"<h2>{_html.escape(title)}</h2>",
    ]
    parts.append(
        "<table><tr><th>kernel</th><th>variant</th><th>grid</th>"
        "<th>sampler</th><th>sector transfers</th><th>waste</th>"
        "<th>patterns</th><th>measured</th></tr>"
    )
    for i, e in enumerate(entries):
        hm = e.heatmap
        pats = ", ".join(sorted({r.pattern for r in e.reports})) or "&mdash;"
        parts.append(
            f"<tr><td><a href='#k{i}'>{_html.escape(e.title)}</a></td>"
            f"<td>{_html.escape(e.variant or hm.kernel)}</td>"
            f"<td>{hm.grid}</td><td>{_html.escape(hm.sampler)}</td>"
            f"<td>{hm.sector_transactions()}</td>"
            f"<td>{hm.waste_ratio():.2f}x</td><td>{pats}</td>"
            f"<td>{_html.escape(run_text(e.run)) or '&mdash;'}</td></tr>"
        )
    parts.append("</table>")
    chart = _traffic_chart_svg(entries)
    if chart:
        parts.append(
            "<h3>device-memory traffic placement</h3>"
            "<p class='evidence'>filled = demand floor (bytes software "
            "asked for); hollow = sector-granularity waste. A fully filled "
            "bar sits on the achievable memory-roofline floor.</p>"
        )
        parts.append(chart)
    if layers:
        parts.append(_layers_section_html(layers))
    if faults:
        parts.append(_faults_section_html(faults))
    if check:
        parts.append(_check_section_html(check))
    if lint:
        parts.append(_lint_section_html(lint))
    if tuning:
        parts.append(_tuning_section_html(tuning))
    for i, e in enumerate(entries):
        hm = e.heatmap
        parts.append(
            f"<div class='card' id='k{i}'>"
            f"<h3>{_html.escape(e.title)}</h3>"
            f"<p class='evidence'>kernel {_html.escape(hm.kernel)} "
            f"grid={hm.grid} sampler={_html.escape(hm.sampler)} "
            f"records={hm.n_records}"
            + (f" dropped={hm.dropped}" if hm.dropped else "")
            + (f" &middot; profiled in {e.wall_s * 1e3:.0f} ms"
               if e.wall_s else "")
            + "</p>"
        )
        if e.run:
            parts.append(
                f"<p class='evidence'>{_html.escape(run_text(e.run))}</p>"
            )
        if e.merge_stats:
            parts.append(
                f"<p class='evidence'>{_html.escape(e.merge_stats)}</p>"
            )
        if e.reports:
            parts.append("<h4>detected patterns</h4><ul>")
            for rep in e.reports:
                parts.append(
                    f"<li><b>{_html.escape(rep.pattern)}</b> on "
                    f"{_html.escape(rep.region)} "
                    f"(severity {rep.severity:.2f})"
                )
                for ev in rep.evidence:
                    parts.append(
                        f"<div class='evidence'>{_html.escape(ev)}</div>"
                    )
                parts.append("</li>")
            parts.append("</ul>")
        else:
            parts.append("<p>no inefficiency patterns detected</p>")
        if e.actions:
            parts.append("<h4>suggested actions</h4><ol>")
            for a in e.actions:
                parts.append(
                    f"<li><b>{_html.escape(a.kind)}</b>"
                    f"({_html.escape(a.region)}): save "
                    f"~{100 * a.est_transaction_saving:.0f}% of transfers "
                    f"&mdash; {_html.escape(a.description)}</li>"
                )
            parts.append("</ol>")
        for rh in hm.regions:
            parts.append(_region_table_html(rh, max_runs=max_runs_per_region))
        parts.append("</div>")
    return "".join(parts)


def _tuning_section_markdown(trajectories: Sequence[Mapping]) -> List[str]:
    """Markdown lines of the tuning-trajectory section (one table/family)."""
    lines: List[str] = []
    for t in trajectories:
        base_tx = (t.get("baseline") or {}).get("transactions", 0)
        best = t.get("best") or {}
        lines += [
            "",
            f"## tuning trajectory — {t.get('kernel')}",
            "",
            f"baseline {base_tx} transfers → best "
            f"`{best.get('label', '?')}` {best.get('transactions', base_tx)} "
            f"transfers ({float(t.get('speedup', 1.0)):.2f}x modeled)",
            "",
            "| step | candidate | spawned by | transfers | verdict | kept | measured |",
            "|---:|---|---|---:|---|---|---|",
        ]
        for s in t.get("steps", ()):
            cand = s.get("candidate") or {}
            action = cand.get("action") or {}
            spawner = (
                f"{action.get('kind', '?')}({action.get('region', '?')}) "
                f"← {action.get('pattern', '?')}"
                if action
                else "—"
            )
            lines.append(
                f"| {s.get('step')} | `{cand.get('label', '?')}` "
                f"| {spawner} | {s.get('transactions')} "
                f"| {s.get('verdict', '')} "
                f"| {'accepted' if s.get('accepted') else 'rejected'} "
                f"| {run_text(s.get('run')) or '—'} |"
            )
    return lines



def render_session_markdown(
    entries: Sequence[ReportEntry],
    title: str = "cuthermo report",
    faults: Optional[Sequence[Mapping]] = None,
    layers: Optional[Mapping] = None,
    tuning: Optional[Sequence[Mapping]] = None,
    check: Optional[Mapping] = None,
    lint: Optional[Sequence[Mapping]] = None,
) -> str:
    """Markdown digest of one iteration (the commit-message artifact)."""
    lines = [f"# {title}", ""]
    lines.append(
        "| kernel | variant | grid | sector transfers | waste | patterns |"
    )
    lines.append("|---|---|---|---:|---:|---|")
    for e in entries:
        hm = e.heatmap
        pats = ", ".join(sorted({r.pattern for r in e.reports})) or "-"
        lines.append(
            f"| {e.title} | {e.variant or hm.kernel} | {hm.grid} "
            f"| {hm.sector_transactions()} | {hm.waste_ratio():.2f}x "
            f"| {pats} |"
        )
    for e in entries:
        hm = e.heatmap
        moved, demanded = _traffic_bytes(hm)
        stats = hm.summary_stats()
        lines += [
            "",
            f"## {e.title}",
            "",
            f"- kernel `{hm.kernel}`, grid `{hm.grid}`, "
            f"sampler `{hm.sampler}`, {hm.n_records} records",
            f"- device-memory traffic: {_fmt_bytes(moved)} moved for "
            f"{_fmt_bytes(demanded)} demanded "
            f"({hm.waste_ratio():.2f}x waste)",
        ]
        if e.run:
            lines.append(f"- {run_text(e.run)}")
        if e.merge_stats:
            lines.append(f"- {e.merge_stats}")
        for rname, r in stats["regions"].items():
            lines.append(
                f"- region `{rname}` [{r['space']}]: "
                f"{r['touched_sectors']} sectors touched by "
                f"{r['n_programs']} programs, max temp "
                f"{r['max_sector_temp']}"
            )
        for rep in e.reports:
            lines.append(
                f"- **{rep.pattern}** on `{rep.region}` "
                f"(severity {rep.severity:.2f}): {rep.evidence[0]}"
            )
        for a in e.actions:
            lines.append(
                f"- action `{a.kind}({a.region})`: "
                f"save ~{100 * a.est_transaction_saving:.0f}% — "
                f"{a.description}"
            )
    if layers:
        lines += _layers_section_markdown(layers)
    if faults:
        lines += _faults_section_markdown(faults)
    if check:
        lines += _check_section_markdown(check)
    if lint:
        lines += _lint_section_markdown(lint)
    if tuning:
        lines += _tuning_section_markdown(tuning)
    lines.append("")
    return "\n".join(lines)


def write_report_bundle(
    entries: Sequence[ReportEntry],
    out_dir: str,
    title: str = "cuthermo report",
    faults: Optional[Sequence[Mapping]] = None,
    layers: Optional[Mapping] = None,
    tuning: Optional[Sequence[Mapping]] = None,
    check: Optional[Mapping] = None,
    lint: Optional[Sequence[Mapping]] = None,
) -> Dict[str, str]:
    """Write a whole-iteration report bundle into ``out_dir``.

    Produces ``index.html`` (self-contained gallery), ``report.md``
    (markdown digest) and one ``<kernel>.csv`` per entry (the exact
    Fig. 5 CSV artifact).  ``faults`` (an artifact-v6 recovered-fault
    block, one dict per ``FaultEvent``) adds the fault-recovery table,
    ``layers`` (a whole-model profile's per-layer attribution) the
    per-layer table, ``tuning`` (trajectory dicts from
    ``TuneResult.as_dict()`` or ``tuner.trajectories_from_session``) the
    tuning-trajectory section, ``check`` (a ``cuthermo check`` report
    document) the regression gate's verdict, and ``lint`` (per-kernel
    predicted-vs-observed dicts) the static-lint cross-tab.
    Returns a name->path mapping of everything written.
    """
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}
    index = os.path.join(out_dir, "index.html")
    with open(index, "w") as f:
        f.write(
            render_session_html(
                entries, title=title, faults=faults, layers=layers,
                tuning=tuning, check=check, lint=lint,
            )
        )
    written["index.html"] = index
    md = os.path.join(out_dir, "report.md")
    with open(md, "w") as f:
        f.write(
            render_session_markdown(
                entries, title=title, faults=faults, layers=layers,
                tuning=tuning, check=check, lint=lint,
            )
        )
    written["report.md"] = md
    seen: Dict[str, int] = {}
    for e in entries:
        stem = dedupe_stem(slugify(e.title), seen)
        csv_path = os.path.join(out_dir, f"{stem}.csv")
        with open(csv_path, "w") as f:
            f.write(render_csv(e.heatmap))
        written[f"{stem}.csv"] = csv_path
    return written


__all__ = [
    "ReportEntry",
    "dedupe_stem",
    "render_ascii",
    "render_csv",
    "render_html",
    "render_session_html",
    "render_session_markdown",
    "run_text",
    "save",
    "slugify",
    "write_report_bundle",
]
