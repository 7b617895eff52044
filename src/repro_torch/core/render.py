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
    """One-line summary of a profile's measured kernel launch ('' if none)."""
    if not run:
        return ""
    if run.get("ms") is None:
        return (
            f"ran the plain version on {run.get('device')} "
            "(no kernel launched, not timed)"
        )
    return (
        f"launched {run.get('launches')}x on {run.get('device')}: "
        f"median {float(run['ms']):.3f} ms, max |err| vs plain "
        f"{float(run.get('max_abs_err', 0.0)):.2e}"
    )


def render_session_html(
    entries: Sequence[ReportEntry],
    title: str = "cuthermo report",
    max_runs_per_region: int = 64,
    faults: Optional[Sequence[Mapping]] = None,
) -> str:
    """Self-contained HTML gallery for one profiled iteration.

    Contains, for every entry: the per-region heat-map tables (compressed
    to at most ``max_runs_per_region`` runs), the detected patterns with
    their evidence lines, the advisor's actions, the measured kernel
    launch where the profile made one, and at the top a summary table
    plus the device-memory traffic chart.  ``faults`` (an artifact-v6
    recovered-fault block) adds the fault-recovery table.  The output
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
    if faults:
        parts.append(_faults_section_html(faults))
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


def render_session_markdown(
    entries: Sequence[ReportEntry],
    title: str = "cuthermo report",
    faults: Optional[Sequence[Mapping]] = None,
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
    if faults:
        lines += _faults_section_markdown(faults)
    lines.append("")
    return "\n".join(lines)


def write_report_bundle(
    entries: Sequence[ReportEntry],
    out_dir: str,
    title: str = "cuthermo report",
    faults: Optional[Sequence[Mapping]] = None,
) -> Dict[str, str]:
    """Write a whole-iteration report bundle into ``out_dir``.

    Produces ``index.html`` (self-contained gallery), ``report.md``
    (markdown digest) and one ``<kernel>.csv`` per entry (the exact
    Fig. 5 CSV artifact).  ``faults`` (an artifact-v6 recovered-fault
    block, one dict per ``FaultEvent``) adds the fault-recovery table.
    Returns a name->path mapping of everything written.
    """
    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, str] = {}
    index = os.path.join(out_dir, "index.html")
    with open(index, "w") as f:
        f.write(render_session_html(entries, title=title, faults=faults))
    written["index.html"] = index
    md = os.path.join(out_dir, "report.md")
    with open(md, "w") as f:
        f.write(render_session_markdown(entries, title=title, faults=faults))
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
