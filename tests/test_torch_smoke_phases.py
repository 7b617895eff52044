"""``chip_smoke.py``'s phase times, read from its source with ``ast``.

The script runs only on a card, so nothing of it is imported here: every
phase that ``main`` runs must report its time into the summary line
(``phase times: {...}``), that line must come just before the result
line, and the result line must stay the script's last.  The pair runner
``tools/chip_smoke_pair.py`` (stdlib only) reads the phase lines the
script prints.
"""

from __future__ import annotations

import ast
import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "chip_smoke.py"
SOURCE = SCRIPT.read_text()
TREE = ast.parse(SOURCE)
MAIN = next(n for n in TREE.body if isinstance(n, ast.FunctionDef) and n.name == "main")
MAIN_SRC = ast.get_source_segment(SOURCE, MAIN)
# the section markers in main, "# -- phase N: what it does ---"
MARKERS = re.findall(r"^\s*# -- phase (\d+): (.*?) -*$", MAIN_SRC, re.MULTILINE)
RECORD = [n for n, what in MARKERS if what.startswith("the record")]
RUN = [n for n, _ in MARKERS if n not in RECORD]
# the phases the module docstring lists ("N. ..." at the line's start)
DOC_PHASES = re.findall(r"^(\d+)\. ", ast.get_docstring(TREE), re.MULTILINE)


def calls(node, name):
    """Every call of the plain name ``name`` under ``node``."""
    return [c for c in ast.walk(node) if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Name) and c.func.id == name]


def reported():
    """The phase names ``main`` passes to ``phase_took``, in order."""
    out = []
    for c in sorted(calls(MAIN, "phase_took"), key=lambda c: c.lineno):
        assert isinstance(c.args[0], ast.Constant), ast.dump(c)
        out.append(c.args[0].value)
    return out


def test_main_marks_the_phases_the_docstring_lists():
    assert RECORD == ["9"]
    assert sorted(n for n, _ in MARKERS) == sorted(DOC_PHASES)


@pytest.mark.parametrize("phase", RUN)
def test_each_phase_main_runs_reports_its_time(phase):
    """Between its marker and the next, the phase ends with one
    ``phase_took`` call under its own number."""
    lines = MAIN_SRC.splitlines()
    start = next(i for i, l in enumerate(lines) if re.match(rf"\s*# -- phase {phase}:", l))
    end = next((i for i, l in enumerate(lines[start + 1:], start + 1)
                if re.match(r"\s*# -- phase \d+:", l)), len(lines))
    body = "\n".join(lines[start:end])
    assert re.findall(r'phase_took\("(\d+)"', body) == [phase]


def test_every_phase_reports_once_and_in_order():
    assert reported() == RUN


def test_phase_took_keeps_the_time_for_the_summary():
    fn = next(n for n in TREE.body if isinstance(n, ast.FunctionDef) and n.name == "phase_took")
    stores = [t for n in ast.walk(fn) if isinstance(n, ast.Assign) for t in n.targets
              if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
              and t.value.id == "PHASE_TIMES"]
    assert stores, "phase_took does not keep the phase's time in PHASE_TIMES"
    (fstr,) = [c.args[0] for c in calls(fn, "print")]
    text = ast.unparse(fstr)
    assert text.startswith("f'phase {phase} took {"), text


def _tail():
    """main's top-level statements after the last phase's report."""
    last = max(c.lineno for c in calls(MAIN, "phase_took"))
    return [s for s in MAIN.body if s.lineno > last]


def test_phase_times_line_comes_just_before_the_result_line():
    tail = _tail()
    prints = [s for s in tail if isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)
              and isinstance(s.value.func, ast.Name) and s.value.func.id == "print"]
    summary, result = prints[-2:]
    assert ast.unparse(summary.value.args[0]).startswith("f'phase times: {json.dumps(PHASE_TIMES)}")
    text = ast.unparse(result.value.args[0])
    assert text.startswith("json.dumps({'ok': True, 'device': {'platform': 'gpu'"), text
    # nothing is printed after the result line: main returns
    after = tail[tail.index(result) + 1:]
    assert len(after) == 1 and isinstance(after[0], ast.Return)
    assert ast.unparse(after[0]) == "return 0"
    # the total goes into the summary before it is printed
    total = [s for s in tail if isinstance(s, ast.Assign)
             and ast.unparse(s.targets[0]) == "PHASE_TIMES['total']"]
    assert total and total[0].lineno < summary.lineno


def _pair_tool():
    spec = importlib.util.spec_from_file_location("chip_smoke_pair",
                                                  ROOT / "tools" / "chip_smoke_pair.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("line, want", [
    ("phase 4 took 108.1 s\n", ("4", "108.1")),
    ("phase 12 took 16.1 s on NVIDIA H100 80GB HBM3, 700.00 W\n", ("12", "16.1")),
    ("phase 11 took 74.2 s; wall by example {} on NVIDIA H100\n", ("11", "74.2")),
    ("  phase 3 took 1.0 s\n", None),
])
def test_pair_tool_reads_the_phase_lines(line, want):
    m = _pair_tool().PHASE.match(line)
    assert (m.groups() if m else None) == want


def test_pair_tool_tables_the_runs():
    runs = [dict(label="0_parent", phases={"1": 44.3, "10": 104.6}, script_s=841.1, rc=0),
            dict(label="1_repo", phases={"1": 46.7}, script_s=None, rc=1)]
    assert _pair_tool().table(runs).splitlines() == [
        "| phase | 0_parent | 1_repo |",
        "| --- | --- | --- |",
        "| 1 | 44.3 | 46.7 |",
        "| 10 | 104.6 | - |",
        "| total | 841.1 | rc 1 |",
    ]
