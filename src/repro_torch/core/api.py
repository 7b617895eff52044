"""Public profiling API: the paper's workflow as three calls.

    spec = gemm_v00_spec(1024, 1024, 1024)         # from kernels/*
    hm   = thermo.heatmap(spec)                    # collect + analyze
    print(thermo.report(spec))                     # patterns + advice

plus :class:`ProfileSession` (re-exported from
:mod:`repro_torch.core.session`) for the persistent multi-kernel loop
behind the ``cuthermo`` CLI.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .advisor import Action, advise, format_report
from .collector import KernelSpec, analyze, collect
from .heatmap import Heatmap
from .patterns import PatternReport, detect_all, patterns_by_region
from .render import render_ascii, render_csv, render_html, save
from .session import Iteration, ProfileSession, SessionDiff, SessionError
from .trace import GridSampler


def heatmap(
    spec: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
) -> Heatmap:
    """Profile one kernel spec and return its word/sector heat map.

    Runs the Level-1 walk (plus any Level-2 dynamic access models in the
    spec, fed from ``dynamic_context`` arrays) over the sampled grid and
    flushes the analyzer — collect + ingest + flush in one call.
    """
    return analyze(spec, sampler=sampler, dynamic_context=dynamic_context)


def patterns(
    spec: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
) -> List[PatternReport]:
    """Profile ``spec`` and return its detected inefficiency patterns."""
    return detect_all(heatmap(spec, sampler, dynamic_context))


def actions(
    spec: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
) -> List[Action]:
    """Profile ``spec`` and return the advisor's suggested optimizations."""
    return advise(heatmap(spec, sampler, dynamic_context))


def report(
    spec: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    """Profile ``spec`` and return the human-readable tuning report."""
    return format_report(heatmap(spec, sampler, dynamic_context))


__all__ = [
    "Action",
    "GridSampler",
    "Heatmap",
    "Iteration",
    "KernelSpec",
    "PatternReport",
    "ProfileSession",
    "SessionDiff",
    "SessionError",
    "actions",
    "advise",
    "analyze",
    "collect",
    "detect_all",
    "format_report",
    "heatmap",
    "patterns",
    "patterns_by_region",
    "render_ascii",
    "render_csv",
    "render_html",
    "report",
    "save",
]
