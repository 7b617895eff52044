"""Persistent profiling sessions: the paper's tuning loop as an artifact.

``ProfileSession`` owns a session directory and appends numbered
*iterations* (``iter0``, ``iter1``, ...).  One iteration profiles any
number of kernels and persists, per kernel, the columnar heat map plus
the derived pattern reports and advisor actions, and — when the profile
launched the kernel on a device — the measured launch (``run``).
``diff_iterations`` aligns two iterations kernel by kernel and attaches
improved / regressed / unchanged / added / removed verdicts.

Layout on disk (the JAX package's format, see ``docs/file-format.md``)::

    sess/
      session.json          # {"format": "cuthermo-session", "version": 6,
                            #  "iterations": ["iter0", "iter1"]}
      iter0/
        manifest.json       # version stamp + per-kernel metadata
        gemm.npz            # r{i}_tags / r{i}_word_temps / r{i}_sector_temps
      iter1/ ...

Versions.  The port reads v1–v7 and writes two:

* v6 — an iteration whose regions are all ``TPUTile`` is written exactly
  as the JAX package writes it, so the JAX package loads it back
  bit-identically;
* v7 — each region's metadata names its geometry (``"geometry":
  "h100-sector"`` or ``"tpu-tile"``), and an iteration with any
  non-TPU region is stamped 7.  The JAX package rejects v7 loudly, so it
  can never rebuild H100 sectors as TPU tiles and misread the arrays.

Every file is committed atomically (temp + fsync + rename, manifest
last), so a reader never sees a half-written manifest.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .advisor import Action, advise
from .collector import KernelSpec, analyze
from .diff import HeatmapDiff, diff as diff_heatmaps
from .heatmap import Heatmap, RegionHeatmap
from .patterns import PatternReport, detect_all
from .render import dedupe_stem, slugify
from .resilience import FaultEvent
from .tiles import TPUTile, make_geometry
from .trace import GridSampler, RegionInfo, ShardInfo

#: The version an iteration with any non-TPU-tile region is stamped with.
ARTIFACT_VERSION = 7

#: The JAX package's current version: what an all-TPUTile iteration (and
#: the session manifest, whose layout has not changed) is stamped with.
TPU_ARTIFACT_VERSION = 6

#: v1 lacks shard provenance, v2 tuning provenance, v3 the scratch_words
#: manifest metric, v4 per-layer attribution, v5 fault provenance, v6
#: region geometry; all load with the missing fields empty (v1–v6 regions
#: are TPU tiles).
SUPPORTED_VERSIONS = (1, 2, 3, 4, 5, 6, 7)

SESSION_FORMAT = "cuthermo-session"
ITERATION_FORMAT = "cuthermo-iteration"


class SessionError(RuntimeError):
    """Raised for malformed, missing, or version-incompatible artifacts."""


# ---------------------------------------------------------------------------
# heat-map (de)serialization
# ---------------------------------------------------------------------------


def heatmap_to_arrays(hm: Heatmap) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Split a Heatmap into (JSON-ready metadata, named int64 arrays).

    ``arrays_to_heatmap`` inverts this losslessly, geometry included.
    """
    meta = {
        "kernel": hm.kernel,
        "grid": list(hm.grid),
        "sampler": hm.sampler,
        "n_records": hm.n_records,
        "dropped": hm.dropped,
        "shards": [s.as_dict() for s in hm.shards],
        "faults": [e.as_dict() for e in hm.faults],
        "regions": [],
    }
    arrays: Dict[str, np.ndarray] = {}
    for i, rh in enumerate(hm.regions):
        geom = rh.region.geometry
        meta["regions"].append(
            {
                "name": rh.region.name,
                "space": rh.region.space,
                "shape": list(geom.shape),
                "itemsize": geom.itemsize,
                "n_programs": rh.n_programs,
                "geometry": geom.kind,
            }
        )
        arrays[f"r{i}_tags"] = rh.tags_array
        arrays[f"r{i}_word_temps"] = rh.word_temps_matrix
        arrays[f"r{i}_sector_temps"] = rh.sector_temps_array
    return meta, arrays


def arrays_to_heatmap(meta: Mapping, arrays: Mapping[str, np.ndarray]) -> Heatmap:
    """Rebuild a Heatmap from ``heatmap_to_arrays`` output (exact inverse).

    Regions without a ``geometry`` stamp (every v1–v6 artifact) are TPU
    tiles.
    """
    regions: List[RegionHeatmap] = []
    for i, rmeta in enumerate(meta["regions"]):
        geom = make_geometry(
            rmeta.get("geometry", TPUTile.kind),
            rmeta["shape"],
            rmeta["itemsize"],
            rmeta["name"],
        )
        info = RegionInfo(rmeta["name"], geom, space=rmeta["space"])
        regions.append(
            RegionHeatmap(
                region=info,
                n_programs=int(rmeta["n_programs"]),
                tags=np.asarray(arrays[f"r{i}_tags"], dtype=np.int64),
                word_temps=np.asarray(
                    arrays[f"r{i}_word_temps"], dtype=np.int64
                ),
                sector_temps=np.asarray(
                    arrays[f"r{i}_sector_temps"], dtype=np.int64
                ),
            )
        )
    return Heatmap(
        kernel=meta["kernel"],
        grid=tuple(int(g) for g in meta["grid"]),
        sampler=meta["sampler"],
        regions=tuple(regions),
        n_records=int(meta["n_records"]),
        dropped=int(meta["dropped"]),
        shards=tuple(ShardInfo.from_dict(d) for d in meta.get("shards", [])),
        faults=tuple(FaultEvent.from_dict(d) for d in meta.get("faults", [])),
    )


def heatmaps_equal(a: Heatmap, b: Heatmap) -> bool:
    """True when two heat maps carry bit-identical temperature state."""
    if (
        a.kernel != b.kernel
        or a.grid != b.grid
        or a.sampler != b.sampler
        or a.n_records != b.n_records
        or a.dropped != b.dropped
        or a.region_names() != b.region_names()
    ):
        return False
    for ra, rb in zip(a.regions, b.regions):
        if (
            ra.region != rb.region
            or ra.n_programs != rb.n_programs
            or not np.array_equal(ra.tags_array, rb.tags_array)
            or not np.array_equal(ra.word_temps_matrix, rb.word_temps_matrix)
            or not np.array_equal(
                ra.sector_temps_array, rb.sector_temps_array
            )
        ):
            return False
    return True


# ---------------------------------------------------------------------------
# iteration records
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProfiledKernel:
    """One kernel's results inside an iteration (heat map + derived views)."""

    name: str  # registry/display name (manifest key, unique per iteration)
    variant: str
    heatmap: Heatmap
    reports: Tuple[PatternReport, ...]
    actions: Tuple[Action, ...]
    wall_s: float = 0.0
    # known region renames an optimization of this kernel performs
    # (e.g. q -> qT); persisted so later diffs align automatically
    region_map: Tuple[Tuple[str, str], ...] = ()
    # the profile's measured launch of the kernel itself, when it made
    # one: {"device": name, "launches": n, "ms": median ms per launch}
    run: Optional[Mapping] = None

    @property
    def shards(self) -> Tuple[ShardInfo, ...]:
        """Per-shard collection provenance (empty for serial profiles)."""
        return self.heatmap.shards

    @property
    def transactions(self) -> int:
        """Modeled device-memory sector transfers of this kernel."""
        return self.heatmap.sector_transactions()

    @property
    def waste_ratio(self) -> float:
        """Moved/demanded words of this kernel's heat map (1.0 = perfect)."""
        return self.heatmap.waste_ratio()

    @property
    def scratch_words(self) -> int:
        """Word touches on this kernel's scratch regions."""
        return self.heatmap.scratch_words()


def profile_kernel(
    spec: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Mapping[str, np.ndarray]] = None,
    *,
    name: Optional[str] = None,
    variant: Optional[str] = None,
    region_map: Sequence[Tuple[str, str]] = (),
    run: Optional[Mapping] = None,
) -> ProfiledKernel:
    """Profile one spec into a ProfiledKernel (the single assembly point).

    Runs collect+analyze under the given sampler (full-grid by default),
    derives patterns and actions, and stamps the wall time.  ``run`` is
    the caller's measured launch of the kernel, stored verbatim.
    """
    sampler = sampler or GridSampler(None)
    t0 = time.perf_counter()
    hm = analyze(spec, sampler=sampler, dynamic_context=dynamic_context)
    return ProfiledKernel(
        name=name or spec.name,
        variant=variant or spec.name,
        heatmap=hm,
        reports=tuple(detect_all(hm)),
        actions=tuple(advise(hm)),
        wall_s=time.perf_counter() - t0,
        region_map=tuple(region_map),
        run=None if run is None else dict(run),
    )


@dataclasses.dataclass(frozen=True)
class Iteration:
    """One loaded tuning iteration: a label plus its profiled kernels."""

    path: Path
    label: str
    created: float
    kernels: Tuple[ProfiledKernel, ...]
    note: str = ""
    version: int = ARTIFACT_VERSION
    # v3 tuning / v5 per-layer provenance and the v6 faults block, kept
    # as loaded (None / empty for iterations that carry none)
    tuning: Optional[Mapping] = None
    layers: Optional[Mapping] = None
    faults: Tuple[Mapping, ...] = ()

    def kernel(self, name: str) -> ProfiledKernel:
        """Look up one profiled kernel by manifest name."""
        for pk in self.kernels:
            if pk.name == name:
                return pk
        raise KeyError(name)

    def kernel_names(self) -> List[str]:
        """Manifest names of every kernel profiled in this iteration."""
        return [pk.name for pk in self.kernels]


@dataclasses.dataclass(frozen=True)
class KernelVerdict:
    """Per-kernel outcome of diffing two iterations."""

    kernel: str
    verdict: str  # 'improved' | 'regressed' | 'unchanged' | 'added' | 'removed'
    diff: Optional[HeatmapDiff] = None

    @property
    def speedup_estimate(self) -> float:
        """Modeled transaction speedup (1.0 when not comparable)."""
        return self.diff.speedup_estimate if self.diff else 1.0


@dataclasses.dataclass(frozen=True)
class SessionDiff:
    """Kernel-aligned diff of two iterations."""

    before_label: str
    after_label: str
    verdicts: Tuple[KernelVerdict, ...]

    @property
    def regressed(self) -> Tuple[KernelVerdict, ...]:
        """Verdicts whose kernels regressed between the two iterations."""
        return tuple(v for v in self.verdicts if v.verdict == "regressed")

    @property
    def improved(self) -> Tuple[KernelVerdict, ...]:
        """Verdicts whose kernels improved between the two iterations."""
        return tuple(v for v in self.verdicts if v.verdict == "improved")

    def summary(self) -> str:
        """Multi-line human-readable summary (the ``cuthermo diff`` body)."""
        lines = [
            f"== session diff: {self.before_label} -> {self.after_label} =="
        ]
        for v in self.verdicts:
            if v.diff is None:
                lines.append(f"[{v.verdict:>9}] {v.kernel}")
                continue
            d = v.diff
            lines.append(
                f"[{v.verdict:>9}] {v.kernel}: transfers "
                f"{d.tx_before} -> {d.tx_after} ({d.speedup_estimate:.2f}x)"
            )
            for tag, items in (
                ("fixed", d.fixed),
                ("INTRODUCED", d.introduced),
                ("persisting", d.persisting),
            ):
                for region, pattern in items:
                    lines.append(f"      [{tag}] {pattern} on {region}")
        n_imp, n_reg = len(self.improved), len(self.regressed)
        lines.append(
            f"{len(self.verdicts)} kernels compared: "
            f"{n_imp} improved, {n_reg} regressed"
        )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# on-disk writers / readers
# ---------------------------------------------------------------------------


def _check_version(manifest: Mapping, path: Path) -> int:
    version = manifest.get("version")
    if version not in SUPPORTED_VERSIONS:
        supported = ", ".join(str(v) for v in SUPPORTED_VERSIONS)
        raise SessionError(
            f"{path}: unsupported artifact version {version!r}; this build "
            f"reads versions {supported}.  Re-profile with this version of "
            "cuthermo (or load with the version that wrote it)."
        )
    return int(version)


def iteration_version(kernels: Sequence[ProfiledKernel]) -> int:
    """The version stamp for an iteration of ``kernels``: v6 when every
    region is a TPU tile (readable by the JAX package), else v7."""
    tpu_only = all(
        rh.region.geometry.kind == TPUTile.kind
        for pk in kernels
        for rh in pk.heatmap.regions
    )
    return TPU_ARTIFACT_VERSION if tpu_only else ARTIFACT_VERSION


def _commit_bytes(path: Path, data: bytes) -> None:
    """Atomically commit ``data`` at ``path`` (temp + fsync + rename)."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _commit_json(path: Path, obj: Mapping) -> None:
    _commit_bytes(path, json.dumps(obj, indent=2).encode("utf-8"))


def write_iteration(
    path: Union[str, Path],
    kernels: Sequence[ProfiledKernel],
    label: Optional[str] = None,
    note: str = "",
) -> Path:
    """Persist one iteration (manifest.json + one npz per kernel).

    ``path`` is created (parents included); an existing manifest there is
    replaced.  Kernel names must be unique within an iteration (they are
    the alignment keys of diffs); duplicates raise :class:`SessionError`.
    The manifest is committed last, so a reader never finds a manifest
    whose arrays are missing.
    """
    path = Path(path)
    names_seen = [pk.name for pk in kernels]
    dupes = sorted({n for n in names_seen if names_seen.count(n) > 1})
    if dupes:
        raise SessionError(
            f"duplicate kernel name(s) {dupes} in one iteration; kernel "
            "names are alignment keys and must be unique (disambiguate "
            "with e.g. 'gemm:v00' / 'gemm:v01')"
        )
    path.mkdir(parents=True, exist_ok=True)
    label = label or path.name
    seen: Dict[str, int] = {}
    entries = []
    fault_block: List[dict] = []
    for pk in kernels:
        meta, arrays = heatmap_to_arrays(pk.heatmap)
        npz_name = f"{dedupe_stem(slugify(pk.name), seen)}.npz"
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        _commit_bytes(path / npz_name, buf.getvalue())
        for ev in pk.heatmap.faults:
            fault_block.append(dict(ev.as_dict(), kernel=pk.name))
        entry = {
            "name": pk.name,
            "variant": pk.variant,
            "npz": npz_name,
            "wall_s": pk.wall_s,
            "transactions": pk.transactions,
            "waste_ratio": pk.waste_ratio,
            "scratch_words": pk.scratch_words,
            "heatmap": meta,
            "region_map": {old: new for old, new in pk.region_map},
            # derived views, stored for numpy-free consumers; loaders
            # recompute them from the arrays (single source of truth)
            "patterns": [r.as_dict() for r in pk.reports],
            "actions": [a.as_dict() for a in pk.actions],
        }
        if pk.run is not None:
            entry["run"] = dict(pk.run)
        entries.append(entry)
    manifest = {
        "format": ITERATION_FORMAT,
        "version": iteration_version(kernels),
        "label": label,
        "note": note,
        "created": time.time(),
        "kernels": entries,
    }
    if fault_block:
        manifest["faults"] = fault_block
    _commit_json(path / "manifest.json", manifest)
    return path


def load_iteration(path: Union[str, Path]) -> Iteration:
    """Load one iteration directory back into memory.

    Raises :class:`SessionError` when the directory has no manifest, the
    manifest is malformed, or its version is not one of
    :data:`SUPPORTED_VERSIONS`.  Pattern reports and advisor actions are
    *recomputed* from the reloaded arrays, which doubles as an integrity
    check: a corrupted npz cannot silently keep stale verdicts.
    """
    path = Path(path)
    mpath = path / "manifest.json"
    if not mpath.is_file():
        raise SessionError(
            f"{path}: not an iteration directory (no manifest.json)"
        )
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SessionError(f"{mpath}: unreadable manifest ({e})") from e
    if manifest.get("format") not in (None, ITERATION_FORMAT):
        raise SessionError(
            f"{mpath}: format {manifest.get('format')!r} is not "
            f"{ITERATION_FORMAT!r}"
        )
    version = _check_version(manifest, mpath)
    kernels: List[ProfiledKernel] = []
    for entry in manifest.get("kernels", []):
        try:
            npz_path = path / entry["npz"]
        except (KeyError, TypeError) as e:
            raise SessionError(
                f"{mpath}: malformed kernel entry ({e!r}); every entry "
                "needs at least 'name' and 'npz'"
            ) from e
        if not npz_path.is_file():
            raise SessionError(f"{npz_path}: referenced by manifest, missing")
        try:
            with np.load(npz_path) as data:
                hm = arrays_to_heatmap(entry["heatmap"], data)
        except Exception as e:  # corrupt npz / missing keys / bad metadata
            raise SessionError(
                f"{npz_path}: corrupt or inconsistent artifact ({e})"
            ) from e
        try:
            kernels.append(
                ProfiledKernel(
                    name=entry["name"],
                    variant=entry.get("variant", ""),
                    heatmap=hm,
                    reports=tuple(detect_all(hm)),
                    actions=tuple(advise(hm)),
                    wall_s=float(entry.get("wall_s", 0.0)),
                    region_map=tuple(
                        sorted(entry.get("region_map", {}).items())
                    ),
                    run=entry.get("run"),
                )
            )
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise SessionError(
                f"{mpath}: malformed kernel entry ({e!r})"
            ) from e
    return Iteration(
        path=path,
        label=manifest.get("label", path.name),
        created=float(manifest.get("created", 0.0)),
        kernels=tuple(kernels),
        note=manifest.get("note", ""),
        version=version,
        tuning=manifest.get("tuning"),
        layers=manifest.get("layers"),
        faults=tuple(manifest.get("faults", [])),
    )


def _effective_region_map(
    rename: Mapping[str, str], before_hm: Heatmap, after_hm: Heatmap
) -> Dict[str, str]:
    """Keep only renames that actually apply to this pair of heat maps.

    A rename is live only when the before side has the old name and the
    after side has the new name but not the old one.
    """
    before = set(before_hm.region_names())
    after = set(after_hm.region_names())
    return {
        old: new
        for old, new in rename.items()
        if old in before and new in after and old not in after
    }


def diff_iterations(
    before: Iteration,
    after: Iteration,
    region_maps: Optional[Mapping[str, Mapping[str, str]]] = None,
) -> SessionDiff:
    """Align two iterations kernel-by-kernel and attach verdicts.

    Kernels are matched by manifest name; region renames come from each
    before-kernel's persisted ``region_map``, overridable per kernel
    through ``region_maps``.  Kernels present on only one side get
    'added' / 'removed' verdicts instead of a heat-map diff.
    """
    region_maps = region_maps or {}
    verdicts: List[KernelVerdict] = []
    after_names = set(after.kernel_names())
    for pk in before.kernels:
        if pk.name not in after_names:
            verdicts.append(KernelVerdict(kernel=pk.name, verdict="removed"))
            continue
        after_pk = after.kernel(pk.name)
        rename = region_maps.get(pk.name)
        if rename is None:
            rename = dict(pk.region_map)
        d = diff_heatmaps(
            pk.heatmap,
            after_pk.heatmap,
            region_map=_effective_region_map(
                rename, pk.heatmap, after_pk.heatmap
            ),
        )
        verdicts.append(
            KernelVerdict(kernel=pk.name, verdict=d.verdict, diff=d)
        )
    before_names = set(before.kernel_names())
    for pk in after.kernels:
        if pk.name not in before_names:
            verdicts.append(KernelVerdict(kernel=pk.name, verdict="added"))
    return SessionDiff(
        before_label=before.label,
        after_label=after.label,
        verdicts=tuple(verdicts),
    )


# ---------------------------------------------------------------------------
# the session object
# ---------------------------------------------------------------------------

_ITER_RE = re.compile(r"^iter(\d+)$")


class ProfileSession:
    """A directory of numbered tuning iterations (the paper's Fig. 2 loop).

    Iterations are append-only: each ``add_iteration`` call
    creates the next ``iterN`` directory.  Everything is reloadable by
    any later process (and by the CLI) from the directory alone.
    """

    def __init__(self, root: Union[str, Path], create: bool = True):
        """Open (and by default create) the session at ``root``."""
        self.root = Path(root)
        spath = self.root / "session.json"
        if spath.is_file():
            self._read_session_manifest()
        elif create:
            self.root.mkdir(parents=True, exist_ok=True)
            self._write_session_manifest([])
        else:
            raise SessionError(f"{self.root}: no session.json (create=False)")

    def _read_session_manifest(self) -> Mapping:
        spath = self.root / "session.json"
        try:
            with open(spath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise SessionError(
                f"{spath}: unreadable session manifest ({e})"
            ) from e
        if manifest.get("format") != SESSION_FORMAT:
            raise SessionError(
                f"{spath}: format {manifest.get('format')!r} is not "
                f"{SESSION_FORMAT!r}"
            )
        _check_version(manifest, spath)
        return manifest

    def _write_session_manifest(self, iterations: List[str]) -> None:
        _commit_json(
            self.root / "session.json",
            {
                "format": SESSION_FORMAT,
                "version": TPU_ARTIFACT_VERSION,
                "iterations": iterations,
            },
        )

    def iteration_names(self) -> List[str]:
        """Names of this session's iterations, ordered by iteration number."""
        names = set(self._read_session_manifest().get("iterations", []))
        # pick up directories written by other processes since last update
        names.update(
            d.name
            for d in self.root.iterdir()
            if d.is_dir() and _ITER_RE.match(d.name)
            and (d / "manifest.json").is_file()
        )
        return sorted(
            names,
            key=lambda n: (
                int(_ITER_RE.match(n).group(1)) if _ITER_RE.match(n) else -1,
                n,
            ),
        )

    def add_iteration(
        self,
        kernels: Sequence[ProfiledKernel],
        label: Optional[str] = None,
        note: str = "",
    ) -> Iteration:
        """Persist already-profiled kernels as the next ``iterN`` directory.

        The directory is claimed with an *exclusive* mkdir, so two
        processes profiling into the same session race to distinct
        ``iterN`` numbers instead of overwriting each other.
        """
        existing = self.iteration_names()
        nums = [int(_ITER_RE.match(n).group(1)) for n in existing
                if _ITER_RE.match(n)]
        n = max(nums) + 1 if nums else 0
        while True:
            name = f"iter{n}"
            try:
                (self.root / name).mkdir(parents=True, exist_ok=False)
                break
            except FileExistsError:
                n += 1  # another writer claimed it; take the next slot
        path = write_iteration(
            self.root / name, kernels, label=label or name, note=note
        )
        if name not in existing:
            existing.append(name)
        self._write_session_manifest(existing)
        return load_iteration(path)

    def iterations(self) -> List[Iteration]:
        """Load every iteration of this session, in creation order."""
        return [self.iteration(n) for n in self.iteration_names()]

    def iteration(self, which: Union[int, str]) -> Iteration:
        """Load one iteration by index (0, -1, ...) or directory name."""
        names = self.iteration_names()
        if isinstance(which, int):
            try:
                which = names[which]
            except IndexError:
                raise SessionError(
                    f"session has {len(names)} iterations, asked for "
                    f"index {which}"
                ) from None
        if which not in names:
            raise SessionError(
                f"{self.root}: no iteration {which!r} (have {names})"
            )
        return load_iteration(self.root / which)

    def diff(
        self,
        before: Union[int, str, Iteration],
        after: Union[int, str, Iteration],
        region_maps: Optional[Mapping[str, Mapping[str, str]]] = None,
    ) -> SessionDiff:
        """Diff two iterations of this session (see :func:`diff_iterations`)."""
        if not isinstance(before, Iteration):
            before = self.iteration(before)
        if not isinstance(after, Iteration):
            after = self.iteration(after)
        return diff_iterations(before, after, region_maps=region_maps)


__all__ = [
    "ARTIFACT_VERSION",
    "SUPPORTED_VERSIONS",
    "TPU_ARTIFACT_VERSION",
    "Iteration",
    "KernelVerdict",
    "ProfileSession",
    "ProfiledKernel",
    "SessionDiff",
    "SessionError",
    "arrays_to_heatmap",
    "diff_iterations",
    "heatmap_to_arrays",
    "heatmaps_equal",
    "iteration_version",
    "load_iteration",
    "profile_kernel",
    "write_iteration",
]
