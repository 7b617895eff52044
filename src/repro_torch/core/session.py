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

Writes are crash safe: every file of an iteration is committed
atomically (temp + fsync + rename, manifest last) under a journal
sidecar, so a kill at any instant leaves a complete iteration, a
completable one (everything durable, only the manifest rename missing),
or a torn one that :meth:`ProfileSession.recover` quarantines — never a
directory that half-loads.

A session with ``workers > 1`` collects through one persistent
:class:`~repro_torch.core.collector.ShardedCollector` pool; the heat maps
are bit-identical to serial ones and carry per-shard provenance.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import time
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .advisor import Action, advise
from .cache import CacheKeyError, CollectionCache, spec_content_hash
from .collector import KernelSpec, ShardedCollector, analyze
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
    # one: {"device": name, "launches": n, "ms": median ms of a call as a
    # caller waits for it (host issue included), "device_ms": ms the card
    # spends on a call (absent from manifests written before it was
    # recorded: not measured)}
    run: Optional[Mapping] = None
    # collection-cache provenance: True when the heat map came from a
    # CollectionCache hit instead of a fresh grid walk; ``cache_key`` is
    # the spec's content hash ("" when profiled without a cache or the
    # spec was uncacheable).  The run above is never cached.
    cached: bool = False
    cache_key: str = ""

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
    workers: int = 1,
    collector: Optional[ShardedCollector] = None,
    cache: Optional[CollectionCache] = None,
) -> ProfiledKernel:
    """Profile one spec into a ProfiledKernel (the single assembly point).

    Runs collect+analyze under the given sampler (full-grid by default),
    derives patterns and actions, and stamps the wall time.  ``run`` is
    the caller's measured launch of the kernel, stored verbatim.

    ``collector`` (a :class:`~repro_torch.core.collector.ShardedCollector`,
    reusable across kernels) or ``workers > 1`` routes the walk through
    sharded collection: the heat map is bit-identical either way, and the
    sharded one carries per-shard (and any recovery) provenance.

    ``cache`` (a :class:`~repro_torch.core.cache.CollectionCache`) makes
    the collection content-addressed: a hit skips the grid walk and
    returns the stored heat map (bit-identical to a fresh walk), a miss
    walks and stores.  Only the heat map is cached: ``run`` is the
    caller's, measured on every profile.  Specs whose callables cannot be
    content-hashed profile uncached.
    """
    sampler = sampler or GridSampler(None)
    t0 = time.perf_counter()
    key = ""
    hm = None
    if cache is not None:
        try:
            key = spec_content_hash(spec, sampler, dynamic_context)
        except CacheKeyError:
            cache.note_uncacheable()
        else:
            hm = cache.get(key)
    cached = hm is not None
    if hm is None:
        if collector is not None:
            hm = collector.analyze(spec, sampler, dynamic_context)
        elif workers > 1:
            with ShardedCollector(workers) as sc:
                hm = sc.analyze(spec, sampler, dynamic_context)
        else:
            hm = analyze(
                spec, sampler=sampler, dynamic_context=dynamic_context
            )
        # a truncated trace depends on the record cap, not only the spec
        if cache is not None and key and hm.dropped == 0:
            cache.put(key, hm)
    return ProfiledKernel(
        name=name or spec.name,
        variant=variant or spec.name,
        heatmap=hm,
        reports=tuple(detect_all(hm)),
        actions=tuple(advise(hm)),
        wall_s=time.perf_counter() - t0,
        region_map=tuple(region_map),
        run=None if run is None else dict(run),
        cached=cached,
        cache_key=key,
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
# manifest-level history (the anomaly-band substrate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HistoryPoint:
    """One kernel's manifest-level metrics in one session iteration.

    Built from ``manifest.json`` alone (no arrays are loaded), so history
    queries over long sessions stay cheap.  ``scratch_words`` is ``None``
    for artifacts written before format v4; consumers skip the metric
    rather than assume zero.  ``tuning_role`` / ``tuning_accepted`` carry
    the iteration's tuner provenance, so ``cuthermo check --anomaly`` can
    leave out candidates the tuner already rejected.
    """

    iteration: str
    label: str
    created: float
    kernel: str
    variant: str
    transactions: int
    waste_ratio: float
    patterns: Tuple[Tuple[str, str], ...]  # (region, pattern), sorted
    scratch_words: Optional[int] = None
    tuning_role: Optional[str] = None  # 'baseline' | 'candidate' | None
    tuning_accepted: Optional[bool] = None

    @property
    def n_patterns(self) -> int:
        """Count of detected inefficiency patterns at this point."""
        return len(self.patterns)


def _history_points_from_manifest(
    manifest: Mapping, iteration: str
) -> List[HistoryPoint]:
    """One HistoryPoint per kernel entry of a loaded manifest."""
    tuning = manifest.get("tuning") or {}
    if not isinstance(tuning, dict):
        raise SessionError(f"{iteration}: malformed manifest ('tuning' is not an object)")
    points: List[HistoryPoint] = []
    for entry in _manifest_kernels(manifest, iteration):
        try:
            patterns = tuple(
                sorted(
                    (str(p.get("region", "")), str(p.get("pattern", "")))
                    for p in entry.get("patterns", [])
                )
            )
            scratch = entry.get("scratch_words")
            points.append(
                HistoryPoint(
                    iteration=iteration,
                    label=str(manifest.get("label", iteration)),
                    created=float(manifest.get("created", 0.0)),
                    kernel=str(entry["name"]),
                    variant=str(entry.get("variant", "")),
                    transactions=int(entry.get("transactions", 0)),
                    waste_ratio=float(entry.get("waste_ratio", 1.0)),
                    patterns=patterns,
                    scratch_words=None if scratch is None else int(scratch),
                    tuning_role=tuning.get("role"),
                    tuning_accepted=tuning.get("accepted"),
                )
            )
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise SessionError(
                f"{iteration}: malformed kernel entry in manifest ({e!r})"
            ) from e
    return points


# ---------------------------------------------------------------------------
# on-disk writers / readers
# ---------------------------------------------------------------------------


def _manifest_kernels(manifest: Mapping, where: object) -> List:
    """The manifest's kernel entries, or SessionError when they are not a
    list (a malformed manifest is a load error, never a traceback)."""
    entries = manifest.get("kernels", [])
    if not isinstance(entries, list):
        raise SessionError(f"{where}: malformed manifest ('kernels' is not a list)")
    return entries


def _check_version(manifest: Mapping, path: Path) -> int:
    if not isinstance(manifest, dict):
        raise SessionError(f"{path}: malformed manifest (not a JSON object)")
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


#: Name of the write-in-progress journal sidecar inside an iteration
#: directory.  It exists from the first byte of an iteration write until
#: after the manifest commit; a directory holding one was torn by a crash
#: (or is being written right now) and is the input to
#: :meth:`ProfileSession.recover`.
JOURNAL_NAME = ".journal.json"

#: Hooks called around every atomic file commit of an iteration write:
#: ``hook(path, event)`` with ``event`` = ``"staged"`` (the temp file is
#: durable, the rename has not happened) or ``"committed"`` (renamed into
#: place).  :class:`repro_torch.core.faultinject.WriteKillPoint` installs
#: itself here to model ``kill -9`` at exact points; production code
#: leaves the list empty.
_write_commit_hooks: List = []


def _notify_hooks(path: Path, event: str) -> None:
    for hook in list(_write_commit_hooks):
        hook(path, event)


def _commit_bytes(path: Path, data: bytes, *, notify: bool = True) -> None:
    """Atomically commit ``data`` at ``path`` (temp + fsync + rename).

    If the process dies at any instant, ``path`` holds its complete old
    content or the complete new one, never a prefix.  The temp file is
    ``<name>.tmp`` in the same directory, which is what
    :meth:`ProfileSession.recover` looks for when it completes a write
    that died between the fsync and the rename.
    """
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if notify:
        _notify_hooks(path, "staged")
    os.replace(tmp, path)
    if notify:
        _notify_hooks(path, "committed")


def _commit_json(path: Path, obj: Mapping, *, notify: bool = True) -> None:
    _commit_bytes(
        path, json.dumps(obj, indent=2).encode("utf-8"), notify=notify
    )


def _commit_npz(path: Path, arrays: Mapping[str, np.ndarray]) -> None:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    _commit_bytes(path, buf.getvalue())


def _validate_layers(
    layers: Mapping, kernels: Sequence[ProfiledKernel]
) -> None:
    """Validate per-layer attribution against the iteration's kernels.

    The layer table must be an exact partition: every profiled kernel
    appears in exactly one row, every row references only profiled
    kernels, and each row's ``transactions`` equals the sum over its
    members, which makes "per-layer totals sum to the iteration total" an
    invariant of the artifact, not a property a reader must check.
    """
    table = layers.get("table")
    if not isinstance(table, (list, tuple)):
        raise SessionError("layers attribution needs a 'table' list of rows")
    tx_by_name = {pk.name: pk.transactions for pk in kernels}
    seen: Dict[str, str] = {}
    for row in table:
        try:
            path_ = str(row["path"])
            members = list(row["kernels"])
            row_tx = int(row["transactions"])
        except (KeyError, TypeError, ValueError) as e:
            raise SessionError(
                f"malformed layer row ({e!r}); every row needs 'path', "
                "'kernels' and 'transactions'"
            ) from e
        total = 0
        for name in members:
            if name not in tx_by_name:
                raise SessionError(
                    f"layer {path_!r} references kernel {name!r} not "
                    "profiled in this iteration"
                )
            if name in seen:
                raise SessionError(
                    f"kernel {name!r} attributed to both layer "
                    f"{seen[name]!r} and {path_!r}; the layer table must "
                    "partition the iteration's kernels"
                )
            seen[name] = path_
            total += tx_by_name[name]
        if total != row_tx:
            raise SessionError(
                f"layer {path_!r} claims {row_tx} transactions but its "
                f"kernels sum to {total}"
            )
    missing = sorted(set(tx_by_name) - set(seen))
    if missing:
        raise SessionError(
            f"kernel(s) {missing} profiled but missing from the layer "
            "table; the layer table must partition the iteration's kernels"
        )


def write_iteration(
    path: Union[str, Path],
    kernels: Sequence[ProfiledKernel],
    label: Optional[str] = None,
    note: str = "",
    tuning: Optional[Mapping] = None,
    *,
    layers: Optional[Mapping] = None,
) -> Path:
    """Persist one iteration (manifest.json + one npz per kernel).

    ``path`` is created (parents included); an existing manifest there is
    replaced.  Kernel names must be unique within an iteration (they are
    the alignment keys of diffs); duplicates raise :class:`SessionError`.
    ``layers`` is whole-model profiling's per-layer attribution; its table
    is validated as an exact partition of ``kernels``
    (:func:`_validate_layers`) and stored under the manifest's ``layers``
    key, as the JAX package stores it.  ``tuning`` is the tuner's
    provenance for this iteration (which step, which candidate, which
    action spawned it), stored verbatim under the manifest's ``tuning``
    key.

    The write is crash safe: a :data:`JOURNAL_NAME` sidecar naming every
    file is committed first, every npz and the manifest are committed
    atomically (manifest last), and the journal is removed only after
    the manifest rename.  A kill at any instant leaves a directory that
    :meth:`ProfileSession.recover` classifies exactly.
    """
    path = Path(path)
    if layers is not None:
        _validate_layers(layers, kernels)
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
    version = iteration_version(kernels)
    # plan the write up front so the journal names every file to expect
    seen: Dict[str, int] = {}
    npz_names = [f"{dedupe_stem(slugify(pk.name), seen)}.npz" for pk in kernels]
    journal = {
        "format": "cuthermo-journal",
        "version": version,
        "label": label,
        "npz": npz_names,
    }
    _commit_json(path / JOURNAL_NAME, journal, notify=False)
    entries = []
    fault_block: List[dict] = []
    for npz_name, pk in zip(npz_names, kernels):
        meta, arrays = heatmap_to_arrays(pk.heatmap)
        _commit_npz(path / npz_name, arrays)
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
        "version": version,
        "label": label,
        "note": note,
        "created": time.time(),
        "kernels": entries,
    }
    if fault_block:
        manifest["faults"] = fault_block
    if tuning is not None:
        manifest["tuning"] = dict(tuning)
    if layers is not None:
        manifest["layers"] = dict(layers)
    _commit_json(path / "manifest.json", manifest)
    (path / JOURNAL_NAME).unlink(missing_ok=True)
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
    if not isinstance(manifest, dict):
        raise SessionError(f"{mpath}: malformed manifest (not a JSON object)")
    if manifest.get("format") not in (None, ITERATION_FORMAT):
        raise SessionError(
            f"{mpath}: format {manifest.get('format')!r} is not "
            f"{ITERATION_FORMAT!r}"
        )
    version = _check_version(manifest, mpath)
    kernels: List[ProfiledKernel] = []
    for entry in _manifest_kernels(manifest, mpath):
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

    Iterations are append-only: each ``add_iteration`` (or ``tune``
    step) creates the next ``iterN`` directory.  Everything is reloadable
    by any later process (and by the CLI) from the directory alone.
    """

    def __init__(
        self,
        root: Union[str, Path],
        create: bool = True,
        cache: Union[None, str, Path, CollectionCache] = None,
        workers: int = 1,
        fault_plan=None,
    ):
        """Open (and by default create) the session at ``root``.

        ``cache`` backs every profile with a content-addressed
        :class:`~repro_torch.core.cache.CollectionCache`: an existing
        cache, or a directory path for an on-disk one.

        ``workers > 1`` collects every later profile through ONE sharded
        process pool that persists across the session's profile and tune
        calls (spawn + import paid once; close it with :meth:`close` or
        use the session as a context manager).  ``fault_plan`` (a
        :class:`repro_torch.core.faultinject.FaultPlan`) threads
        deterministic fault injection into that pool.
        """
        self.workers = max(1, int(workers))
        self.fault_plan = fault_plan
        self._collector: Optional[ShardedCollector] = None
        if cache is None or isinstance(cache, CollectionCache):
            self.cache = cache
        else:
            self.cache = CollectionCache(cache)
        self.root = Path(root)
        spath = self.root / "session.json"
        if spath.is_file():
            self._read_session_manifest()
        elif create:
            self.root.mkdir(parents=True, exist_ok=True)
            self._write_session_manifest([])
        else:
            raise SessionError(f"{self.root}: no session.json (create=False)")

    # -- collector lifecycle -----------------------------------------------
    def collector(
        self, workers: Optional[int] = None
    ) -> Optional[ShardedCollector]:
        """The session's persistent shard pool (None when serial).

        Created on first use and reused by every later profile or tune
        call; asking for a different worker count replaces it.  The
        session owns it (:meth:`close`).
        """
        n = self.workers if workers is None else max(1, int(workers))
        if n <= 1:
            return None
        if self._collector is None or self._collector.workers != n:
            if self._collector is not None:
                self._collector.close()
            self._collector = ShardedCollector(n, fault_plan=self.fault_plan)
        return self._collector

    def close(self) -> None:
        """Shut down the session's persistent shard pool (idempotent)."""
        if self._collector is not None:
            self._collector.close()
            self._collector = None

    def __enter__(self) -> "ProfileSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

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
            notify=False,
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

    # -- crash recovery ----------------------------------------------------
    def recover(self) -> List[FaultEvent]:
        """Complete or quarantine iterations torn by a crash or kill.

        Scans every ``iterN`` directory for the :data:`JOURNAL_NAME`
        sidecar an interrupted :func:`write_iteration` leaves, and
        resolves each one:

        * journal present, manifest loads: the write finished and only the
          journal removal was lost; the journal is removed.
        * journal present, ``manifest.json.tmp`` durable and every npz it
          names present: the write died between the manifest fsync and
          its rename; the rename is performed (nothing is reconstructed).
        * anything else: the iteration is torn and moves to
          ``<root>/quarantine/``, freeing its slot.

        Returns one ``torn-iteration`` event per resolved directory.  Not
        called on open: a journal is also what a concurrently running
        writer looks like, so recovery is an explicit decision.
        """
        events: List[FaultEvent] = []
        for d in sorted(self.root.iterdir()):
            if not d.is_dir() or not _ITER_RE.match(d.name):
                continue
            jpath = d / JOURNAL_NAME
            mpath = d / "manifest.json"
            tpath = d / "manifest.json.tmp"
            if not jpath.is_file():
                if mpath.is_file():
                    continue  # healthy (or written before journals)
                # claimed (mkdir) but killed before the journal commit
                events.append(self._quarantine(d, "no journal, no manifest"))
                continue
            if mpath.is_file() and self._iteration_loads(d):
                jpath.unlink(missing_ok=True)
                self._sweep_tmps(d)
                events.append(
                    FaultEvent(
                        kind="torn-iteration",
                        where="session",
                        detail=(
                            f"{d.name}: write completed, journal removal "
                            "lost; journal removed"
                        ),
                    )
                )
                continue
            if tpath.is_file():
                # the manifest temp was fsync'd before the rename: if it
                # parses and its npz files exist, the content is durable
                try:
                    manifest = json.loads(tpath.read_text())
                    npz_ok = all(
                        (d / e["npz"]).is_file()
                        for e in manifest.get("kernels", [])
                    )
                except (OSError, json.JSONDecodeError, KeyError, TypeError):
                    npz_ok = False
                if npz_ok:
                    os.replace(tpath, mpath)
                    if self._iteration_loads(d):
                        jpath.unlink(missing_ok=True)
                        self._sweep_tmps(d)
                        events.append(
                            FaultEvent(
                                kind="torn-iteration",
                                where="session",
                                detail=(
                                    f"{d.name}: completed from durable "
                                    "temp manifest"
                                ),
                            )
                        )
                        continue
            events.append(self._quarantine(d, "torn write (incomplete)"))
        self._write_session_manifest(self.iteration_names())
        return events

    @staticmethod
    def _iteration_loads(d: Path) -> bool:
        try:
            load_iteration(d)
            return True
        except SessionError:
            return False

    @staticmethod
    def _sweep_tmps(d: Path) -> None:
        for tmp in d.glob("*.tmp"):
            tmp.unlink(missing_ok=True)

    def _quarantine(self, d: Path, why: str) -> FaultEvent:
        qroot = self.root / "quarantine"
        qroot.mkdir(exist_ok=True)
        target = qroot / d.name
        k = 1
        while target.exists():
            k += 1
            target = qroot / f"{d.name}-{k}"
        d.rename(target)
        return FaultEvent(
            kind="torn-iteration",
            where="session",
            detail=f"{d.name}: {why}; quarantined to {target.name}",
        )

    def profile(
        self,
        specs: Iterable[KernelSpec],
        sampler: Optional[GridSampler] = None,
        dynamic_contexts: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
        names: Optional[Mapping[str, str]] = None,
        variants: Optional[Mapping[str, str]] = None,
        region_maps: Optional[Mapping[str, Mapping[str, str]]] = None,
        label: Optional[str] = None,
        note: str = "",
        workers: Optional[int] = None,
    ) -> Iteration:
        """Profile every spec and persist the results as the next iteration.

        ``names`` maps a spec's own name to the manifest name used for
        cross-iteration alignment (so ``gemm_v01`` in iter1 can diff
        against ``gemm_v00`` in iter0 under the shared name ``gemm``);
        ``dynamic_contexts``, ``variants`` and ``region_maps`` are keyed
        the same way, by ``KernelSpec.name``.  Returns the loaded
        :class:`Iteration`.

        The default sampler is the full grid: iteration diffs compare
        absolute transfer totals, which only align when both sides cover
        the whole problem.  ``workers`` overrides the session's worker
        count for this call (:meth:`collector`).
        """
        sampler = sampler or GridSampler(None)
        dynamic_contexts = dynamic_contexts or {}
        names = names or {}
        variants = variants or {}
        region_maps = region_maps or {}
        collector = self.collector(workers)
        profiled = [
            profile_kernel(
                spec,
                sampler,
                dynamic_contexts.get(spec.name),
                name=names.get(spec.name),
                variant=variants.get(spec.name),
                region_map=sorted(region_maps.get(spec.name, {}).items()),
                collector=collector,
                cache=self.cache,
            )
            for spec in specs
        ]
        return self.add_iteration(profiled, label=label, note=note)

    def add_iteration(
        self,
        kernels: Sequence[ProfiledKernel],
        label: Optional[str] = None,
        note: str = "",
        tuning: Optional[Mapping] = None,
        *,
        layers: Optional[Mapping] = None,
    ) -> Iteration:
        """Persist already-profiled kernels as the next ``iterN`` directory.

        ``tuning`` is stored as the iteration's tuner provenance and
        ``layers`` as the per-layer attribution of a whole-model profile
        (validated; see :func:`write_iteration`).  The directory is claimed
        with an *exclusive* mkdir, so two processes profiling into the same
        session race to distinct ``iterN`` numbers instead of overwriting
        each other.
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
            self.root / name, kernels, label=label or name, note=note,
            tuning=tuning, layers=layers,
        )
        if name not in existing:
            existing.append(name)
        self._write_session_manifest(existing)
        return load_iteration(path)

    def tune(
        self,
        kernel: str,
        budget: Optional[int] = None,
        workers: Optional[int] = None,
        **kwargs,
    ):
        """Close the tuning loop for one kernel family into this session.

        A front end over :func:`repro_torch.core.tuner.tune`: the baseline
        and every candidate profile are persisted as iterations of this
        session, each manifest carrying the tuning provenance; the
        session's cache serves repeated walks and its shard pool
        (``workers``) collects them.  ``budget`` defaults to
        :data:`repro_torch.core.tuner.DEFAULT_BUDGET`; ``kwargs`` are
        ``tune``'s (``device``, ``seed``, ``target_patterns``, ...).
        """
        from .tuner import DEFAULT_BUDGET, tune as _tune

        return _tune(
            kernel,
            budget=DEFAULT_BUDGET if budget is None else budget,
            session=self,
            collector=self.collector(workers),
            cache=self.cache,
            **kwargs,
        )

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

    def history(
        self, include_rejected: bool = True
    ) -> Dict[str, List[HistoryPoint]]:
        """Per-kernel metric history across every iteration, in order.

        Reads only the iteration manifests (no arrays).  Returns manifest
        kernel name -> :class:`HistoryPoint` list in iteration order.
        ``include_rejected=False`` drops iterations the tuner profiled and
        rejected, which would otherwise pollute a rolling anomaly band.
        """
        out: Dict[str, List[HistoryPoint]] = {}
        for name in self.iteration_names():
            mpath = self.root / name / "manifest.json"
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                raise SessionError(f"{mpath}: unreadable manifest ({e})") from e
            _check_version(manifest, mpath)
            for pt in _history_points_from_manifest(manifest, name):
                if not include_rejected and pt.tuning_accepted is False:
                    continue
                out.setdefault(pt.kernel, []).append(pt)
        return out

    def kernel_history(
        self, kernel: str, include_rejected: bool = True
    ) -> List[HistoryPoint]:
        """One kernel's :meth:`history` row (empty when never profiled)."""
        return self.history(include_rejected=include_rejected).get(kernel, [])

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
    "JOURNAL_NAME",
    "SUPPORTED_VERSIONS",
    "TPU_ARTIFACT_VERSION",
    "HistoryPoint",
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
