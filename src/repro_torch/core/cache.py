"""Content-addressed collection cache: trace once, reuse bit-identically.

The Level-1 walk is a *pure function* of (KernelSpec, GridSampler,
dynamic context): the heat map it produces is fully determined by the
spec's geometry, its index-map code, the sampled grid window, and the
concrete index arrays the Level-2 walkers read.  That purity is what
makes collection cacheable — and what this module addresses by content:

* :func:`spec_content_hash` is a **stable content hash** (sha256 hex)
  of the spec: its shapes, names and each region's geometry, and every
  callable's bytecode, constants, defaults, and captured closure
  values — so ``lambda i: (i, 0)`` and ``lambda i: (0, i)`` hash apart,
  a retile factor captured in a closure changes the key, and rebuilding
  the same registry spec in a fresh process reproduces the same hash.
  The geometry (``geometry_kind``: ``h100-sector`` or ``tpu-tile``) is
  part of the key, so an entry walked under one geometry never answers
  a walk under the other.
* :class:`CollectionCache` maps that key to the collected
  :class:`~repro_torch.core.heatmap.Heatmap` — in memory and, when given a
  directory, on disk (one npz + one provenance-stamped meta JSON per
  key, artifact-versioned like session iterations).  A hit returns a
  heat map bit-identical to fresh collection (the golden suite pins
  this); anything stale, corrupt, or version-mismatched is a *miss*,
  never an error — a cache must not be able to break profiling.

``profile_kernel``/``ProfileSession``/``tune`` thread a cache through
the single profiling assembly point, which is what bounds a tuning
session by *distinct* traces: an unchanged kernel or a repeated tuner
candidate costs one dictionary lookup instead of a grid walk.

An entry holds the heat map only.  A profile's ``run`` record (the
kernel's launch on the card) is measured anew on every profile and is
never stored here.  The cached artifact is the canonical map with shard
and fault provenance stripped (``Heatmap.shards == ()``).

What the hash cannot see: a callable's references to module *globals*
mutated after build (captured closure values and defaults are covered).
No spec in this codebase does that — index maps close over their
parameters — but callables that cannot be digested at all (C builtins,
exotic objects) raise :class:`CacheKeyError` and the callers fall back
to uncached collection instead of guessing.

On-disk layout (the JAX package's, see docs/file-format.md)::

    cache-dir/
      ab/
        ab3f0e....npz    # heatmap arrays (heatmap_to_arrays layout)
        ab3f0e....json   # {"format": "cuthermo-collection-cache",
                         #  "version": <ARTIFACT_VERSION>,
                         #  "cache_version": 1, "key": "...",
                         #  "kernel": ..., "provenance": {...},
                         #  "heatmap": <array metadata>}
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np

from .collector import KernelSpec
from .heatmap import Heatmap
from .trace import GridSampler

#: Version of the cache key derivation AND the meta-JSON schema.  Bump
#: whenever either changes: old entries then simply stop hitting (their
#: keys were derived differently) or are skipped on load (their meta
#: carries the old stamp) — stale state can never satisfy a lookup.
CACHE_VERSION = 1

CACHE_FORMAT = "cuthermo-collection-cache"


class CacheKeyError(ValueError):
    """Raised when a spec holds a callable that cannot be content-hashed."""


# ---------------------------------------------------------------------------
# content hashing
# ---------------------------------------------------------------------------


def _hash_value(h, value, memo: set, depth: int = 0) -> None:
    """Digest one captured value into ``h`` (type-tagged, recursive).

    Covers the values index maps and access models actually capture:
    scalars, strings, tuples/lists/dicts/sets, numpy arrays and dtypes,
    nested code objects, and other Python callables (a generated
    candidate's wrapper closes over its parent's index map).  Anything
    else raises :class:`CacheKeyError` — the caller profiles uncached
    rather than risking a false hit.
    """
    if depth > 32:
        raise CacheKeyError("value nesting too deep to content-hash")
    if value is None or isinstance(value, (bool, int, float, complex, str)):
        h.update(f"{type(value).__name__}:{value!r};".encode())
    elif isinstance(value, bytes):
        h.update(b"bytes:")
        h.update(value)
    elif isinstance(value, (tuple, list)):
        h.update(f"{type(value).__name__}[{len(value)}]:".encode())
        for item in value:
            _hash_value(h, item, memo, depth + 1)
    elif isinstance(value, (set, frozenset)):
        h.update(f"set[{len(value)}]:".encode())
        for item in sorted(value, key=repr):
            _hash_value(h, item, memo, depth + 1)
    elif isinstance(value, dict):
        h.update(f"dict[{len(value)}]:".encode())
        for k in sorted(value, key=repr):
            _hash_value(h, k, memo, depth + 1)
            _hash_value(h, value[k], memo, depth + 1)
    elif isinstance(value, np.ndarray):
        arr = np.ascontiguousarray(value)
        h.update(f"ndarray:{arr.dtype.str}:{arr.shape};".encode())
        h.update(arr.tobytes())
    elif isinstance(value, np.generic):
        h.update(f"npscalar:{value.dtype.str}:{value!r};".encode())
    elif isinstance(value, np.dtype):
        h.update(f"dtype:{value.str};".encode())
    elif isinstance(value, type(_hash_value.__code__)):
        _hash_code(h, value, memo, depth + 1)
    elif callable(value):
        _hash_callable(h, value, memo, depth + 1)
    else:
        raise CacheKeyError(
            f"cannot content-hash captured value of type "
            f"{type(value).__name__!r}"
        )


def _hash_code(h, code, memo: set, depth: int) -> None:
    """Digest a code object: bytecode + constants (nested code included)."""
    h.update(b"code:")
    h.update(code.co_code)
    h.update(f":{code.co_argcount}:{code.co_nlocals};".encode())
    for const in code.co_consts:
        _hash_value(h, const, memo, depth + 1)


def _hash_callable(h, fn, memo: set, depth: int = 0) -> None:
    """Digest a callable's *behavior*: code, defaults, captured state.

    Plain Python functions (lambdas included) digest their bytecode,
    constants, defaults, and closure cell values — recursively, so a
    wrapper function hashes its wrapped inner map too.
    ``functools.partial`` digests the wrapped callable plus the bound
    arguments.  Two textually different sources with identical bytecode
    and captures hash the same (they collect identically); changing a
    captured parameter or the map's arithmetic changes the key.
    """
    if depth > 32:
        raise CacheKeyError("callable nesting too deep to content-hash")
    if id(fn) in memo:
        h.update(b"cycle;")
        return
    memo.add(id(fn))
    import functools

    if isinstance(fn, functools.partial):
        h.update(b"partial:")
        _hash_callable(h, fn.func, memo, depth + 1)
        _hash_value(h, fn.args, memo, depth + 1)
        _hash_value(h, fn.keywords or {}, memo, depth + 1)
        return
    code = getattr(fn, "__code__", None)
    if code is None:
        raise CacheKeyError(
            f"cannot content-hash non-Python callable {fn!r}"
        )
    h.update(b"fn:")
    _hash_code(h, code, memo, depth + 1)
    _hash_value(h, getattr(fn, "__defaults__", None) or (), memo, depth + 1)
    _hash_value(h, getattr(fn, "__kwdefaults__", None) or {}, memo, depth + 1)
    closure = getattr(fn, "__closure__", None) or ()
    h.update(f"closure[{len(closure)}]:".encode())
    for cell in closure:
        try:
            contents = cell.cell_contents
        except ValueError:  # unfilled cell (recursive def mid-construction)
            h.update(b"emptycell;")
            continue
        _hash_value(h, contents, memo, depth + 1)


def callable_fingerprint(fn) -> str:
    """Stable sha256 hex digest of one callable (see :func:`_hash_callable`)."""
    h = hashlib.sha256()
    _hash_callable(h, fn, set())
    return h.hexdigest()


def spec_content_hash(
    spec: KernelSpec,
    sampler: Optional[GridSampler] = None,
    dynamic_context: Optional[Mapping[str, np.ndarray]] = None,
) -> str:
    """Content-address one collection as a sha256 hex key.

    The digest covers everything that determines the resulting heat
    map: the spec's structure (name, grid, per-operand shape, dtype,
    block, kind, origin, once and geometry kind, scratch layout and
    geometry, dynamic walker names),
    every callable's *content* (index maps, scratch access models,
    dynamic walkers — bytecode, constants, defaults, closures), the
    sampler window, and the dynamic context arrays byte-for-byte.  The
    interpreter's major.minor version is mixed in because bytecode is
    only comparable within one: an upgrade invalidates rather than
    colliding.  Stable across process restarts for rebuildable specs
    (the registry's seeded builders are deterministic).

    Raises :class:`CacheKeyError` for specs whose callables cannot be
    digested; callers should collect uncached in that case.
    """
    h = hashlib.sha256()
    memo: set = set()
    h.update(
        f"cuthermo-cache-v{CACHE_VERSION}:"
        f"py{sys.version_info[0]}.{sys.version_info[1]};".encode()
    )
    h.update(f"kernel:{spec.name};grid:{tuple(spec.grid)};".encode())
    for op in spec.operands:
        h.update(
            f"op:{op.name}:{tuple(op.shape)}:{np.dtype(op.dtype).str}:"
            f"{tuple(op.block_shape)}:{op.kind}:{op.space}:"
            f"{tuple(op.origin)}:{op.once}:{op.geometry_kind};".encode()
        )
        _hash_callable(h, op.index_map, memo)
    for sc in spec.scratch:
        h.update(
            f"scratch:{sc.name}:{tuple(sc.shape)}:"
            f"{np.dtype(sc.dtype).str}:{sc.kind}:{sc.geometry_kind};".encode()
        )
        if sc.access_model is None:
            h.update(b"whole-buffer;")
        else:
            _hash_callable(h, sc.access_model, memo)
    for name, fn in spec.dynamic:
        h.update(f"dynamic:{name};".encode())
        _hash_callable(h, fn, memo)
    sampler = sampler or GridSampler()
    h.update(f"sampler:{sampler.target}:{sampler.window};".encode())
    for name in sorted(dynamic_context or {}):
        h.update(f"ctx:{name};".encode())
        _hash_value(h, np.asarray((dynamic_context or {})[name]), memo)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    """Hit/miss counters of one :class:`CollectionCache`."""

    hits: int = 0
    misses: int = 0
    stores: int = 0
    memory_hits: int = 0
    disk_hits: int = 0
    uncacheable: int = 0
    # entries found on disk but defective (truncated npz, unreadable
    # meta, torn pair) — quarantined, counted, and missed; distinct
    # from `misses` so a corruption storm is visible
    corrupt: int = 0

    def as_dict(self) -> dict:
        """JSON-ready counters."""
        return dataclasses.asdict(self)


class CollectionCache:
    """Content-addressed heat-map cache: in-memory, optionally on-disk.

    ``path=None`` keeps entries in memory only (one process's tuning
    run); a directory adds a persistent tier shared across processes
    and sessions.  Thread-safe: one cache may serve several threads.

    Lookups that fail for any reason (missing file, corrupt npz,
    version mismatch, truncated JSON) count as misses; :meth:`put`
    never raises on disk errors either.  The worst a broken cache can
    do is cost a re-trace.

    A *present but defective* disk entry (truncated or unreadable npz,
    broken meta JSON, a torn npz/meta pair) is more than a plain miss:
    it is moved to ``<dir>/quarantine/`` so it cannot silently eat a
    lookup on every future run, counted in ``stats.corrupt``, and
    warned about once per key.  Entries written by a *different build*
    (format/version/cache-version mismatch) stay plain misses — they
    are valid files, just not ours to read.
    """

    def __init__(self, path: Optional[Union[str, Path]] = None):
        self.path = None if path is None else Path(path)
        self._mem: Dict[str, Tuple[dict, Dict[str, np.ndarray]]] = {}
        self._lock = threading.Lock()
        self._corrupt_warned: set = set()
        self.stats = CacheStats()

    # -- key paths ----------------------------------------------------------
    def _entry_paths(self, key: str) -> Tuple[Path, Path]:
        assert self.path is not None
        d = self.path / key[:2]
        return d / f"{key}.npz", d / f"{key}.json"

    # -- lookup -------------------------------------------------------------
    def get(self, key: str) -> Optional[Heatmap]:
        """Return the cached heat map for ``key``, or None on a miss.

        Every call rebuilds a fresh :class:`Heatmap` from the stored
        arrays, so callers can never alias (or mutate) each other's
        regions.  Disk hits are promoted into the memory tier.
        """
        from .session import arrays_to_heatmap

        with self._lock:
            entry = self._mem.get(key)
            if entry is not None:
                self.stats.hits += 1
                self.stats.memory_hits += 1
                meta, arrays = entry
                return arrays_to_heatmap(meta, arrays)
        entry = self._load_disk(key)
        with self._lock:
            if entry is None:
                self.stats.misses += 1
                return None
            self._mem[key] = entry
            self.stats.hits += 1
            self.stats.disk_hits += 1
            meta, arrays = entry
        return arrays_to_heatmap(meta, arrays)

    def _load_disk(
        self, key: str
    ) -> Optional[Tuple[dict, Dict[str, np.ndarray]]]:
        if self.path is None:
            return None
        npz_path, meta_path = self._entry_paths(key)
        if not meta_path.exists() and not npz_path.exists():
            return None  # never stored: a plain miss
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except FileNotFoundError:
            self._quarantine(key, "npz present but meta missing (torn store)")
            return None
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            self._quarantine(key, f"unreadable meta ({type(e).__name__})")
            return None
        from .session import SUPPORTED_VERSIONS

        if (
            meta.get("format") != CACHE_FORMAT
            or meta.get("version") not in SUPPORTED_VERSIONS
            or meta.get("cache_version") != CACHE_VERSION
            or meta.get("key") != key
        ):
            # a valid entry from a different build/derivation: plain miss
            return None
        try:
            with np.load(npz_path) as data:
                arrays = {k: np.asarray(data[k]) for k in data.files}
        except FileNotFoundError:
            self._quarantine(key, "meta present but npz missing (torn store)")
            return None
        except Exception as e:  # noqa: BLE001 — zip/pickle/format errors
            self._quarantine(key, f"corrupt npz ({type(e).__name__})")
            return None
        # round-trip sanity: a truncated npz must be a miss, not a
        # KeyError three layers down
        try:
            hm_meta = meta["heatmap"]
            n_regions = len(hm_meta["regions"])
        except (KeyError, TypeError):
            self._quarantine(key, "malformed heatmap metadata")
            return None
        for i in range(n_regions):
            for part in ("tags", "word_temps", "sector_temps"):
                if f"r{i}_{part}" not in arrays:
                    self._quarantine(
                        key, f"truncated npz (missing r{i}_{part})"
                    )
                    return None
        return hm_meta, arrays

    def _quarantine(self, key: str, why: str) -> None:
        """Move a defective disk entry out of the lookup path.

        Both halves of the entry go to ``<dir>/quarantine/`` (kept, not
        deleted — an operator may want the evidence), the defect is
        counted in ``stats.corrupt``, and the first hit per key warns.
        Best-effort: a failure to quarantine still leaves the lookup a
        miss, it just costs the scan again next time.
        """
        import warnings

        npz_path, meta_path = self._entry_paths(key)
        qdir = self.path / "quarantine"
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            for p in (npz_path, meta_path):
                if not p.exists():
                    continue
                target = qdir / p.name
                k = 1
                while target.exists():
                    k += 1
                    target = qdir / f"{p.stem}-{k}{p.suffix}"
                p.rename(target)
        except OSError:
            pass
        first = False
        with self._lock:
            self.stats.corrupt += 1
            if key not in self._corrupt_warned:
                self._corrupt_warned.add(key)
                first = True
        if first:
            warnings.warn(
                f"collection cache entry {key[:12]}...: {why}; moved to "
                f"{qdir} (the profile re-collects)",
                RuntimeWarning,
                stacklevel=4,
            )

    # -- store --------------------------------------------------------------
    def put(self, key: str, hm: Heatmap) -> None:
        """Store one collected heat map under its content key.

        The canonical (collection-path-independent) form is stored, shard
        and fault provenance stripped: they belong to one collection, not
        to the content.  Nothing but the heat map is stored.
        """
        from .session import ARTIFACT_VERSION, heatmap_to_arrays

        canonical = dataclasses.replace(hm, shards=(), faults=())
        meta, arrays = heatmap_to_arrays(canonical)
        with self._lock:
            self._mem[key] = (meta, arrays)
            self.stats.stores += 1
        if self.path is None:
            return
        npz_path, meta_path = self._entry_paths(key)
        try:
            npz_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = npz_path.with_suffix(".npz.tmp")
            with open(tmp, "wb") as f:
                np.savez_compressed(f, **arrays)
            tmp.replace(npz_path)
            # the meta commits atomically too: a kill mid-store then
            # leaves either no meta (quarantined as a torn pair on the
            # next lookup) or a complete one — never a JSON prefix
            mtmp = meta_path.with_suffix(".json.tmp")
            with open(mtmp, "w") as f:
                json.dump(
                    {
                        "format": CACHE_FORMAT,
                        "version": ARTIFACT_VERSION,
                        "cache_version": CACHE_VERSION,
                        "key": key,
                        "kernel": canonical.kernel,
                        "heatmap": meta,
                        "provenance": {
                            "created": time.time(),
                            "python": sys.version.split()[0],
                            "sampler": canonical.sampler,
                        },
                    },
                    f,
                    indent=2,
                )
            mtmp.replace(meta_path)
        except Exception:  # noqa: BLE001 — a full disk must not kill a run
            pass

    # -- bookkeeping --------------------------------------------------------
    def note_uncacheable(self) -> None:
        """Count one profile whose spec could not be content-hashed."""
        with self._lock:
            self.stats.uncacheable += 1

    def clear_memory(self) -> None:
        """Drop the in-memory tier (disk entries survive) — test hook."""
        with self._lock:
            self._mem.clear()

    def __len__(self) -> int:
        return len(self._mem)


__all__ = [
    "CACHE_FORMAT",
    "CACHE_VERSION",
    "CacheKeyError",
    "CacheStats",
    "CollectionCache",
    "callable_fingerprint",
    "spec_content_hash",
]
