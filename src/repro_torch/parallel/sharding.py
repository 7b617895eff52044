"""Logical-axis sharding rules (MaxText-style) -> a ``DeviceMesh`` layout.

The port of the JAX package's ``repro/parallel/sharding.py``.  Model
code never names mesh axes; it names LOGICAL axes ("embed", "mlp",
"heads", "expert", "vocab", ...).  A :class:`Rules` table maps each
logical axis to zero or more mesh axes.  DP / FSDP / TP / SP / EP are
therefore config choices:

    TP    : "mlp"/"heads"/"vocab"/"expert" -> "model"
    FSDP  : "embed" -> "data" (or ("pod","data") for full sharding)
    DP    : "batch" -> ("pod", "data")
    SP    : "cache_seq" -> "model" (long-context serving)
    EP    : "expert" -> "model"

A :class:`PartitionSpec` names, per tensor dim, the mesh axes that split
it (major to minor, as JAX splits them); :func:`placements` turns one
into DTensor placements on a ``DeviceMesh`` whose dims are named like
the axes, and :func:`distribute_params` lays a parameter dict out by
them (the reference's ``shardings_from_logical`` plus ``device_put``).

Trees here are dicts (the port's parameters are a flat dotted-name
dict), lists (the port's per-layer caches) and leaves.  The reference's
stacked ``"layer"`` dim has no counterpart: the port keeps one tensor
per layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

PyTree = Any


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    axis names (major to minor).  A one-name tuple is the bare name, and a
    spec equals the plain tuple of its entries, as
    ``jax.sharding.PartitionSpec`` does."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = p[0] if len(p) == 1 else p
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def axes_of(part: Any) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s named dims, or the ``shape``
    dict of a shim (the reference tests' ``FakeMesh``)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis name -> tuple of mesh axis names (or () = replicate)."""

    table: Tuple[Tuple[str, Tuple[str, ...]], ...]

    def get(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        for name, axes in self.table:
            if name == logical:
                return axes
        return ()

    def merged(self, axes: Tuple[str, ...], name: str) -> "Rules":
        """The table with each run of ``axes`` named ``name`` (for a flat
        view of the mesh; see :func:`merge_axes`)."""
        return Rules(tuple((logical, axes_of(merge_axes(tuple(mesh_axes), axes, name)))
                           for logical, mesh_axes in self.table))

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        parts = []
        used: set = set()
        for ax in logical_axes:
            axes = tuple(a for a in self.get(ax) if a not in used)
            used.update(axes)
            parts.append(axes or None)
        return PartitionSpec(*parts)


def make_rules(
    *,
    data_axes: Tuple[str, ...] = ("data",),
    model_axis: str = "model",
    fsdp: bool = True,
    fsdp_axes: Optional[Tuple[str, ...]] = None,
    expert_parallel: bool = True,
    expert_axes: Optional[Tuple[str, ...]] = None,  # e.g. ("model","data")
    seq_shard_cache: bool = False,
    extra: Tuple[Tuple[str, Tuple[str, ...]], ...] = (),
) -> Rules:
    """The standard rules table for a (pod?, data, model) mesh, the
    reference's.  ``expert_axes``: the mesh axes the expert dim shards
    over (spanning the data axes too makes each expert device-local)."""
    fsdp_axes = fsdp_axes or ("data",)
    expert_axes = expert_axes or ((model_axis,) if expert_parallel else ())
    # `extra` FIRST: Rules.get returns the first match, so extra entries
    # override the defaults below
    table = list(extra) + [
        ("batch", data_axes),
        ("layer", ()),
        ("embed", fsdp_axes if fsdp else ()),
        ("mlp", (model_axis,)),
        ("heads", (model_axis,)),
        ("kv", ()),
        ("expert", expert_axes),
        ("vocab", (model_axis,)),
        # activations
        ("act_batch", data_axes),
        ("act_seq", ()),
        ("act_embed", ()),
        # caches
        ("cache_batch", data_axes),
        ("cache_heads", (model_axis,)),
        ("cache_seq", (model_axis,) if seq_shard_cache else ()),
    ]
    return Rules(tuple(table))


# ---------------------------------------------------------------------------
# tree helpers
# ---------------------------------------------------------------------------


def _is_logical(x: Any) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree, is_leaf: Callable = None) -> PyTree:
    """``fn`` over the leaves of dicts and lists (tuples are leaves), with
    the matching leaves of ``rest``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def specs_from_logical(logical_tree: PyTree, rules: Rules) -> PyTree:
    """Map a tree of logical-axis tuples to a tree of PartitionSpecs."""
    return tree_map(rules.spec, logical_tree, is_leaf=_is_logical)


def splits_apart(part: Any, axes: Tuple[str, ...]) -> bool:
    """Whether a spec entry names some of ``axes`` other than as one run
    of all of them, in order."""
    named = axes_of(part)
    hit = [a for a in named if a in axes]
    if not hit:
        return False
    i = named.index(hit[0])
    return named[i:i + len(axes)] != tuple(axes)


def merge_axes(part: Any, axes: Tuple[str, ...], name: str) -> Any:
    """A spec entry with its run of ``axes`` named ``name`` (the dim of a
    flat view that carries them); see :func:`splits_apart`."""
    named = axes_of(part)
    if axes[0] not in named:
        return part
    i = named.index(axes[0])
    merged = named[:i] + (name,) + named[i + len(axes):]
    return merged[0] if len(merged) == 1 else merged


def merge_spec_tree(spec_tree: PyTree, axes: Tuple[str, ...], name: str) -> PyTree:
    """Every PartitionSpec of a tree with :func:`merge_axes` applied."""
    return tree_map(lambda sp: PartitionSpec(*(merge_axes(p, axes, name) for p in sp)),
                    spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def spec_leaves(spec_tree: PyTree) -> List[PartitionSpec]:
    """The PartitionSpecs of a tree."""
    out: List[PartitionSpec] = []
    tree_map(out.append, spec_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return out


def fixup_specs(spec_tree: PyTree, shape_tree: PyTree, mesh: Any) -> PyTree:
    """Drop mesh axes from dims they don't divide evenly, keeping the
    prefix of a dim's axes that still divides.  ``shape_tree`` holds
    anything with a ``.shape``; ``mesh`` a ``DeviceMesh`` or an object
    whose ``.shape`` maps axis name to size.

    E.g. an MQA kv-projection (d, 1, 128) cannot shard its singleton
    heads dim over a 16-way model axis: that dim falls back to
    replication."""
    sizes = mesh_shape(mesh)

    def fix(spec: PartitionSpec, shaped) -> PartitionSpec:
        dims = tuple(getattr(shaped, "shape", ()))  # a cache's int length: ()
        parts = list(spec) + [None] * (len(dims) - len(spec))
        out = []
        for d, part in zip(dims, parts):
            axes = axes_of(part)
            if not axes:
                out.append(None)
                continue
            size = math.prod(sizes[a] for a in axes)
            if size == 0 or d % size != 0:
                kept: List[str] = []
                acc = 1
                for a in axes:
                    if d % (acc * sizes[a]) == 0:
                        kept.append(a)
                        acc *= sizes[a]
                out.append(tuple(kept) or None)
            else:
                out.append(part)
        return PartitionSpec(*out)

    return tree_map(fix, spec_tree, shape_tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def cache_specs(cache_tree: PyTree, rules: Rules, mesh: Any = None) -> PyTree:
    """PartitionSpecs for the port's caches (a list of per-layer dicts).

    The reference's policy: batch over the data axes; the model axis
    shards the HEADS dim when divisible, else the SEQUENCE dim
    (flash-decode style).  Feature-dim sharding is never used: it turns
    every score product into a full-matrix reduction.  ``length`` is a
    Python int and gets the empty spec."""
    model_axes = rules.get("cache_heads")
    batch_axes = rules.get("cache_batch")
    sizes = mesh_shape(mesh) if mesh is not None else {}

    def axis_size(axes: Tuple[str, ...]) -> int:
        return math.prod(sizes[a] for a in axes) if mesh is not None else 1

    msize, bsize = axis_size(model_axes), axis_size(batch_axes)
    model_part = model_axes or None
    batch_part = batch_axes or None

    def shard_heads_or_seq(dims, heads_i: int, seq_i: Optional[int], batch_i: int = 0):
        parts: List[Any] = [None] * len(dims)
        if batch_part and dims[batch_i] % max(bsize, 1) == 0 and bsize > 1:
            parts[batch_i] = batch_part
        if model_part and msize > 1:
            if dims[heads_i] % msize == 0 and heads_i != batch_i:
                parts[heads_i] = model_part
            elif seq_i is not None and dims[seq_i] % msize == 0:
                parts[seq_i] = model_part
        return parts

    def layer_specs(cache: Dict[str, Any]) -> Dict[str, PartitionSpec]:
        out = {}
        for name, leaf in cache.items():
            if name == "length":
                out[name] = PartitionSpec()
                continue
            d = tuple(leaf.shape)
            if name in ("k", "v"):  # (B, S, KV, D)
                parts = shard_heads_or_seq(d, heads_i=2, seq_i=1)
            elif name in ("c_kv", "k_rope"):  # (B, S, R): never shard R
                parts = shard_heads_or_seq(d, heads_i=0, seq_i=1)
            elif name == "conv":  # (B, k-1, C)
                parts = shard_heads_or_seq(d, heads_i=2, seq_i=None)
            elif name == "ssm":  # (B, H, P, N)
                parts = shard_heads_or_seq(d, heads_i=1, seq_i=None)
            else:
                parts = [None] * len(d)
            out[name] = PartitionSpec(*parts)
        return out

    return [layer_specs(c) for c in cache_tree]


def constrain(x: torch.Tensor, logical_axes: Sequence[Optional[str]], rules: Rules):
    """Redistribute ``x`` to the placements of ``logical_axes`` on the
    active mesh (a no-op with none, or for a plain tensor)."""
    from .context import use_rules, constrain_logical

    with use_rules(rules):
        return constrain_logical(x, logical_axes)


# ---------------------------------------------------------------------------
# DTensor layout
# ---------------------------------------------------------------------------


def placements(spec: PartitionSpec, mesh: Any) -> Tuple[Any, ...]:
    """The DTensor placements, one per mesh dim, that give each rank the
    block JAX gives the device at the same mesh coordinates.

    JAX splits a dim sharded over several axes major to minor in the
    spec's order; DTensor splits in the order of the mesh's dims.  Where
    the two agree each axis is a ``Shard``; an axis that the spec puts
    after an axis that comes later in the mesh is a ``_StridedShard``
    whose split factor is the product of those later axes' sizes."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    names = list(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    where = {}
    for dim, part in enumerate(spec):
        for pos, a in enumerate(axes_of(part)):
            if a not in sizes:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh has {names}")
            where[a] = (dim, axes_of(part)[:pos])
    out = []
    for i, a in enumerate(names):
        if a not in where:
            out.append(Replicate())
            continue
        dim, major = where[a]
        factor = math.prod(sizes[m] for m in major if names.index(m) > i)
        out.append(Shard(dim) if factor == 1 else _StridedShard(dim, split_factor=factor))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh: Any) -> Tuple[int, ...]:
    """A rank's block of a tensor of ``shape`` laid out by ``spec`` (the
    spec's axes divide their dims, as after :func:`fixup_specs`)."""
    sizes = mesh_shape(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    return tuple(d // math.prod(sizes[a] for a in axes_of(p)) for d, p in zip(shape, parts))


def distribute(t: torch.Tensor, spec: PartitionSpec, mesh: Any):
    """``t`` (the same full tensor on every rank) as a DTensor laid out by
    ``spec``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements(spec, mesh))


def distribute_params(params: Dict[str, torch.Tensor], specs: Dict[str, PartitionSpec],
                      mesh: Any) -> Dict[str, torch.Tensor]:
    """Each parameter as a DTensor laid out by its spec (leaf for leaf;
    ``requires_grad`` kept).  Every rank passes the same full tensors."""
    out = {}
    for name, t in params.items():
        d = distribute(t.detach(), specs[name], mesh)
        out[name] = d.requires_grad_(t.requires_grad)
    return out


def spec_bytes(shapes: Dict[str, Any], specs: Dict[str, PartitionSpec], mesh: Any,
               itemsize: Optional[int] = None) -> int:
    """Bytes of one rank's blocks of the tensors (anything with ``.shape``
    and, unless ``itemsize`` is given, a torch ``.dtype``)."""
    total = 0
    for name, t in shapes.items():
        size = itemsize or torch.empty((), dtype=t.dtype).element_size()
        total += math.prod(local_shape(tuple(t.shape), specs[name], mesh)) * size
    return total
