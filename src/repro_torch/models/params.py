"""Parameter definitions: one source of truth for shape, init and axes.

Model code declares a (nested) dict of :class:`ParamDef` leaves, as the
JAX package's ``repro/models/params.py`` does.  From that declaration:

  * :class:`ParamTree` — an ``nn.Module`` whose dict levels are child
    modules and whose leaves are ``nn.Parameter`` s (``tree()`` hands the
    apply functions the nested dict of tensors they take);
  * :func:`init_params` — a nested dict of initialized tensors, drawn
    from the same distributions as the JAX package's ``_init_leaf`` (the
    same bits are not required: the draws come from a ``torch.Generator``).

Each def's logical axis names (``ParamDef.logical``) give
:func:`logical_specs`, which :mod:`repro_torch.parallel.sharding` maps
to a mesh layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declaration of one parameter tensor."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # logical axis name per dim (None = replicated)
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed' | 'out_proj'
    scale: float = 1.0  # multiplier on the default fan-in scale
    dtype: Any = torch.float32

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"shape {self.shape} and logical {self.logical} rank mismatch"
            )

    def fan_in(self) -> int:
        """Fan-in heuristic: product of all but the last dim (>=1)."""
        if len(self.shape) <= 1:
            return max(1, math.prod(self.shape[:1]))
        return max(1, math.prod(self.shape[:-1]))


def is_def(x: Any) -> bool:
    return isinstance(x, ParamDef)


def leaves(tree: PyTree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested dict (or list), keys sorted as
    ``jax.tree.flatten`` orders them, paths joined with ``/``."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], f"{prefix}{key}/")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from leaves(sub, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def init_leaf_(d: ParamDef, out: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` in place from ``d``'s distribution (the JAX package's
    ``_init_leaf``): zeros, ones, N(0, scale) for embeddings, else a normal
    truncated to +-2 times the fan-in scale (over sqrt 2 for ``out_proj``).
    The draw is made in float32 and cast, as the reference's is."""
    if d.init == "zeros":
        return out.zero_()
    if d.init == "ones":
        return out.fill_(1.0)
    draw = out if out.dtype == torch.float32 else torch.empty(
        out.shape, dtype=torch.float32, device=out.device
    )
    if d.init == "embed":
        draw.normal_(0.0, d.scale, generator=generator)
    else:
        std = d.scale / math.sqrt(d.fan_in())
        if d.init == "out_proj":
            std = std / math.sqrt(2.0)  # GPT-2 style residual-depth damping hook
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        draw.mul_(std)
    if draw is not out:
        out.copy_(draw)
    return out


def materialize(defs: PyTree, device: Any = None, dtype: Any = None) -> PyTree:
    """Uninitialized tensors of the def tree's shapes (``dtype`` overrides
    every leaf's own)."""
    if is_def(defs):
        return torch.empty(defs.shape, dtype=dtype or defs.dtype, device=device)
    if isinstance(defs, dict):
        return {k: materialize(v, device, dtype) for k, v in defs.items()}
    return [materialize(v, device, dtype) for v in defs]


def init_(defs: PyTree, tree: PyTree, generator: torch.Generator) -> PyTree:
    """Initialize ``tree`` (tensors shaped as ``defs``) in place, leaf by
    leaf in flatten order, from ``generator``."""
    got = dict(leaves(tree))
    with torch.no_grad():
        for path, d in leaves(defs):
            init_leaf_(d, got[path], generator)
    return tree


def init_params(
    defs: PyTree,
    generator: torch.Generator,
    dtype: Any = None,
    device: Any = None,
) -> PyTree:
    """Materialize concrete parameters from a def tree."""
    return init_(defs, materialize(defs, device, dtype), generator)


def param_count(defs: PyTree) -> int:
    return sum(math.prod(d.shape) for _, d in leaves(defs))


def param_bytes(defs: PyTree, dtype_bytes: int = 4) -> int:
    return param_count(defs) * dtype_bytes


def merge(*trees: Dict[str, Any]) -> Dict[str, Any]:
    """Shallow-merge def dicts (disjoint keys)."""
    out: Dict[str, Any] = {}
    for t in trees:
        for k, v in t.items():
            if k in out:
                raise KeyError(f"duplicate param key {k}")
            out[k] = v
    return out


class ParamTree(nn.Module):
    """The parameters of a def tree as a module: each dict level a child
    module, each list an ``nn.ModuleList`` of them (one per layer), each
    :class:`ParamDef` an ``nn.Parameter`` of the same name (uninitialized
    until :meth:`init_` fills it)."""

    def __init__(self, defs: Dict[str, Any], device: Any = None, dtype: Any = None):
        super().__init__()
        self.defs = defs
        for key, d in defs.items():
            if is_def(d):
                empty = torch.empty(d.shape, dtype=dtype or d.dtype, device=device)
                self.register_parameter(key, nn.Parameter(empty))
            elif isinstance(d, list):
                self.add_module(key, nn.ModuleList(ParamTree(s, device, dtype) for s in d))
            else:
                self.add_module(key, ParamTree(d, device, dtype))

    def tree(self) -> Dict[str, Any]:
        """The nested dict of tensors the apply functions take."""
        out: Dict[str, Any] = {}
        for key, d in self.defs.items():
            child = getattr(self, key)
            if is_def(d):
                out[key] = child
            elif isinstance(d, list):
                out[key] = [m.tree() for m in child]
            else:
                out[key] = child.tree()
        return out

    def logical_specs(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Dotted parameter name -> logical axis names, the keys of
        ``named_parameters()`` (and of ``reference_plan``)."""
        return logical_specs(self.defs)

    def init_(self, generator: torch.Generator) -> "ParamTree":
        """Initialize every parameter in place from ``generator`` (meta
        parameters hold no values and are left as they are)."""
        if not any(p.is_meta for p in self.parameters()):
            init_(self.defs, self.tree(), generator)
        return self


def logical_specs(defs: PyTree) -> Dict[str, Tuple[Optional[str], ...]]:
    """Dotted parameter name -> its logical axis names (one per dim)."""
    got = dict(leaves(defs))
    return {name: tuple(got[path].logical) for path, name in dotted_names(defs)}


def dotted_names(defs: PyTree) -> List[Tuple[str, str]]:
    """``(leaf path, dotted name)`` of every leaf: the name
    ``ParamTree(defs).named_parameters()`` gives it."""
    return [(path, path.replace("/", ".")) for path, _ in leaves(defs)]
