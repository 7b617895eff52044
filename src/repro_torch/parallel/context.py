"""Active rules and mesh: logical sharding constraints from inside model code.

The port of the JAX package's ``repro/parallel/context.py``.  Model code
stays mesh-agnostic: it calls ``constrain_logical(x, names)`` with
LOGICAL axis names.  When a launcher has activated a rules table
(:func:`use_rules`) and a mesh (:func:`use_mesh`, the counterpart of
JAX's ``with mesh:``) and ``x`` is a DTensor, the call redistributes
``x`` to the placements of those names on that mesh; otherwise it is a
no-op (one device, plain tensors, tests).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Optional, Sequence

import torch

from .sharding import Rules, fixup_specs, placements

_ACTIVE: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "repro_torch_active_rules", default=None
)
_MESH: contextvars.ContextVar[Any] = contextvars.ContextVar("repro_torch_active_mesh",
                                                            default=None)


@contextlib.contextmanager
def use_rules(rules: Rules):
    token = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(token)


def active_rules() -> Optional[Rules]:
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh: Any):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) the one logical
    constraints bind to, as ``with mesh:`` does in JAX."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def active_mesh() -> Any:
    return _MESH.get()


def constrain_logical(x: torch.Tensor, logical_axes: Sequence[Optional[str]]):
    """``x`` redistributed to the fixed-up placements of ``logical_axes``
    (a no-op without active rules and mesh, or for a plain tensor).

    The spec is always bound to the active mesh, never left to
    propagation: the reference records that a silent fallback here cost
    36 GiB of replicated logits on whisper train_4k."""
    from torch.distributed.tensor import DTensor

    rules = _ACTIVE.get()
    mesh = _MESH.get()
    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    if x.device_mesh != mesh:
        raise ValueError(f"constrain_logical: x lies on {x.device_mesh}, the active mesh "
                         f"is {mesh}")
    spec = fixup_specs(rules.spec(logical_axes), x, mesh)
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def split_dim(x: torch.Tensor, dim: int, sizes) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``.  A DTensor split along ``dim`` over
    mesh dims whose ranks the first of ``sizes`` does not divide (e.g. 8
    KV heads of a projection split 16 ways) is gathered along those mesh
    dims first: DTensor cannot lay the split out, where GSPMD pads."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        dim = dim % x.ndim
        mesh = x.device_mesh
        split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        if sizes[0] % math.prod(mesh.size(i) for i in split):
            x = x.redistribute(mesh, [Replicate() if i in split else p
                                      for i, p in enumerate(x.placements)])
    return x.unflatten(dim, sizes)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a DTensor ``table`` (an embedding): each rank
    looks its own rows of ``idx`` up in the whole table, gathered, and the
    table's gradient is the sum of the ranks' over the mesh dims that split
    ``idx``.  DTensor's own rules for a vocab-sharded lookup fail on the
    torch versions the port runs on (the gather's mask on torch 2.13, the
    backward's ``index_put`` on torch 2.11); these local ops do not."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim, run_check=False)
    grad = [Partial() if p.is_shard() else Replicate() for p in idx.placements]
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad)
    return DTensor.from_local(whole[idx.to_local()], mesh, idx.placements, run_check=False)
