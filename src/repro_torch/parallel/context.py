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


def on_mesh(t: torch.Tensor, mesh: Any) -> torch.Tensor:
    """``t`` as a DTensor on ``mesh`` (a plain tensor, the same on every
    rank, is replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def whole_sums(placements) -> tuple:
    """``placements`` with each partial sum replicated: the layout a value
    laid out so takes once its sums are complete, and its gradient's."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if p.is_partial() else p for p in placements)


class _KeepLayout(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the forward's
    input was (a partial sum's gradient replicated)."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, whole_sums(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def keep_layout(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose gradient comes back laid out as ``t`` is (a plain tensor
    as it is).  DTensor lays a gradient out as the ops that made it chose:
    a sequence split over the model axis where the forward had none would
    flatten into the batch in a product's backward, a view torch 2.11's
    DTensor refuses."""
    from torch.distributed.tensor import DTensor

    return _KeepLayout.apply(t) if isinstance(t, DTensor) else t


def _replicated_partials(t: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial placements completed (replicated)."""
    want = whole_sums(t.placements)
    return t if want == tuple(t.placements) else t.redistribute(t.device_mesh, want)


class _Completed(torch.autograd.Function):
    """Partial placements completed, the gradient's too: DTensor's own
    redistribution would send the gradient back as the forward's partial
    type, and refuses a sum's partial for a mean's."""

    @staticmethod
    def forward(ctx, t):
        return _replicated_partials(t)

    @staticmethod
    def backward(ctx, grad):
        return _replicated_partials(grad)


def completed(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its partial sums over mesh dims completed, replicated over
    them (a plain tensor as it is).  For a statistic reduced over a split
    dim, such as a norm's mean square over features split over the model
    axis: DTensor would otherwise complete it by a reduce-scatter over the
    sequence, and the normed output's sequence would stay split."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor) or not any(p.is_partial() for p in t.placements):
        return t
    return _Completed.apply(t)


def pad(x: torch.Tensor, widths, value: float = 0.0) -> torch.Tensor:
    """``F.pad(x, widths, value=value)``.  A DTensor is padded per rank, its
    padded dims gathered first where they are split: torch 2.11's DTensor
    rule for the pad gives one placement whatever the mesh, and its
    redistribution fails on a mesh of two dims."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return F.pad(x, widths, value=value)
    padded = {x.ndim - 1 - i for i in range(len(widths) // 2)
              if widths[2 * i] or widths[2 * i + 1]}
    mesh = x.device_mesh
    want = [Replicate() if (p.is_shard() and p.dim in padded) or (p.is_partial() and value)
            else p for p in x.placements]
    if want != list(x.placements):
        x = x.redistribute(mesh, want)
    shape = list(x.shape)
    for i in range(len(widths) // 2):
        shape[x.ndim - 1 - i] += widths[2 * i] + widths[2 * i + 1]
    return DTensor.from_local(F.pad(x.to_local(), widths, value=value), mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a DTensor ``table`` (an embedding): each rank
    looks its own rows of ``idx`` up in the whole table, gathered, and the
    table's gradient is the sum of the ranks' over the mesh dims that split
    ``idx``.  DTensor's own rules for a vocab-sharded lookup fail on the
    torch versions the port runs on (the gather's mask on torch 2.13, the
    backward's ``index_put`` on torch 2.11); these local ops do not."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    idx = on_mesh(idx, mesh)
    grad = [Partial() if p.is_shard() else Replicate() for p in idx.placements]
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad)
    return DTensor.from_local(whole[idx.to_local()], mesh, idx.placements, run_check=False)
