"""Op-level cost of a PyTorch computation: FLOPs, bytes and collectives.

The port's counterpart of the JAX package's ``repro/core/hlo_cost.py``
and ``hlo_thermo.py``, which read the compiled XLA HLO text of a model
pass.  PyTorch runs eagerly, so the port counts the aten operations the
pass dispatches instead:

  * **FLOPs** — ``torch.utils.flop_counter.FlopCounterMode`` for the
    matrix products (``mm``, ``bmm``, ``addmm``, convolutions, fused
    attention), 2 per multiply-add; plus, as the reference's HLO count
    does (``hlo_cost``: "~1 flop per output element"), one per element of
    every other op's result, views excepted (``elementwise_flops``).
  * **bytes** — every aten op's distinct input and output tensors, each
    read or written once per op (an in-place op's destination once).
    View ops (and the aliases ``_unsafe_view``, ``alias``, ``detach``)
    move nothing and are skipped.  The sizes are recorded as the
    op runs; no tensor is kept.  An eager op writes its result to memory
    where XLA may fuse a chain into one pass, so this is the eager
    program's traffic, an upper bound on a fused one's.
  * **collectives** — the c10d ops seen (``c10d``, ``_c10d_functional``;
    a functional collective's wait and wrapper are not), with their input
    bytes as wire bytes and neither FLOPs nor HBM bytes: 0 on one device;
    ``by_collective`` splits them by op name, as the reference's
    ``hlo_cost`` splits its collectives.
  * **the level-3 heat block** — each collective of the reference's five
    kinds (``HLO_NAMES``) is also kept as a :class:`Collective` record: its
    kind, its output's shape and dtype and its group's size, read from
    the process group.  :meth:`OpCost.heat` gives from them the
    reference's ``hlo_thermo.HloHeat.as_dict()``: the count, each one's
    ring cost per device, that cost by kind, and the signatures (kind,
    shape, group) seen more than once, the paper's "hot" pattern at the
    fleet level.

:func:`count` counts a single-device pass.  :func:`count_local` counts
one rank's share of a pass over DTensors (the dry-run): it lets each
DTensor op run its local ops and collectives and counts those, on the
rank's blocks, skipping the global-shape ops DTensor runs on fake
tensors to work out an output's shape; its product FLOPs come from the
same formulas (``flop_registry``) that ``FlopCounterMode`` applies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
# ops of those namespaces that move nothing: a functional collective's
# wait and its autograd wrapper
_NOT_COLLECTIVES = ("wait", "_wrap_tensor_autograd")
# aten ops that alias their input without being marked as views
_ALIASES = (torch.ops.aten._unsafe_view, torch.ops.aten.alias, torch.ops.aten.lift_fresh,
            torch.ops.aten.detach)
# c10d op -> the reference's HLO collective (hlo_thermo.COLLECTIVE_OPS): the
# functional ops and the process-group ops they stand for.  A P2P exchange
# is one collective-permute, as the reference's ppermute is one: its send
# is recorded, and the recv that completes it on the other rank is not
HLO_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce",
    "allreduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
# torch dtype -> HLO's element type, for a signature's shape text
_HLO_TYPES = {
    torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16", torch.float64: "f64",
    torch.int8: "s8", torch.int16: "s16", torch.int32: "s32", torch.int64: "s64",
    torch.uint8: "u8", torch.bool: "pred",
}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective as the heat block sees it (the reference's
    ``hlo_thermo.CollectiveStats``): its kind, the shape text of its
    output (HLO's ``f32[8,64]``; a tuple for several tensors), the output's
    bytes and the size of its group."""

    op: str
    shape: str
    out_bytes: int
    group_size: int

    @property
    def wire_bytes_per_device(self) -> float:
        """Ring cost on a group of g with output B bytes: all-reduce
        2(g-1)/g B, a permute B, the others (g-1)/g B."""
        g = max(1, self.group_size)
        if self.op == "all-reduce":
            return 2.0 * (g - 1) / g * self.out_bytes
        if self.op == "collective-permute":
            return float(self.out_bytes)
        return (g - 1) / g * self.out_bytes


def _shape_text(tensors) -> str:
    parts = [f"{_HLO_TYPES.get(t.dtype, str(t.dtype).replace('torch.', ''))}"
             f"[{','.join(map(str, t.shape))}]" for t in tensors]
    return parts[0] if len(parts) == 1 else f"({', '.join(parts)})"


def _group_size(func, args, kwargs) -> int:
    """The size of the group a c10d op runs over: its ``group_size``
    argument, or that of the group it names or is given."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for i, arg in enumerate(func._schema.arguments):
        value = kwargs.get(arg.name, args[i] if i < len(args) else None)
        if arg.name == "group_size" and value is not None:
            return int(value)
        if arg.name == "group_name" and value is not None:
            return _resolve_process_group(value).size()
        if arg.name == "process_group" and value is not None:
            if isinstance(value, torch.ScriptObject):  # the process-group ops' boxed group
                value = ProcessGroup.unbox(value)
            return value.size()
    return 1


def _collective(func, args, kwargs, inputs, outputs):
    """The heat block's record of a c10d op, or None when it is none of
    the reference's five kinds."""
    op = HLO_NAMES.get(func._overloadpacket.__name__)
    if op is None:
        return None
    # the output's shape, as the reference reads it; an op that returns
    # no tensor (a send) moves its input
    tensors = [t for t in outputs if isinstance(t, torch.Tensor)] or [
        t for t in inputs if isinstance(t, torch.Tensor)]
    return Collective(op=op, shape=_shape_text(tensors), out_bytes=_tensor_bytes(tensors),
                      group_size=_group_size(func, args, kwargs))


@dataclasses.dataclass
class OpCost:
    """What one counted computation dispatched."""

    flops: float = 0.0
    elementwise_flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_count: int = 0
    ops: int = 0
    by_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: List[Collective] = dataclasses.field(default_factory=list)

    @property
    def product_flops(self) -> float:
        """The matrix products' FLOPs alone (FlopCounterMode's count)."""
        return self.flops - self.elementwise_flops

    def as_dict(self) -> Dict[str, float]:
        return {"flops": self.flops, "product_flops": self.product_flops,
                "bytes": self.bytes, "wire_bytes": self.wire_bytes}

    def heat(self) -> Dict[str, object]:
        """The level-3 heat block (``layers.hlo.heat``), the reference's
        ``HloHeat.as_dict()`` over the collectives recorded: their count,
        their ring cost per device in all and by kind, and each (kind,
        shape, group) signature seen more than once with its count."""
        by_op: Dict[str, float] = {}
        seen: Dict[Tuple[str, str, int], int] = {}
        for c in self.collectives:
            by_op[c.op] = by_op.get(c.op, 0.0) + c.wire_bytes_per_device
            sig = (c.op, c.shape, c.group_size)
            seen[sig] = seen.get(sig, 0) + 1
        return {
            "collective_count": len(self.collectives),
            "collective_bytes": sum(c.wire_bytes_per_device for c in self.collectives),
            "bytes_by_op": by_op,
            "redundant": [[f"{op} {shape}", n] for (op, shape, _g), n in seen.items() if n > 1],
        }


def _tensor_bytes(tensors) -> int:
    seen = set()
    total = 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        # the storage and the offset into it, so that meta tensors, which
        # have no data pointer, are told apart as real ones are
        key = (t.untyped_storage()._cdata, t.storage_offset(), t.numel(), t.dtype)
        if key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes each dispatched aten op reads and writes, and
    counts the collectives among them."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = OpCost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.ops += 1
        if getattr(func, "is_view", False) or func._overloadpacket in _ALIASES:
            return out
        inputs = tree_leaves((args, kwargs))
        outputs = tree_leaves(out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if not func.__name__.startswith(_NOT_COLLECTIVES):  # bookkeeping
                wire = _tensor_bytes(inputs)
                self.cost.collective_count += 1
                self.cost.wire_bytes += wire
                name = func._overloadpacket.__name__
                self.cost.by_collective[name] = self.cost.by_collective.get(name, 0.0) + wire
                record = _collective(func, args, kwargs, inputs, outputs)
                if record is not None:
                    self.cost.collectives.append(record)
            return out
        self.cost.bytes += _tensor_bytes(inputs + outputs)
        if func._overloadpacket not in flop_registry:
            self.cost.elementwise_flops += sum(
                t.numel() for t in outputs if isinstance(t, torch.Tensor)
            )
        return out


class LocalCounter(ByteCounter):
    """:class:`ByteCounter` for a pass over DTensors: a DTensor op is
    handed back (``NotImplemented``) so that its local ops reach this mode
    on the rank's blocks; fake tensors (DTensor's shape propagation) are
    not counted; products are counted here from ``flop_registry``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **kwargs)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        formula = _LOCAL_FLOPS.get(func._overloadpacket) or flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.cost.flops += formula(*args, **kwargs, out_val=out)
        return out


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **kwargs) -> int:
    """``bmm`` and its ``out_dtype`` overload (whose extra argument the
    stock formula takes for its output shape): 2 * b * m * n * k."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[-1]


def _bmm_local(a, b, *args, out_val=None, **kwargs) -> int:
    return _bmm_flop(tuple(a.shape), tuple(b.shape))


_LOCAL_FLOPS = {torch.ops.aten.bmm: _bmm_local}


def count_local(fn: Callable[[], Any]) -> Tuple[Any, OpCost]:
    """Run ``fn()`` (a pass over DTensors) and count this rank's share:
    (its result, the cost)."""
    with LocalCounter() as counter:
        result = fn()
    counter.cost.flops += counter.cost.elementwise_flops
    return result, counter.cost


def count(fn: Callable[[], Any]) -> Tuple[Any, OpCost]:
    """Run ``fn()`` under the counters; returns (its result, the cost)."""
    flops = FlopCounterMode(display=False, custom_mapping={torch.ops.aten.bmm: _bmm_flop})
    with flops, ByteCounter() as counter:
        result = fn()
    counter.cost.flops = float(flops.get_total_flops()) + counter.cost.elementwise_flops
    return result, counter.cost
