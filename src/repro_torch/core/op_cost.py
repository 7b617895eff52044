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

:func:`count` counts a single-device pass.  :func:`count_local` counts
one rank's share of a pass over DTensors (the dry-run): it lets each
DTensor op run its local ops and collectives and counts those, on the
rank's blocks, skipping the global-shape ops DTensor runs on fake
tensors to work out an output's shape; its product FLOPs come from the
same formulas (``flop_registry``) that ``FlopCounterMode`` applies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

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

    @property
    def product_flops(self) -> float:
        """The matrix products' FLOPs alone (FlopCounterMode's count)."""
        return self.flops - self.elementwise_flops

    def as_dict(self) -> Dict[str, float]:
        return {"flops": self.flops, "product_flops": self.product_flops,
                "bytes": self.bytes, "wire_bytes": self.wire_bytes}


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
