"""Gradient compression with error feedback (distributed-optimization trick).

The port of the JAX package's ``repro/parallel/compression.py``.  It
halves (bf16) or quarters (int8 + scale) the bytes each gradient would
move over a data-parallel all-reduce.  Error feedback keeps the
quantization residual locally and folds it into the next step's
gradient, which preserves convergence.  On one device there is no
all-reduce: the training step compresses and decompresses in place of
one, as the reference's does on a single chip.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

Tensor = torch.Tensor
Tree = Dict[str, Tensor]
Wire = Union[Tensor, Tuple[Tensor, Tensor]]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"  # 'none' | 'bf16' | 'int8'
    error_feedback: bool = True


def init_error_buffer(params: Tree, cfg: CompressionConfig) -> Optional[Tree]:
    if cfg.mode == "none" or not cfg.error_feedback:
        return None
    return {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}


def _q_one(g: Tensor, e: Optional[Tensor], cfg: CompressionConfig):
    gf = g.to(torch.float32) + (e if e is not None else 0.0)
    if cfg.mode == "bf16":
        wire: Wire = gf.to(torch.bfloat16)
        deq = wire.to(torch.float32)
    else:  # int8 with a per-tensor scale: the wire is (payload, scale)
        scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        wire = (q, scale)
        deq = q.to(torch.float32) * scale
    return wire, (gf - deq if cfg.error_feedback else None)


def compress(
    grads: Tree, err: Optional[Tree], cfg: CompressionConfig
) -> Tuple[Dict[str, Wire], Optional[Tree]]:
    """Quantize grads to the wire dtype; return (wire_grads, new_error)."""
    if cfg.mode == "none":
        return grads, err
    if cfg.mode not in ("bf16", "int8"):
        raise ValueError(f"compression mode {cfg.mode!r}: one of none, bf16, int8")
    pairs = {k: _q_one(g, err[k] if err is not None else None, cfg) for k, g in grads.items()}
    wires = {k: w for k, (w, _) in pairs.items()}
    new_err = {k: e for k, (_, e) in pairs.items()} if cfg.error_feedback else None
    return wires, new_err


def decompress(wire: Dict[str, Wire], cfg: CompressionConfig) -> Tree:
    if cfg.mode == "none":
        return wire
    if cfg.mode == "bf16":
        return {k: w.to(torch.float32) for k, w in wire.items()}
    return {k: q.to(torch.float32) * scale for k, (q, scale) in wire.items()}
