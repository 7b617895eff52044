"""Decoder-stack composition: blocks, layer layouts, the layer loop.

A *block* = mixer (attention / MLA / mamba) + FFN (dense MLP / MoE /
none), pre-norm residual.  An architecture is a *layout*: a list of
:class:`BlockKind` s.  The JAX package (``repro/models/transformer.py``)
compresses a layout into *segments* — (pattern, repeats) pairs — and
scans each over stacked parameters; the port keeps :func:`segments` (the
weights carried across from the reference are unstacked by it) but runs
one block per layer in a Python loop, each layer's parameters its own
module in an ``nn.ModuleList`` and each layer's cache its own dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .attention import AttnConfig, MLAConfig
from .layers import (
    gelu_mlp,
    gelu_mlp_defs,
    layernorm,
    layernorm_defs,
    rmsnorm,
    rmsnorm_defs,
    swiglu,
    swiglu_defs,
)
from .mamba import SSMConfig
from .moe import MoEConfig
from .params import ParamDef

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BlockKind:
    """One decoder block: its token mixer and its feed-forward."""

    mixer: str  # 'attn' | 'mla' | 'mamba'
    ffn: str  # 'mlp' | 'moe' | 'none'

    def tag(self) -> str:
        return f"{self.mixer}_{self.ffn}"


@dataclasses.dataclass(frozen=True)
class StackConfig:
    """Everything the decoder stack needs (built by ModelConfig)."""

    d_model: int
    d_ff: int
    layout: Tuple[BlockKind, ...]
    mlp_kind: str = "swiglu"  # 'swiglu' | 'gelu'
    attn: Optional[AttnConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-6
    remat: str = "none"  # 'none' | 'full': each block recomputed in the backward
    # optional activation-layout constraint applied to the residual stream
    # at every block boundary (the dry-run installs a sequence-parallel
    # (batch, seq-over-model, none) constraint here)
    act_constraint: Any = None
    # optional layout applied to a block's normed input before its mixer and
    # dense FFN, and to the final norm's output before the unembedding: the
    # dry-run gathers the sequence there (batch, none, none), the all-gather
    # a sequence-parallel layout makes before its products.  A product of a
    # (batch, seq, d) activation split over both leading dims would flatten
    # them, which torch 2.11's DTensor refuses.
    act_gather: Any = None


def segments(layout: Sequence[BlockKind]) -> List[Tuple[Tuple[BlockKind, ...], int]]:
    """Compress a layout into (pattern, repeats) segments, as the
    reference does: whole-layout periodicity first (jamba), else maximal
    runs of identical kinds (deepseek's dense prefix).  Lossless."""
    n = len(layout)
    for p in range(1, n // 2 + 1):
        if n % p:
            continue
        pattern = tuple(layout[:p])
        if all(layout[i] == pattern[i % p] for i in range(n)):
            if n // p > 1 and len(set(pattern)) > 1 or p == 1:
                return [(pattern, n // p)]
    segs: List[Tuple[Tuple[BlockKind, ...], int]] = []
    i = 0
    while i < n:
        j = i
        while j < n and layout[j] == layout[i]:
            j += 1
        segs.append(((layout[i],), j - i))
        i = j
    return segs


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------


def _norm_defs(cfg: StackConfig) -> Dict[str, ParamDef]:
    return layernorm_defs(cfg.d_model) if cfg.norm == "layernorm" else rmsnorm_defs(cfg.d_model)


def _norm(cfg: StackConfig, params, x: Tensor) -> Tensor:
    if cfg.norm == "layernorm":
        return layernorm(params, x, cfg.norm_eps)
    return rmsnorm(params, x, cfg.norm_eps)


def block_defs(cfg: StackConfig, kind: BlockKind) -> Dict[str, Any]:
    defs: Dict[str, Any] = {"norm_mixer": _norm_defs(cfg)}
    if kind.mixer == "attn":
        defs["attn"] = attn_mod.attn_defs(cfg.attn)
    elif kind.mixer == "mla":
        defs["mla"] = attn_mod.mla_defs(cfg.mla)
    elif kind.mixer == "mamba":
        defs["mamba"] = mamba_mod.mamba_defs(cfg.ssm)
    else:
        raise ValueError(kind.mixer)
    if kind.ffn == "mlp":
        defs["norm_ffn"] = _norm_defs(cfg)
        defs["mlp"] = (
            gelu_mlp_defs(cfg.d_model, cfg.d_ff)
            if cfg.mlp_kind == "gelu"
            else swiglu_defs(cfg.d_model, cfg.d_ff)
        )
    elif kind.ffn == "moe":
        defs["norm_ffn"] = _norm_defs(cfg)
        defs["moe"] = moe_mod.moe_defs(cfg.moe)
    elif kind.ffn != "none":
        raise ValueError(kind.ffn)
    return defs


def gathered(cfg: StackConfig, h: Tensor) -> Tensor:
    """``h`` laid out by ``cfg.act_gather`` (as it is without one)."""
    return h if cfg.act_gather is None else cfg.act_gather(h)


def _scattered(cfg: StackConfig, y: Tensor) -> Tensor:
    """A gathered sublayer's output laid out as the residual stream before
    the add, so that its gradient comes back in the gathered layout."""
    return y if cfg.act_gather is None else cfg.act_constraint(y)


def block_apply(
    params: Dict[str, Any],
    x: Tensor,
    positions: Tensor,
    cfg: StackConfig,
    kind: BlockKind,
    cache: Optional[Dict[str, Any]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Any]], Tensor]:
    """Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.act_constraint is not None:
        x = cfg.act_constraint(x)
    h = gathered(cfg, _norm(cfg, params["norm_mixer"], x))
    if kind.mixer == "attn":
        y, new_cache = attn_mod.attn_apply(params["attn"], h, positions, cfg.attn, cache)
    elif kind.mixer == "mla":
        pos1d = positions if positions.ndim == 2 else positions[..., 0]
        y, new_cache = attn_mod.mla_apply(params["mla"], h, pos1d, cfg.mla, cache)
    else:
        y, new_cache = mamba_mod.mamba_apply(params["mamba"], h, cfg.ssm, cache)
    x = x + _scattered(cfg, y)
    if kind.ffn == "mlp":
        h = gathered(cfg, _norm(cfg, params["norm_ffn"], x))
        mlp = gelu_mlp if cfg.mlp_kind == "gelu" else swiglu
        x = x + _scattered(cfg, mlp(params["mlp"], h))
    elif kind.ffn == "moe":
        h = _norm(cfg, params["norm_ffn"], x)
        # the routed experts take h as it is (EP's exchange splits its tokens
        # over the model axis), the shared experts' products the gathered h
        y, moe_aux = moe_mod.moe_apply(params["moe"], h, cfg.moe, shared_in=gathered(cfg, h))
        x = x + y
        aux = aux + moe_aux
    if cfg.act_constraint is not None:
        # the output too: it is what the backward keeps per layer
        x = cfg.act_constraint(x)
    return x, new_cache, aux


def block_cache(
    kind: BlockKind, cfg: StackConfig, batch: int, max_seq: int,
    dtype: Any = torch.bfloat16, device: Any = None,
) -> Dict[str, Any]:
    if kind.mixer == "attn":
        return attn_mod.init_cache(batch, max_seq, cfg.attn.n_kv_heads, cfg.attn.head_dim,
                                   dtype, device)
    if kind.mixer == "mla":
        return attn_mod.init_mla_cache(batch, max_seq, cfg.mla, dtype, device)
    return mamba_mod.init_mamba_cache(batch, cfg.ssm, dtype, device)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def remat_wrap(fn, remat: str, caches: Any):
    """``fn``, or ``fn`` under ``torch.utils.checkpoint`` when ``remat`` is
    ``"full"``, there are no caches and autograd is recording."""
    if remat != "full" or caches is not None or not torch.is_grad_enabled():
        return fn

    def recomputed(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    return recomputed


def stack_caches(
    cfg: StackConfig, batch: int, max_seq: int,
    dtype: Any = torch.bfloat16, device: Any = None,
) -> List[Dict[str, Any]]:
    """One cache per layer, in layer order."""
    return [block_cache(kind, cfg, batch, max_seq, dtype, device) for kind in cfg.layout]


def stack_apply(
    layers: Sequence[Dict[str, Any]],
    x: Tensor,
    positions: Tensor,
    cfg: StackConfig,
    caches: Optional[Sequence[Dict[str, Any]]] = None,
) -> Tuple[Tensor, Optional[List[Dict[str, Any]]], Tensor]:
    """Run the full stack: each layer's parameters (and cache) in turn.
    Returns (x, new_caches, total_aux_loss).  With ``remat == "full"`` a
    pass that records gradients keeps only each block's input and
    recomputes the block in the backward (the reference's
    ``jax.checkpoint``); prefill and decode never do."""
    new_caches: Optional[List[Dict[str, Any]]] = [] if caches is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    run = remat_wrap(block_apply, cfg.remat, caches)
    for i, (params, kind) in enumerate(zip(layers, cfg.layout)):
        cache = caches[i] if caches is not None else None
        x, nc, aux = run(params, x, positions, cfg, kind, cache)
        aux_total = aux_total + aux
        if new_caches is not None:
            new_caches.append(nc)
    return x, new_caches, aux_total
