"""Mixture-of-Experts: top-k routing and two dispatch strategies.

The port of the JAX package's ``repro/models/moe.py``, in plain PyTorch.
Neither package's forward reaches its grouped-matmul kernel: the
reference's ragged path runs ``jax.lax.ragged_dot`` (here one product per
expert's run of sorted rows) and its capacity path einsums.

  * ``'ragged'``  (default) — dropless sort-based dispatch: flatten the
    (token, expert) assignments, sort by expert (stable), run each
    expert's SwiGLU on its rows, unsort, weighted-combine.
  * ``'capacity'`` — GShard-style grouped fixed-capacity dispatch into a
    (G, E, C, d) buffer; tokens beyond an expert's capacity in their
    group are dropped, first come first served in (token, slot) order.
  * ``'ep'`` — the reference's expert parallelism over a device mesh.
    With no mesh (the port shards nothing yet) it is the capacity path,
    as the reference's is without one.

Top-k takes the larger router probability first and, on a tie, the
lower expert id (a stable descending sort), as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .layers import hi
from .params import ParamDef

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    n_shared_experts: int = 0  # DeepSeek-style always-on experts
    capacity_factor: float = 1.25
    moe_impl: str = "ragged"  # 'ragged' | 'capacity' | 'ep'
    aux_loss_weight: float = 0.01


def moe_defs(cfg: MoEConfig) -> Dict[str, ParamDef]:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.1),
        "w_gate": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "w_up": ParamDef((e, d, f), ("expert", "embed", "mlp")),
        "w_down": ParamDef((e, f, d), ("expert", "mlp", "embed"), init="out_proj"),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        defs.update(
            {
                "shared_w_gate": ParamDef((d, fs), ("embed", "mlp")),
                "shared_w_up": ParamDef((d, fs), ("embed", "mlp")),
                "shared_w_down": ParamDef((fs, d), ("mlp", "embed"), init="out_proj"),
            }
        )
    return defs


def _router(params, x2d: Tensor, cfg: MoEConfig):
    """Router logits -> (top-k expert ids, normalized weights, aux loss).
    (The reference's optional router noise is drawn by no caller and is
    not ported.)"""
    logits = hi(x2d @ params["router"].to(x2d.dtype))
    probs = torch.softmax(logits, dim=-1)  # (T, E)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, : cfg.top_k], top_e[:, : cfg.top_k]
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    t = x2d.shape[0]
    me = probs.mean(dim=0)  # mean router prob per expert
    # first-choice counts by scatter: bincount would wait on the card for
    # its output size
    ce = torch.zeros(cfg.n_experts, dtype=probs.dtype, device=probs.device).scatter_add_(
        0, top_e[:, 0], torch.ones(t, dtype=probs.dtype, device=probs.device)) / t
    aux = cfg.n_experts * torch.sum(me * ce) * cfg.aux_loss_weight
    return top_e, top_w.to(x2d.dtype), aux


def _silu_f32(g: Tensor, dtype: torch.dtype) -> Tensor:
    """silu in float32 (float64 for a float64 run), back to ``dtype``."""
    return F.silu(hi(g)).to(dtype)


def _expert_ffn_ragged(params, xs: Tensor, group_sizes, dtype) -> Tensor:
    """SwiGLU of each expert over its run of expert-sorted rows."""
    outs = []
    start = 0
    for e, n in enumerate(group_sizes):
        rows = xs[start : start + n]
        start += n
        g = rows @ params["w_gate"][e].to(dtype)
        u = rows @ params["w_up"][e].to(dtype)
        outs.append((_silu_f32(g, dtype) * u) @ params["w_down"][e].to(dtype))
    return torch.cat(outs, dim=0)


def moe_apply_ragged(
    params: Dict[str, Tensor],
    x: Tensor,  # (B, S, d)
    cfg: MoEConfig,
) -> Tuple[Tensor, Tensor]:
    """Dropless sort-based MoE.  Returns (y, aux_loss)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    t = b * s
    top_e, top_w, aux = _router(params, x2d, cfg)

    flat_e = top_e.reshape(-1)  # (T*k,)
    token_idx = torch.arange(t, device=x.device).repeat_interleave(cfg.top_k)
    order = torch.argsort(flat_e, stable=True)
    xs = x2d[token_idx[order]]  # (T*k, d) gather
    # rows per expert by scatter, which meta tensors run too (bincount's
    # output size is data)
    counts = torch.zeros(cfg.n_experts, dtype=torch.long, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    if x.device.type == "meta":
        # no values (the op sweep): any split of the T*k rows dispatches
        # the same products, FLOPs and bytes
        n, e = flat_e.numel(), cfg.n_experts
        group_sizes = [n // e + (i < n % e) for i in range(e)]
    else:
        group_sizes = counts.tolist()
    ys = _expert_ffn_ragged(params, xs, group_sizes, x.dtype)  # (T*k, d)

    # unsort + weighted combine
    unsorted = torch.empty_like(ys)
    unsorted[order] = ys
    y = torch.einsum("tkd,tk->td", unsorted.reshape(t, cfg.top_k, d), top_w.to(ys.dtype))
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(params, x2d)
    return y.reshape(b, s, d), aux


def capacity(cfg: MoEConfig, s: int) -> int:
    """Slots per (group, expert) for a group of ``s`` tokens."""
    return max(cfg.top_k, int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts))


def moe_apply_capacity(
    params: Dict[str, Tensor],
    x: Tensor,
    cfg: MoEConfig,
) -> Tuple[Tensor, Tensor]:
    """GShard-style grouped capacity dispatch (drops overflow).  A group
    is one row of the batch; capacity is per (group, expert)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    x2d = x.reshape(b * s, d)
    top_e, top_w, aux = _router(params, x2d, cfg)
    cap = capacity(cfg, s)

    ge = top_e.reshape(b, s * k)  # (G, S*k) expert of each (token, slot)
    # (G, S*k, E) one-hot by comparison: F.one_hot checks its range on the
    # host, which waits for the card
    onehot = (ge[..., None] == torch.arange(e, device=x.device)).long()
    # position within the (group, expert) queue: earlier arrivals first
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(dim=-1)
    keep = pos < cap
    e_idx = torch.where(keep, ge, e)  # dropped -> the spare expert row
    p_idx = torch.where(keep, pos, 0)
    tok = torch.arange(s, device=x.device).repeat_interleave(k)[None].expand(b, s * k)
    gi = torch.arange(b, device=x.device)[:, None].expand(b, s * k)

    disp = torch.zeros((b, e + 1, cap, d), dtype=x.dtype, device=x.device)
    disp = disp.index_put((gi, e_idx, p_idx), x[gi, tok])[:, :e]

    g = torch.einsum("gecd,edf->gecf", disp, params["w_gate"].to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", disp, params["w_up"].to(x.dtype))
    h = _silu_f32(g, x.dtype) * u
    eo = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(x.dtype))

    # gather back per (group, token, slot), weight, sum over slots
    yk = eo[gi, e_idx.clamp(0, e - 1), p_idx]  # (G, S*k, d)
    yk = torch.where(keep[..., None], yk, 0.0).reshape(b, s, k, d)
    w = top_w.reshape(b, s, k)
    y = torch.einsum("gskd,gsk->gsd", yk, w.to(yk.dtype)).to(x.dtype)
    if cfg.n_shared_experts:
        y = (y.reshape(b * s, d) + _shared_ffn(params, x2d)).reshape(b, s, d)
    return y, aux


def _shared_ffn(params, x2d: Tensor) -> Tensor:
    g = x2d @ params["shared_w_gate"].to(x2d.dtype)
    u = x2d @ params["shared_w_up"].to(x2d.dtype)
    return (_silu_f32(g, x2d.dtype) * u) @ params["shared_w_down"].to(x2d.dtype)


def moe_apply(
    params: Dict[str, Tensor],
    x: Tensor,
    cfg: MoEConfig,
) -> Tuple[Tensor, Tensor]:
    if cfg.moe_impl in ("ep", "capacity"):
        return moe_apply_capacity(params, x, cfg)
    return moe_apply_ragged(params, x, cfg)


def moe_ref(params: Dict[str, Tensor], x: Tensor, cfg: MoEConfig) -> Tuple[Tensor, Tensor]:
    """Dense oracle: every token through every expert, weighted by the
    full top-k gate.  O(E) compute — tests only."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    top_e, top_w, aux = _router(params, x2d, cfg)
    g = torch.einsum("td,edf->tef", x2d, params["w_gate"].to(x.dtype))
    u = torch.einsum("td,edf->tef", x2d, params["w_up"].to(x.dtype))
    h = _silu_f32(g, x.dtype) * u
    eo = torch.einsum("tef,efd->ted", h, params["w_down"].to(x.dtype))
    w_full = torch.zeros((b * s, cfg.n_experts), dtype=x.dtype, device=x.device)
    w_full = w_full.scatter_add(1, top_e, top_w)
    y = torch.einsum("ted,te->td", eo, w_full)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(params, x2d)
    return y.reshape(b, s, d), aux
