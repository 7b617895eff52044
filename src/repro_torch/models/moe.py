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
  * ``'ep'`` — expert parallelism over a ``DeviceMesh``: each rank routes
    its own tokens and two all-to-alls move the slots to the ranks that
    hold their experts and back (:func:`moe_apply_ep`).  With no mesh it
    is the capacity path, as the reference's is without one.

Top-k takes the larger router probability first and, on a tie, the
lower expert id (a stable descending sort), as ``jax.lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.context import constrain_logical, on_mesh, whole_sums
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
    ce = torch.zeros(cfg.n_experts, dtype=probs.dtype, device=probs.device).scatter_add(
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
    shared_in: Optional[Tensor] = None,
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
    counts = torch.zeros(cfg.n_experts, dtype=torch.long, device=x.device).scatter_add(
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
    y = y.to(x.dtype).reshape(b, s, d)
    if cfg.n_shared_experts:
        y = y + _shared_out(params, x, shared_in)
    return y, aux


def capacity(cfg: MoEConfig, s: int) -> int:
    """Slots per (group, expert) for a group of ``s`` tokens."""
    return max(cfg.top_k, int(cfg.capacity_factor * s * cfg.top_k / cfg.n_experts))


def moe_apply_capacity(
    params: Dict[str, Tensor],
    x: Tensor,
    cfg: MoEConfig,
    shared_in: Optional[Tensor] = None,
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
    # EP layout: groups stay data-sharded, experts shard over the model
    # axis (the reference measured +9 GiB/layer on deepseek train_4k
    # with the buffers left expert-replicated)
    disp = constrain_logical(disp, ("act_batch", "expert", None, None))

    g = torch.einsum("gecd,edf->gecf", disp, params["w_gate"].to(x.dtype))
    u = torch.einsum("gecd,edf->gecf", disp, params["w_up"].to(x.dtype))
    h = _silu_f32(g, x.dtype) * u
    eo = torch.einsum("gecf,efd->gecd", h, params["w_down"].to(x.dtype))
    eo = constrain_logical(eo, ("act_batch", "expert", None, None))

    # gather back per (group, token, slot), weight, sum over slots
    yk = _take_slots(eo, e_idx.clamp(0, e - 1), p_idx)  # (G, S*k, d)
    yk = torch.where(keep[..., None], yk, 0.0).reshape(b, s, k, d)
    w = top_w.reshape(b, s, k)
    y = torch.einsum("gskd,gsk->gsd", yk, w.to(yk.dtype)).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + _shared_out(params, x, shared_in)
    return y, aux


def _take_slots(eo: Tensor, e_idx: Tensor, p_idx: Tensor) -> Tensor:
    """``eo[g, e_idx[g, j], p_idx[g, j]]`` for each group g: (G, S*k, d).  On
    a mesh each rank takes its groups' slots from its groups' rows of
    ``eo``, gathered over the experts: DTensor's rule for the index fails
    where the groups split over two mesh dims (torch 2.11)."""
    from torch.distributed.tensor import DTensor

    if isinstance(eo, DTensor):
        rows = ("act_batch", None)
        eo = constrain_logical(eo, rows + (None, None))
        e_idx, p_idx = (constrain_logical(on_mesh(t, eo.device_mesh), rows)
                        for t in (e_idx, p_idx))
        out = _take_slots(eo.to_local(), e_idx.to_local(), p_idx.to_local())
        return DTensor.from_local(out, eo.device_mesh, e_idx.placements, run_check=False)
    gi = torch.arange(eo.shape[0], device=eo.device)[:, None].expand_as(e_idx)
    return eo[gi, e_idx, p_idx]


def _shared_ffn(params, x2d: Tensor) -> Tensor:
    g = x2d @ params["shared_w_gate"].to(x2d.dtype)
    u = x2d @ params["shared_w_up"].to(x2d.dtype)
    return (_silu_f32(g, x2d.dtype) * u) @ params["shared_w_down"].to(x2d.dtype)


def _shared_out(params, x: Tensor, shared_in: Optional[Tensor] = None) -> Tensor:
    """The shared experts' output (B, S, d) for the input ``x``, computed on
    ``shared_in`` where given: the same values laid out for the products
    (the dry-run's train step gathers the sequence, which would otherwise
    flatten into the batch split over the model axis), and laid out as
    ``x``."""
    b, s, d = x.shape
    if shared_in is None:
        return _shared_ffn(params, x.reshape(b * s, d)).reshape(b, s, d)
    out = _shared_ffn(params, shared_in.reshape(b * s, d)).reshape(b, s, d)
    if hasattr(x, "placements") and out.placements != whole_sums(x.placements):
        # explicitly, so that the gradient comes back laid out as ``out``
        out = out.redistribute(x.device_mesh, whole_sums(x.placements))
    return out


# ---------------------------------------------------------------------------
# EP: explicit all-to-all expert parallelism
# ---------------------------------------------------------------------------

# (id of a mesh, its expert axes) -> (this rank's process group over those
# axes, the group rank of the member with each expert-parallel index)
_EP_GROUPS: Dict[Tuple[int, Tuple[str, ...]], Tuple[Any, List[int]]] = {}


def _ep_group(mesh, axes: Tuple[str, ...]):
    """The process group over the mesh ``axes`` (this rank's), and for
    each expert-parallel index j (``axes`` major to minor, as JAX numbers
    a device along several axes) the group rank of the member at j."""
    import torch.distributed as dist

    key = (id(mesh), axes)
    if key in _EP_GROUPS:
        return _EP_GROUPS[key]
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh.permute(
        [names.index(a) for a in names if a not in axes] + [names.index(a) for a in axes])
    ranks = ranks.reshape(-1, math.prod(mesh.shape[names.index(a)] for a in axes))
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        group, _ = dist.new_subgroups_by_enumeration([sorted(r.tolist()) for r in ranks])
    me = dist.get_rank()
    mine = next(r.tolist() for r in ranks if me in r.tolist())
    # new groups number their members in rank order
    order = sorted(mine) if len(axes) > 1 else list(mine)
    _EP_GROUPS[key] = (group, [order.index(r) for r in mine])
    return _EP_GROUPS[key]


def _exchange(buf: Tensor, group, where: List[int]) -> Tensor:
    """All-to-all of ``buf`` (ep_size, ...): block j goes to the member at
    expert-parallel index j, and block j of the result came from it."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    n = buf.shape[0]
    inv = [where.index(r) for r in range(n)]  # group rank -> expert-parallel index
    out = all_to_all_single_autograd(buf[inv].reshape(n * buf.shape[1], *buf.shape[2:]),
                                     None, None, group)
    out = out.reshape(buf.shape)
    return out[where]


def moe_apply_ep(
    params: Dict[str, Tensor],
    x: Tensor,  # (B, S, d) — seq must divide the model axis
    cfg: MoEConfig,
    shared_in: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Expert parallelism with explicit all-to-alls (the DeepSeek/GShard
    production pattern), the reference's ``shard_map`` as DTensor local
    compute.

    Layout: tokens enter (batch over the data axes, seq over model); each
    rank routes its local tokens, scatters them into an (E, C, d) send
    buffer (C from the local token count), exchanges it over the expert
    axes so each rank receives the slots of its own E/ep experts, runs
    the local expert FFN and exchanges back: two all-to-alls a layer,
    through the autograd-aware functional collective so gradients cross
    them.  The output is laid out as ``x`` came in, and the shared
    experts are added after the exchange.  Falls back
    to :func:`moe_apply_capacity` as the reference does: no mesh or
    rules, no ``model`` axis, or a sequence or expert count that does not
    divide."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..parallel.context import active_mesh, active_rules
    from ..parallel.sharding import PartitionSpec, mesh_shape, placements

    mesh, rules = active_mesh(), active_rules()
    if mesh is None or rules is None or "model" not in mesh.mesh_dim_names:
        return moe_apply_capacity(params, x, cfg, shared_in)
    sizes = mesh_shape(mesh)
    msize = sizes["model"]
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if s % msize:
        return moe_apply_capacity(params, x, cfg, shared_in)
    batch_axes = tuple(rules.get("act_batch"))
    bsize = math.prod(sizes[a] for a in batch_axes)
    bpart = batch_axes if b % max(bsize, 1) == 0 and bsize > 1 else None
    # the axes over which ranks hold different tokens
    token_axes = {"model"} | set(bpart or ())
    ep_axes = tuple(rules.get("expert")) or ("model",)
    if not set(ep_axes) <= token_axes:
        # ranks with the same tokens would send an expert the same slots
        # twice, and its weights' gradients would count them twice
        ep_axes = ("model",)
    ep_size = math.prod(sizes[a] for a in ep_axes)
    if e % ep_size:
        ep_axes, ep_size = ("model",), msize
    if e % ep_size:
        return moe_apply_capacity(params, x, cfg, shared_in)
    e_local = e // ep_size
    names = mesh.mesh_dim_names
    x_pl = placements(PartitionSpec(bpart, "model", None), mesh)
    w_pl = placements(PartitionSpec(ep_axes, None, None), mesh)
    replicated = placements(PartitionSpec(), mesh)
    # a weight's local gradient is a part of the whole over the axes where
    # ranks see other tokens, and the same value over the others
    summed = [Partial() if a in token_axes else Replicate() for a in names]
    w_grad = [w if a in ep_axes else g for a, w, g in zip(names, w_pl, summed)]
    dtype = x.dtype

    def local(t: Tensor, pl, grad_pl=None) -> Tensor:
        return on_mesh(t, mesh).redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    router_w = local(params["router"], replicated, summed).to(dtype)
    w_gate, w_up, w_down = (local(params[n], w_pl, w_grad).to(dtype)
                            for n in ("w_gate", "w_up", "w_down"))
    x_loc = local(x, x_pl)
    group, where = _ep_group(mesh, ep_axes)

    bl, sl, _ = x_loc.shape
    t = bl * sl
    x2 = x_loc.reshape(t, d)
    probs = torch.softmax(hi(x2 @ router_w), dim=-1)  # (t, E), router replicated
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = (top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)).to(dtype)
    cap = max(k, int(cfg.capacity_factor * t * k / e))

    # local scatter into the (E, C, d) send buffer
    flat_e = top_e.reshape(-1)  # (t*k,)
    onehot = (flat_e[:, None] == torch.arange(e, device=x2.device)).long()
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    keep = pos < cap
    e_idx = torch.where(keep, flat_e, e)
    p_idx = torch.where(keep, pos, 0)
    tok = torch.arange(t, device=x2.device).repeat_interleave(k)
    send = torch.zeros((e + 1, cap, d), dtype=dtype, device=x2.device)
    send = send.index_put((e_idx, p_idx), x2[tok])[:e]

    # exchange: each rank keeps the slots of its own e_local experts
    recv = _exchange(send.reshape(ep_size, e_local, cap, d), group, where)
    xs = recv.transpose(0, 1).reshape(e_local, ep_size * cap, d)
    g = torch.einsum("ecd,edf->ecf", xs, w_gate)
    u = torch.einsum("ecd,edf->ecf", xs, w_up)
    h = _silu_f32(g, dtype) * u
    eo = torch.einsum("ecf,efd->ecd", h, w_down)  # (e_local, ep_size*cap, d)

    # return path
    back = eo.reshape(e_local, ep_size, cap, d).transpose(0, 1)
    mine = _exchange(back.contiguous(), group, where).reshape(e, cap, d)
    yk = mine[e_idx.clamp(0, e - 1), p_idx]
    yk = torch.where(keep[:, None], yk, 0.0).reshape(t, k, d)
    y = torch.einsum("tkd,tk->td", yk, top_w.to(yk.dtype)).reshape(bl, sl, d).to(dtype)

    # load-balance aux (Switch), averaged over model and the batch axes:
    # a sum of each rank's share, so that each rank's gradient is its share
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=probs.dtype, device=probs.device).scatter_add_(
        0, top_e[:, 0], torch.ones(t, dtype=probs.dtype, device=probs.device)) / t
    avg = {"model"} | set(batch_axes)
    n_avg = math.prod(sizes[a] for a in avg)
    aux = e * torch.sum(me * ce) * cfg.aux_loss_weight / n_avg
    aux = DTensor.from_local(aux, mesh, [Partial() if a in avg else Replicate() for a in names],
                             run_check=False).redistribute(mesh, replicated)
    y = DTensor.from_local(y, mesh, x_pl, run_check=False)
    if not isinstance(x, DTensor):  # plain in, plain out
        y, aux = y.full_tensor(), aux.full_tensor()
    elif whole_sums(x.placements) != tuple(x_pl):
        # out as x came in (a prefill's sequence is whole): the residual add
        # would otherwise split the stream's sequence over the model axis
        y = y.redistribute(mesh, whole_sums(x.placements))
    if cfg.n_shared_experts:
        y = y + _shared_out(params, x, shared_in)
    return y, aux


def moe_apply(
    params: Dict[str, Tensor],
    x: Tensor,
    cfg: MoEConfig,
    shared_in: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """``shared_in``: the shared experts' input, where it is laid out apart
    from ``x`` (:func:`_shared_out`)."""
    if cfg.moe_impl == "ep":
        return moe_apply_ep(params, x, cfg, shared_in)
    if cfg.moe_impl == "capacity":
        return moe_apply_capacity(params, x, cfg, shared_in)
    return moe_apply_ragged(params, x, cfg, shared_in)


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
