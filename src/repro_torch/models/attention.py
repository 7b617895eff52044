"""Attention: GQA/MHA (chunked online softmax), KV caches, sliding window, MLA.

The port of the JAX package's ``repro/models/attention.py``.  Its forward
reaches no hand-written kernel, in either package: ``flash_xla`` is an
online-softmax loop over KV chunks in plain PyTorch (the JAX package's is
a ``lax.scan`` in XLA), ``attention_ref`` the O(S^2) oracle that decode
uses.  Routing them through the port's flash kernel is a decision left
to be measured (ROADMAP, "Later").

Score and value products accumulate and return float32 for
half-precision operands, as the reference's
``preferred_element_type=jnp.float32`` does (:func:`matmul_acc`).
``flash_xla``'s backward is the reference's custom VJP: it recomputes
each chunk's probabilities from the saved logsumexp, so nothing of size
Sq x Skv is kept for it.

KV caches are dicts of buffers plus a ``length``; writes are functional
(:func:`update_seq_buffer` returns a new buffer), as the reference's are.
The ``length`` is a Python int that every row shares (the model forward,
training, the dry-run), or a (B,) int64 tensor on the cache's device
whose row b is row b's own length (the serving ``Server``, whose slots
hold requests of different lengths): a one-token write then puts row b's
K/V at ``length[b]``, and row b's key mask and RoPE position follow its
own length.  A model step on such caches goes through :func:`row_step`,
which builds the write mask and the next lengths once for every layer,
so the layers keep sharing one length tensor.  The tensor form writes one
token at a time and stays off the dry-run's DTensor path.  There is no
ring buffer: a sliding window masks the full buffer, as in the reference.

MLA (DeepSeek-V2/V3 multi-head latent attention) caches the latent plus
the rope key only; decode uses the absorbed formulation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..parallel.context import constrain_logical, keep_layout, pad, split_dim
from .layers import apply_mrope, apply_rope, hi_dtype, rmsnorm, rmsnorm_defs
from .params import ParamDef

Tensor = torch.Tensor
NEG_INF = -1e30
_HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    use_rope: bool = True
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    sliding_window: Optional[int] = None
    chunk: int = 512  # kv chunk of the online-softmax loop

    @property
    def q_groups(self) -> int:
        return self.n_heads // self.n_kv_heads


def attn_defs(cfg: AttnConfig) -> Dict[str, ParamDef]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "kv")),
        "wk": ParamDef((d, kv, hd), ("embed", "heads", "kv")),
        "wv": ParamDef((d, kv, hd), ("embed", "heads", "kv")),
        "wo": ParamDef((h, hd, d), ("heads", "kv", "embed"), init="out_proj"),
    }


# ---------------------------------------------------------------------------
# products with a float32 result
# ---------------------------------------------------------------------------


def matmul_acc(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` (batched over broadcast leading dims) with a float32
    result for half-precision operands: JAX's
    ``preferred_element_type=float32``.  On the card ``bmm``'s
    ``out_dtype`` keeps them on the tensor cores; elsewhere they are
    upcast first."""
    if a.dtype not in _HALF:
        return a @ b
    if not a.is_cuda:
        return a.float() @ b.float()
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(*lead, a.shape[-2], b.shape[-1])


class _MergeDims(torch.autograd.Function):
    """``t.flatten(dim, dim + 1)``, whose gradient is split back with
    :func:`split_dim` (on a mesh, a split that the heads do not divide is
    gathered first)."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.split = dim, tuple(t.shape[dim:dim + 2])
        return t.flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, grad):
        return split_dim(grad, ctx.dim, ctx.split), None


def _proj(x: Tensor, w: Tensor) -> Tensor:
    """``einsum('bsd,dhk->bshk')``: x times a (d, heads, head_dim) weight."""
    d, h, k = w.shape
    return split_dim(x @ _MergeDims.apply(w.to(x.dtype), 1), -1, (h, k))


def _out(o: Tensor, w: Tensor) -> Tensor:
    """``einsum('bshk,hkd->bsd')``: heads back to the model width."""
    return _MergeDims.apply(o, o.dim() - 2) @ _MergeDims.apply(w.to(o.dtype), 0)


# ---------------------------------------------------------------------------
# chunked online-softmax attention
# ---------------------------------------------------------------------------


def _chunk_mask(kpos, qpos, skv, causal, window, kv_length):
    mask = kpos < skv  # padding tail
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if kv_length is not None:
        mask = mask & (kpos < kv_length)
    return mask


def _grouped(q: Tensor, n_kv: int) -> Tensor:
    """(B, Sq, H, D) -> (B, KV, G*Sq, D), scaled by 1/sqrt(D): the query
    heads grouped under their KV head."""
    b, sq, h, d = q.shape
    g = h // n_kv
    scale = 1.0 / math.sqrt(d)
    return (split_dim(q, 2, (n_kv, g)).permute(0, 2, 3, 1, 4) * scale).reshape(
        b, n_kv, g * sq, d)


def _chunk_scores(q5, k, c0, chunk, qpos, skv, causal, window, kv_length):
    """The masked scaled scores of one KV chunk, (B, KV, G, Sq, c) in
    float32 (float64 for float64 operands), and the chunk's K (B, KV, D, c)."""
    b, kvh, gsq, _ = q5.shape
    sq = qpos.shape[-2]
    kc = k[:, c0 : c0 + chunk].permute(0, 2, 3, 1)
    c = kc.shape[-1]
    s = matmul_acc(q5, kc).reshape(b, kvh, gsq // sq, sq, c)
    kpos = c0 + torch.arange(c, device=q5.device)
    mask = _chunk_mask(kpos, qpos, skv, causal, window, kv_length)
    return torch.where(mask, s, NEG_INF), kc


def _flash_fwd(q, k, v, q_positions, kv_length, causal, window, chunk):
    """Online-softmax forward: (out5 (B, KV, G, Sq, D), lse (B, KV, G, Sq))
    in float32 (float64 for float64 operands)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(chunk, skv)
    acc_t = hi_dtype(q)
    q5 = _grouped(q, kvh)
    qpos = q_positions[:, None, None, :, None]
    m = torch.full((b, kvh, g, sq), NEG_INF, dtype=acc_t, device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=acc_t, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, d), dtype=acc_t, device=q.device)
    for c0 in range(0, skv, chunk):
        s, _ = _chunk_scores(q5, k, c0, chunk, qpos, skv, causal, window, kv_length)
        vc = v[:, c0 : c0 + chunk].permute(0, 2, 1, 3)  # (B, KV, c, D)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.clamp(m_new, min=-0.5e30)  # fully-masked row guard
        p = torch.exp(s - m_safe[..., None])
        corr = torch.exp(m - m_safe)
        l = l * corr + p.sum(dim=-1)
        pv = matmul_acc(p.to(vc.dtype).reshape(b, kvh, g * sq, -1), vc)
        acc = acc * corr[..., None] + pv.reshape(b, kvh, g, sq, d)
        m = m_safe
    l = torch.clamp(l, min=1e-30)
    return acc / l[..., None], m + torch.log(l)


def _flash_bwd(q, k, v, q_positions, kv_length, causal, window, chunk, out5, lse, dout):
    """The reference's ``_flash_bwd``: each chunk's probabilities
    recomputed from the saved logsumexp, nothing of size Sq x Skv kept."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(chunk, skv)
    acc_t = hi_dtype(q)
    q5 = _grouped(q, kvh)
    qpos = q_positions[:, None, None, :, None]
    do5 = dout.reshape(b, sq, kvh, g, d).permute(0, 2, 3, 1, 4).to(acc_t)
    delta = (do5 * out5).sum(dim=-1)  # rowsum(dO * O), (B, KV, G, Sq)
    do4 = do5.reshape(b, kvh, g * sq, d)
    q4 = q5.to(acc_t)
    dq = torch.zeros((b, kvh, g * sq, d), dtype=acc_t, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, skv, chunk):
        s, kc = _chunk_scores(q5, k, c0, chunk, qpos, skv, causal, window, kv_length)
        p = torch.exp(s - lse[..., None])  # exact probabilities, recomputed
        c = p.shape[-1]
        p4 = p.reshape(b, kvh, g * sq, c)
        vc = v[:, c0 : c0 + chunk].permute(0, 2, 1, 3).to(acc_t)  # (B, KV, c, D)
        dvs.append(p4.transpose(-1, -2) @ do4)
        dp = (do4 @ vc.transpose(-1, -2)).reshape(b, kvh, g, sq, c)
        ds = (p * (dp - delta[..., None])).reshape(b, kvh, g * sq, c)  # d(scaled scores)
        dq = dq + ds @ kc.to(acc_t).transpose(-1, -2)
        dks.append(ds.transpose(-1, -2) @ q4)
    dq = dq.reshape(b, kvh, g, sq, d) * (1.0 / math.sqrt(d))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3)  # (B, Skv, KV, D)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashXLA(torch.autograd.Function):
    """The reference's ``jax.custom_vjp``: the forward saves its output
    (float32) and the rows' logsumexp; the backward recomputes."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_length, causal, window, chunk):
        out5, lse = _flash_fwd(q, k, v, q_positions, kv_length, causal, window, chunk)
        ctx.save_for_backward(q, k, v, q_positions, out5, lse)
        ctx.static = (kv_length, causal, window, chunk)
        b, sq, h, d = q.shape
        return out5.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_positions, out5, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, q_positions, *ctx.static, out5, lse, dout)
        return dq, dk, dv, None, None, None, None, None


def _per_rank_heads(fn, q: Tensor, k: Tensor, v: Tensor, q_positions: Tensor, *args):
    """``fn(q, k, v, q_positions, *args)``; on a mesh (DTensor ``q``), each
    rank runs it on its batch rows and query heads.  The KV heads are
    repeated to the query heads first (replicated over the model axis,
    then split like the query heads), so each rank's heads are whole: the
    chunked attention's reshapes and its autograd Function never meet a
    split they cannot lay out."""
    from torch.distributed.tensor import DTensor

    if not isinstance(q, DTensor):
        return fn(q, k, v, q_positions, *args)
    b, sk, kvh, d = k.shape
    h = q.shape[2]
    heads = ("act_batch", None, "heads", None)
    q = constrain_logical(q, heads)

    def spread(t: Tensor) -> Tensor:
        t = constrain_logical(t, ("act_batch", None, None, None))
        t = t[:, :, :, None, :].expand(b, sk, kvh, h // kvh, d).reshape(b, sk, h, d)
        return constrain_logical(t, heads)

    mesh = q.device_mesh
    pos = _batch_rows(q_positions, q)
    out = fn(q.to_local(), spread(k).to_local(), spread(v).to_local(), pos, *args)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)


def _batch_rows(t: Tensor, like) -> Tensor:
    """This rank's rows of ``t`` (the same full tensor on every rank),
    split over the batch as ``like`` (a DTensor) is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = like.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in like.placements]
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return full.redistribute(mesh, pl).to_local()


def flash_xla(
    q: Tensor,  # (B, Sq, H, D)
    k: Tensor,  # (B, Skv, KV, D)
    v: Tensor,  # (B, Skv, KV, D)
    q_positions: Tensor,  # (B, Sq) int
    kv_length: Optional[int] = None,  # valid cache length
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 512,
) -> Tensor:
    """Online-softmax attention looped over KV chunks.  Exact; O(chunk)
    live scores.  The last chunk is the tail itself, where the reference
    pads it and masks the pad: the pad's probabilities are exactly 0.
    Its backward recomputes each chunk's probabilities (:class:`_FlashXLA`)."""
    return _FlashXLA.apply(q, k, v, q_positions, kv_length, causal, window, chunk)


def _length_mask(length: Any) -> Any:
    """A cache length laid out against (B, H, Sq, Skv) scores: an int as it
    is, a per-row (B,) tensor as (B, 1, 1, 1)."""
    if isinstance(length, Tensor) and length.ndim == 1:
        return length.view(-1, 1, 1, 1)
    return length


def attention_ref(
    q: Tensor, k: Tensor, v: Tensor,
    q_positions: Tensor,
    kv_length: Any = None,  # an int, or (B,) per-row lengths
    causal: bool = True,
    window: Optional[int] = None,
) -> Tensor:
    """Naive O(S^2) oracle (tests + decode)."""
    b, sq, h, d = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = matmul_acc(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))  # (B, H, Sq, Skv)
    s = s / math.sqrt(d)
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    qpos = q_positions[:, None, :, None]
    mask = torch.ones_like(s, dtype=torch.bool)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if kv_length is not None:
        mask = mask & (kpos < _length_mask(kv_length))
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = matmul_acc(p.to(v.dtype), v.permute(0, 2, 1, 3))  # (B, H, Sq, D)
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(
    batch: int, max_seq: int, n_kv: int, head_dim: int,
    dtype: Any = torch.bfloat16, device: Any = None,
) -> Dict[str, Any]:
    return {
        "k": torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, n_kv, head_dim), dtype=dtype, device=device),
        "length": 0,
    }


def update_seq_buffer(buf: Tensor, new: Tensor, idx: Any) -> Tensor:
    """``buf`` with ``new`` written along axis 1 at position ``idx`` (a new
    tensor; ``buf`` is unchanged).  As the reference: a full-length write
    replaces the buffer, a one-token write outside the buffer writes
    nothing (its one-hot select hits no row), and a longer write starts
    where it fits (``dynamic_update_slice`` wraps a negative start once
    and clamps it)."""
    s, cap = new.shape[1], buf.shape[1]
    new = new.to(buf.dtype)
    if s == cap:
        return new
    idx = int(idx)
    out = buf.clone()
    if s == 1:
        if 0 <= idx < cap:
            out[:, idx : idx + 1] = new
        return out
    start = min(max(idx + cap if idx < 0 else idx, 0), cap - s)
    out[:, start : start + s] = new
    return out


def row_step(caches: Any, lengths: Tensor) -> Any:
    """The caches of a one-token step at per-row ``lengths`` ((B,) int64):
    each layer's dict also holds the step's write mask ``hit`` ((B, S):
    row b's position ``lengths[b]``, none past the buffer) and the lengths
    after it, ``next``, both built once for every layer, so that the
    layers' new caches share one length tensor."""
    cap = next(c[k].shape[1] for c in caches for k in ("k", "c_kv") if k in c)
    step = {"hit": torch.arange(cap, device=lengths.device)[None, :] == lengths[:, None],
            "next": lengths + 1}
    return [dict(c, **step) if "length" in c else c for c in caches]


def _append(cache: Dict[str, Any], key: str, new: Tensor) -> Tensor:
    """``cache[key]`` with ``new`` written at the cache's length.  In a
    :func:`row_step`, one token a row by the reference's one-hot select
    along the sequence: no read back to the host, and nothing written in
    a row whose length is past the buffer."""
    buf = cache[key]
    if "hit" not in cache:
        return update_seq_buffer(buf, new, cache["length"])
    if new.shape[1] != 1:
        raise ValueError(f"per-row cache lengths write one token a step, not {new.shape[1]}")
    hit = cache["hit"]
    return torch.where(hit.view(*hit.shape, *([1] * (buf.ndim - 2))), new.to(buf.dtype), buf)


def _advanced(cache: Dict[str, Any], s: int) -> Any:
    """The cache's length after a write of ``s`` tokens."""
    return cache["next"] if "next" in cache else cache["length"] + s


def cache_update(cache: Dict[str, Any], k_new: Tensor, v_new: Tensor) -> Dict[str, Any]:
    """Append (B, s, KV, D) at the current length (decode: s == 1), or
    one token a row at each row's own length."""
    return {
        "k": _append(cache, "k", k_new),
        "v": _append(cache, "v", v_new),
        "length": _advanced(cache, k_new.shape[1]),
    }


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------


def attn_apply(
    params: Dict[str, Tensor],
    x: Tensor,  # (B, S, d_model)
    positions: Tensor,  # (B, S) int, or (B, S, 3) for m-rope
    cfg: AttnConfig,
    cache: Optional[Dict[str, Any]] = None,
    use_flash: bool = True,
) -> Tuple[Tensor, Optional[Dict[str, Any]]]:
    s = x.shape[1]
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])

    if cfg.use_rope:
        if cfg.mrope_sections is not None:
            q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
            qpos1d = positions[..., 0]
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            qpos1d = positions
    else:
        qpos1d = positions if positions.ndim == 2 else positions[..., 0]

    new_cache = None
    if cache is not None:
        new_cache = cache_update(cache, k, v)
        k_all, v_all = new_cache["k"].to(q.dtype), new_cache["v"].to(q.dtype)
        kv_len = new_cache["length"]
        if s == 1:
            # on a mesh, the one-token query's heads gathered over the model
            # axis: the score products then split the batch alone, where
            # the batch and the heads both split would flatten into a
            # strided layout
            q = constrain_logical(q, ("act_batch", None, None, None))
            out = attention_ref(q, k_all, v_all, qpos1d, kv_length=kv_len,
                                causal=False, window=cfg.sliding_window)
        else:
            out = _per_rank_heads(flash_xla, q, k_all, v_all, qpos1d, kv_len, cfg.causal,
                                  cfg.sliding_window, cfg.chunk)
    elif use_flash:
        out = _per_rank_heads(flash_xla, q, k, v, qpos1d, None, cfg.causal,
                              cfg.sliding_window, cfg.chunk)
    else:
        out = attention_ref(q, k, v, qpos1d, causal=cfg.causal, window=cfg.sliding_window)
    return _out(out, params["wo"]), new_cache


def cross_attn_apply(
    params: Dict[str, Tensor],
    x: Tensor,  # (B, S, d) decoder states
    enc: Tensor,  # (B, S_enc, d) encoder states
    cfg: AttnConfig,
) -> Tensor:
    b, s, _ = x.shape
    q = _proj(x, params["wq"])
    k = _proj(enc, params["wk"])
    v = _proj(enc, params["wv"])
    qpos = torch.arange(s, device=x.device)[None].expand(b, s)
    # on a mesh, per rank on whole heads as the self-attention does: DTensor
    # would otherwise split the encoder's 1500 positions over the model
    # axis in the backward, unevenly, and fail to flatten them
    out = _per_rank_heads(flash_xla, q, k, v, qpos, None, False, None, cfg.chunk)
    return _out(out, params["wo"])


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    chunk: int = 512

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def mla_defs(cfg: MLAConfig) -> Dict[str, Any]:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq_a": ParamDef((d, cfg.q_lora_rank), ("embed", None)),
        "q_norm": rmsnorm_defs(cfg.q_lora_rank)["scale"],
        "wq_b": ParamDef((cfg.q_lora_rank, h, cfg.qk_head_dim), (None, "heads", "kv")),
        "wkv_a": ParamDef((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim), ("embed", None)),
        "kv_norm": rmsnorm_defs(cfg.kv_lora_rank)["scale"],
        "wk_b": ParamDef((cfg.kv_lora_rank, h, cfg.qk_nope_head_dim), (None, "heads", "kv")),
        "wv_b": ParamDef((cfg.kv_lora_rank, h, cfg.v_head_dim), (None, "heads", "kv")),
        "wo": ParamDef((h, cfg.v_head_dim, d), ("heads", "kv", "embed"), init="out_proj"),
    }


def init_mla_cache(
    batch: int, max_seq: int, cfg: MLAConfig,
    dtype: Any = torch.bfloat16, device: Any = None,
) -> Dict[str, Any]:
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype, device=device),
        "k_rope": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim), dtype=dtype, device=device),
        "length": 0,
    }


def _mla_qkv_latent(params, x, positions, cfg: MLAConfig):
    """Shared front: q heads (nope + rope) and the (c_kv, k_rope) latents.
    The down-projections' gradients come back laid out as their outputs
    (:func:`keep_layout`), where DTensor would split their sequence."""
    q_lat = rmsnorm({"scale": params["q_norm"]}, keep_layout(x @ params["wq_a"].to(x.dtype)))
    q = _proj(q_lat, params["wq_b"])
    q_nope = q[..., : cfg.qk_nope_head_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim :], positions, cfg.rope_theta)
    kv = keep_layout(x @ params["wkv_a"].to(x.dtype))
    c_kv = rmsnorm({"scale": params["kv_norm"]}, kv[..., : cfg.kv_lora_rank])
    k_rope = apply_rope(kv[..., cfg.kv_lora_rank :][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _absorb(q_nope: Tensor, wk_b: Tensor) -> Tensor:
    """``einsum('bshk,rhk->bshr')``: q_nope into the latent space."""
    return torch.einsum("bshk,rhk->bshr", q_nope, wk_b.to(q_nope.dtype))


def _expand(lat: Tensor, wv_b: Tensor) -> Tensor:
    """``einsum('bshr,rhk->bshk')``: the attended latent through wv_b."""
    return torch.einsum("bshr,rhk->bshk", lat, wv_b.to(lat.dtype))


def mla_apply(
    params: Dict[str, Tensor],
    x: Tensor,
    positions: Tensor,
    cfg: MLAConfig,
    cache: Optional[Dict[str, Any]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Any]]]:
    """MLA in the absorbed ("MLA-as-MQA") form on every path: one shared
    (R + P)-wide key [c_kv ; k_rope] and the R-wide latent as the value;
    decode scores directly against the latent cache."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_latent(params, x, positions, cfg)
    new_cache = None
    kv_len = None
    if cache is not None:
        c_all = _append(cache, "c_kv", c_kv)
        r_all = _append(cache, "k_rope", k_rope)
        new_cache = {"c_kv": c_all, "k_rope": r_all, "length": _advanced(cache, x.shape[1])}
        if x.shape[1] == 1:
            y = _mla_absorbed_decode(params, q_nope, q_rope, new_cache, cfg, x.dtype)
            return _out(y, params["wo"]), new_cache
        c_kv, k_rope = c_all.to(x.dtype), r_all.to(x.dtype)
        kv_len = new_cache["length"]

    q_all = torch.cat([_absorb(q_nope, params["wk_b"]), q_rope], dim=-1)  # (B,S,H,R+P)
    k_all = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]  # MQA K
    r, p = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    # flash scales by 1/sqrt(R+P); MLA wants 1/sqrt(qk_head_dim)
    q_all = q_all * math.sqrt((r + p) / cfg.qk_head_dim)
    vpad = pad(c_kv[:, :, None, :], (0, p))
    # on a mesh per rank on whole heads, as the GQA path: DTensor would
    # otherwise split the score products' contraction and all-reduce each
    # chunk's f32 scores
    out_lat = _per_rank_heads(flash_xla, q_all, k_all, vpad, positions, kv_len, True, None,
                              cfg.chunk)[..., :r]
    return _out(_expand(out_lat, params["wv_b"]), params["wo"]), new_cache


def _mla_absorbed_decode(params, q_nope, q_rope, cache, cfg: MLAConfig, dtype):
    """Absorbed decode: scores are q_lat . c_kv + q_rope . k_rope, the
    attended value a latent later expanded through wv_b."""
    scale = 1.0 / math.sqrt(cfg.qk_head_dim)
    c_kv = cache["c_kv"].to(dtype)  # (B, T, R)
    k_rope = cache["k_rope"].to(dtype)  # (B, T, P)
    q_lat = _absorb(q_nope, params["wk_b"])  # (B, S, H, R)
    # (B, S*H, R) x (B, R, T) -> (B, H, S, T)
    b, s, h, _ = q_lat.shape
    s_nope = matmul_acc(q_lat.reshape(b, s * h, -1), c_kv.transpose(1, 2))
    s_rope = matmul_acc(q_rope.reshape(b, s * h, -1), k_rope.transpose(1, 2))
    sc = ((s_nope + s_rope) * scale).reshape(b, s, h, -1).permute(0, 2, 1, 3)
    tpos = torch.arange(c_kv.shape[1], device=c_kv.device)[None, None, None, :]
    pr = torch.softmax(torch.where(tpos < _length_mask(cache["length"]), sc, NEG_INF), dim=-1)
    lat = matmul_acc(pr.to(dtype).permute(0, 2, 1, 3).reshape(b, s * h, -1), c_kv)
    return _expand(lat.reshape(b, s, h, -1).to(dtype), params["wv_b"])
