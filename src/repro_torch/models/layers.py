"""Core layers: norms, rotary embeddings (RoPE / M-RoPE), MLPs, embedding.

Plain functions over dicts of tensors, as in the JAX package's
``repro/models/layers.py``.  Computation is dtype-disciplined: params may
be bf16, math that needs precision (norm variance, softmax, rope angles)
runs in float32.  A weight is cast to the activation's dtype before a
product (the JAX package's operands already agree, or promote to it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.context import completed, gather_rows
from .params import ParamDef

Tensor = torch.Tensor


def hi_dtype(t: Tensor) -> torch.dtype:
    """The precision of the math the reference does in float32: float32,
    or float64 for a float64 run."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def hi(t: Tensor) -> Tensor:
    """``t`` in :func:`hi_dtype`."""
    return t.to(hi_dtype(t))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_defs(dim: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((dim,), ("embed",), init="ones")}


def rmsnorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-6) -> Tensor:
    dtype = x.dtype
    xf = hi(x)
    var = completed(torch.mean(xf * xf, dim=-1, keepdim=True))
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].to(xf.dtype)).to(dtype)


def layernorm_defs(dim: int) -> Dict[str, ParamDef]:
    return {
        "scale": ParamDef((dim,), ("embed",), init="ones"),
        "bias": ParamDef((dim,), ("embed",), init="zeros"),
    }


def layernorm(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-5) -> Tensor:
    dtype = x.dtype
    xf = hi(x)
    mu = completed(torch.mean(xf, dim=-1, keepdim=True))
    var = completed(torch.mean((xf - mu) ** 2, dim=-1, keepdim=True))
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(xf.dtype) + params["bias"].to(xf.dtype)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings (rotate-half: the two halves of head_dim pair)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None,
               dtype: torch.dtype = torch.float32) -> Tensor:
    """Inverse frequencies for the even head dims."""
    i = torch.arange(0, head_dim, 2, dtype=dtype, device=device)
    return 1.0 / (theta ** (i / head_dim))


def _rotate(x: Tensor, ang: Tensor) -> Tensor:
    """Rotate-half by angles ``ang`` (..., seq, half): cos/sin in the
    angle's precision, the rotation itself in x's dtype."""
    cos = torch.cos(ang)[..., None, :].to(x.dtype)  # broadcast over heads
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(
    x: Tensor,  # (..., seq, heads, head_dim)
    positions: Tensor,  # (..., seq) int
    theta: float = 10000.0,
) -> Tensor:
    """Rotate-half RoPE: dims i and i + head_dim/2 rotate together."""
    adt = hi_dtype(x)
    inv = rope_freqs(x.shape[-1], theta, x.device, adt)  # (hd/2,)
    ang = positions.to(adt)[..., None] * inv  # (..., seq, hd/2)
    return _rotate(x, ang)


def apply_mrope(
    x: Tensor,  # (..., seq, heads, head_dim)
    positions: Tensor,  # (..., seq, 3) int — (temporal, height, width)
    sections: Tuple[int, int, int],
    theta: float = 1000000.0,
) -> Tensor:
    """Multimodal RoPE (Qwen2-VL §3.1): the head_dim/2 frequency slots are
    split into three consecutive sections, each rotated by its own
    position component.  For pure text all three components are equal
    and M-RoPE is 1-D RoPE."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"sections {sections} must sum to head_dim/2={half}")
    adt = hi_dtype(x)
    inv = rope_freqs(x.shape[-1], theta, x.device, adt)  # (half,)
    sec_ids = torch.repeat_interleave(
        torch.arange(3, device=x.device), torch.tensor(sections, device=x.device),
        output_size=half,
    )  # (half,): the position component of each frequency slot
    pos_per_slot = positions.to(adt)[..., sec_ids]  # (..., seq, half)
    return _rotate(x, pos_per_slot * inv)


def sinusoidal_positions(seq: int, dim: int, device=None,
                         dtype: torch.dtype = torch.float32) -> Tensor:
    """Non-learned sinusoid table (whisper encoder): [sin | cos]."""
    pos = torch.arange(seq, dtype=dtype, device=device)[:, None]
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=dtype, device=device) / dim))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamDef((d_ff, d_model), ("mlp", "embed"), init="out_proj"),
    }


def swiglu(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    # silu in the compute dtype, as the reference keeps it
    return (F.silu(g) * u) @ params["w_down"].to(x.dtype)


def gelu_mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "w_in": ParamDef((d_model, d_ff), ("embed", "mlp")),
        "b_in": ParamDef((d_ff,), ("mlp",), init="zeros"),
        "w_out": ParamDef((d_ff, d_model), ("mlp", "embed"), init="out_proj"),
        "b_out": ParamDef((d_model,), ("embed",), init="zeros"),
    }


def gelu_mlp(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    h = x @ params["w_in"].to(x.dtype) + params["b_in"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    return h @ params["w_out"].to(x.dtype) + params["b_out"].to(x.dtype)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(vocab: int, d_model: int) -> Dict[str, ParamDef]:
    return {"embedding": ParamDef((vocab, d_model), ("vocab", "embed"), init="embed", scale=0.02)}


def untied_unembed_defs(vocab: int, d_model: int) -> Dict[str, ParamDef]:
    return {"w_out": ParamDef((d_model, vocab), ("embed", "vocab"), init="out_proj")}


def embed(params: Dict[str, Tensor], tokens: Tensor) -> Tensor:
    table = params["embedding"]
    if hasattr(table, "placements"):  # a DTensor: see gather_rows
        return gather_rows(table, tokens)
    return table[tokens]


def unembed(params: Dict[str, Tensor], x: Tensor) -> Tensor:
    """Tied unembedding over the padded vocab: logits in float32 (float64
    for a float64 run)."""
    return hi(x @ params["embedding"].to(x.dtype).T)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def cross_entropy(
    logits: Tensor,  # (..., vocab) float
    labels: Tensor,  # (...,) int
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Mean negative log-likelihood of ``labels``; with ``mask``, the
    masked mean (over at least one position)."""
    logz = torch.logsumexp(logits, dim=-1)
    # the gathered column keeps its dim until it is combined with logz: a
    # vocab-sharded DTensor's gather result is reduced over the model axis
    # there, with a mask of the gather's own shape
    gold = torch.gather(logits, -1, labels[..., None].long())
    nll = (logz[..., None] - gold)[..., 0]
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
