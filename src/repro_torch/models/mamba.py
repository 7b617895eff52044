"""Mamba2 (SSD — state-space duality) layer: chunked scan + O(1) decode.

The port of the JAX package's ``repro/models/mamba.py``.  The SSD
algorithm (Dao & Gu, arXiv:2405.21060) computes the selective
state-space recurrence

    h_t = exp(A dt_t) h_{t-1} + dt_t * B_t x_t^T ,   y_t = C_t . h_t + D x_t

by splitting the sequence into chunks: an intra-chunk quadratic term
plus an inter-chunk state recurrence.  Decode uses the per-token
recurrent form.  ``ssd_ref`` is plain PyTorch in both packages: neither
forward reaches its SSD chunk kernel.  The scan runs in float32 (float64
for a float64 run), as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.context import constrain_logical, keep_layout, on_mesh, pad
from .layers import hi, rmsnorm
from .params import ParamDef

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128  # N
    head_dim: int = 64  # P
    expand: int = 2
    n_groups: int = 1  # G (B/C groups, GQA-like)
    conv_kernel: int = 4
    chunk: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba_defs(cfg: SSMConfig) -> Dict[str, ParamDef]:
    d, di, g, n, h = cfg.d_model, cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.n_heads
    in_dim = 2 * di + 2 * g * n + h  # z, x, B, C, dt
    return {
        "w_in": ParamDef((d, in_dim), ("embed", "mlp")),
        "conv_w": ParamDef((cfg.conv_kernel, cfg.conv_dim), (None, "mlp"), scale=1.0),
        "conv_b": ParamDef((cfg.conv_dim,), ("mlp",), init="zeros"),
        "A_log": ParamDef((h,), ("heads",), init="zeros"),
        "D": ParamDef((h,), ("heads",), init="ones"),
        "dt_bias": ParamDef((h,), ("heads",), init="zeros"),
        "norm_scale": ParamDef((di,), ("mlp",), init="ones"),
        "w_out": ParamDef((di, d), ("mlp", "embed"), init="out_proj"),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def _segsum(x: Tensor) -> Tensor:
    """Lower-triangular segment sums: out[..., i, j] = sum_{j<k<=i} x[..., k];
    -inf above the diagonal (exp gives 0 there)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_ref(
    x: Tensor,  # (B, S, H, P) — already dt-scaled inputs (dt * x)
    a: Tensor,  # (B, S, H)   — log decay per step (A * dt, negative)
    bmat: Tensor,  # (B, S, H, N)
    cmat: Tensor,  # (B, S, H, N)
    chunk: int = 64,
    initial_state: Optional[Tensor] = None,  # (B, H, P, N)
) -> Tuple[Tensor, Tensor]:
    """Chunked SSD; returns (y (B,S,H,P), final_state (B,H,P,N))."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    c = s // chunk
    xr = x.reshape(b, c, chunk, h, p)
    ar = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)  # (B,H,C,L)
    br = bmat.reshape(b, c, chunk, h, n)
    cr = cmat.reshape(b, c, chunk, h, n)
    a_cum = torch.cumsum(ar, dim=-1)  # (B,H,C,L)

    # 1. intra-chunk (diagonal blocks): attention-like with a decay mask
    ll = torch.exp(_segsum(ar))  # (B,H,C,L,L)
    scores = torch.einsum("bclhn,bcshn->bhcls", cr, br) * ll
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xr)

    # 2. per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B,H,C,L)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", br, decay_states, xr)

    # 3. inter-chunk recurrence over chunk states
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    states = torch.cat([initial_state[:, None].to(states.dtype), states], dim=1)
    padded = F.pad(a_cum[..., -1], (1, 0))  # (B,H,C+1)
    dmat = torch.exp(_segsum(padded))  # (B,H,C+1,C+1)
    dmat = torch.where(torch.isfinite(dmat), dmat, 0.0)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dmat, states)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output
    out_decay = torch.exp(a_cum)  # (B,H,C,L)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", cr, prev_states, out_decay)
    return (y_diag + y_off).reshape(b, s, h, p), final_state


def _ssd_per_rank(x: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
                  chunk: int) -> Tuple[Tensor, Tensor]:
    """:func:`ssd_ref`; on a mesh (DTensor ``x``), each rank runs it on its
    batch rows and heads, which the scan keeps apart.  Its products would
    otherwise flatten the batch with heads split over the model axis, a
    view torch 2.11's DTensor refuses."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return ssd_ref(x, a, bmat, cmat, chunk=chunk)
    heads = ("act_batch", None, "heads", None)
    x, bmat, cmat = (constrain_logical(t, heads) for t in (x, bmat, cmat))
    a = constrain_logical(a, heads[:3])
    y, state = ssd_ref(x.to_local(), a.to_local(), bmat.to_local(), cmat.to_local(), chunk=chunk)
    mesh = x.device_mesh
    # the final state (B, H, P, N) split as x's batch and heads
    state_pl = [Shard({0: 0, 2: 1}[p.dim]) if p.is_shard() else p for p in x.placements]
    return (DTensor.from_local(y, mesh, x.placements, run_check=False),
            DTensor.from_local(state, mesh, state_pl, run_check=False))


def ssd_decode_step(
    state: Tensor,  # (B, H, P, N) float
    x_t: Tensor,  # (B, H, P) — dt-scaled input
    a_t: Tensor,  # (B, H) — log decay
    b_t: Tensor,  # (B, H, N)
    c_t: Tensor,  # (B, H, N)
) -> Tuple[Tensor, Tensor]:
    """One recurrent step.  Returns (y_t (B,H,P), new_state)."""
    decay = torch.exp(a_t)[..., None, None]  # (B,H,1,1)
    new_state = decay * state + x_t[..., :, None] * b_t[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_t)
    return y.to(x_t.dtype), new_state


def _ssd_step_per_rank(state: Tensor, x_t: Tensor, a_t: Tensor, b_t: Tensor,
                       c_t: Tensor) -> Tuple[Tensor, Tensor]:
    """:func:`ssd_decode_step`; on a mesh (DTensor ``state``), each rank
    steps its batch rows and heads, as the cache splits them: the state
    product would otherwise flatten the batch with the split heads."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(state, DTensor):
        return ssd_decode_step(state, x_t, a_t, b_t, c_t)
    mesh = state.device_mesh
    rows_heads = [p if p.is_shard() and p.dim < 2 else Replicate() for p in state.placements]
    y, new_state = ssd_decode_step(*(on_mesh(t, mesh).redistribute(mesh, rows_heads).to_local()
                                     for t in (state, x_t, a_t, b_t, c_t)))
    return (DTensor.from_local(y, mesh, rows_heads, run_check=False),
            DTensor.from_local(new_state, mesh, rows_heads, run_check=False))


def ssd_naive_ref(
    x: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
    initial_state: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Pure sequential recurrence — the ground-truth oracle for ssd_ref."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    state = (
        torch.zeros((b, h, p, n), dtype=hi(x).dtype, device=x.device)
        if initial_state is None else initial_state
    )
    ys = []
    for t in range(s):
        y, state = ssd_decode_step(state, hi(x[:, t]), a[:, t], bmat[:, t], cmat[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state


# ---------------------------------------------------------------------------
# causal depthwise conv (kernel k): k shifted adds, decode keeps k-1 inputs
# ---------------------------------------------------------------------------


def causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """x: (B, S, C), w: (k, C), b: (C,).  Causal depthwise conv + silu."""
    k, s = w.shape[0], x.shape[1]
    xp = pad(x, (0, 0, k - 1, 0))
    y = torch.zeros(x.shape, dtype=hi(x).dtype, device=x.device)
    for i in range(k):
        y = y + hi(xp[:, i : i + s]) * hi(w[i])
    return F.silu(y + hi(b)).to(x.dtype)


def causal_conv_step(
    conv_state: Tensor,  # (B, k-1, C) most recent inputs, oldest first
    x_t: Tensor,  # (B, C)
    w: Tensor,
    b: Tensor,
) -> Tuple[Tensor, Tensor]:
    window = torch.cat([conv_state, x_t[:, None]], dim=1)  # (B, k, C), promoted
    y = torch.einsum("bkc,kc->bc", hi(window), hi(w))
    y = F.silu(y + hi(b)).to(x_t.dtype)
    return y, window[:, 1:]


# ---------------------------------------------------------------------------
# full layer
# ---------------------------------------------------------------------------


def _split_in(proj: Tensor, cfg: SSMConfig):
    di = cfg.d_inner
    return proj[..., :di], proj[..., di : di + cfg.conv_dim], proj[..., di + cfg.conv_dim :]


def _split_xbc(xbc: Tensor, cfg: SSMConfig):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    return xbc[..., :di], xbc[..., di : di + gn], xbc[..., di + gn :]


def _broadcast_groups(m: Tensor, cfg: SSMConfig) -> Tensor:
    """(B, S, G*N) -> (B, S, H, N) by repeating each group over its heads."""
    b, s = m.shape[:2]
    m = m.reshape(b, s, cfg.n_groups, cfg.d_state)
    return m.repeat_interleave(cfg.n_heads // cfg.n_groups, dim=2)


def init_mamba_cache(batch: int, cfg: SSMConfig, dtype: Any = torch.bfloat16,
                     device: Any = None) -> Dict[str, Tensor]:
    state_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), dtype=state_dtype,
                           device=device),
    }


def mamba_apply(
    params: Dict[str, Tensor],
    x: Tensor,  # (B, S, d_model)
    cfg: SSMConfig,
    cache: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    b, s, _ = x.shape
    # its gradient, summed from the slices below, laid out as the product's
    proj = keep_layout(x @ params["w_in"].to(x.dtype))
    z, xbc, dt_raw = _split_in(proj, cfg)
    dt = F.softplus(hi(dt_raw) + hi(params["dt_bias"]))  # (B,S,H)
    a_neg = -torch.exp(hi(params["A_log"]))  # (H,) negative
    d_skip = hi(params["D"])

    if cache is not None and s == 1:
        xbc_t, conv_state = causal_conv_step(cache["conv"], xbc[:, 0], params["conv_w"],
                                             params["conv_b"])
        xs, bm, cm = _split_xbc(xbc_t[:, None], cfg)
        xh = xs.reshape(b, 1, cfg.n_heads, cfg.head_dim)[:, 0]
        bh = _broadcast_groups(bm, cfg)[:, 0]
        ch = _broadcast_groups(cm, cfg)[:, 0]
        dt_t = dt[:, 0]  # (B,H)
        y_t, ssm_state = _ssd_step_per_rank(
            cache["ssm"], hi(xh * dt_t[..., None]), a_neg[None] * dt_t, hi(bh), hi(ch)
        )
        y_t = y_t + d_skip[None, :, None] * xh
        y = y_t.reshape(b, 1, cfg.d_inner).to(x.dtype)
        new_cache = {"conv": conv_state, "ssm": ssm_state}
    else:
        xbc_c = causal_conv(xbc, params["conv_w"], params["conv_b"])
        xs, bm, cm = _split_xbc(xbc_c, cfg)
        xh = xs.reshape(b, s, cfg.n_heads, cfg.head_dim)
        y4, final_state = _ssd_per_rank(
            hi(xh * dt[..., None]),
            a_neg[None, None] * dt,
            hi(_broadcast_groups(bm, cfg)),
            hi(_broadcast_groups(cm, cfg)),
            chunk=min(cfg.chunk, s),
        )
        y4 = y4 + d_skip[None, None, :, None] * xh
        y = y4.reshape(b, s, cfg.d_inner).to(x.dtype)
        new_cache = None
        if cache is not None:  # prefill: fill the conv and ssm states
            conv_in = xbc[:, -(cfg.conv_kernel - 1):]
            new_cache = {"conv": conv_in.to(cache["conv"].dtype), "ssm": final_state}

    # gated RMSNorm (mamba2's norm(y * silu(z)))
    y = y * F.silu(hi(z)).to(x.dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y)
    return y @ params["w_out"].to(x.dtype), new_cache
