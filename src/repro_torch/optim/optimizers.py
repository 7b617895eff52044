"""Optimizers as (init, update) pairs over the named parameter tensors.

The port of the JAX package's ``repro/optim/optimizers.py``.  Parameters,
gradients and moments are dicts of tensors keyed by parameter name (the
names ``model.named_parameters()`` gives).  ``update`` computes each
leaf's step in float32, casts it back to the parameter's dtype and
writes parameters and moments in place (the reference donates its state
to the same end); it returns the same dicts, so a caller may use either.

``state_dtype`` sets the moments' precision: ``f32`` (exact), ``bf16``
(half the memory) or ``int8`` (quantized moments, one scale per leaf).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor
Tree = Dict[str, Tensor]
Schedule = Callable[[Tensor], Tensor]


class OptState(NamedTuple):
    step: Tensor  # 0-dim int32, on the parameters' device
    m: Tree
    v: Tree
    mu: Optional[Tree] = None  # quantization scales (int8 mode)
    nu: Optional[Tree] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], Tuple[Tree, OptState]]


def global_norm(tree: Tree) -> Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree.values()))


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tuple[Tree, Tensor]:
    """Scale every gradient in its own dtype so that the global norm is at
    most ``max_norm``; returns (clipped, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


# -- moment quantization helpers ---------------------------------------------


def _q_store(x: Tensor, dtype: str) -> Tuple[Tensor, Optional[Tensor]]:
    if dtype == "int8":
        scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
        return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale
    if dtype == "bf16":
        return x.to(torch.bfloat16), None
    return x.to(torch.float32), None


def _q_load(x: Tensor, scale: Optional[Tensor], dtype: str) -> Tensor:
    if dtype == "int8":
        return x.to(torch.float32) * scale
    return x.to(torch.float32)


_STATE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _step0(params: Tree) -> Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(
    lr: Schedule,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype: str = "f32",  # 'f32' | 'bf16' | 'int8'
) -> Optimizer:
    if state_dtype not in _STATE_DTYPES:
        raise ValueError(f"state_dtype {state_dtype!r}: one of {sorted(_STATE_DTYPES)}")
    mdtype = _STATE_DTYPES[state_dtype]

    def init(params: Tree) -> OptState:
        def zeros():
            # zeros_like: a DTensor parameter's moments are laid out as it is
            return {k: torch.zeros_like(p, dtype=mdtype) for k, p in params.items()}

        if state_dtype == "int8":
            def scales():
                return {k: torch.full((), 1e-12, dtype=torch.float32, device=p.device)
                        for k, p in params.items()}

            mu, nu = scales(), scales()
        else:
            mu = nu = None
        return OptState(step=_step0(params), m=zeros(), v=zeros(), mu=mu, nu=nu)

    @torch.no_grad()
    def update(grads: Tree, state: OptState, params: Tree):
        step = state.step + 1
        lr_t = lr(step)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            ms = state.mu[k] if state.mu is not None else None
            vs = state.nu[k] if state.nu is not None else None
            mf = b1 * _q_load(state.m[k], ms, state_dtype) + (1 - b1) * g
            vf = b2 * _q_load(state.v[k], vs, state_dtype) + (1 - b2) * g * g
            mhat = mf / bc1
            vhat = vf / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr_t * delta)
            for store, scales, val in ((state.m, state.mu, mf), (state.v, state.nu, vf)):
                q, s = _q_store(val, state_dtype)
                store[k].copy_(q)
                if s is not None:
                    scales[k].copy_(s)
        return params, OptState(step, state.m, state.v, state.mu, state.nu)

    return Optimizer(init=init, update=update)


def lion(
    lr: Schedule,
    b1: float = 0.9,
    b2: float = 0.99,
    weight_decay: float = 0.1,
) -> Optimizer:
    """Lion: sign-momentum; state is a single moment (half of Adam's)."""

    def init(params: Tree) -> OptState:
        m = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        v = {k: torch.zeros((1,), dtype=torch.float32, device=p.device)  # unused
             for k, p in params.items()}
        return OptState(step=_step0(params), m=m, v=v)

    @torch.no_grad()
    def update(grads: Tree, state: OptState, params: Tree):
        step = state.step + 1
        lr_t = lr(step)
        for k, p in params.items():
            g = grads[k].to(torch.float32)
            m = state.m[k]
            update_dir = torch.sign(b1 * m + (1 - b1) * g)
            pf = p.to(torch.float32)
            p.copy_(pf - lr_t * (update_dir + weight_decay * pf))
            m.copy_(b2 * m + (1 - b2) * g)
        return params, OptState(step, state.m, state.v)

    return Optimizer(init=init, update=update)
