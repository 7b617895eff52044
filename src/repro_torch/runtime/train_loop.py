"""Training runtime: TrainState, step builder, grad accumulation, hooks.

The port of the JAX package's ``repro/runtime/train_loop.py``.
``build_train_step`` returns ``train_step(state, tokens, labels)
-> (state, metrics)`` with:

  * gradient accumulation over ``grad_accum`` microbatches, summed in
    float32 (not in the parameters' dtype, as ``.grad`` would);
  * gradient compression (bf16 / int8 + error feedback) then
    decompression, where a data-parallel all-reduce would sit between;
  * global-norm clipping, the schedule-driven optimizer, the loss's own
    metrics (its aux loss among them);
  * donated state: parameters and moments are updated in place (with
    ``donate=False`` the step works on a copy and leaves ``state`` as it
    was).

``loss_fn(params, tokens, labels) -> (loss, metrics)`` must compute the
loss from ``params`` (name -> tensor); :func:`model_loss` gives that for
a port model.  Hooks (straggler monitor, checkpointing) observe each
step from the host — see :mod:`repro_torch.runtime.fault`.

On a mesh (``mesh`` and ``rules`` given, the counterpart of the
reference's ``in_shardings``) the state's parameters and moments are
DTensors laid out by the rules (:func:`repro_torch.parallel.sharding.
distribute_params`); each step takes the full global batch on every
rank and keeps its shard (``Shard(0)`` over the data axes, replicated
over ``model``), runs under the rules and mesh with plain tensors taken
as replicated, and lets DTensor reduce the gradients over the data
axes.  The clip norm reduces over the full tensors; the update is the
same per-leaf code on DTensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.optim import Optimizer, OptState, clip_by_global_norm
from repro_torch.parallel.compression import (
    CompressionConfig,
    compress,
    decompress,
    init_error_buffer,
)
from repro_torch.parallel.context import use_mesh, use_rules
from repro_torch.parallel.sharding import distribute, fixup_specs

Tensor = torch.Tensor
Tree = Dict[str, Tensor]


class TrainState(NamedTuple):
    params: Tree
    opt_state: OptState
    err_buffer: Optional[Tree] = None  # compression error feedback


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    max_grad_norm: float = 1.0
    compression: CompressionConfig = CompressionConfig()


def init_state(params: Tree, optimizer: Optimizer, cfg: TrainConfig = TrainConfig()) -> TrainState:
    """The state over ``params`` (name -> tensor, e.g.
    ``dict(model.named_parameters())``: those tensors are trained in place)."""
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        err_buffer=init_error_buffer(params, cfg.compression),
    )


class _LossOf(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.loss(*args, **kwargs)


def model_loss(model: nn.Module, params: Tree, tokens: Tensor, labels: Tensor, **kwargs):
    """``model.loss(tokens, labels, **kwargs)`` computed with ``params``
    (name -> tensor) in place of the model's own parameters."""
    return torch.func.functional_call(
        _LossOf(model), {f"model.{k}": v for k, v in params.items()}, (tokens, labels), kwargs,
    )


def _copy_state(state: TrainState) -> TrainState:
    def copy(tree):
        return None if tree is None else {k: v.detach().clone() for k, v in tree.items()}

    params = {k: p.detach().clone().requires_grad_(p.requires_grad)
              for k, p in state.params.items()}
    opt = state.opt_state
    return TrainState(params, OptState(opt.step.clone(), copy(opt.m), copy(opt.v),
                                       copy(opt.mu), copy(opt.nu)),
                      copy(state.err_buffer))


def _full(t: Tensor) -> Tensor:
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def build_train_step(
    loss_fn: Callable[[Tree, Tensor, Tensor], Tuple[Tensor, Dict]],
    optimizer: Optimizer,
    cfg: TrainConfig = TrainConfig(),
    donate: bool = True,
    mesh: Any = None,
    rules: Any = None,
):
    """loss_fn(params, tokens, labels) -> (loss, metrics dict).  With
    ``mesh`` (a ``DeviceMesh``) and ``rules``, the step of a state laid
    out on that mesh."""
    if (mesh is None) != (rules is None):
        raise ValueError("a mesh step needs both mesh and rules")

    def place(t: Tensor) -> Tensor:
        """A global batch (the same on every rank) as this rank's shard."""
        if mesh is None:
            return t
        spec = fixup_specs(rules.spec(("batch",) + (None,) * (t.dim() - 1)), t, mesh)
        return distribute(t, spec, mesh)

    def grad_fn(params: Tree, tokens: Tensor, labels: Tensor):
        leaves = list(params.values())
        with torch.enable_grad():
            loss, metrics = loss_fn(params, place(tokens), place(labels))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {k: g if g is not None else torch.zeros_like(p)
                 for (k, p), g in zip(params.items(), grads)}
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads

    def step(state: TrainState, tokens: Tensor, labels: Tensor):
        if not donate:
            state = _copy_state(state)
        params = state.params
        if cfg.grad_accum > 1:
            b = tokens.shape[0]
            if b % cfg.grad_accum:
                raise ValueError(f"batch {b} does not split into {cfg.grad_accum} microbatches")
            mb = b // cfg.grad_accum
            g_sum = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            loss_sum = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(cfg.grad_accum):
                rows = slice(i * mb, (i + 1) * mb)
                (loss, metrics), g = grad_fn(params, tokens[rows], labels[rows])
                for k, gk in g.items():
                    g_sum[k] += gk.to(torch.float32)
                del g
                loss_sum = loss_sum + loss
            grads = {k: g / cfg.grad_accum for k, g in g_sum.items()}
            loss = loss_sum / cfg.grad_accum
        else:
            (loss, metrics), grads = grad_fn(params, tokens, labels)

        # gradient compression where the data-axis reduce would be
        wire, new_err = compress(grads, state.err_buffer, cfg.compression)
        grads = decompress(wire, cfg.compression)

        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
        new_params, new_opt = optimizer.update(grads, state.opt_state, params)
        metrics = {k: _full(v) for k, v in metrics.items()}
        metrics["grad_norm"] = _full(gnorm)
        metrics["loss"] = _full(loss)
        return TrainState(new_params, new_opt, new_err), metrics

    if mesh is None:
        return step

    def mesh_step(state: TrainState, tokens: Tensor, labels: Tensor):
        from torch.distributed.tensor.experimental import implicit_replication

        with use_rules(rules), use_mesh(mesh), implicit_replication():
            return step(state, tokens, labels)

    return mesh_step


def run(
    train_step,
    state: TrainState,
    pipeline,
    n_steps: int,
    hooks: Tuple[Callable[[int, TrainState, Dict], None], ...] = (),
    start_step: int = 0,
) -> Tuple[TrainState, Dict]:
    """Host-side loop: data -> step -> hooks. Returns final (state, metrics).
    Batches go to the parameters' device."""
    device = next(iter(state.params.values())).device
    metrics: Dict[str, Any] = {}
    it = iter(pipeline)
    for i in range(start_step, start_step + n_steps):
        tokens, labels = next(it)
        state, metrics = train_step(
            state,
            torch.from_numpy(np.ascontiguousarray(tokens)).to(device),
            torch.from_numpy(np.ascontiguousarray(labels)).to(device),
        )
        for h in hooks:
            h(i, state, metrics)
    return state, metrics
