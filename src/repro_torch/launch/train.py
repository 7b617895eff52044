"""Training launcher: end-to-end training, on one device or a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke \
        --steps 50 --ckpt-dir /tmp/ckpt --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu

The reference's flags (``repro/launch/train.py``) plus ``--device``
(the CUDA card unless it says otherwise).  ``--smoke`` takes the reduced
config.  Run alone it trains on one device.  Under ``torchrun``
(``WORLD_SIZE`` > 1; one process per card) it starts the process group
(NCCL with each rank on ``cuda:LOCAL_RANK``, or gloo with ``--device
cpu``) unless one is started already, builds the squarest (data, model)
mesh of the world and lays the parameters out by
``make_rules(data_axes=("data",), fsdp=True)``; every rank draws the
same global batch from the seed and keeps its shard, and only rank 0
logs.  ``--ckpt-dir`` saves the parameters (full tensors, written by rank
0) every ``--ckpt-every`` steps and at the end, with the data position;
``--resume`` restores the latest, laid out again by the same specs, and
continues from its step (the optimizer's moments start again from zero,
as in the reference); a SIGTERM writes a checkpoint at the next step
boundary and stops with ``Preempted``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticSource, TokenPipeline
from repro_torch.models import build_model
from repro_torch.launch.mesh import make_mesh
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.parallel.sharding import (
    distribute,
    distribute_params,
    fixup_specs,
    make_rules,
    specs_from_logical,
)
from repro_torch.runtime import (
    PreemptionHandler,
    StragglerMonitor,
    TrainConfig,
    build_train_step,
    init_state,
    model_loss,
    run,
)


def make_mesh_from_devices(device_type: str):
    """The squarest (data, model) mesh over the default process group's
    ranks, or None for one rank (the reference's over its devices)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return None
    for m in range(int(n**0.5), 0, -1):
        if n % m == 0:
            return make_mesh((n // m, m), ("data", "model"), device_type)
    return None


def layout_params(model, params: Dict[str, torch.Tensor], mesh):
    """The launcher's layout of ``params`` on ``mesh``: (rules, specs,
    the parameters as DTensors), by ``make_rules(data_axes=("data",),
    fsdp=True)`` and ``fixup_specs``."""
    rules = make_rules(data_axes=("data",), fsdp=True)
    specs = fixup_specs(specs_from_logical(model.logical_specs(), rules), params, mesh)
    return rules, specs, distribute_params(params, specs, mesh)


def _start_ranks(device: torch.device) -> torch.device:
    """Under torchrun, the process group (if none is started) and this
    rank's device."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device


class _RankZeroSaver:
    """A checkpoint manager's ``save`` of DTensor trees: every rank
    gathers the full tensors, rank 0 writes them."""

    def __init__(self, mgr: CheckpointManager):
        self.mgr = mgr

    def save(self, tree, step, extra=None, blocking=False):
        full = {k: {n: t.full_tensor() for n, t in v.items()} for k, v in tree.items()}
        if dist.get_rank() == 0:
            self.mgr.save(full, step, extra=extra, blocking=blocking)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = _start_ranks(torch.device(args.device))
    cfg = get_config(args.arch, smoke=args.smoke)
    # every rank draws the same parameters from the seed
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(args.seed))
    mesh = make_mesh_from_devices(device.type)
    rank0 = mesh is None or dist.get_rank() == 0

    opt = adamw(cosine_warmup(args.lr, max(args.steps // 10, 1), args.steps))
    tc = TrainConfig(grad_accum=args.grad_accum)
    params = dict(model.named_parameters())
    rules = specs = None
    if mesh is not None:
        rules, specs, params = layout_params(model, params, mesh)
    state = init_state(params, opt, tc)

    def loss_fn(p, t, l):
        if cfg.family == "audio":
            frames = torch.zeros(
                (t.shape[0], min(cfg.max_source_positions, 64), cfg.d_model),
                dtype=cfg.dtype, device=t.device,
            )
            return model_loss(model, p, t, l, frames=frames)
        return model_loss(model, p, t, l)

    step = build_train_step(loss_fn, opt, tc, mesh=mesh, rules=rules)

    dc = DataConfig(global_batch=args.batch, seq_len=args.seq, vocab=cfg.vocab,
                    seed=args.seed)
    pipe = TokenPipeline(SyntheticSource(dc))

    hooks = []
    monitor = StragglerMonitor()
    monitor.begin_step()
    hooks.append(monitor.hook())

    start_step = 0
    mgr: Optional[CheckpointManager] = None
    pre: Optional[PreemptionHandler] = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep_n=3)
        if args.resume and mgr.latest_step() is not None:
            target = state.params if mesh is None else {
                k: torch.empty(p.shape, dtype=p.dtype, device=device)
                for k, p in state.params.items()}
            restored, ck_step, extra = mgr.restore({"params": target})
            with torch.no_grad():
                for k, v in restored["params"].items():
                    state.params[k].copy_(v if mesh is None else distribute(v, specs[k], mesh))
            start_step = ck_step
            pipe.restore(extra.get("data_step", ck_step))
            if rank0:
                print(f"[train] resumed from step {ck_step}")
        if mesh is not None:
            mgr = _RankZeroSaver(mgr)

        def ckpt_hook(i, st, metrics):
            if (i + 1) % args.ckpt_every == 0:
                mgr.save({"params": st.params}, i + 1,
                         extra={"data_step": pipe.state()})

        hooks.append(ckpt_hook)
        pre = PreemptionHandler().register()
        hooks.append(
            pre.checkpoint_hook(
                mgr, lambda: ({"params": state.params}, {"data_step": pipe.state()})
            )
        )

    def log_hook(i, st, metrics):
        if rank0 and (i % 10 == 0 or i == start_step + args.steps - 1):
            print(
                f"[train] step {i:5d} loss {float(metrics['loss']):.4f} "
                f"grad_norm {float(metrics['grad_norm']):.3f}"
            )

    hooks.append(log_hook)

    try:
        state, metrics = run(step, state, pipe, args.steps, tuple(hooks),
                             start_step=start_step)
        if mgr:
            mgr.save({"params": state.params}, start_step + args.steps,
                     extra={"data_step": pipe.state()}, blocking=True)
    finally:
        if mgr:
            getattr(mgr, "mgr", mgr).wait()
        if pre is not None:
            pre.unregister()
    return {"final_loss": float(metrics["loss"]), "steps": args.steps,
            "straggler_events": len(monitor.events)}


if __name__ == "__main__":
    out = main()
    if not dist.is_initialized() or dist.get_rank() == 0:
        print("[train] done:", out)
    if dist.is_initialized():
        dist.destroy_process_group()
