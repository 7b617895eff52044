"""Training launcher: the end-to-end training driver, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b --smoke \
        --steps 50 --ckpt-dir /tmp/ckpt --device cpu

The reference's flags (``repro/launch/train.py``) plus ``--device``
(the CUDA card unless it says otherwise).  ``--smoke`` takes the reduced
config.  The run uses one device: with more than one card visible it
says so and trains on the first (the reference's data x model mesh
waits for the port's sharding).  ``--ckpt-dir`` saves the parameters
every ``--ckpt-every`` steps and at the end, with the data position;
``--resume`` restores the latest and continues from its step (the
optimizer's moments start again from zero, as in the reference); a
SIGTERM writes a checkpoint at the next step boundary and stops with
``Preempted``.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticSource, TokenPipeline
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.runtime import (
    PreemptionHandler,
    StragglerMonitor,
    TrainConfig,
    build_train_step,
    init_state,
    model_loss,
    run,
)


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

    device = torch.device(args.device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        print(f"[train] {torch.cuda.device_count()} cards visible; training on one "
              f"({device}): the multi-device mesh is not ported")
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(args.seed))

    opt = adamw(cosine_warmup(args.lr, max(args.steps // 10, 1), args.steps))
    tc = TrainConfig(grad_accum=args.grad_accum)
    state = init_state(dict(model.named_parameters()), opt, tc)

    def loss_fn(p, t, l):
        if cfg.family == "audio":
            frames = torch.zeros(
                (t.shape[0], min(cfg.max_source_positions, 64), cfg.d_model),
                dtype=cfg.dtype, device=t.device,
            )
            return model_loss(model, p, t, l, frames=frames)
        return model_loss(model, p, t, l)

    step = build_train_step(loss_fn, opt, tc)

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
            restored, ck_step, extra = mgr.restore({"params": state.params})
            with torch.no_grad():
                for k, v in restored["params"].items():
                    state.params[k].copy_(v)
            start_step = ck_step
            pipe.restore(extra.get("data_step", ck_step))
            print(f"[train] resumed from step {ck_step}")

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
        if i % 10 == 0 or i == start_step + args.steps - 1:
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
            mgr.wait()
        if pre is not None:
            pre.unregister()
    return {"final_loss": float(metrics["loss"]), "steps": args.steps,
            "straggler_events": len(monitor.events)}


if __name__ == "__main__":
    out = main()
    print("[train] done:", out)
