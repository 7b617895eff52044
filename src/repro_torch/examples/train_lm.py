"""End-to-end training driver: train a small LM for a few hundred steps
with checkpointing, preemption safety, straggler monitoring, and a
mid-run simulated restart (kill -> restore -> continue).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

The default model is ~1.2M parameters (4 layers of 128, vocab 2048) on
synthetic Zipf tokens; pass ``--arch granite-8b --smoke`` for an
assigned architecture's smoke config.  ``--mesh DxM`` lays the
parameters out on a (data, model) mesh of D x M ranks through
``repro_torch.launch.mesh`` and the training launcher's rules: alone it
starts a one-rank process group (so ``--mesh 1x1`` on one card), and
under ``torchrun`` it joins the ranks' group, e.g.

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.examples.train_lm \
        --mesh 2x2 --device cpu --steps 20

The restart restores the whole state (parameters, AdamW moments and
step, the data position) into a freshly built model, so the steps after
it equal those of a run that was never stopped.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticSource, TokenPipeline
from repro_torch.examples import add_common_args, card_label, device_of
from repro_torch.models import ModelConfig, build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.runtime import (
    StragglerMonitor,
    TrainConfig,
    build_train_step,
    init_state,
    model_loss,
    run,
)

CONFIG = ModelConfig(name="lm-demo", family="dense", n_layers=4, d_model=128, n_heads=8,
                     n_kv_heads=4, d_ff=512, vocab=2048, dtype=torch.float32)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _load(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole value ``src`` into ``dst``, laid out as ``dst`` is."""
    if hasattr(dst, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        src = distribute_tensor(src.to(dst.to_local().device), dst.device_mesh, dst.placements)
    with torch.no_grad():
        dst.copy_(src.to(dst.device))


def _start_mesh(spec: str, device: torch.device, tmp: str):
    """The (data, model) mesh ``spec`` (``DxM``) over the ranks' process
    group, started here (one rank, a file store in ``tmp``) unless
    ``torchrun`` or the caller started one; (mesh, device, whether this
    call started the group)."""
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_mesh

    shape = tuple(int(x) for x in spec.lower().split("x"))
    started = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        device = launch_train._start_ranks(device)
    elif not dist.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                                  else device.index)
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        started = True
    return make_mesh(shape, ("data", "model"), device.type), device, started


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--restart-at", type=int, default=None,
                    help="simulate a failure+restore at this step")
    ap.add_argument("--arch", default=None, help="an assigned architecture's config")
    ap.add_argument("--smoke", action="store_true", help="its reduced config")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="train on a (data, model) mesh of D x M ranks")
    args = ap.parse_args(argv)
    steps = args.steps
    restart_at = args.restart_at or steps // 2
    device = device_of(args.device)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    mesh = None
    started = False
    if args.mesh:
        mesh, device, started = _start_mesh(args.mesh, device, ckpt_dir)
        if dist.get_world_size() > 1:  # every rank reads rank 0's
            shared = [ckpt_dir]
            dist.broadcast_object_list(shared, src=0)
            if shared[0] != ckpt_dir:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
                ckpt_dir = shared[0]
    rank0 = mesh is None or dist.get_rank() == 0
    try:
        out = _train(args, steps, restart_at, device, mesh, ckpt_dir, rank0)
    finally:
        if started:
            dist.destroy_process_group()
        if rank0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return out


def _train(args, steps, restart_at, device, mesh, ckpt_dir, rank0) -> dict:
    from repro_torch.launch.train import layout_params

    cfg = get_config(args.arch, smoke=args.smoke) if args.arch else CONFIG
    gen = torch.Generator(device=device)

    def fresh_params():
        """A newly built model's parameters (every rank draws the same),
        laid out on the mesh when there is one."""
        model = build_model(cfg, device=device, generator=gen.manual_seed(args.seed))
        params = dict(model.named_parameters())
        rules = None
        if mesh is not None:
            rules, _, params = layout_params(model, params, mesh)
        return model, params, rules

    model, params, rules = fresh_params()
    opt = adamw(cosine_warmup(3e-3, steps // 10, steps))
    tc = TrainConfig(grad_accum=2, max_grad_norm=1.0)
    dc = DataConfig(global_batch=16, seq_len=64, vocab=cfg.vocab, seed=args.seed)

    mgr = CheckpointManager(ckpt_dir, keep_n=2)
    monitor = StragglerMonitor()
    monitor.begin_step()

    def loss_fn(p, t, l):
        return model_loss(model, p, t, l)

    step = build_train_step(loss_fn, opt, tc, mesh=mesh, rules=rules)

    def state_tree(st):
        """Full restartable state: params + optimizer moments + step, as
        whole tensors (every rank takes part in gathering a DTensor)."""
        return {"params": {k: _full(v) for k, v in st.params.items()},
                "m": {k: _full(v) for k, v in st.opt_state.m.items()},
                "v": {k: _full(v) for k, v in st.opt_state.v.items()},
                "opt_step": st.opt_state.step}

    def save(st, at, pipe, blocking=False):
        tree = state_tree(st)
        if rank0:  # rank 0 writes
            mgr.save(tree, at, extra={"data_step": pipe.state()}, blocking=blocking)

    losses = {}

    def make_hooks(pipe):
        def ckpt(i, st, metrics):
            if (i + 1) % 25 == 0:
                save(st, i + 1, pipe)

        def log(i, st, metrics):
            losses[i] = float(metrics["loss"])
            if i % 20 == 0 and rank0:
                print(f"step {i:4d}  loss {losses[i]:.4f}  "
                      f"grad {float(metrics['grad_norm']):.3f}")

        return (monitor.hook(), ckpt, log)

    # ---- phase 1: train until the simulated failure ----
    pipe = TokenPipeline(SyntheticSource(dc))
    state = init_state(params, opt, tc)
    state, metrics = run(step, state, pipe, restart_at, make_hooks(pipe))
    save(state, restart_at, pipe, blocking=True)
    mgr.wait()
    if mesh is not None:
        dist.barrier()  # the checkpoint is written before any rank reads it
    loss_at_kill = float(metrics["loss"])
    if rank0:
        print(f"\n!! simulated preemption at step {restart_at} "
              f"(loss {loss_at_kill:.4f}); restarting from checkpoint...\n")

    # ---- phase 2: fresh model state, restore FULL state, continue ----
    restored, ck_step, extra = mgr.restore(state_tree(state))
    del state
    model, params2, _ = fresh_params()
    for k, v in restored["params"].items():
        _load(params2[k], v)
    pipe2 = TokenPipeline(SyntheticSource(dc))
    pipe2.restore(extra["data_step"])
    state2 = init_state(params2, opt, tc)
    for k in params2:
        _load(state2.opt_state.m[k], restored["m"][k])
        _load(state2.opt_state.v[k], restored["v"][k])
    _load(state2.opt_state.step, restored["opt_step"])
    state2, metrics = run(step, state2, pipe2, steps - ck_step,
                          make_hooks(pipe2), start_step=ck_step)
    mgr.wait()
    final = float(metrics["loss"])
    if rank0:
        print(f"\nfinal loss after restart: {final:.4f} "
              f"(was {loss_at_kill:.4f} at the kill point)")
    assert final < loss_at_kill + 0.35, "training regressed"
    if rank0:
        print(f"straggler events observed: {len(monitor.events)}")
        print(f"OK ({card_label(device)})")
    return {
        "losses": [losses[i] for i in range(steps)],
        "loss_at_kill": loss_at_kill,
        "final_loss": final,
        "restart_at": ck_step,
        "checkpoints": sorted(int(d[5:]) for d in os.listdir(ckpt_dir)
                              if d.startswith("step_") and d[5:].isdigit()),
        "steps": steps,
        "straggler_events": len(monitor.events),
        "mesh": None if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "device": card_label(device),
    }


if __name__ == "__main__":
    main()
