"""Test-side: run checks on N gloo ranks of this machine's CPU.

:func:`spawn` starts N processes (``torch.multiprocessing``, spawn
method), each of which joins a gloo process group through a
``FileStore`` in a directory of the caller's (no port is chosen), runs
``job(rank, world, **kwargs)`` and saves what it returns with
``torch.save``; the caller gets the list of results by rank.  Each rank
runs one intra-op thread, after ``cpu_math.prepare``.  A run that does
not end within ``timeout`` seconds is killed and fails.

:func:`multirank_checks` is the job the multi-rank tests run: every
check on one 2 x 2 (data, model) mesh, a (4,) stage mesh for the
pipeline, and the training launcher, in one spawn.
"""

import os
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store, out, job, kwargs):
    os.environ["OMP_NUM_THREADS"] = "1"
    torch.set_num_threads(1)
    from repro_torch import cpu_math

    cpu_math.prepare()
    dist.init_process_group("gloo", store=dist.FileStore(str(store), world), rank=rank,
                            world_size=world)
    try:
        result = job(rank, world, **kwargs)
    except Exception:  # noqa: BLE001 — carried to the caller, which fails on it
        result = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out) / f"rank{rank}.pt")


def spawn(job, world: int, tmp: Path, timeout: float, **kwargs):
    """``job(rank, world, **kwargs)`` on ``world`` gloo ranks; the results
    by rank.  Fails on a rank's exception or after ``timeout`` seconds."""
    out = Path(tmp) / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_entry, args=(world, Path(tmp) / "store", out, job, kwargs),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not end within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for r, res in enumerate(results):
        if isinstance(res, dict) and "error" in res:
            raise AssertionError(f"rank {r}:\n{res['error']}")
    return results


# -- the checks --------------------------------------------------------------------


def _placements(mesh):
    """Both orders of a dim split over ("data", "model"): this rank's block
    is the one JAX gives the device at its mesh coordinates."""
    from repro_torch.parallel.sharding import P, distribute

    t = torch.arange(32.0).reshape(16, 2)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = {}
    for order in (("data", "model"), ("model", "data")):
        d = distribute(t, P(order), mesh)
        block = 0
        for a in order:  # major to minor
            block = block * sizes[a] + coord[a]
        rows = t.shape[0] // 4
        out[order] = dict(
            local_is_jax_block=torch.equal(d.to_local(), t[block * rows:(block + 1) * rows]),
            full_is_input=torch.equal(d.full_tensor(), t),
            placements=[repr(p) for p in d.placements],
        )
    return out


def _constrain(mesh):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.parallel.context import constrain_logical, use_mesh, use_rules
    from repro_torch.parallel.sharding import make_rules

    x = DTensor.from_local(torch.randn(8, 4, 64, generator=torch.Generator().manual_seed(0)),
                           mesh, [Replicate(), Replicate()], run_check=False)
    with use_rules(make_rules()), use_mesh(mesh):
        y = constrain_logical(x, ("act_batch", None, "vocab"))
    return dict(placements=[repr(p) for p in y.placements],
                equal=torch.equal(y.full_tensor(), x.full_tensor()),
                is_dtensor=isinstance(y, DTensor))


def _train_step(mesh, cfg_kwargs, state_dict, tokens, labels):
    """One AdamW step of the same state, on one device and on the mesh."""
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.optim import adamw, constant
    from repro_torch.parallel.sharding import (
        distribute_params, fixup_specs, make_rules, specs_from_logical,
    )
    from repro_torch.runtime import TrainConfig, build_train_step, init_state, model_loss

    cfg = ModelConfig(**cfg_kwargs, dtype=torch.float32)
    model = build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict.items()})
    params = dict(model.named_parameters())
    toks, labs = torch.from_numpy(tokens), torch.from_numpy(labels)
    opt, tc = adamw(constant(1e-2)), TrainConfig()

    def loss(p, t, l):
        return model_loss(model, p, t, l)

    one, m1 = build_train_step(loss, opt, tc, donate=False)(init_state(params, opt, tc),
                                                            toks, labs)
    rules = make_rules()
    specs = fixup_specs(specs_from_logical(model.logical_specs(), rules), params, mesh)
    sharded = distribute_params(params, specs, mesh)
    two, m2 = build_train_step(loss, opt, tc, mesh=mesh, rules=rules)(
        init_state(sharded, opt, tc), toks, labs)
    return dict(
        loss_one=float(m1["loss"]), loss_mesh=float(m2["loss"]),
        one={k: v.detach().numpy() for k, v in one.params.items()},
        mesh={k: v.full_tensor().detach().numpy() for k, v in two.params.items()},
        moments_sharded=all(type(v).__name__ == "DTensor" for v in two.opt_state.m.values()),
    )


def _ep(mesh, moe_kwargs, params, x):
    """moe_apply_ep with the experts over ("model",) and over
    ("model", "data"): outputs, and the gradients of sum(y^2) against
    autograd through the port's moe_ref."""
    from repro_torch.models.moe import MoEConfig, moe_apply_ep, moe_ref
    from repro_torch.parallel.context import use_mesh, use_rules
    from repro_torch.parallel.sharding import make_rules

    cfg = MoEConfig(**moe_kwargs)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    leaves = [xt] + list(p.values())
    y_ref, _ = moe_ref(p, xt, cfg)
    want = torch.autograd.grad((y_ref ** 2).sum(), leaves)
    out = {}
    for axes in (("model",), ("model", "data")):
        with use_mesh(mesh), use_rules(make_rules(expert_axes=axes)):
            y, aux = moe_apply_ep(p, xt, cfg)
            got = torch.autograd.grad((y ** 2).sum(), leaves)
        out[axes] = dict(
            y=y.detach().numpy(), aux=float(aux.detach()),
            grad_err=max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                         for g, w in zip(got, want)),
        )
    return out


def _ep_heat(mesh, model_kwargs, batch, seq):
    """The op counter's level-3 heat block of one forward of an EP MoE
    model on the mesh (plain parameters, replicated): the block, and each
    collective's record."""
    import dataclasses

    from repro_torch.core import op_cost
    from repro_torch.models.model import ModelConfig, build_model
    from repro_torch.parallel.context import use_mesh, use_rules
    from repro_torch.parallel.sharding import make_rules

    cfg = ModelConfig(**model_kwargs, dtype=torch.float32)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=torch.Generator().manual_seed(1))
    with use_mesh(mesh), use_rules(make_rules()), torch.no_grad():
        _, cost = op_cost.count(lambda: model.apply(tokens))
    return dict(heat=cost.heat(), records=[dataclasses.asdict(c) for c in cost.collectives])


def _pipeline(n_stages, ws, mbs):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline
    from repro_torch.parallel.sharding import P, distribute

    mesh = make_mesh((n_stages,), ("stage",), "cpu")
    w, m = torch.from_numpy(ws), torch.from_numpy(mbs)

    def stage_fn(wi, x):
        return torch.tanh(x @ wi)

    seq = m
    for i in range(n_stages):
        seq = stage_fn(w[i], seq)
    out = pipeline(stage_fn, mesh, axis="stage")(distribute(w, P("stage"), mesh), m)
    full = pipeline(stage_fn, mesh, axis="stage")(w, m)  # full stacked params on every rank
    return dict(err=float((out - seq).abs().max()), err_full=float((full - seq).abs().max()))


def _launcher(ckpt):
    from repro_torch.launch import train

    argv = ["--smoke", "--device", "cpu", "--batch", "8", "--seq", "32", "--ckpt-dir", ckpt]
    first = train.main(argv + ["--steps", "3", "--ckpt-every", "2"])
    resumed = train.main(argv + ["--steps", "1", "--resume"])
    return dict(first=first, resumed=resumed)


def multirank_checks(rank, world, *, train_case, ep_case, pipe_case, heat_case, ckpt):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    t0 = time.perf_counter()
    out = dict(placements=_placements(mesh), constrain=_constrain(mesh))
    out["train"] = _train_step(mesh, **train_case)
    out["ep"] = _ep(mesh, **ep_case)
    out["ep_heat"] = _ep_heat(mesh, **heat_case)
    out["pipeline"] = _pipeline(world, **pipe_case)
    os.environ["WORLD_SIZE"] = str(world)
    out["launcher"] = _launcher(ckpt)
    out["seconds"] = time.perf_counter() - t0
    if rank:  # the arrays once
        out["train"] = {k: v for k, v in out["train"].items() if k not in ("one", "mesh")}
        out["ep"] = {k: {n: v for n, v in r.items() if n != "y"} for k, r in out["ep"].items()}
    return out
