"""Multi-pod dry-run: run one step of every (arch x shape x mesh) cell on
placeholder ranks, and record what one rank would execute and hold.

Run:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --arch mamba2-2.7b --mesh both

The port of the JAX package's ``repro/launch/dryrun.py``, which lowers
and compiles each cell for 512 placeholder devices.  PyTorch has no
ahead-of-time lowering of a whole step, so the counterpart runs the step
once, eagerly, on rank 0 of a ``"fake"`` process group of 256 or 512
ranks (collectives return at once and move nothing) with every tensor on
the ``meta`` device (shapes and dtypes, no values, nothing allocated: a
671B model costs no host memory).  For each cell this:

  1. builds the production mesh (16x16 or 2x16x16) over the fake group,
  2. builds the model on meta and lays its parameters (and the optimizer
     state, caches and batch) out as meta DTensors by the same sharding
     decisions as the reference (``build_cell``),
  3. runs the train step / prefill / decode step once under
     :func:`repro_torch.core.op_cost.count_local`: the FLOPs, bytes and
     collective wire bytes of rank 0's local ops,
  4. records per-device argument and output bytes from the local shard
     sizes, the peak of a second run under ``MemTracker`` (no temp
     bytes: there is no compiler's buffer assignment to read), and the
     roofline terms, to
     ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json`` with the
     reference's keys.

Only one default process group can exist in a process: run the dry-run
in a process of its own wherever another group is started.  The eager
count is not the reference's fused XLA count (ROADMAP queue 3).

Sharding policy, as the reference's: DP over (pod, data), ZeRO-3/FSDP
params over the data axes, TP over model, EP experts over model (and the
data axes where the expert count divides), SP for activations (train)
and cache sequence (decode).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, all_cells, get_config, skipped_cells
from repro_torch.core import op_cost, roofline
from repro_torch.launch.mesh import (
    POD_DATA,
    data_axes_of,
    flat_production_mesh,
    make_production_mesh,
    n_chips,
)
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.parallel.context import constrain_logical, use_mesh, use_rules
from repro_torch.parallel.sharding import (
    PartitionSpec,
    cache_specs,
    distribute,
    fixup_specs,
    make_rules,
    merge_spec_tree,
    mesh_shape,
    spec_leaves,
    specs_from_logical,
    splits_apart,
)
from repro_torch.runtime.train_loop import TrainConfig, build_train_step, init_state

ARTIFACTS = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                          "artifacts", "dryrun_torch"))


def build_rules(mesh, shape_kind: str, sp: bool = True,
                weight_stationary: bool = False,
                data_axes_override=None, expert_axes=None):
    """Sharding rules per shape kind.

    ``weight_stationary`` (serving, when params fit TP-only): replicate
    weights across the data axes instead of FSDP — the reference measured
    the per-token weight all-gathers it removes at 2.7x on granite-8b
    decode_32k.
    """
    data_axes = data_axes_override or data_axes_of(mesh)
    return make_rules(
        data_axes=data_axes,
        fsdp=not weight_stationary,
        fsdp_axes=data_axes,  # ZeRO-3: params sharded over every data axis
        expert_axes=expert_axes,
        seq_shard_cache=(shape_kind == "decode"),
        extra=(
            (("act_seq", ("model",)),)
            if sp and shape_kind == "train"
            else ()
        ),
    )


# serving is weight-stationary when TP-only params fit comfortably in HBM
_WS_HBM_BUDGET = 8 * 1024**3  # bf16 params per chip, model-axis sharded


def _axes_size(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in axes)


def cell_rules(cfg, shape, mesh, sp: bool = True):
    """The cell's sharding decisions, the reference's ``build_cell``'s:
    (rules, {"data_axes", "pure_dp", "weight_stationary", "expert_axes"}).
    ``mesh`` is a ``DeviceMesh`` or a shim whose ``.shape`` maps axis
    name to size."""
    data_axes = data_axes_of(mesh)
    sizes = mesh_shape(mesh)
    weight_stationary = False
    if shape.kind in ("prefill", "decode"):
        total, _ = cfg.param_counts()
        weight_stationary = (total * 2 / sizes["model"]) < _WS_HBM_BUDGET
    # pure-DP fallback (batch over the model axis too): the reference's
    # refuted hypothesis, kept as an explicit experiment knob only
    msize = sizes["model"]
    pure_dp = bool(int(os.environ.get("REPRO_PURE_DP", "0"))) and (
        shape.kind == "train"
        and shape.global_batch % (_axes_size(mesh, data_axes) * msize) == 0
    )
    if pure_dp:
        data_axes = data_axes + ("model",)
    # widest expert placement that divides the expert count: spanning the
    # data axes makes experts device-local
    expert_axes = None
    if cfg.n_experts:
        for cand in (("model",) + data_axes, ("model",) + data_axes[-1:], ("model",)):
            if cfg.n_experts % _axes_size(mesh, cand) == 0:
                expert_axes = cand
                break
    rules = build_rules(mesh, shape.kind, sp=sp and not pure_dp,
                        weight_stationary=weight_stationary,
                        data_axes_override=data_axes,
                        expert_axes=expert_axes)
    return rules, {"data_axes": data_axes, "pure_dp": pure_dp,
                   "weight_stationary": weight_stationary, "expert_axes": expert_axes}


def input_specs(arch_id: str, shape_name: str, opt_state_dtype: str = "f32",
                smoke: bool = False, layers: Optional[int] = None) -> Dict[str, Any]:
    """Meta stand-ins for every input of the cell's step: the model (its
    parameters on meta), tokens, labels, caches and frames.  ``layers``
    cuts the depth (the widths stay the config's)."""
    cfg = get_config(arch_id, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES[shape_name]
    if cfg.n_experts and shape.kind in ("train", "prefill") and not smoke:
        # explicit-all-to-all expert parallelism for the big token counts
        # (the reference measured ~10x the wire bytes on the capacity path)
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    model = build_model(cfg, device="meta")
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {"config": cfg, "model": model, "shape": shape}
    if shape.kind == "train":
        out["tokens"] = torch.zeros((b, s), dtype=torch.long, device="meta")
        out["labels"] = torch.zeros((b, s), dtype=torch.long, device="meta")
    elif shape.kind == "prefill":
        # cache capacity == prompt length: the prefill write replaces the
        # whole buffer
        out["tokens"] = torch.zeros((b, s), dtype=torch.long, device="meta")
        out["caches"] = model.init_caches(b, s, dtype=torch.bfloat16)
    else:  # decode: one new token against a seq_len-deep cache
        out["tokens"] = torch.zeros((b, 1), dtype=torch.long, device="meta")
        out["caches"] = [dict(c, length=s - 1) if "length" in c else c
                         for c in model.init_caches(b, s, dtype=torch.bfloat16)]
    if cfg.family == "audio":
        frames = min(cfg.max_source_positions, 1500)
        out["frames"] = torch.zeros((b, frames, cfg.d_model), dtype=cfg.dtype, device="meta")
    return out


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def local_bytes(tree) -> int:
    """Bytes of this rank's blocks of the tensors in ``tree``."""
    total = 0
    for t in _tensors(tree):
        loc = t.to_local() if hasattr(t, "to_local") else t
        total += loc.numel() * loc.element_size()
    return total


_POD_DATA = ("pod", "data")


def flat_view(mesh, rules, spec_trees):
    """``(mesh, rules, spec_trees)`` moved to the multi-pod mesh's flat
    view (:func:`repro_torch.launch.mesh.flat_production_mesh`) where
    neither the rules nor any spec names ``pod`` or ``data`` other than as
    the run ``("pod", "data")``; else as given.  On the view each rank
    holds the block it holds on the 3-D mesh, and DTensor plans each op
    over two mesh dims instead of three (a 2x16x16 train step at depth 1
    took its strategy search 887 s on an 8-core CPU)."""
    if "pod" not in mesh.mesh_dim_names or not can_flatten(rules, spec_trees):
        return mesh, rules, spec_trees
    return (flat_production_mesh(mesh.device_type), rules.merged(_POD_DATA, POD_DATA),
            merge_spec_tree(spec_trees, _POD_DATA, POD_DATA))


def can_flatten(rules, spec_trees) -> bool:
    """Whether neither ``rules`` nor any spec of ``spec_trees`` names
    ``pod`` or ``data`` other than as the run ``("pod", "data")``."""
    parts = [p for sp in spec_leaves(spec_trees) for p in sp]
    parts += [mesh_axes for _, mesh_axes in rules.table]
    return not any(splits_apart(p, _POD_DATA) for p in parts)


def build_cell(arch_id: str, shape_name: str, mesh, *, sp: bool = True,
               opt_state_dtype: str = "f32", smoke: bool = False,
               layers: Optional[int] = None):
    """Returns (step fn, its DTensor arguments, model_flops, meta);
    meta['_rules'] carries the Rules used (active while the step runs) and
    meta['_mesh'] the mesh the arguments lie on (``mesh``, or its flat
    view: :func:`flat_view`)."""
    spec = input_specs(arch_id, shape_name, opt_state_dtype, smoke=smoke, layers=layers)
    cfg, model, shape = spec["config"], spec["model"], spec["shape"]
    chips = n_chips(mesh)
    # the sharding decisions of the config at its full depth, at any cut
    rules, decided = cell_rules(get_config(arch_id, smoke=smoke), shape, mesh, sp=sp)
    pure_dp, weight_stationary, expert_axes = (
        decided["pure_dp"], decided["weight_stationary"], decided["expert_axes"])
    data_axes = decided["data_axes"]

    # params (and the caches): logical -> physical (+ divisibility fixup)
    named = dict(model.named_parameters())
    pspecs = fixup_specs(specs_from_logical(model.logical_specs(), rules), named, mesh)
    cspecs = ([] if shape.kind == "train" else
              fixup_specs(cache_specs(spec["caches"], rules, mesh), spec["caches"], mesh))
    bspec = PartitionSpec(
        data_axes if shape.global_batch % _axes_size(mesh, data_axes) == 0 else None)
    meta: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "kind": shape.kind,
        "chips": chips, "mesh": "x".join(map(str, mesh.shape)),
        "pure_dp": pure_dp, "weight_stationary": weight_stationary,
        "expert_axes": list(expert_axes) if expert_axes else None,
    }
    if shape.kind != "decode":
        # a decode step keeps the 3-D mesh and the counts recorded there: on
        # the view one gather over pod_data replaces DTensor's two (pod, then
        # data), whose local copies count 640 ops, 655,360 FLOPs and 2.6 MB
        # more on granite-3-2b x decode_32k
        mesh, rules, (pspecs, cspecs, bspec) = flat_view(mesh, rules,
                                                         [pspecs, cspecs, bspec])
    meta.update(mesh_view="x".join(map(str, mesh.shape)), _rules=rules, _mesh=mesh)
    total, active = cfg.param_counts()
    meta.update(total_params=total, active_params=active)
    # as meta DTensors
    params = {k: distribute(p.detach(), pspecs[k], mesh).requires_grad_(p.requires_grad)
              for k, p in named.items()}
    # the blocks the ranks hold, read off the DTensors on the mesh used
    meta["param_bytes_per_device"] = local_bytes(params)

    # activation constraint (the residual stream: sequence-parallel in a
    # train step, whole in a prefill), and the sequence gathered before each
    # block's products.  Left free, a prefill's stream takes whatever layout
    # DTensor's choices give it, a sequence split over the model axis among
    # them, which the next products would flatten into the batch.
    if hasattr(model, "stack_cfg") and (shape.kind == "prefill"
                                        or (shape.kind == "train" and sp)):
        model.stack_cfg = dataclasses.replace(
            model.stack_cfg,
            act_constraint=functools.partial(constrain_logical,
                                             logical_axes=("act_batch", "act_seq", None)),
            act_gather=functools.partial(constrain_logical,
                                         logical_axes=("act_batch", None, None)),
        )

    def batch(t):
        return distribute(t, PartitionSpec(bspec[0], *([None] * (t.dim() - 1))), mesh)

    from repro_torch.runtime import model_loss

    if shape.kind == "train":
        model_flops = cfg.model_flops_train(shape.global_batch, shape.seq_len)
        opt = adamw(cosine_warmup(3e-4, 2000, 100_000), state_dtype=opt_state_dtype)

        def loss_fn(p, tokens, labels):
            if cfg.family == "audio":
                # the synthetic frames laid out like real data would be
                frames = batch(torch.zeros((shape.global_batch,
                                            min(cfg.max_source_positions, 1500), cfg.d_model),
                                           dtype=cfg.dtype, device="meta"))
                return model_loss(model, p, tokens, labels, frames=frames)
            return model_loss(model, p, tokens, labels)

        tc = TrainConfig(grad_accum=1)
        with use_mesh(mesh), use_rules(rules):
            state = init_state(params, opt, tc)
        step = build_train_step(loss_fn, opt, tc, mesh=mesh, rules=rules)
        return step, (state, spec["tokens"], spec["labels"]), model_flops, meta

    # serving paths: the caches laid out by the reference's cache policy
    caches = [{k: (distribute(v, cs[k], mesh) if isinstance(v, torch.Tensor) else v)
               for k, v in c.items()} for c, cs in zip(spec["caches"], cspecs)]
    tokens = batch(spec["tokens"])
    frames = batch(spec["frames"]) if cfg.family == "audio" else None
    if shape.kind == "prefill":
        model_flops = 2.0 * active * shape.global_batch * shape.seq_len
        kwargs = {"embeddings": frames} if frames is not None else {}

        def fn(tokens, caches):
            with torch.no_grad():
                return model.prefill(tokens, caches, last_only=True, **kwargs)
    else:  # decode
        model_flops = 2.0 * active * shape.global_batch
        kwargs = {"embeddings": frames} if frames is not None else {}

        def fn(tokens, caches):
            with torch.no_grad():
                return model.decode_step(tokens, caches, **kwargs)

    def serve(p, tokens, caches):
        return torch.func.functional_call(_Serve(model, fn), {f"model.{k}": v for k, v in
                                                              p.items()}, (tokens, caches))

    return serve, (params, tokens, caches), model_flops, meta


class _Serve(torch.nn.Module):
    """``fn`` run with the model's parameters replaced (functional_call)."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, tokens, caches):
        return self.fn(tokens, caches)


def _peak_bytes(fn, args) -> float:
    """The peak of one rank's memory over a second run of the step, from
    ``MemTracker`` (its local blocks, on ``meta``)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    tracker = MemTracker()
    with tracker:
        fn(*args)
    return float(sum(v["Total"] for v in tracker.get_tracker_snapshot("peak").values()))


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, *, sp: bool = True,
             opt_state_dtype: str = "f32", out_dir: Optional[str] = None,
             verbose: bool = True, layers: Optional[int] = None) -> Dict[str, Any]:
    """One cell on the production mesh; needs the default process group
    to be a ``"fake"`` one of 256 (512 with ``multi_pod``) ranks (see
    :func:`fake_world`).  ``layers`` cuts the model's depth."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = n_chips(mesh)
    t0 = time.time()
    fn, args, model_flops, meta = build_cell(
        arch_id, shape_name, mesh, sp=sp, opt_state_dtype=opt_state_dtype, layers=layers
    )
    t_build = time.time() - t0
    from torch.distributed.tensor.experimental import implicit_replication

    rules, mesh = meta.pop("_rules"), meta.pop("_mesh")
    arg_bytes = local_bytes(args)
    t1 = time.time()
    with use_mesh(mesh), use_rules(rules), implicit_replication():
        out, cost = op_cost.count_local(lambda: fn(*args))
        t_run = time.time() - t1
        peak = _peak_bytes(fn, args)
    out_bytes = local_bytes(out)
    # what the step returns in its inputs' place (the train step updates
    # its state in place; the reference donates state and caches)
    alias = local_bytes(out[0]) if meta["kind"] == "train" else local_bytes(out[1])
    mem = {
        "argument_size_in_bytes": float(arg_bytes),
        "output_size_in_bytes": float(out_bytes),
        "alias_size_in_bytes": float(alias),
        "temp_size_in_bytes": None,  # no compiler's buffer assignment to read
        "peak_bytes": peak,
    }
    wall = time.time() - t0
    terms = roofline.from_raw(f"{arch_id}/{shape_name}", chips, cost.flops, cost.bytes,
                              cost.wire_bytes, model_flops=model_flops)
    result = {
        **meta,
        "ok": True,
        "lower_s": round(t_build, 2),
        "compile_s": round(t_run, 2),
        "wall_s": round(wall, 2),  # the cell's build, step and peak run
        "memory": mem,
        "per_device_bytes": arg_bytes + out_bytes - alias,
        "cost": {"flops": cost.flops, "bytes": cost.bytes,
                 "product_flops": cost.product_flops, "ops": cost.ops},
        "xla_cost_singlecount": None,
        "collectives": {
            "total_wire_bytes_per_device": cost.wire_bytes,
            "by_op": dict(cost.by_collective),
            # how many of each kind, output shape and group size: where two
            # torch versions' counts part, which collectives make the difference
            "by_shape": dict(collections.Counter(
                f"{c.op} {c.shape} over {c.group_size}" for c in cost.collectives)),
        },
        "model_flops": model_flops,
        "roofline": terms.as_dict(),
        "bound": terms.bound,
    }
    if verbose:
        gib = result["per_device_bytes"] / 2**30
        print(
            f"[dryrun] {arch_id:>22s} x {shape_name:<12s} mesh={meta['mesh']:<8s} "
            f"build {t_build:5.1f}s run {t_run:6.1f}s | {gib:7.2f} GiB/chip | "
            f"{terms.summary()}"
        )
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch_id}__{shape_name}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def fake_world(world_size: int) -> None:
    """Make the default process group a ``"fake"`` one of ``world_size``
    ranks (this process rank 0), replacing a fake one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs a process of its own: a "
                               f"{dist.get_backend()} process group is started here")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="every cell of the grid (with --arch / --shape, those of the grid's "
                         "cells that match)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--no-sp", action="store_true")
    ap.add_argument("--opt-state-dtype", default="f32", choices=["f32", "bf16", "int8"])
    ap.add_argument("--out", default=None,
                    help=f"where to write <mesh>/<arch>__<shape>.json (default {ARTIFACTS})")
    args = ap.parse_args(argv)

    if args.all:  # the grid, or its cells of --arch / --shape
        cells = [(a, s) for a, s in all_cells()
                 if args.arch in (None, a) and args.shape in (None, s)]
    else:
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = []
    for multi in meshes:
        mesh_name = "multi_2x16x16" if multi else "single_16x16"
        out_dir = os.path.join(args.out or ARTIFACTS, mesh_name)
        fake_world(512 if multi else 256)
        for arch_id, shape_name in cells:
            if arch_id is None or shape_name is None:
                raise SystemExit("--arch/--shape required unless --all")
            try:
                run_cell(arch_id, shape_name, multi, sp=not args.no_sp,
                         opt_state_dtype=args.opt_state_dtype, out_dir=out_dir)
            except Exception as e:  # noqa: BLE001 — report, continue, fail at end
                failures.append((mesh_name, arch_id, shape_name, repr(e)[:300]))
                print(f"[dryrun] FAIL {arch_id} x {shape_name} ({mesh_name}): {e}")
    skips = skipped_cells()
    print(f"\n[dryrun] done: {len(cells) * len(meshes) - len(failures)} ok, "
          f"{len(failures)} failed, {len(skips)} skipped-by-design "
          f"(long_500k on full-attention archs)")
    if failures:
        for f in failures:
            print("  FAIL:", *f)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
