"""Test-side: the JAX package's sharding decisions, parameter specs and
cache specs for a production-mesh cell, keyed like the port's.

The reference's ``build_cell`` makes its decisions inline, next to the
lowering; :func:`ref_rules` repeats them from the reference's own config
and ``build_rules``.  The meshes are shape shims (``FakeMesh``, as the
reference's own tests use): nothing here starts a process group.
"""

import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as JP

_saved = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402  (sets XLA_FLAGS on import)

if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

from repro.configs import SHAPES, get_config as ref_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.transformer import segments as ref_segments  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402

from repro_torch.configs import get_config as port_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model as port_build_model  # noqa: E402
from repro_torch.parallel import sharding as port_sharding  # noqa: E402


class FakeMesh:
    """A production mesh's axis sizes, and nothing else."""

    def __init__(self, multi: bool):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


def ref_rules(arch: str, shape_name: str, multi: bool):
    """The reference ``build_cell``'s rules for the cell (sp on, pure DP
    off), from its own config and ``build_rules``."""
    cfg, shape, mesh = ref_config(arch), SHAPES[shape_name], FakeMesh(multi)
    data_axes = ("pod", "data") if multi else ("data",)
    ws = False
    if shape.kind in ("prefill", "decode"):
        total, _ = cfg.param_counts()
        ws = (total * 2 / mesh.shape["model"]) < ref_dryrun._WS_HBM_BUDGET
    expert_axes = None
    if cfg.n_experts:
        for cand in (("model",) + data_axes, ("model",) + data_axes[-1:], ("model",)):
            if cfg.n_experts % math.prod(mesh.shape[a] for a in cand) == 0:
                expert_axes = cand
                break
    return ref_dryrun.build_rules(mesh, shape.kind, sp=True, weight_stationary=ws,
                                  data_axes_override=data_axes, expert_axes=expert_axes)


@functools.cache
def ref_model(arch: str, layers=None):
    """The reference's model of ``arch`` (cut to ``layers`` deep)."""
    cfg = ref_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return ref_build_model(cfg)


@functools.cache
def port_model(arch: str):
    return port_build_model(port_config(arch), device="meta")


def _flat(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


def ref_param_specs(arch: str, shape_name: str, multi: bool, layers=None):
    """Reference leaf path -> (fixed-up spec, shape, itemsize)."""
    model, mesh = ref_model(arch, layers), FakeMesh(multi)
    rules = ref_rules(arch, shape_name, multi)
    abstract = model.abstract_params()
    specs = ref_sharding.fixup_specs(
        ref_sharding.specs_from_logical(model.logical_specs(), rules), abstract, mesh)
    specs = _flat(specs, is_leaf=lambda x: isinstance(x, JP))
    shapes = _flat(abstract)
    return {p: (specs[p], tuple(a.shape), jnp.dtype(a.dtype).itemsize) for p, a in shapes.items()}


def port_param_specs(arch: str, shape_name: str, multi: bool):
    """Port parameter name -> fixed-up spec, from the port's dry-run
    decisions."""
    model, mesh = port_model(arch), FakeMesh(multi)
    rules, _ = dryrun.cell_rules(port_config(arch), SHAPES[shape_name], mesh)
    return port_sharding.fixup_specs(
        port_sharding.specs_from_logical(model.logical_specs(), rules),
        dict(model.named_parameters()), mesh)


def local_bytes(shape, spec, sizes, itemsize) -> int:
    parts = list(spec) + [None] * (len(shape) - len(spec))
    n = 1
    for d, part in zip(shape, parts):
        axes = () if part is None else ((part,) if isinstance(part, str) else tuple(part))
        n *= d // math.prod(sizes[a] for a in axes)
    return n * itemsize


def ref_param_bytes(arch: str, shape_name: str, multi: bool, layers=None) -> int:
    """Per-device parameter bytes under the reference's specs (of the model
    cut to ``layers`` deep)."""
    sizes = FakeMesh(multi).shape
    return sum(local_bytes(shape, spec, sizes, item)
               for spec, shape, item in ref_param_specs(arch, shape_name, multi,
                                                        layers).values())


def ref_cache_specs(arch: str, shape_name: str, multi: bool):
    """Per port layer, {leaf name: the reference's fixed-up spec of that
    layer's cache leaf, its stacked layer dim dropped}."""
    cfg, shape, mesh = ref_config(arch), SHAPES[shape_name], FakeMesh(multi)
    model = ref_model(arch)
    rules = ref_rules(arch, shape_name, multi)
    caches = model.init_caches(shape.global_batch, shape.seq_len, dtype=jnp.bfloat16,
                               abstract=True)
    specs = _flat(ref_sharding.fixup_specs(ref_sharding.cache_specs(caches, rules, mesh),
                                           caches, mesh), is_leaf=lambda x: isinstance(x, JP))
    if cfg.family == "audio" or cfg.n_encoder_layers:
        prefixes = [("", True)] * cfg.n_layers
    else:
        prefixes = []
        for si, (pattern, repeats) in enumerate(ref_segments(cfg.layout())):
            for _ in range(repeats):
                for bi in range(len(pattern)):
                    sub = "" if len(pattern) == 1 else f"sub{bi}/"
                    prefixes.append((f"seg{si}/{sub}", repeats > 1))
    out = []
    for prefix, stacked in prefixes:
        layer = {}
        for path, spec in specs.items():
            if path.startswith(prefix) and "/" not in path[len(prefix):]:
                layer[path[len(prefix):]] = tuple(spec)[1:] if stacked else tuple(spec)
        out.append(layer)
    return out


def port_cache_specs(arch: str, shape_name: str, multi: bool):
    shape, mesh = SHAPES[shape_name], FakeMesh(multi)
    model = port_model(arch)
    rules, _ = dryrun.cell_rules(port_config(arch), shape, mesh)
    caches = model.init_caches(shape.global_batch, shape.seq_len, dtype=torch.bfloat16)
    return port_sharding.fixup_specs(port_sharding.cache_specs(caches, rules, mesh), caches, mesh)
