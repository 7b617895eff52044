"""Test-side: the DTensor ops that torch 2.11 refuses, caught on a newer
torch.

The port's dry-run runs on the card's host under torch 2.11, whose DTensor
refuses some ops that a newer torch lays out (a view that flattens a split
dim becomes a ``_StridedShard`` there).  :func:`watch` wraps
``repro_torch.core.op_cost.LocalCounter``, the dispatch mode every dry-run
step runs under, and records each op on a DTensor that torch 2.11 would
refuse, with the model-code line that made it:

* ``aten.view`` / ``aten._unsafe_view`` (matmul's and einsum's flatten)
  under torch 2.11's strict view rule
  (``torch/distributed/tensor/_ops/_view_ops.py:propagate_shape_and_sharding``):
  a flattened group whose dims after the first is split, a flattened first
  dim its mesh dim does not divide, or a split dim whose first part its
  mesh dim does not divide;
* ``aten.constant_pad_nd`` (``F.pad``) on a mesh of two dims or more:
  torch 2.11's strategy gives one placement whatever the mesh, and the
  redistribution fails;
* ``aten.index_put`` whose values split a dim that the index selects (the
  backward of ``table[idx]``): torch 2.11 lays the table out as
  ``Shard(-1)`` and refuses it.

The rules are the ones read in torch 2.11's DTensor; the card's run is
what decides.  :func:`run_cell` runs a dry-run cell under the watch in a
process of its own.  This module imports no JAX: that process imports it.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
import traceback
from typing import List, Tuple

import torch

aten = torch.ops.aten
VIEWS = (aten.view.default, aten._unsafe_view.default)
PADS = (aten.constant_pad_nd.default,)
INDEX_PUTS = (aten.index_put.default, aten._index_put_impl_.default)


def _shard_dims(placements) -> dict:
    """Tensor dim -> the mesh dims that split it."""
    out: dict = {}
    for mesh_dim, p in enumerate(placements):
        if p.is_shard():
            out.setdefault(p.dim, []).append(mesh_dim)
    return out


def refused_view(shape, target, placements, mesh_sizes) -> str:
    """Why torch 2.11 refuses ``view(shape -> target)`` of a DTensor laid
    out by ``placements``, or ``""``."""
    from torch.distributed.tensor._ops._view_ops import Flatten, InputDim, Split, view_groups

    target = list(target)
    if -1 in target:
        known = math.prod(t for t in target if t != -1)
        target[target.index(-1)] = math.prod(shape) // max(known, 1)
    split = _shard_dims(placements)

    def first_of(cmd):
        if isinstance(cmd, InputDim):
            return cmd
        if isinstance(cmd, Flatten):
            for i, d in enumerate(cmd.input_dims):
                mesh_dims = split.get(d.input_dim, [])
                if i > 0 and mesh_dims:
                    raise _Refused(f"flattens dim {d.input_dim}, split, after dim "
                                   f"{cmd.input_dims[0].input_dim}")
                if i == 0 and mesh_dims and shape[d.input_dim] % mesh_sizes[mesh_dims[0]]:
                    raise _Refused(f"flattens dim {d.input_dim}, split unevenly")
            return cmd.input_dims[0]
        if isinstance(cmd, Split):
            in_dim = first_of(cmd.input_dim)
            if cmd.split_id == 0 and in_dim is not None:
                out = cmd.group_shape[0]
                for m in split.get(in_dim.input_dim, [])[:1]:
                    if out % mesh_sizes[m]:
                        raise _Refused(f"splits dim {in_dim.input_dim} into {out} first")
            return in_dim if cmd.split_id == 0 else None
        return None

    try:
        for cmd in view_groups(list(shape), target):
            first_of(cmd)
    except _Refused as e:
        return str(e)
    return ""


class _Refused(Exception):
    pass


def _port_line(frames) -> str:
    for frame in reversed(frames):
        if "repro_torch" in frame.filename and "op_cost" not in frame.filename:
            return f"{frame.filename.split('repro_torch/')[-1]}:{frame.lineno}"
    return "?"


def _site() -> str:
    """The innermost line of the port's code that made the op; in the
    backward, the autograd node's name and (under
    ``torch.autograd.set_detect_anomaly(True)``) its forward's line."""
    node = torch._C._current_autograd_node()
    if node is None:
        return _port_line(traceback.extract_stack())
    forward = node.metadata.get("traceback_") or []
    frames = [traceback.FrameSummary(f.split('"')[1], int(f.split("line ")[1].split(",")[0]),
                                     "") for f in "".join(forward).split("\n")
              if f.strip().startswith("File ")]
    return f"{node.name()} of {_port_line(frames)}"


def why_refused(func, args) -> str:
    """Why torch 2.11 refuses ``func(*args)`` on a DTensor, or ``""``."""
    from torch.distributed.tensor import DTensor

    if not args or not isinstance(args[0], DTensor):
        return ""
    t = args[0]
    sizes = tuple(t.device_mesh.shape)
    if func in VIEWS:
        return refused_view(tuple(t.shape), args[1], t.placements, sizes)
    if func in PADS and len(sizes) > 1:
        return "pads on a mesh of more than one dim"
    if func in INDEX_PUTS and isinstance(args[2], DTensor):
        offset = args[2].ndim - t.ndim
        if any(p.is_shard() and p.dim < offset for p in args[2].placements):
            return "index_put of values split on an indexed dim"
    return ""


def watch() -> List[Tuple]:
    """Record, from now on in this process, every op that torch 2.11 would
    refuse: a list of (op, shape, argument, reason, model-code line)."""
    from repro_torch.core import op_cost

    refused: List[Tuple] = []
    count = op_cost.LocalCounter.__torch_dispatch__

    def watched(self, func, types, args=(), kwargs=None):
        why = why_refused(func, args)
        if why:
            arg = list(args[1]) if func in VIEWS + PADS else None
            refused.append((str(func), list(args[0].shape), arg, why, _site()))
        return count(self, func, types, args, kwargs)

    op_cost.LocalCounter.__torch_dispatch__ = watched
    return refused


_CELL = textwrap.dedent("""
    import json, sys
    import torch_views
    from repro_torch.launch import dryrun
    arch, shape, multi, layers = sys.argv[1], sys.argv[2], sys.argv[3] == "1", int(sys.argv[4])
    refused = torch_views.watch()
    dryrun.fake_world(512 if multi else 256)
    res = dryrun.run_cell(arch, shape, multi, verbose=False, layers=layers)
    res["refused"] = refused
    print(json.dumps(res))
""")


def run_cell(arch: str, shape: str, multi: bool, layers: int, timeout: float) -> dict:
    """``repro_torch.launch.dryrun.run_cell`` of the cell cut to ``layers``
    deep, in a process of its own (a ``"fake"`` process group of 512 ranks
    with ``multi``, else 256) under :func:`watch`: its result, with the ops
    torch 2.11 would refuse under ``"refused"``."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(here), "src"), here]))
    out = subprocess.run([sys.executable, "-c", _CELL, arch, shape, str(int(multi)),
                          str(layers)], capture_output=True, text=True, env=env,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])
