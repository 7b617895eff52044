"""Mesh construction over ``torch.distributed`` (functions only — importing
this module touches no process group).

The port of the JAX package's ``repro/launch/mesh.py``.  A mesh is a
``DeviceMesh`` with named dims over the ranks of the default process
group (one process per device).  The reference's ``mesh_axis_types`` is
a JAX-version shim for ``jax.make_mesh``'s ``axis_types`` keyword and
has no counterpart here: ``init_device_mesh`` takes no such argument.
"""

from __future__ import annotations

import math
from typing import Tuple

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}

#: the one dim of the multi-pod mesh's flat view that carries ("pod",
#: "data"), major to minor (the name ``DeviceMesh._flatten`` gives them)
POD_DATA = "pod_data"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes``, over the
    default process group (whose world size must be the shape's product)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks): in
    practice over a ``"fake"`` process group of that world size
    (:mod:`repro_torch.launch.dryrun`)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


def flat_production_mesh(device_type: str = "cpu"):
    """The 2x16x16 mesh viewed as 32x16, ``(pod_data, model)``.

    Rank ``pod * 256 + data * 16 + model`` sits at ``(pod * 16 + data,
    model)``, so a dim split over ``("pod", "data")`` on the 3-D mesh is
    one ``Shard`` of ``pod_data`` here and each rank holds the same block.
    DTensor's strategy search costs far less over two mesh dims than over
    three (``repro_torch.launch.dryrun`` takes this view where no spec
    names one of the two axes without the other)."""
    (pod, data, model), (_, _, model_axis) = PRODUCTION_SHAPES[True]
    return make_mesh((pod * data, model), (POD_DATA, model_axis), device_type)


def data_axes_of(mesh) -> Tuple[str, ...]:
    """The data axes of a ``DeviceMesh`` (or of a shim whose ``.shape``
    maps axis name to size)."""
    names = mesh.shape if isinstance(mesh.shape, dict) else mesh.mesh_dim_names
    if "pod" in names:
        return ("pod", "data")
    return (POD_DATA,) if POD_DATA in names else ("data",)


def n_chips(mesh) -> int:
    shape = mesh.shape.values() if isinstance(mesh.shape, dict) else mesh.shape
    return math.prod(shape)
