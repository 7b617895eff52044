"""repro_torch.parallel — logical sharding rules on a ``DeviceMesh``, the
active rules and mesh, gradient compression and the GPipe pipeline (the
port of the JAX package's ``repro/parallel``)."""

from . import compression, context, pipeline, sharding
from .sharding import (
    PartitionSpec,
    Rules,
    cache_specs,
    constrain,
    distribute_params,
    fixup_specs,
    make_rules,
    placements,
    specs_from_logical,
)

__all__ = [
    "PartitionSpec",
    "Rules",
    "cache_specs",
    "compression",
    "constrain",
    "context",
    "distribute_params",
    "fixup_specs",
    "make_rules",
    "pipeline",
    "placements",
    "sharding",
    "specs_from_logical",
]
