"""repro_torch.models — the model definitions and the model -> kernel bridge.

``model`` holds ``ModelConfig``, the decoder-only ``LM`` and
``build_model``; ``encdec`` the whisper backbone; ``attention``, ``moe``,
``mamba``, ``layers``, ``params`` and ``transformer`` the pieces, each
named as its counterpart in the JAX package.  ``registry`` holds the
profiled models and their kernel derivation.
"""

from repro_torch import cpu_math

from . import (
    attention,
    encdec,
    frontends,
    layers,
    mamba,
    model,
    moe,
    params,
    registry,
    transformer,
)
from .model import LM, BlockKind, ModelConfig, build_model

cpu_math.prepare()  # before any forward runs on the CPU

__all__ = [
    "LM",
    "BlockKind",
    "ModelConfig",
    "attention",
    "build_model",
    "encdec",
    "frontends",
    "layers",
    "mamba",
    "model",
    "moe",
    "params",
    "registry",
    "transformer",
]
