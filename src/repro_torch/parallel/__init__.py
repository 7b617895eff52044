"""repro_torch.parallel — gradient compression (the one-device part of the
JAX package's ``repro/parallel``; sharding, pipelining and context
parallelism are not ported yet)."""

from . import compression

__all__ = ["compression"]
