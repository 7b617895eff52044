"""The port's heat-map engine: NumPy on the host, as in ``repro.core``.

Modules mirror ``repro/core`` name for name; region layouts are
pluggable (:mod:`repro_torch.core.tiles`), so one engine models both the
H100's 32 B sectors and the TPU tile the JAX package is held to.
"""
