"""repro_torch — the PyTorch/CUDA port of the CUTHERMO reproduction.

``repro_torch.core`` is the heat-map engine (NumPy), ``repro_torch.kernels``
the hand-written Hopper kernels with their plain PyTorch versions and
profiler specs, and ``python -m repro_torch.cli`` the ``cuthermo``
front end.  The package imports neither JAX nor the ``repro`` package.
"""

__version__ = "0.1.0"
