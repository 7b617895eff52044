"""The CPU's vector math, set up in one thread before a parallel call.

On the CPU, torch's ``exp``, ``log``, ``sin``, ``cos`` and ``sqrt`` of
float32 and float64 tensors call MKL's vector math (VML) once for each
chunk of an OpenMP parallel region.  The first VML call of a process,
made from several threads at once, sometimes computes some chunks on a
path off by ~1e-4 relative; every later call is exact.  The port's plain
SSD chunk shows it (``tools/vml_first_call.py``): on the mamba-tiny
registry inputs, in fresh processes run 16 at a time on an 8-core Xeon
with AVX-512, the first call's decays came out 1.04e-4 off in 1 of 960
processes (the y they feed 1.5e-3 off, past the chunk's tolerance) while
the second call was exact, and in 0 of 960 after :func:`prepare`.  It
makes the process's first call of each of those functions on one
element, which runs in the calling thread alone.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def prepare() -> None:
    """Call each VML function once on one element, in this thread (once a
    process)."""
    for dtype in (torch.float32, torch.float64):
        one = torch.ones(1, dtype=dtype)
        for fn in (torch.exp, torch.log, torch.sin, torch.cos, torch.sqrt):
            fn(one)
