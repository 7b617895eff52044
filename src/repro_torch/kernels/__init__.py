"""repro_torch.kernels — hand-written Hopper kernels and the kernel registry.

Each kernel module ships the CUDA kernels' wrappers (launch counters, no
fallback on a CUDA tensor), their plain PyTorch versions, and profiler
``KernelSpec`` builders that describe the CUDA kernels' own per-warp
footprints.  ``ops`` holds the public wrappers, ``ref`` the oracles.

The **registry** makes every kernel addressable by name for the
``cuthermo`` front end, with the same semantics as the JAX package's
(``role`` / :meth:`RegistryEntry.ladder` / :func:`build` /
:func:`resolve`).  A variant also knows how to launch its kernel on seeded
inputs at the registry's shapes (:func:`run_variant`), which is how
``cuthermo profile`` puts a measured launch beside the modeled heat map.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec
from repro_torch.core.trace import GridSampler

from . import gemm, ops, ref

#: Inputs of one launch: ``(device, generator) -> positional tensors``.
InputMaker = Callable[[torch.device, torch.Generator], Tuple[torch.Tensor, ...]]


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One profile-ready point on a kernel's optimization ladder.

    ``kernel`` is the wrapper that launches the variant's CUDA kernel,
    ``plain`` its plain PyTorch version, and ``inputs`` makes seeded
    inputs at the registry's shapes; all three are ``None`` for a
    spec-only variant.
    """

    name: str
    build: Callable[[], KernelSpec]
    context: Optional[Callable[[], Dict[str, np.ndarray]]] = None
    role: str = "baseline"  # 'baseline' | 'optimized'
    note: str = ""
    kernel: Optional[Callable[..., torch.Tensor]] = None
    plain: Optional[Callable[..., torch.Tensor]] = None
    inputs: Optional[InputMaker] = None
    atol: float = 0.0  # max |kernel - plain| accepted on the registry inputs

    def spec(self) -> KernelSpec:
        """Build the KernelSpec at the registry's default shapes."""
        return self.build()

    def dynamic_context(self) -> Optional[Dict[str, np.ndarray]]:
        """Deterministic dynamic context (seeded), or None if not needed."""
        return self.context() if self.context is not None else None


def _full() -> GridSampler:
    # Full-grid sampling: aligned (whole-problem) coverage is what lets two
    # variants' transfer totals diff meaningfully.
    return GridSampler(None)


@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    """One named kernel family: variants + the sampler that suits it."""

    name: str
    summary: str
    variants: Tuple[KernelVariant, ...]
    sampler: Callable[[], GridSampler] = _full
    region_map: Tuple[Tuple[str, str], ...] = ()  # baseline->optimized renames

    def variant(self, name: Optional[str] = None) -> KernelVariant:
        """Look up a variant by name; the first (baseline) is the default."""
        if name is None:
            return self.variants[0]
        for v in self.variants:
            if v.name == name:
                return v
        raise KeyError(
            f"kernel {self.name!r} has no variant {name!r} "
            f"(have {[v.name for v in self.variants]})"
        )

    def variant_names(self) -> Tuple[str, ...]:
        """All variant names, baseline first."""
        return tuple(v.name for v in self.variants)

    def ladder(self, min_position: int = 0) -> Tuple[Tuple[int, KernelVariant], ...]:
        """The family's optimization ladder: (position, variant) pairs.

        Only ``role='optimized'`` variants, in published (paper) order,
        starting at ``min_position``.
        """
        return tuple(
            (pos, v)
            for pos, v in enumerate(self.variants)
            if v.role == "optimized" and pos >= min_position
        )


GEMM_SHAPE = (1024, 1024, 1024)  # (m, n, k)


def _gemm_inputs(device: torch.device, gen: torch.Generator):
    m, n, k = GEMM_SHAPE
    a = torch.randn((m, k), generator=gen, device=device, dtype=torch.float32)
    b = torch.randn((k, n), generator=gen, device=device, dtype=torch.float32)
    return a, b


def _gemm_variant(name: str, role: str, note: str) -> KernelVariant:
    return KernelVariant(
        name,
        lambda: getattr(gemm, f"gemm_{name}_spec")(*GEMM_SHAPE),
        role=role,
        note=note,
        kernel=gemm.KERNELS[name],
        plain=gemm.gemm_plain,
        inputs=_gemm_inputs,
        # float32 sums of 1024 N(0,1) products (|C| ~ 32) in another order
        atol=1e-3,
    )


REGISTRY: Dict[str, RegistryEntry] = {
    e.name: e
    for e in (
        RegistryEntry(
            name="gemm",
            summary="dense matmul ladder: lanes on rows (false sharing on "
            "C) -> lanes on columns (coalesced) -> shared-memory tiled "
            "(paper §VI-A)",
            variants=(
                _gemm_variant(
                    "v00", "baseline",
                    "warp lanes on 32 rows of one column: false sharing on C",
                ),
                _gemm_variant(
                    "v01", "optimized",
                    "thread indices swapped: a warp covers whole C sectors",
                ),
                _gemm_variant(
                    "v02", "optimized",
                    "64x64x16 shared-memory tiles + 4x4 register micro-tiles",
                ),
            ),
            sampler=_full,
        ),
    )
}


def names() -> Tuple[str, ...]:
    """All registered kernel names, stable order."""
    return tuple(REGISTRY)


def get(name: str) -> RegistryEntry:
    """Look up a registry entry; raises KeyError with the known names."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel {name!r}; known: {', '.join(REGISTRY)}"
        ) from None


def resolve(ref: str) -> Tuple[RegistryEntry, KernelVariant]:
    """Resolve a CLI-style ``name`` or ``name:variant`` reference."""
    name, _, variant = ref.partition(":")
    entry = get(name)
    return entry, entry.variant(variant or None)


def build(ref: str) -> Tuple[KernelSpec, Optional[Dict[str, np.ndarray]]]:
    """Resolve + build a profile-ready (spec, dynamic_context) pair.

    Deterministic: two calls for the same ref collect identical traces.
    """
    _, variant = resolve(ref)
    return variant.spec(), variant.dynamic_context()


class KernelMismatch(RuntimeError):
    """A kernel's output disagreed with its plain version."""


def cuda_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 2) -> float:
    """Median device time of ``fn()`` in ms over ``iters`` timed calls.

    Each call is bracketed by its own pair of CUDA events on the current
    stream, so the figure is device time, not enqueue time.
    """
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def run_variant(
    variant: KernelVariant,
    device: "str | torch.device" = "cuda",
    iters: int = 20,
    seed: int = 0,
) -> Dict[str, object]:
    """Launch ``variant``'s kernel on seeded inputs and check it.

    On a CUDA device the kernel runs once against its plain version
    (float32 products without TF32), then ``iters`` more times under CUDA
    events; the record carries the device name, the launches made, the
    median time and the largest absolute error.  On the CPU the wrapper
    takes the plain version, so nothing is launched or timed.  Raises
    :class:`KernelMismatch` when the error exceeds ``variant.atol``.
    """
    if variant.kernel is None:
        raise ValueError(f"variant {variant.name!r} has no kernel to run")
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    args = variant.inputs(device, gen)
    on_card = device.type == "cuda"
    before = getattr(variant.kernel, "launches", 0)
    if on_card:
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            want = variant.plain(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    else:
        want = variant.plain(*args)
    got = variant.kernel(*args)
    if on_card:
        torch.cuda.synchronize(device)
    err = float((got.float() - want.float()).abs().max())
    if not err <= variant.atol:
        raise KernelMismatch(
            f"{variant.name}: max |kernel - plain| = {err:.3e} exceeds "
            f"{variant.atol:.1e}"
        )
    run: Dict[str, object] = {
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "shapes": [list(t.shape) for t in args],
        "dtype": str(args[0].dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": None,
    }
    if on_card:
        with torch.cuda.device(device):
            run["ms"] = cuda_time_ms(lambda: variant.kernel(*args), iters=iters)
    run["launches"] = getattr(variant.kernel, "launches", 0) - before
    return run


__all__ = [
    "GEMM_SHAPE",
    "KernelMismatch",
    "KernelVariant",
    "REGISTRY",
    "RegistryEntry",
    "build",
    "cuda_time_ms",
    "gemm",
    "get",
    "names",
    "ops",
    "ref",
    "resolve",
    "run_variant",
]
