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
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import cpu_math
from repro_torch.core.collector import KernelSpec
from repro_torch.core.trace import GridSampler

from . import (
    flash, gemm, gmm, gramschm, histogram, ops, paged_attn, ragged_flash,
    ref, spmv, ssd, ttm,
)

cpu_math.prepare()  # before any plain version runs on the CPU

#: Inputs of one launch: ``(device, generator) -> positional tensors``.
InputMaker = Callable[[torch.device, torch.Generator], Tuple[torch.Tensor, ...]]
#: What a kernel returns: one tensor, or several (ssd's ``(y, s)``).
Outputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
#: The largest |kernel - plain| accepted: a number, or the kernel module's
#: ``tolerance(want, *inputs)``, a number or a tensor that broadcasts over
#: ``want`` (one plain output).
Tolerance = Union[float, Callable[..., Union[float, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One profile-ready point on a kernel's optimization ladder.

    ``kernel`` is the wrapper that launches the variant's CUDA kernel,
    ``plain`` its plain PyTorch version (both return one tensor or a tuple
    of them), and ``inputs`` makes seeded inputs at the registry's shapes;
    all three are ``None`` for a spec-only variant.  ``kwargs`` holds the
    non-tensor arguments that both ``kernel`` and ``plain`` take by keyword
    (gramschm's column ``k``), as ``(name, value)`` pairs.
    """

    name: str
    build: Callable[[], KernelSpec]
    context: Optional[Callable[[], Dict[str, np.ndarray]]] = None
    role: str = "baseline"  # 'baseline' | 'optimized'
    note: str = ""
    kernel: Optional[Callable[..., Outputs]] = None
    plain: Optional[Callable[..., Outputs]] = None
    inputs: Optional[InputMaker] = None
    atol: Tolerance = 0.0  # max |kernel - plain| accepted on the registry inputs
    kwargs: Tuple[Tuple[str, object], ...] = ()

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


SPMV_SHAPE = (65536, 36417)  # (n_rows, n_cols)
HIST_SHAPE = (65536, 2048)  # (cells, n_bins)


def _spmv_context() -> Dict[str, np.ndarray]:
    n_rows, n_cols = SPMV_SHAPE
    rng = np.random.default_rng(0)
    return {"col_indices": rng.integers(0, n_cols, size=n_rows).astype(np.int32)}


def _hist_context() -> Dict[str, np.ndarray]:
    n, n_bins = HIST_SHAPE
    rng = np.random.default_rng(0)
    return {"cells": rng.integers(0, n_bins, size=n).astype(np.int64)}


def _hist_inputs(device: torch.device, gen: torch.Generator):
    # the launched cells are the profiled cells: the heat map walks them
    cells = _hist_context()["cells"].astype(np.int32)
    return (torch.from_numpy(cells).to(device),)


def _hist_variant(name: str, role: str, note: str) -> KernelVariant:
    # every rung walks the seeded cells, as every CUDA kernel scatters by
    # data (the reference's partials and scratch rungs model dense blocks)
    spec = {"naive": histogram.hist_naive_spec, "partials": histogram.hist_opt_spec,
            "scratch": histogram.hist_opt2_spec}[name]
    return KernelVariant(
        name,
        lambda: spec(*HIST_SHAPE),
        context=_hist_context,
        role=role,
        note=note,
        kernel=histogram.KERNELS[name],
        plain=histogram.PLAIN[name],
        inputs=_hist_inputs,
        # integer counts below 2**24 are exact in float32, in any order
        atol=0.0,
        kwargs=(("n_bins", HIST_SHAPE[1]),),
    )


GRAMSCHM_SHAPE = (512, 512, 512)  # (ni, nj, nk)
GRAMSCHM_K = 3
TTM_SHAPE = (512, 8, 32)  # (f, nf, r)


def _gramschm_inputs(transposed: bool) -> InputMaker:
    def make(device: torch.device, gen: torch.Generator):
        ni, nj, nk = GRAMSCHM_SHAPE
        q = torch.randn((ni, nk), generator=gen, device=device, dtype=torch.float32)
        a = torch.randn((ni, nj), generator=gen, device=device, dtype=torch.float32)
        return (q.t().contiguous() if transposed else q), a

    return make


def _gramschm_variant(name: str, role: str, note: str) -> KernelVariant:
    return KernelVariant(
        name,
        lambda: getattr(gramschm, f"k3_{name}_spec")(*GRAMSCHM_SHAPE, k=GRAMSCHM_K),
        role=role,
        note=note,
        kernel=gramschm.KERNELS[name],
        plain=gramschm.PLAIN[name],
        inputs=_gramschm_inputs(transposed=name == "opt"),
        # float32 sums of 512 N(0,1) products (|r| < ~80) in another order
        atol=1e-3,
        kwargs=(("k", GRAMSCHM_K),),
    )


def _ttm_inputs(device: torch.device, gen: torch.Generator):
    f, nf, r = TTM_SHAPE
    vals = torch.randn((f, nf), generator=gen, device=device, dtype=torch.float32)
    urows = torch.randn((f, nf, r), generator=gen, device=device, dtype=torch.float32)
    return vals, urows


def _ttm_variant(name: str, role: str, note: str) -> KernelVariant:
    return KernelVariant(
        name,
        lambda: getattr(ttm, f"ttm_{name}_spec")(*TTM_SHAPE),
        role=role,
        note=note,
        kernel=ttm.KERNELS[name],
        plain=ttm.ttm_plain,
        inputs=_ttm_inputs,
        # float32 sums of 8 N(0,1) products (|Y| < ~20), fused or not
        atol=1e-4,
    )


FLASH_SHAPE = (4, 1024, 1024, 128)  # (bh, sq, skv, d)
FLASH_BKV = 64
GMM_SHAPE = (1024, 512, 512, 8)  # (m, k, n, experts)
GMM_BM = 128
SSD_SHAPE = (4, 8, 128, 64, 64)  # (bh, chunks, l, p, n)


def _gmm_ids() -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.sort(rng.integers(0, 8, size=8)).astype(np.int64)


def _flash_inputs(device: torch.device, gen: torch.Generator):
    bh, sq, skv, d = FLASH_SHAPE
    return tuple(
        torch.randn((bh, s, d), generator=gen, device=device, dtype=torch.float32)
        for s in (sq, skv, skv)
    )


def _gmm_inputs(device: torch.device, gen: torch.Generator):
    m, k, n, e = GMM_SHAPE
    x = torch.randn((m, k), generator=gen, device=device, dtype=torch.float32)
    w = torch.randn((e, k, n), generator=gen, device=device, dtype=torch.float32)
    ids = torch.from_numpy(_gmm_ids().astype(np.int32)).to(device)
    return x, w, ids


def ssd_inputs(bh: int, c: int, l: int, p: int, n: int):
    """Seeded SSD inputs: x, B, C ~ N(0, 1) and log-decays a = -0.4 |N(0, 1)|
    (``tests/test_kernels.py``'s), all float32."""

    def make(device: torch.device, gen: torch.Generator):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

        x = randn(bh, c, l, p)
        a = -randn(bh, c, l).abs() * 0.4
        return x, a, randn(bh, c, l, n), randn(bh, c, l, n)

    return make


RAGGED_SHAPE = (
    ragged_flash.DEF_B, ragged_flash.DEF_H, ragged_flash.DEF_S, ragged_flash.DEF_D,
)  # (b, h, s, d)
RAGGED_BKV = ragged_flash.DEF_BKV
PAGED_SHAPE = (
    paged_attn.DEF_B, paged_attn.DEF_H, paged_attn.DEF_D, paged_attn.DEF_PAGE,
    paged_attn.DEF_PAGES, paged_attn.DEF_SLOTS,
)  # (b, h, d, page, pages, slots)


def _ragged_inputs(device: torch.device, gen: torch.Generator):
    # the launched bounds are the profiled bounds: the heat map walks them
    b, h, s, d = RAGGED_SHAPE
    ctx = ragged_flash.ragged_context(b, s)
    q, k, v = (
        torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        for shape in ((b, h, d), (b, s, d), (b, s, d))
    )
    return q, k, v, *(torch.from_numpy(ctx[n]).to(device) for n in ("starts", "ends"))


def _paged_inputs(dense: bool) -> InputMaker:
    """The paged rung's pool and tables from the context; the dense rung's
    contiguous per-row cache under the identity table, with the context's
    lengths."""

    def make(device: torch.device, gen: torch.Generator):
        b, h, d, page, pages, slots = PAGED_SHAPE
        ctx = paged_attn.paged_context(b, pages, slots, page)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

        q = randn(b, h, d)
        lens = torch.from_numpy(ctx["context_lens"]).to(device)
        if dense:
            k_pages, tables = paged_attn.contiguous_pages(randn(b, slots * page, d), page)
            v_pages, _ = paged_attn.contiguous_pages(randn(b, slots * page, d), page)
        else:
            k_pages, v_pages = randn(1, pages, page, d), randn(1, pages, page, d)
            tables = torch.from_numpy(ctx["block_tables"]).to(device)
        return q, k_pages, v_pages, tables, lens

    return make


def _ragged_variant(name: str, role: str, note: str, build, dense=None) -> KernelVariant:
    kernel = {}
    if dense is not None:
        dense_kw = (("dense", True),) if dense else ()
        kernel = dict(
            kernel=ragged_flash.ragged_decode_attention,
            plain=ragged_flash.ragged_decode_plain,
            inputs=_ragged_inputs,
            atol=ragged_flash.tolerance,
            kwargs=(("bkv", RAGGED_BKV), *dense_kw),
        )
    return KernelVariant(name, build, context=ragged_flash.ragged_context, role=role,
                         note=note, **kernel)


def _paged_variant(name: str, role: str, note: str, build, dense=None) -> KernelVariant:
    kernel = {}
    if dense is not None:
        kernel = dict(
            kernel=paged_attn.paged_decode_attention,
            plain=paged_attn.paged_decode_plain,
            inputs=_paged_inputs(dense),
            atol=paged_attn.tolerance,
            kwargs=(("dense", True),) if dense else (),
        )
    return KernelVariant(name, build, context=paged_attn.paged_context, role=role,
                         note=note, **kernel)


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
                    "BM x 128 block tiles (BM 64 or 128): bf16 on the tensor "
                    "cores, f32 with 8x8 register micro-tiles",
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="spmv",
            summary="CSR SpMV: misaligned rowOffsets view + x gather vs "
            "the zigzag duplicated-pairs fix (paper Fig. 7); spec only",
            variants=(
                KernelVariant(
                    "csr",
                    lambda: spmv.spmv_csr_spec(*SPMV_SHAPE),
                    context=_spmv_context,
                    note="shifted rowOffsets load straddles five sectors",
                ),
                KernelVariant(
                    "zigzag",
                    lambda: spmv.spmv_zigzag_spec(*SPMV_SHAPE),
                    context=_spmv_context,
                    role="optimized",
                    note="duplicated (start,end) pairs, one aligned load",
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="histogram",
            summary="GPUMD-style scatter histogram: global scatter vs "
            "per-block partials vs shared-memory accumulator",
            variants=(
                _hist_variant(
                    "naive", "baseline",
                    "every warp scatters into the global bins",
                ),
                _hist_variant(
                    "partials", "optimized",
                    "per-block partial rows, summed afterwards",
                ),
                _hist_variant(
                    "scratch", "optimized",
                    "shared-memory histogram per block, one flush each",
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="gramschm",
            summary="Gram-Schmidt kernel3: stride-N q column walk vs the "
            "transposed contiguous walk (paper §VI-B)",
            variants=(
                _gramschm_variant(
                    "naive", "baseline",
                    "q read with stride NK: one warm word per sector",
                ),
                _gramschm_variant("opt", "optimized", "qT read contiguously"),
            ),
            sampler=_full,
            region_map=(("q", "qT"),),
        ),
        RegistryEntry(
            name="ttm",
            summary="PASTA TTM: per-thread shared-memory partials (abuse) vs "
            "the fused register accumulation",
            variants=(
                _ttm_variant(
                    "scratch", "baseline",
                    "Y_shr holds warp-local partials: abuse",
                ),
                _ttm_variant(
                    "fused", "optimized",
                    "accumulate in registers, drop the shared memory",
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="cuszp",
            summary="cuSZp-style compression: one scalar per warp parked in "
            "shared memory",
            variants=(
                KernelVariant(
                    "like",
                    lambda: ttm.cuszp_like_spec(64),
                    note="exclusive-sum broadcast via shared memory",
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="flash",
            summary="flash attention: K/V tiles staged in shared memory, "
            "online softmax in registers (well-tiled reference)",
            variants=(
                KernelVariant(
                    "default",
                    lambda: flash.flash_spec(*FLASH_SHAPE, bkv=FLASH_BKV),
                    note="64-query blocks over 64-row KV tiles, causal",
                    kernel=flash.flash_attention,
                    plain=flash.flash_plain,
                    inputs=_flash_inputs,
                    atol=flash.tolerance,
                    kwargs=(("causal", True), ("bkv", FLASH_BKV)),
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="gmm",
            summary="grouped matmul (MoE expert dispatch): expert-indexed "
            "W fetches",
            variants=(
                KernelVariant(
                    "default",
                    lambda: gmm.gmm_spec(*GMM_SHAPE, _gmm_ids(), bm=GMM_BM),
                    note="each block reads its tile's expert id",
                    kernel=gmm.gmm,
                    plain=gmm.gmm_plain,
                    inputs=_gmm_inputs,
                    atol=gmm.tolerance,
                    kwargs=(("bm", GMM_BM),),
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="ssd",
            summary="Mamba SSD chunk scan: per-(head,chunk) state "
            "streaming",
            variants=(
                KernelVariant(
                    "chunk",
                    lambda: ssd.ssd_chunk_spec(*SSD_SHAPE),
                    note="one block per (head, chunk), chunk staged in shared memory",
                    kernel=ssd.ssd_chunk,
                    plain=ssd.ssd_plain,
                    inputs=ssd_inputs(*SSD_SHAPE),
                    atol=ssd.tolerance,
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="ragged_flash",
            summary="serving ragged flash attention: dense decode/prefill "
            "sweeps vs the EasyDeL-style block-skip over [starts, ends)",
            variants=(
                _ragged_variant(
                    "decode", "baseline",
                    "dense decode sweep: every KV block, every row",
                    ragged_flash.ragged_decode_spec, dense=True,
                ),
                _ragged_variant(
                    "decode-ragged", "optimized",
                    "scalar-prefetched bounds skip dead KV blocks",
                    ragged_flash.ragged_decode_ragged_spec, dense=False,
                ),
                _ragged_variant(
                    "prefill", "baseline", "dense causal prefill sweep",
                    ragged_flash.ragged_prefill_spec,
                ),
                _ragged_variant(
                    "prefill-ragged", "optimized",
                    "causal + ragged clamp on the KV walk",
                    ragged_flash.ragged_prefill_ragged_spec,
                ),
            ),
            sampler=_full,
        ),
        RegistryEntry(
            name="paged_attn",
            summary="serving paged KV-cache attention: contiguous cache "
            "sweep vs the vLLM-style block-table page gather",
            variants=(
                _paged_variant(
                    "decode", "baseline",
                    "contiguous per-row cache, dense slot sweep",
                    paged_attn.paged_decode_spec, dense=True,
                ),
                _paged_variant(
                    "decode-paged", "optimized",
                    "block-table gather, clamped to context_lens",
                    paged_attn.paged_decode_paged_spec, dense=False,
                ),
                _paged_variant(
                    "prefill", "baseline",
                    "dense causal sweep over the contiguous cache",
                    paged_attn.paged_prefill_spec,
                ),
                _paged_variant(
                    "prefill-paged", "optimized", "page gather + causal clamp",
                    paged_attn.paged_prefill_paged_spec,
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
    """Look up a registry entry; raises KeyError with the known names.

    Families named ``model.<model>.<kind>`` are derived from a model's
    layout by ``repro_torch.models.registry.kernel_entry``; ``names()``
    never lists them.
    """
    if name.startswith("model."):
        from repro_torch.models import registry as model_registry

        return model_registry.kernel_entry(name)
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

    The spec is *source-stamped* with its canonical ``name:variant`` ref,
    which is what lets a ``ShardedCollector`` worker rebuild the same
    spec (and seeded context) in another process: the spec object holds
    index-map lambdas and cannot be pickled.  Deterministic: two calls
    for the same ref collect identical traces.
    """
    entry, variant = resolve(ref)
    spec = dataclasses.replace(
        variant.spec(), source=f"{entry.name}:{variant.name}"
    )
    return spec, variant.dynamic_context()


def wrappers() -> Dict[str, Callable[..., Outputs]]:
    """Every kernel wrapper by its name: the registry's (the model families
    launch the same wrappers), and ``spmv_ell``, which only ``ops.spmv``
    reaches."""
    return {fn.__name__: fn
            for module in (gemm, spmv, histogram, gramschm, ttm, flash, gmm, ssd,
                           ragged_flash, paged_attn)
            for fn in module.KERNELS.values()}


def launch_counts() -> Dict[str, int]:
    """Launches so far of every kernel wrapper, by its name."""
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    """Set the launch count of every kernel wrapper to 0."""
    for fn in wrappers().values():
        fn.launches = 0


class KernelMismatch(RuntimeError):
    """A kernel's output disagreed with its plain version."""


def cuda_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 2) -> float:
    """Median time of one ``fn()`` as a caller waits for it, in ms, over
    ``iters`` timed calls: host issue included, not device time.

    Each call is bracketed by its own pair of CUDA events on the current
    stream.  A card that has finished the call before records the start
    event as soon as the host issues it, then waits for the wrapper's
    Python, allocations and launch, so a call whose kernels are shorter
    than its host issue is timed at the rate the host issues it.
    :func:`device_time_ms` gives the card's own time.
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


#: The shortest sleep :func:`device_time_ms` holds the queue with, in ms,
#: when no warm-up call gave the host's issue time to size it by.
SLEEP_MIN_MS = 2.0
_SLEEP_CALIBRATION_CYCLES = 1_000_000
_CYCLES_PER_MS: Dict[int, float] = {}


class QueueDrained(RuntimeError):
    """The card ran out of queued work while :func:`device_time_ms` timed
    it, so its span would hold the host's issue."""


def held_call_ms(span_ms: float, iters: int, sleeping: bool) -> float:
    """The card's mean time of one of ``iters`` calls queued behind a sleep,
    in ms, or :class:`QueueDrained`.

    ``span_ms`` runs from the event recorded right after the sleep to the
    one recorded after the last call; ``sleeping`` is True when the first
    event was still pending once the host had issued the last call and its
    event.  Then every call was queued before the card began the first, so
    the card ran them back to back and the span holds the card's work
    alone: no wait for the host.  Otherwise the card may have waited
    inside the span, and the figure is refused.
    """
    if iters < 1 or not span_ms > 0:
        raise ValueError(f"a span of {span_ms} ms over {iters} calls")
    if not sleeping:
        raise QueueDrained(
            f"the sleep ended before the host had issued all {iters} calls: "
            f"the card may have waited for the host inside the {span_ms:.4f} ms span"
        )
    return span_ms / iters


def _cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` in one ms on the current
    device, measured once per process with an event pair around a sleep."""
    dev = torch.cuda.current_device()
    if dev not in _CYCLES_PER_MS:
        torch.cuda._sleep(1000)  # loads the sleep kernel
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(_SLEEP_CALIBRATION_CYCLES)
        stop.record()
        stop.synchronize()
        _CYCLES_PER_MS[dev] = _SLEEP_CALIBRATION_CYCLES / start.elapsed_time(stop)
    return _CYCLES_PER_MS[dev]


def device_time_ms(fn: Callable[[], object], iters: int = 20, warmup: int = 2) -> float:
    """Time the card spends on one ``fn()``, in ms: the mean over ``iters``
    calls run back to back, whatever the host's issue costs.

    After the warm-up the current stream sleeps on the card
    (``torch.cuda._sleep``) while the host issues the ``iters`` calls, so
    they run back to back once it ends; one event right after the sleep
    and one after the last call bracket them all (a call of two kernels or
    a memset counts whole, with the card's own gap between kernels).  An
    event pair around each call would add its events' time on the card,
    about 3 us a record, to every call.  The sleep lasts three times the
    host's issue of the last warm-up call for each of the ``iters`` calls,
    at least ``SLEEP_MIN_MS``.  :func:`held_call_ms` refuses a batch whose
    sleep ended before the host had issued it; the calls are then timed
    once more behind twice the sleep and four times the host's issue of
    that batch, and if that sleep ends too soon as well
    :class:`QueueDrained` is raised.  There is no fallback to
    :func:`cuda_time_ms`.
    """
    issue_ms = 0.0
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
    sleep_ms = max(SLEEP_MIN_MS, 3 * iters * issue_ms)
    span_ms, sleeping, issued_ms = _held_calls(fn, iters, sleep_ms)
    try:
        return held_call_ms(span_ms, iters, sleeping)
    except QueueDrained:
        sleep_ms = max(2 * sleep_ms, 4 * issued_ms)
    span_ms, sleeping, _ = _held_calls(fn, iters, sleep_ms)
    return held_call_ms(span_ms, iters, sleeping)


def _held_calls(fn: Callable[[], object], iters: int, sleep_ms: float):
    """Issue ``iters`` calls of ``fn()`` behind a sleep of ``sleep_ms`` on
    the card: ``(span_ms, sleeping)`` as :func:`held_call_ms` takes them,
    and the host's time in ms to issue the sleep and the calls."""
    cycles = int(sleep_ms * _cycles_per_ms())
    held = torch.cuda.Event(enable_timing=True)
    done = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(cycles)
    held.record()
    for _ in range(iters):
        fn()
    done.record()
    sleeping = not held.query()
    issued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return held.elapsed_time(done), sleeping, issued_ms


def run_variant(
    variant: KernelVariant,
    device: "str | torch.device" = "cuda",
    iters: int = 20,
    seed: int = 0,
) -> Dict[str, object]:
    """Launch ``variant``'s kernel on seeded inputs and check it.

    On a CUDA device the kernel runs once against its plain version
    (float32 products without TF32), then is timed twice over ``iters``
    calls: ``ms`` is the median time of a call as a caller waits for it,
    host issue included (:func:`cuda_time_ms`, after two warm-up calls),
    and ``device_ms`` the time the card spends on a call
    (:func:`device_time_ms`).  The record carries the device name, the
    launches made, both times and the largest absolute error over all
    outputs, and the variant's non-tensor arguments under ``kwargs`` when
    it has any.  On the CPU the wrapper takes the plain version, so nothing
    is launched or timed and both times are None.
    Raises :class:`KernelMismatch` when an element's error exceeds
    ``variant.atol`` (each output held to its own tolerance).
    """
    if variant.kernel is None:
        raise ValueError(f"variant {variant.name!r} has no kernel to run")
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    args = variant.inputs(device, gen)
    kwargs = dict(variant.kwargs)
    on_card = device.type == "cuda"
    before = getattr(variant.kernel, "launches", 0)
    if on_card:
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            want = variant.plain(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    else:
        want = variant.plain(*args, **kwargs)
    got = variant.kernel(*args, **kwargs)
    if on_card:
        torch.cuda.synchronize(device)
    pairs = list(zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))))
    err = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
    for g, w in pairs:
        tol = variant.atol(w, *args) if callable(variant.atol) else variant.atol
        if not bool(((g.float() - w.float()).abs() <= tol).all()):
            raise KernelMismatch(
                f"{variant.name}: max |kernel - plain| = {err:.3e} exceeds "
                f"its tolerance ({float(torch.as_tensor(tol).min()):.1e} at "
                "its smallest)"
            )
    run: Dict[str, object] = {
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "shapes": [list(t.shape) for t in args],
        "dtype": str(args[0].dtype).replace("torch.", ""),
        "max_abs_err": err,
        "ms": None,
        "device_ms": None,
    }
    if kwargs:
        run["kwargs"] = kwargs
    if on_card:
        def call():
            return variant.kernel(*args, **kwargs)

        with torch.cuda.device(device):
            run["ms"] = cuda_time_ms(call, iters=iters)
            run["device_ms"] = device_time_ms(call, iters=iters, warmup=0)
    run["launches"] = getattr(variant.kernel, "launches", 0) - before
    return run


__all__ = [
    "FLASH_SHAPE",
    "GEMM_SHAPE",
    "GMM_SHAPE",
    "GRAMSCHM_K",
    "GRAMSCHM_SHAPE",
    "HIST_SHAPE",
    "KernelMismatch",
    "KernelVariant",
    "REGISTRY",
    "RegistryEntry",
    "build",
    "cuda_time_ms",
    "device_time_ms",
    "flash",
    "gemm",
    "get",
    "gmm",
    "gramschm",
    "held_call_ms",
    "histogram",
    "names",
    "ops",
    "PAGED_SHAPE",
    "paged_attn",
    "QueueDrained",
    "RAGGED_BKV",
    "RAGGED_SHAPE",
    "ragged_flash",
    "ref",
    "reset_launch_counts",
    "resolve",
    "run_variant",
    "SPMV_SHAPE",
    "spmv",
    "SSD_SHAPE",
    "ssd",
    "ssd_inputs",
    "TTM_SHAPE",
    "ttm",
]
