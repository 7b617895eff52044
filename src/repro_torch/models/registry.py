"""Model registry: CI-sized configs + the model -> kernel derivation bridge.

``MODELS`` holds the JAX package's three tiny-but-real configs
(``repro/models/registry.py``), each paired with the profile shapes
(batch, seq) that ``cuthermo model`` runs at.

This module is also the *kernel bridge*: ``kernel_entry`` synthesizes a
:class:`repro_torch.kernels.RegistryEntry` for references of the form
``model.<model>.<kind>`` (kind in attn / mlp / moe / ssm / unembed), with
the spec shapes derived from the model config; ``repro_torch.kernels.get``
delegates those names here.  Every rung of such a family launches the CUDA
kernel its spec describes, at the model's shapes (``kind_variant``):

  attn     ``flash_attention`` with KV tiles of 32 (base) or 64 (wide-kv);
  mlp      the GEMM ladder's ``gemm_v01`` and ``gemm_v02``, (tokens, d_ff,
           d_model); ``unembed`` the same at (tokens, padded_vocab, d_model);
  moe      ``gmm`` with 32-row (tile32) or 64-row (tile64) expert tiles;
  ssm      ``ssd_chunk``, one rung.

The kernels launch in float32, whatever ``cfg.dtype`` says, as the JAX
package's specs are float32 too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec

from .model import ModelConfig

__all__ = [
    "MODELS",
    "ModelEntry",
    "apply_overrides",
    "config_from_reference",
    "get_model",
    "kernel_entry",
    "kernel_kinds",
    "kind_spec",
    "kind_variant",
    "model_names",
]


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """A registered model: the config plus its default profile shapes."""

    config: ModelConfig
    batch: int
    seq: int
    summary: str = ""


MODELS: Dict[str, ModelEntry] = {
    "transformer-tiny": ModelEntry(
        config=ModelConfig(
            name="transformer-tiny",
            family="dense",
            n_layers=2,
            d_model=128,
            n_heads=4,
            n_kv_heads=4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            attn_chunk=64,
            dtype=torch.float32,
        ),
        batch=2,
        seq=64,
        summary="2-layer dense transformer (attn + swiglu MLP)",
    ),
    "moe-tiny": ModelEntry(
        config=ModelConfig(
            name="moe-tiny",
            family="moe",
            n_layers=2,
            d_model=128,
            n_heads=4,
            n_kv_heads=4,
            d_ff=128,
            vocab=512,
            head_dim=32,
            attn_chunk=64,
            n_experts=4,
            top_k=2,
            moe_period=1,
            dtype=torch.float32,
        ),
        batch=2,
        seq=64,
        summary="2-layer MoE transformer (attn + 4-expert ragged MoE)",
    ),
    "mamba-tiny": ModelEntry(
        config=ModelConfig(
            name="mamba-tiny",
            family="ssm",
            n_layers=2,
            d_model=128,
            n_heads=4,
            n_kv_heads=4,
            d_ff=0,
            vocab=512,
            attn_chunk=64,
            ssm_state=16,
            ssm_head_dim=32,
            ssm_expand=2,
            ssm_chunk=32,
            dtype=torch.float32,
        ),
        batch=2,
        seq=64,
        summary="2-layer Mamba-2 SSD stack (no FFN)",
    ),
}


def model_names() -> Tuple[str, ...]:
    """All registered model names, stable order."""
    return tuple(MODELS)


def get_model(name: str) -> ModelEntry:
    """Look up a model entry; raises KeyError with the known names."""
    try:
        return MODELS[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; known: {', '.join(MODELS)}"
        ) from None


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dtype


def config_from_reference(fields: Mapping) -> ModelConfig:
    """The port's config of ``dataclasses.asdict`` of a JAX-package
    ``ModelConfig``: every field as it is, the dtype taken by name."""
    fields = dict(fields)
    dtype = fields.pop("dtype")
    return ModelConfig(**fields, dtype=_torch_dtype(getattr(dtype, "__name__", dtype)))


def apply_overrides(cfg: ModelConfig, overrides: Sequence[str]) -> ModelConfig:
    """Apply CLI ``key=value`` overrides, coercing to the field's type.

    Coercion follows the *current* value's type (int/float/bool/str, and a
    torch dtype by name); unknown keys and malformed pairs raise
    ``ValueError`` so the CLI can map them to exit code 2.
    """
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    changes: Dict[str, object] = {}
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep or not key:
            raise ValueError(f"override {item!r} is not of the form key=value")
        if key not in fields:
            raise ValueError(
                f"unknown config field {key!r}; known: "
                f"{', '.join(sorted(fields))}"
            )
        current = getattr(cfg, key)
        if isinstance(current, bool):
            if raw.lower() not in ("true", "false", "0", "1"):
                raise ValueError(f"override {key}: expected bool, got {raw!r}")
            changes[key] = raw.lower() in ("true", "1")
        elif isinstance(current, (int, float)):
            kind = type(current)
            try:
                changes[key] = kind(raw)
            except ValueError:
                raise ValueError(
                    f"override {key}: expected {kind.__name__}, got {raw!r}"
                ) from None
        elif isinstance(current, torch.dtype):
            changes[key] = _torch_dtype(raw)
        else:
            changes[key] = raw
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# model -> kernel derivation
# ---------------------------------------------------------------------------

# layout() block kinds -> the kernel kind that implements them
_MIXER_KIND = {"attn": "attn", "mla": "attn", "mamba": "ssm"}
_FFN_KIND = {"mlp": "mlp", "moe": "moe", "none": None}


def kernel_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """Distinct kernel kinds a model's layout exercises, stable order.

    Always ends with ``unembed``: every LM closes with the logits GEMM.
    """
    kinds: list = []
    for block in cfg.layout():
        for kind in (_MIXER_KIND[block.mixer], _FFN_KIND[block.ffn]):
            if kind is not None and kind not in kinds:
                kinds.append(kind)
    kinds.append("unembed")
    return tuple(kinds)


def _moe_ids(n_tiles: int, n_experts: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.sort(rng.integers(0, n_experts, size=n_tiles)).astype(np.int64)


#: KV tile width of each attn rung, and expert-tile rows of each moe rung.
_ATTN_BKV = (32, 64)
_MOE_BM = (32, 64)


def _shapes(cfg: ModelConfig, kind: str, batch: int, seq: int, rung: int) -> Dict:
    """The launch shapes of one kind at one rung."""
    if kind not in kernel_kinds(cfg):
        raise ValueError(
            f"model {cfg.name!r} has no {kind!r} kernels "
            f"(layout uses: {', '.join(kernel_kinds(cfg))})"
        )
    tokens = batch * seq
    if kind == "attn":
        return dict(bh=batch * cfg.n_heads, s=seq, d=cfg.head_dim_, bkv=_ATTN_BKV[rung])
    if kind in ("mlp", "unembed"):
        n = cfg.d_ff if kind == "mlp" else cfg.padded_vocab
        return dict(m=tokens, n=n, k=cfg.d_model)
    if kind == "moe":
        bm = _MOE_BM[rung]
        # the tokens padded to whole expert tiles, as plan_groups pads groups
        m = math.ceil(tokens / bm) * bm
        return dict(m=m, k=cfg.d_model, n=cfg.d_ff, e=cfg.n_experts, bm=bm,
                    ids=_moe_ids(m // bm, cfg.n_experts))
    if kind == "ssm":
        n_heads = max(1, cfg.d_model * cfg.ssm_expand // cfg.ssm_head_dim)
        chunk = min(cfg.ssm_chunk, seq)
        return dict(bh=batch * n_heads, c=seq // chunk, l=chunk,
                    p=cfg.ssm_head_dim, n=cfg.ssm_state)
    raise ValueError(f"unknown kernel kind {kind!r}")


def kind_spec(
    cfg: ModelConfig, kind: str, batch: int, seq: int, rung: int = 0
) -> KernelSpec:
    """Build the KernelSpec for one kernel kind at the model's shapes.

    ``rung=0`` is the baseline derivation; ``rung=1`` the optimized one
    (wider KV tiles for attention, the shared-memory tiled GEMM for the
    MLP and the logits, wider expert tiles for MoE).  The SSD chunk has a
    single rung.  Raises ``ValueError`` for a kind the config doesn't use.
    """
    from repro_torch.kernels import flash, gemm, gmm, ssd

    sh = _shapes(cfg, kind, batch, seq, rung)
    if kind == "attn":
        return flash.flash_spec(sh["bh"], sh["s"], sh["s"], sh["d"], bkv=sh["bkv"])
    if kind in ("mlp", "unembed"):
        build = gemm.gemm_v01_spec if rung == 0 else gemm.gemm_v02_spec
        return build(sh["m"], sh["n"], sh["k"])
    if kind == "moe":
        return gmm.gmm_spec(sh["m"], sh["k"], sh["n"], sh["e"], sh["ids"], bm=sh["bm"])
    return ssd.ssd_chunk_spec(sh["bh"], sh["c"], sh["l"], sh["p"], sh["n"])


def _randn(gen: torch.Generator, device: torch.device, *shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def kind_variant(
    cfg: ModelConfig, kind: str, batch: int, seq: int, rung: int = 0,
    name: str = "", note: str = "",
):
    """The runnable :class:`repro_torch.kernels.KernelVariant` of one kind
    at one rung: its spec, the kernel its spec describes, that kernel's
    plain version and seeded float32 inputs at the model's shapes."""
    from repro_torch import kernels as kreg
    from repro_torch.kernels import flash, gemm, gmm, ssd

    sh = _shapes(cfg, kind, batch, seq, rung)
    if kind == "attn":
        def inputs(device, gen):
            return tuple(_randn(gen, device, sh["bh"], sh["s"], sh["d"]) for _ in range(3))

        run = dict(kernel=flash.flash_attention, plain=flash.flash_plain, inputs=inputs,
                   atol=flash.tolerance, kwargs=(("causal", True), ("bkv", sh["bkv"])))
    elif kind in ("mlp", "unembed"):
        def inputs(device, gen):
            return _randn(gen, device, sh["m"], sh["k"]), _randn(gen, device, sh["k"], sh["n"])

        run = dict(kernel=gemm.KERNELS["v01" if rung == 0 else "v02"],
                   plain=gemm.gemm_plain, inputs=inputs,
                   # float32 sums of k N(0,1) products in another order
                   atol=1e-6 * sh["k"])
    elif kind == "moe":
        def inputs(device, gen):
            x = _randn(gen, device, sh["m"], sh["k"])
            w = _randn(gen, device, sh["e"], sh["k"], sh["n"])
            return x, w, torch.from_numpy(sh["ids"].astype(np.int32)).to(device)

        run = dict(kernel=gmm.gmm, plain=gmm.gmm_plain, inputs=inputs,
                   atol=gmm.tolerance, kwargs=(("bm", sh["bm"]),))
    else:
        run = dict(kernel=ssd.ssd_chunk, plain=ssd.ssd_plain,
                   inputs=kreg.ssd_inputs(sh["bh"], sh["c"], sh["l"], sh["p"], sh["n"]),
                   atol=ssd.tolerance)
    return kreg.KernelVariant(
        name=name or _KIND_RUNGS[kind][rung][0],
        build=lambda: kind_spec(cfg, kind, batch, seq, rung=rung),
        role="baseline" if rung == 0 else "optimized",
        note=note,
        **run,
    )


_KIND_SUMMARY = {
    "attn": "flash attention at the model's (heads, seq, head_dim)",
    "mlp": "FFN GEMM at (tokens, d_ff, d_model): v01 coalesced vs v02 tiled",
    "moe": "MoE expert dispatch GMM with seeded sorted expert ids",
    "ssm": "Mamba SSD chunk scan at the model's state shapes",
    "unembed": "logits GEMM at (tokens, padded_vocab, d_model)",
}

_KIND_RUNGS = {
    "attn": (("base", "32-row KV tiles"),
             ("wide-kv", "64-row KV tiles: half the K/V tile loads per block")),
    "mlp": (("v01", "lanes on columns, B re-read per warp"),
            ("v02", "BM x 128 block tiles, 8x8 register micro-tiles")),
    "moe": (("tile32", "32-row expert tiles"),
            ("tile64", "64-row tiles: fewer tiles per expert")),
    "ssm": (("chunk", "one block per (head, chunk)"),),
    "unembed": (("v01", "lanes on columns, B re-read per warp"),
                ("v02", "BM x 128 block tiles, 8x8 register micro-tiles")),
}


def kernel_entry(ref: str):
    """Synthesize the RegistryEntry for a ``model.<model>.<kind>`` family.

    Raises ``KeyError`` (matching ``repro_torch.kernels.get``'s contract)
    for malformed refs, unknown models, and kinds the model doesn't use.
    """
    from repro_torch import kernels as kreg

    parts = ref.split(".")
    if len(parts) != 3 or parts[0] != "model":
        raise KeyError(
            f"model-derived kernel refs look like model.<model>.<kind>, "
            f"got {ref!r}"
        )
    _, model_name, kind = parts
    entry = get_model(model_name)  # KeyError on unknown model
    cfg = entry.config
    if kind not in kernel_kinds(cfg):
        raise KeyError(
            f"model {model_name!r} has no {kind!r} kernels "
            f"(layout uses: {', '.join(kernel_kinds(cfg))})"
        )
    variants = tuple(
        kind_variant(cfg, kind, entry.batch, entry.seq, rung, rung_name, note)
        for rung, (rung_name, note) in enumerate(_KIND_RUNGS[kind])
    )
    return kreg.RegistryEntry(
        name=ref,
        summary=f"{model_name}: {_KIND_SUMMARY[kind]}",
        variants=variants,
    )
