"""The ten published architecture configs (exact public hyperparameters).

Copied as data from the JAX package (``repro/configs/archs.py``), with the
same names and sources.  ``FULL`` maps each arch id to its ``config()``
builder (full size), ``SMOKE`` to a reduced same-family config for CPU
tests, built by the reference's own reduction (``_smoke``).  Whole-model
profiling runs them through ``models.registry.apply_overrides`` (Jamba's
layout at a cut depth is the port's full-width model run).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.models.model import ModelConfig

VPAD = 2048  # vocab padded to model-axis-divisible multiples


# -- dense GQA (llama-architecture) -----------------------------------------


def granite_20b() -> ModelConfig:
    # [arXiv:2405.04324] 52L d6144 48H MQA(kv=1) ff24576 v49152
    # gpt-bigcode lineage: 2-matrix GELU MLP (matches the 20B count)
    return ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144,
        n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, head_dim=128,
        mlp_kind="gelu", vocab_pad_multiple=VPAD, remat="full",
    )


def granite_3_2b() -> ModelConfig:
    # [hf:ibm-granite/granite-3.0-2b-base] 40L d2048 32H kv8 ff8192 v49155
    return ModelConfig(
        name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
        n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49155, head_dim=64,
        vocab_pad_multiple=VPAD, remat="full",
    )


def yi_9b() -> ModelConfig:
    # [arXiv:2403.04652] 48L d4096 32H kv4 ff11008 v64000
    return ModelConfig(
        name="yi-9b", family="dense", n_layers=48, d_model=4096,
        n_heads=32, n_kv_heads=4, d_ff=11008, vocab=64000, head_dim=128,
        vocab_pad_multiple=VPAD, remat="full",
    )


def granite_8b() -> ModelConfig:
    # [arXiv:2405.04324] 36L d4096 32H kv8 ff14336 v49152
    return ModelConfig(
        name="granite-8b", family="dense", n_layers=36, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=49152, head_dim=128,
        vocab_pad_multiple=VPAD, remat="full",
    )


# -- SSM ----------------------------------------------------------------------


def mamba2_2_7b() -> ModelConfig:
    # [arXiv:2405.21060] 64L d2560 attn-free, ssm_state=128, v50280
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        vocab_pad_multiple=VPAD, remat="full",
    )


# -- MoE ------------------------------------------------------------------------


def deepseek_v3_671b() -> ModelConfig:
    # [arXiv:2412.19437] 61L d7168 128H MLA, 1 shared + 256 routed top-8,
    # expert ff 2048, first 3 layers dense (ff 18432), MTP, v129280
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_ff=2048, vocab=129280,
        attn_kind="mla", q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
        n_experts=256, top_k=8, n_shared_experts=1, moe_impl="capacity",
        n_dense_layers=3, dense_d_ff=18432, mtp=True, attn_chunk=2048,
        vocab_pad_multiple=VPAD, remat="full",
    )


def llama4_scout() -> ModelConfig:
    # [hf:meta-llama/Llama-4-Scout-17B-16E] 48L d5120 40H kv8,
    # MoE 16e top-1 + 1 shared, expert ff 8192, v202048
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, head_dim=128,
        n_experts=16, top_k=1, n_shared_experts=1, moe_impl="capacity",
        vocab_pad_multiple=VPAD, remat="full",
    )


# -- audio (enc-dec backbone; conv frontend stubbed) ---------------------------


def whisper_base() -> ModelConfig:
    # [arXiv:2212.04356] 6L enc + 6L dec, d512 8H ff2048 v51865, layernorm
    return ModelConfig(
        name="whisper-base", family="audio", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=8, d_ff=2048, vocab=51865, head_dim=64,
        norm="layernorm", use_rope=False, n_encoder_layers=6,
        max_source_positions=1500, vocab_pad_multiple=VPAD, remat="full",
    )


# -- VLM backbone (vision frontend stubbed) -------------------------------------


def qwen2_vl_72b() -> ModelConfig:
    # [arXiv:2409.12191] 80L d8192 64H kv8 ff29568 v152064, M-RoPE
    return ModelConfig(
        name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064, head_dim=128,
        mrope_sections=(16, 24, 24), rope_theta=1e6,
        vocab_pad_multiple=VPAD, remat="full",
    )


# -- hybrid ------------------------------------------------------------------------


def jamba_52b() -> ModelConfig:
    # [arXiv:2403.19887] 32L d4096 32H kv8 ff14336, mamba:attn 7:1
    # (attn at index 4 of each 8-layer period), MoE 16e top-2 every
    # other layer, v65536.  Mamba layers adapted to the SSD (mamba2)
    # formulation, as in the JAX package.
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536, head_dim=128,
        ssm_state=16, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
        hybrid_period=8, hybrid_attn_index=4,
        n_experts=16, top_k=2, moe_period=2, moe_impl="capacity",
        vocab_pad_multiple=VPAD, remat="full",
    )


FULL: Dict[str, Callable[[], ModelConfig]] = {
    "granite-20b": granite_20b,
    "granite-3-2b": granite_3_2b,
    "yi-9b": yi_9b,
    "granite-8b": granite_8b,
    "mamba2-2.7b": mamba2_2_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "llama4-scout-17b-a16e": llama4_scout,
    "whisper-base": whisper_base,
    "qwen2-vl-72b": qwen2_vl_72b,
    "jamba-v0.1-52b": jamba_52b,
}


# -- smoke configs: same family, tiny dims -------------------------------------


def _smoke(full: ModelConfig, **overrides) -> ModelConfig:
    base = dict(
        n_layers=min(full.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(full.n_kv_heads, 2) if full.n_kv_heads > 1 else 1,
        d_ff=128 if full.d_ff else 0,
        vocab=512,
        head_dim=16,
        vocab_pad_multiple=1,
        remat="none",
        dtype=torch.float32,
        dense_d_ff=128 if full.dense_d_ff else None,
        max_source_positions=64,
    )
    if full.n_experts:
        base.update(n_experts=4, top_k=min(full.top_k, 2),
                    n_shared_experts=full.n_shared_experts)
    if full.ssm_state:
        base.update(ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_chunk=8)
    if full.attn_kind == "mla":
        base.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16, head_dim=None)
    if full.hybrid_period:
        base.update(n_layers=8, hybrid_period=4, hybrid_attn_index=2)
    if full.n_dense_layers:
        base.update(n_layers=4, n_dense_layers=1)
    if full.n_encoder_layers:
        base.update(n_encoder_layers=2, n_layers=2)
    if full.mrope_sections:
        base.update(mrope_sections=(4, 2, 2))
    base.update(overrides)
    return dataclasses.replace(full, **base)


SMOKE: Dict[str, Callable[[], ModelConfig]] = {
    aid: (lambda aid=aid: _smoke(FULL[aid]())) for aid in FULL
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """The published config of ``arch_id`` (its reduced smoke config with
    ``smoke``); KeyError with the known ids."""
    table = SMOKE if smoke else FULL
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id}; known: {sorted(table)}")
    return table[arch_id]()
