"""The model configuration, as far as the profiler reads it.

``ModelConfig`` carries every field of the JAX package's
(``repro/models/model.py``), with a torch dtype, and the derived values
whole-model profiling reads: ``padded_vocab``, ``head_dim_`` and the
block ``layout()``.  The forward pass (``LM``, the stack, the sub-configs
of attention, MoE and SSM) comes with its own slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockKind:
    """One decoder block: its token mixer and its feed-forward."""

    mixer: str  # 'attn' | 'mla' | 'mamba'
    ffn: str  # 'mlp' | 'moe' | 'none'

    def tag(self) -> str:
        return f"{self.mixer}_{self.ffn}"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'vlm' | 'audio'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    use_rope: bool = True
    mrope_sections: Optional[Tuple[int, int, int]] = None
    tie_embeddings: bool = True
    sliding_window: Optional[int] = None
    attn_chunk: int = 512
    # MLA (attn_kind='mla')
    attn_kind: str = "gqa"  # 'gqa' | 'mla'
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # MoE
    mlp_kind: str = "swiglu"  # 'swiglu' | 'gelu' (gpt-bigcode style)
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_period: int = 1  # a MoE FFN every `period` layers (jamba: 2)
    n_dense_layers: int = 0  # leading dense layers (deepseek: 3)
    dense_d_ff: Optional[int] = None  # d_ff of those dense layers
    moe_impl: str = "ragged"
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0  # >0 enables mamba mixers
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    hybrid_period: int = 0  # jamba: 8 (one attn layer per period)
    hybrid_attn_index: int = 4
    # MTP (deepseek)
    mtp: bool = False
    mtp_loss_weight: float = 0.3
    # enc-dec
    n_encoder_layers: int = 0
    max_source_positions: int = 1500
    # execution
    remat: str = "none"
    dtype: Any = torch.bfloat16
    # embedding table padded up so "vocab" shards evenly over the model
    # axis; logits include the pad
    vocab_pad_multiple: int = 1

    @property
    def padded_vocab(self) -> int:
        m = max(1, self.vocab_pad_multiple)
        return ((self.vocab + m - 1) // m) * m

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layout(self) -> Tuple[BlockKind, ...]:
        """The (mixer, ffn) kind of every layer, in order."""
        kinds: List[BlockKind] = []
        mixer_default = "mla" if self.attn_kind == "mla" else "attn"
        for l in range(self.n_layers):
            if self.ssm_state and self.hybrid_period:
                mixer = (
                    "attn" if l % self.hybrid_period == self.hybrid_attn_index else "mamba"
                )
            elif self.ssm_state:
                mixer = "mamba"
            else:
                mixer = mixer_default
            if self.d_ff == 0 and not self.n_experts:
                ffn = "none"
            elif self.n_experts and l >= self.n_dense_layers and (
                (l % self.moe_period) == (self.moe_period - 1) or self.moe_period == 1
            ):
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append(BlockKind(mixer, ffn))
        return tuple(kinds)
