"""Top-level model: config, layout construction, LM forward, losses.

``ModelConfig`` carries every field of the JAX package's
(``repro/models/model.py``), with a torch dtype.  From it:

    model   = build_model(cfg, device=..., generator=...)  # LM or EncDec
    logits, caches, aux = model.apply(tokens)              # forward
    logits, caches = model.prefill(tokens, model.init_caches(b, n))
    logits, caches = model.decode_step(next_tokens, caches) # serving

Families: decoder-only LMs (dense / MoE / SSM / hybrid / VLM backbone)
here; encoder-decoder (whisper) in :mod:`repro_torch.models.encdec`.
The model is an ``nn.Module`` whose parameters mirror the reference's
tree, one module per layer; :func:`params_from_reference` carries a
reference parameter tree (numpy arrays) into it.

``logical_specs()`` names each parameter's logical axes; the forward
calls ``constrain_logical`` where the reference does, a no-op unless a
launcher has activated rules and a mesh (:mod:`repro_torch.parallel`).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..parallel.context import constrain_logical, pad
from . import params as P
from .attention import AttnConfig, MLAConfig, row_step
from .layers import (
    cross_entropy, embed, embed_defs, hi, rmsnorm, rmsnorm_defs, unembed, untied_unembed_defs,
)
from .mamba import SSMConfig
from .moe import MoEConfig
from .params import ParamDef, ParamTree
from .transformer import (
    BlockKind, StackConfig, block_apply, block_defs, gathered, segments, stack_apply, stack_caches,
)

Tensor = torch.Tensor

__all__ = [
    "LM",
    "BlockKind",
    "ModelConfig",
    "build_model",
    "caches_length",
    "lm_param_defs",
    "params_from_reference",
    "reference_plan",
]


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

    # -- sub-configs -------------------------------------------------------

    def attn_config(self, causal: bool = True) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            head_dim=self.head_dim_,
            rope_theta=self.rope_theta,
            causal=causal,
            use_rope=self.use_rope,
            mrope_sections=self.mrope_sections,
            sliding_window=self.sliding_window,
            chunk=self.attn_chunk,
        )

    def mla_config(self) -> MLAConfig:
        return MLAConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            q_lora_rank=self.q_lora_rank,
            kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim,
            qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim,
            rope_theta=self.rope_theta,
            chunk=self.attn_chunk,
        )

    def moe_config(self) -> Optional[MoEConfig]:
        if not self.n_experts:
            return None
        return MoEConfig(
            d_model=self.d_model,
            d_ff=self.d_ff,
            n_experts=self.n_experts,
            top_k=self.top_k,
            n_shared_experts=self.n_shared_experts,
            capacity_factor=self.capacity_factor,
            moe_impl=self.moe_impl,
        )

    def ssm_config(self) -> Optional[SSMConfig]:
        if not self.ssm_state:
            return None
        return SSMConfig(
            d_model=self.d_model,
            d_state=self.ssm_state,
            head_dim=self.ssm_head_dim,
            expand=self.ssm_expand,
            n_groups=self.ssm_groups,
            chunk=self.ssm_chunk,
        )

    # -- layout --------------------------------------------------------------

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

    def stack_config(self) -> StackConfig:
        return StackConfig(
            d_model=self.d_model,
            d_ff=self.dense_d_ff or self.d_ff,
            mlp_kind=self.mlp_kind,
            layout=self.layout(),
            attn=self.attn_config(),
            mla=self.mla_config() if self.attn_kind == "mla" else None,
            ssm=self.ssm_config(),
            moe=self.moe_config(),
            norm=self.norm,
            norm_eps=self.norm_eps,
            remat=self.remat,
        )

    # -- accounting ----------------------------------------------------------

    def param_counts(self) -> Tuple[int, int]:
        """(total, active) parameter counts (the decoder-only LM's, for
        every family, as the reference counts them)."""
        total = P.param_count(lm_param_defs(self))
        active = total
        if self.n_experts and self.top_k:
            per_expert = 3 * self.d_model * self.d_ff
            n_moe_layers = sum(1 for k in self.layout() if k.ffn == "moe")
            active = total - n_moe_layers * per_expert * (self.n_experts - self.top_k)
        return total, active

    def model_flops_train(self, batch: int, seq: int) -> float:
        """6 * N_active * D (the roofline's MODEL_FLOPS convention)."""
        return 6.0 * self.param_counts()[1] * batch * seq

    def model_flops_decode(self, batch: int) -> float:
        return 2.0 * self.param_counts()[1] * batch


# ---------------------------------------------------------------------------
# decoder-only LM
# ---------------------------------------------------------------------------


def _mtp_kind(cfg: ModelConfig) -> BlockKind:
    return BlockKind("mla" if cfg.attn_kind == "mla" else "attn", "mlp")


def lm_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The LM's def tree: the reference's, with the stack as one block
    per layer (``layers``) where the reference stacks segments."""
    scfg = cfg.stack_config()
    defs: Dict[str, Any] = {
        "embed": embed_defs(cfg.padded_vocab, cfg.d_model),
        "layers": [block_defs(scfg, kind) for kind in scfg.layout],
        "final_norm": rmsnorm_defs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = untied_unembed_defs(cfg.padded_vocab, cfg.d_model)
    if cfg.mtp:
        defs["mtp"] = {
            "proj": ParamDef((2 * cfg.d_model, cfg.d_model), ("embed", None)),
            "block": block_defs(scfg, _mtp_kind(cfg)),
            "norm": rmsnorm_defs(cfg.d_model),
        }
    return defs


def _default_generator(device: Any) -> Optional[torch.Generator]:
    device = torch.device(device or "cpu")
    if device.type == "meta":  # nothing to draw
        return None
    return torch.Generator(device=device).manual_seed(0)


class LM(ParamTree):
    """The decoder-only LM.  Parameters in ``cfg.dtype`` on ``device``,
    drawn from ``generator`` (seed 0 on the device when none is given)."""

    def __init__(self, cfg: ModelConfig, device: Any = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(lm_param_defs(cfg), device, cfg.dtype)
        self.cfg = cfg
        self.stack_cfg = cfg.stack_config()
        self.init_(generator or _default_generator(device))

    @property
    def device(self) -> torch.device:
        return self.embed.embedding.device

    def _positions(self, tokens: Tensor, start: Any = 0) -> Tensor:
        b, s = tokens.shape
        pos = row_positions(start, b, s, tokens.device)
        if self.cfg.mrope_sections is not None:
            pos = pos[..., None].expand(b, s, 3)  # text: t == h == w
        return pos

    def apply(
        self,
        tokens: Tensor,  # (B, S) int
        positions: Optional[Tensor] = None,
        caches: Optional[List[Dict[str, Any]]] = None,
        embeddings: Optional[Tensor] = None,  # frontend stub path
        last_only: bool = False,  # prefill: unembed only the final position
    ) -> Tuple[Tensor, Optional[List[Dict[str, Any]]], Tensor]:
        """Returns (logits (B, S, padded_vocab) float32, new_caches, aux_loss)."""
        cfg = self.cfg
        p = self.tree()
        start = caches_length(caches) if caches is not None else 0
        if positions is None:
            positions = self._positions(tokens, start)
        if isinstance(start, Tensor):
            caches = row_step(caches, start)
        x = embed(p["embed"], tokens).to(cfg.dtype)
        if embeddings is not None:
            x = x + embeddings.to(cfg.dtype)
        # the gather from the vocab-sharded embedding leaves x with no
        # layout of its own: constrain it (the reference measured 87.7 ->
        # 6.0 GiB/chip on whisper train_4k)
        x = constrain_logical(x, ("act_batch", "act_seq", None))
        x, new_caches, aux = stack_apply(p["layers"], x, positions, self.stack_cfg, caches)
        if last_only:
            x = x[:, -1:]  # slice BEFORE the (B, S, vocab) unembed product
        x = gathered(self.stack_cfg, rmsnorm(p["final_norm"], x, cfg.norm_eps))
        if cfg.tie_embeddings:
            logits = unembed(p["embed"], x)
        else:
            logits = hi(x @ p["unembed"]["w_out"].to(x.dtype))
        return logits, new_caches, aux

    forward = apply

    def loss(
        self,
        tokens: Tensor,  # (B, S)
        labels: Tensor,  # (B, S) next-token targets; -1 = masked
    ) -> Tuple[Tensor, Dict[str, Tensor]]:
        logits, _, aux = self.apply(tokens)
        mask = (labels >= 0).to(logits.dtype)
        ce = cross_entropy(logits, torch.clamp(labels, min=0), mask)
        total = ce + aux
        metrics = {"ce": ce, "aux": aux}
        if self.cfg.mtp:
            mtp_ce = self._mtp_loss(tokens, labels)
            total = total + self.cfg.mtp_loss_weight * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, tokens: Tensor, labels: Tensor) -> Tensor:
        """DeepSeek-style multi-token prediction at the reference's
        interface level: one extra block over [emb(t) ; emb(t+1)]
        projected down, predicting labels[t+1] at position t."""
        cfg = self.cfg
        p = self.tree()
        mtp = p["mtp"]
        nxt = pad(tokens[:, 1:], (0, 1))  # teacher-forced t+1
        e = embed(p["embed"], nxt).to(cfg.dtype)
        h = embed(p["embed"], tokens).to(cfg.dtype)
        x = torch.cat([h, e], dim=-1) @ mtp["proj"].to(cfg.dtype)
        x, _, _ = block_apply(mtp["block"], x, self._positions(tokens), self.stack_cfg,
                              _mtp_kind(cfg))
        x = gathered(self.stack_cfg, rmsnorm(mtp["norm"], x, cfg.norm_eps))
        mtp_logits = unembed(p["embed"], x)
        tgt = pad(labels[:, 1:], (0, 1), value=-1)
        mask = (tgt >= 0).to(mtp_logits.dtype)
        return cross_entropy(mtp_logits, torch.clamp(tgt, min=0), mask)

    # -- serving -----------------------------------------------------------------

    def init_caches(self, batch: int, max_seq: int,
                    dtype: Any = torch.bfloat16) -> List[Dict[str, Any]]:
        return stack_caches(self.stack_cfg, batch, max_seq, dtype, self.device)

    def decode_step(self, tokens: Tensor, caches: List[Dict[str, Any]]):
        """(B, 1) next tokens -> (logits (B, 1, V), new caches)."""
        logits, new_caches, _ = self.apply(tokens, caches=caches)
        return logits, new_caches

    def prefill(self, tokens: Tensor, caches: List[Dict[str, Any]], last_only: bool = False):
        """(B, S) prompt into empty caches -> (logits, filled caches)."""
        logits, new_caches, _ = self.apply(tokens, caches=caches, last_only=last_only)
        return logits, new_caches


def caches_length(caches: Any) -> Any:
    """Current sequence length of a cache tree (0 for pure-SSM caches);
    the layers' lengths are all equal.  An int, or the (B,) tensor of
    per-row lengths that a ``Server``'s layers share."""
    for path, leaf in P.leaves(caches):
        if path.rsplit("/", 1)[-1] == "length":
            return leaf if isinstance(leaf, Tensor) and leaf.ndim == 1 else int(leaf)
    return 0


def row_positions(start: Any, b: int, s: int, device: Any) -> Tensor:
    """(B, S) positions from ``start``: an int that every row shares, or a
    (B,) tensor of per-row starts."""
    steps = torch.arange(s, device=device)
    if isinstance(start, Tensor) and start.ndim == 1:
        return start[:, None] + steps[None, :]
    return (start + steps)[None, :].expand(b, s)


def build_model(cfg: ModelConfig, device: Any = None,
                generator: Optional[torch.Generator] = None):
    """Family dispatch: decoder-only here, enc-dec in encdec.py."""
    if cfg.family == "audio" or cfg.n_encoder_layers:
        from .encdec import EncDec

        return EncDec(cfg, device, generator)
    return LM(cfg, device, generator)


# ---------------------------------------------------------------------------
# the reference's weights carried across
# ---------------------------------------------------------------------------


def reference_plan(cfg: ModelConfig) -> Dict[str, Tuple[str, Optional[int]]]:
    """Port parameter name -> (the reference tree's leaf path, the index
    along its stacked layer axis or None).  The reference stacks each
    segment's repeats (``transformer.segments``) and the enc-dec's blocks;
    the port keeps one module per layer."""
    plan: Dict[str, Tuple[str, Optional[int]]] = {}

    def direct(defs: Any, jax_prefix: str, port_prefix: str, index: Optional[int] = None):
        for path, name in P.dotted_names(defs):
            plan[port_prefix + name] = (jax_prefix + path, index)

    if cfg.family == "audio" or cfg.n_encoder_layers:
        from .encdec import encdec_param_defs

        defs = encdec_param_defs(cfg)
        for key in ("embed", "enc_norm", "dec_norm"):
            direct(defs[key], f"{key}/", f"{key}.")
        plan["dec_pos"] = ("dec_pos", None)
        for part in ("encoder", "decoder"):
            for i, block in enumerate(defs[part]):
                direct(block, f"{part}/", f"{part}.{i}.", i)
        return plan
    defs = lm_param_defs(cfg)
    for key, sub in defs.items():
        if key != "layers":
            direct(sub, f"{key}/", f"{key}.")
    layer = 0
    for si, (pattern, repeats) in enumerate(segments(cfg.layout())):
        for r in range(repeats):
            for bi in range(len(pattern)):
                sub = "" if len(pattern) == 1 else f"sub{bi}/"
                direct(defs["layers"][layer], f"stack/seg{si}/{sub}", f"layers.{layer}.",
                       r if repeats > 1 else None)
                layer += 1
    return plan


def params_from_reference(cfg: ModelConfig, tree: Mapping) -> Dict[str, Tensor]:
    """The port's state dict of a reference parameter tree (nested dicts of
    numpy arrays, e.g. ``jax.tree.map(np.asarray, LM(cfg).init(key))``),
    in ``cfg.dtype``: the scanned segments unstacked, one layer each.

    Every reference leaf (every slice of a stacked one) is used exactly
    once and every port parameter filled exactly once, else ValueError.
    """
    flat = {path: np.asarray(a) for path, a in P.leaves(tree)}
    plan = reference_plan(cfg)
    want = {name: d.shape for name, d in _named_shapes(cfg)}
    if set(plan) != set(want):
        raise ValueError(f"plan and model disagree on {sorted(set(plan) ^ set(want))}")
    used: Dict[str, collections.Counter] = {path: collections.Counter() for path in flat}
    state: Dict[str, Tensor] = {}
    for name, (path, index) in plan.items():
        if path not in flat:
            raise ValueError(f"{name}: the reference tree has no leaf {path!r}")
        arr = flat[path] if index is None else flat[path][index]
        used[path][index] += 1
        if tuple(arr.shape) != tuple(want[name]):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} from {path}, want {want[name]}")
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        state[name] = torch.from_numpy(np.array(arr)).to(cfg.dtype)
    for path, counts in used.items():
        stacked = None not in counts
        expect = set(range(flat[path].shape[0])) if stacked and counts else {None}
        if set(counts) != expect or any(n != 1 for n in counts.values()):
            raise ValueError(f"reference leaf {path!r} used {dict(counts)}, want each of "
                             f"{sorted(expect, key=str)} once")
    return state


def _named_shapes(cfg: ModelConfig):
    if cfg.family == "audio" or cfg.n_encoder_layers:
        from .encdec import encdec_param_defs

        defs = encdec_param_defs(cfg)
    else:
        defs = lm_param_defs(cfg)
    got = dict(P.leaves(defs))
    return [(name, got[path]) for path, name in P.dotted_names(defs)]
