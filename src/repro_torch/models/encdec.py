"""Encoder-decoder backbone (whisper-base): encoder + cross-attn decoder.

The port of the JAX package's ``repro/models/encdec.py``.  The conv
audio frontend is a stub (:mod:`repro_torch.models.frontends`): the
encoder takes precomputed frame embeddings (B, S_enc, d_model).  Whisper
uses LayerNorm, sinusoids on the encoder and learned absolute positions
on the decoder.  Same interface as :class:`repro_torch.models.model.LM`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.context import constrain_logical, keep_layout
from .attention import (
    AttnConfig, attn_apply, attn_defs, cross_attn_apply, init_cache, row_step,
)
from .layers import (
    cross_entropy,
    embed,
    embed_defs,
    gelu_mlp,
    gelu_mlp_defs,
    layernorm,
    layernorm_defs,
    sinusoidal_positions,
    unembed,
)
from .model import ModelConfig, _default_generator, caches_length, row_positions
from .params import ParamDef, ParamTree
from .transformer import remat_wrap

Tensor = torch.Tensor


def _attn_cfgs(cfg: ModelConfig) -> Tuple[AttnConfig, AttnConfig]:
    def one(causal):
        return AttnConfig(
            d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, causal=causal, use_rope=False, chunk=cfg.attn_chunk,
        )

    return one(False), one(True)


def encdec_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's def tree with one entry per encoder and decoder
    block where the reference stacks them."""
    enc_attn, dec_attn = _attn_cfgs(cfg)
    enc_block = {
        "norm1": layernorm_defs(cfg.d_model),
        "attn": attn_defs(enc_attn),
        "norm2": layernorm_defs(cfg.d_model),
        "mlp": gelu_mlp_defs(cfg.d_model, cfg.d_ff),
    }
    dec_block = {
        "norm1": layernorm_defs(cfg.d_model),
        "self_attn": attn_defs(dec_attn),
        "norm_x": layernorm_defs(cfg.d_model),
        "cross_attn": attn_defs(dec_attn),
        "norm2": layernorm_defs(cfg.d_model),
        "mlp": gelu_mlp_defs(cfg.d_model, cfg.d_ff),
    }
    return {
        "embed": embed_defs(cfg.padded_vocab, cfg.d_model),
        # learned absolute positions (whisper decoder), sized as the reference's
        "dec_pos": ParamDef((65536, cfg.d_model), (None, "embed"), init="embed", scale=0.01),
        "encoder": [enc_block] * (cfg.n_encoder_layers or cfg.n_layers),
        "enc_norm": layernorm_defs(cfg.d_model),
        "decoder": [dec_block] * cfg.n_layers,
        "dec_norm": layernorm_defs(cfg.d_model),
    }


class EncDec(ParamTree):
    def __init__(self, cfg: ModelConfig, device: Any = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(encdec_param_defs(cfg), device, cfg.dtype)
        self.cfg = cfg
        self.n_enc = cfg.n_encoder_layers or cfg.n_layers
        self.n_dec = cfg.n_layers
        self.enc_attn, self.dec_attn = _attn_cfgs(cfg)
        self.init_(generator or _default_generator(device))

    @property
    def device(self) -> torch.device:
        return self.dec_pos.device

    def encode(self, frames: Tensor, remat: Optional[str] = None) -> Tensor:
        """frames: (B, S_enc, d_model) precomputed frontend embeddings;
        ``remat`` overrides ``cfg.remat`` (serving passes ``"none"``)."""
        cfg = self.cfg
        p = self.tree()
        b, s, _ = frames.shape
        x = frames.to(cfg.dtype) + sinusoidal_positions(s, cfg.d_model, frames.device).to(cfg.dtype)
        x = constrain_logical(x, ("act_batch", None, None))
        pos = torch.arange(s, device=frames.device)[None].expand(b, s)

        def body(blk, x):
            y, _ = attn_apply(blk["attn"], layernorm(blk["norm1"], x, cfg.norm_eps), pos,
                              self.enc_attn)
            x = x + keep_layout(y)
            x = x + keep_layout(gelu_mlp(blk["mlp"], layernorm(blk["norm2"], x, cfg.norm_eps)))
            return constrain_logical(x, ("act_batch", None, None))

        run = remat_wrap(body, remat or cfg.remat, None)
        for blk in p["encoder"]:
            x = run(blk, x)
        return layernorm(p["enc_norm"], x, cfg.norm_eps)

    def decode(
        self,
        tokens: Tensor,  # (B, S)
        enc: Tensor,  # (B, S_enc, d)
        caches: Optional[List[Dict[str, Any]]] = None,
        start: Any = 0,  # an int, or (B,) per-row cache lengths
    ) -> Tuple[Tensor, Optional[List[Dict[str, Any]]]]:
        cfg = self.cfg
        p = self.tree()
        b, s = tokens.shape
        pos = row_positions(start, b, s, tokens.device)
        x = (embed(p["embed"], tokens).to(cfg.dtype)
             + embed({"embedding": p["dec_pos"]}, pos).to(cfg.dtype))
        # the vocab-sharded embedding gather leaves x with no layout: constrain
        x = constrain_logical(x, ("act_batch", None, None))
        new_caches: Optional[List[Dict[str, Any]]] = [] if caches is not None else None

        def body(blk, x, enc, cache):
            y, nc = attn_apply(blk["self_attn"], layernorm(blk["norm1"], x, cfg.norm_eps), pos,
                               self.dec_attn, cache)
            # each sublayer's gradient laid out as its output: DTensor would
            # split it over the sequence in the backward, and the products
            # flatten it into the batch
            x = x + keep_layout(y)
            x = x + keep_layout(cross_attn_apply(
                blk["cross_attn"], layernorm(blk["norm_x"], x, cfg.norm_eps), enc, self.dec_attn))
            x = x + keep_layout(gelu_mlp(blk["mlp"], layernorm(blk["norm2"], x, cfg.norm_eps)))
            return constrain_logical(x, ("act_batch", None, None)), nc

        run = remat_wrap(body, cfg.remat, caches)
        for i, blk in enumerate(p["decoder"]):
            cache = caches[i] if caches is not None else None
            x, nc = run(blk, x, enc, cache)
            if new_caches is not None:
                new_caches.append(nc)
        x = layernorm(p["dec_norm"], x, cfg.norm_eps)
        logits = constrain_logical(unembed(p["embed"], x), ("act_batch", None, "vocab"))
        return logits, new_caches

    def apply(
        self,
        tokens: Tensor,
        positions: Optional[Tensor] = None,
        caches: Optional[List[Dict[str, Any]]] = None,
        embeddings: Optional[Tensor] = None,  # encoder frames
    ):
        """Returns (logits, new_caches, aux_loss 0).  Without frames it
        encodes zeros, as the reference does (its self-contained mode)."""
        if embeddings is None:
            b = tokens.shape[0]
            embeddings = torch.zeros(
                (b, min(self.cfg.max_source_positions, 128), self.cfg.d_model),
                dtype=self.cfg.dtype, device=tokens.device,
            )
        enc = self.encode(embeddings, remat="none" if caches is not None else None)
        start = caches_length(caches) if caches is not None else 0
        if isinstance(start, torch.Tensor):
            caches = row_step(caches, start)
        logits, new_caches = self.decode(tokens, enc, caches, start)
        return logits, new_caches, torch.zeros((), dtype=torch.float32, device=tokens.device)

    forward = apply

    def loss(self, tokens: Tensor, labels: Tensor, frames: Optional[Tensor] = None):
        logits, _, aux = self.apply(tokens, embeddings=frames)
        mask = (labels >= 0).to(logits.dtype)
        ce = cross_entropy(logits, torch.clamp(labels, min=0), mask)
        return ce + aux, {"ce": ce, "aux": aux, "loss": ce + aux}

    def init_caches(self, batch: int, max_seq: int, dtype: Any = torch.bfloat16):
        return [
            init_cache(batch, max_seq, self.cfg.n_kv_heads, self.cfg.head_dim_, dtype, self.device)
            for _ in range(self.n_dec)
        ]

    def decode_step(self, tokens: Tensor, caches, embeddings: Optional[Tensor] = None):
        logits, new_caches, _ = self.apply(tokens, caches=caches, embeddings=embeddings)
        return logits, new_caches

    def prefill(self, tokens: Tensor, caches, embeddings: Optional[Tensor] = None,
                last_only: bool = False):
        logits, new_caches, _ = self.apply(tokens, caches=caches, embeddings=embeddings)
        return (logits[:, -1:] if last_only else logits), new_caches
