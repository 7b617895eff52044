"""Modality frontend stubs, as in the JAX package's
``repro/models/frontends.py``.

The ``[audio]`` / ``[vlm]`` archs specify the transformer backbone only;
the frontend supplies precomputed frame or patch embeddings.  These stubs
define the input contract (shape and dtype) and a seeded synthetic
generator.  A real deployment would put whisper's conv mel stack or
Qwen2-VL's ViT behind the same interface.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Shape and dtype of a frontend's output (no storage)."""

    shape: Tuple[int, ...]
    dtype: Any


def audio_frame_spec(batch: int, n_frames: int, d_model: int,
                     dtype: Any = torch.bfloat16) -> InputSpec:
    """Whisper: (B, frames, d_model) post-conv frame embeddings."""
    return InputSpec((batch, n_frames, d_model), dtype)


def vision_patch_spec(batch: int, n_patches: int, d_model: int,
                      dtype: Any = torch.bfloat16) -> InputSpec:
    """Qwen2-VL: (B, patches, d_model) post-ViT patch embeddings."""
    return InputSpec((batch, n_patches, d_model), dtype)


def synth_frames(generator: torch.Generator, batch: int, n_frames: int, d_model: int,
                 dtype: Any = torch.bfloat16, device: Any = None) -> torch.Tensor:
    """Synthetic frame embeddings N(0, 0.02^2) drawn from ``generator``."""
    x = torch.randn((batch, n_frames, d_model), generator=generator,
                    device=device or generator.device)
    return (x * 0.02).to(dtype)


def mrope_positions_for_image(
    batch: int, text_len: int, grid_t: int, grid_h: int, grid_w: int
) -> np.ndarray:
    """(B, S, 3) M-RoPE position ids: image patch tokens first at their
    3-D grid coordinates, then text tokens with equal (t, h, w) continuing
    after the largest image position (Qwen2-VL §3.1)."""
    n_img = grid_t * grid_h * grid_w
    pos = np.zeros((batch, text_len + n_img, 3), np.int32)
    t_ids, h_ids, w_ids = np.meshgrid(
        np.arange(grid_t), np.arange(grid_h), np.arange(grid_w), indexing="ij"
    )
    pos[:, :n_img, 0] = t_ids.reshape(-1)
    pos[:, :n_img, 1] = h_ids.reshape(-1)
    pos[:, :n_img, 2] = w_ids.reshape(-1)
    start = max(grid_t, grid_h, grid_w)
    pos[:, n_img:, :] = (start + np.arange(text_len))[None, :, None]
    return pos
