"""Shape/cell registry for the (architecture x input-shape) grid.

A copy of the JAX package's ``repro/configs/base.py`` (which imports no
JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}

# archs that run long_500k (sub-quadratic decode); full-attention archs
# skip it
SUBQUADRATIC = {"mamba2-2.7b", "jamba-v0.1-52b"}

ARCH_IDS = [
    "granite-20b",
    "granite-3-2b",
    "yi-9b",
    "granite-8b",
    "mamba2-2.7b",
    "deepseek-v3-671b",
    "llama4-scout-17b-a16e",
    "whisper-base",
    "qwen2-vl-72b",
    "jamba-v0.1-52b",
]


def cells(arch_id: str) -> List[str]:
    """Shape names that are run for this arch."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if arch_id in SUBQUADRATIC:
        out.append("long_500k")
    return out


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in cells(a)]


def skipped_cells() -> List[Tuple[str, str, str]]:
    return [
        (a, "long_500k", "full quadratic attention; 512k decode skipped")
        for a in ARCH_IDS
        if a not in SUBQUADRATIC
    ]
