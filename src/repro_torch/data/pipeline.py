"""Token data pipeline: sources, per-host sharding, resumable iteration.

A numpy copy of the JAX package's ``repro/data/pipeline.py``: the same
seed, step and host give the same batches, bit for bit.

Sources:
  * ``SyntheticSource`` — deterministic Zipf-ish token stream from a
    counter-based PRNG: batch ``i`` is a pure function of (seed, i), so
    any host can materialize exactly its shard of any step — which is
    what makes restore-from-checkpoint trivially exact (no iterator
    state beyond the step counter) and elastic (a different host count
    re-slices the same global batch).
  * ``MemmapSource`` — a flat binary token file (np.uint16/np.int32)
    sampled at deterministic offsets, same counter-based discipline.

The pipeline emits (tokens, labels) with labels = next-token (shifted),
masked with -1 at sequence ends.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    # counter-based: independent stream per (seed, step, host)
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, host))
    )


class SyntheticSource:
    """Zipf-distributed tokens (realistic rank-frequency curve)."""

    def __init__(self, cfg: DataConfig, zipf_a: float = 1.2):
        self.cfg = cfg
        self.zipf_a = zipf_a

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = _rng_for(cfg.seed, step, cfg.host_id)
        z = rng.zipf(self.zipf_a, size=(cfg.host_batch, cfg.seq_len + 1))
        return np.minimum(z - 1, cfg.vocab - 1).astype(np.int32)


class MemmapSource:
    """Flat binary token corpus, deterministic random windows."""

    def __init__(self, cfg: DataConfig, path: str, dtype=np.uint16):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        if len(self.tokens) < cfg.seq_len + 2:
            raise ValueError("corpus shorter than seq_len")

    def batch(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = _rng_for(cfg.seed, step, cfg.host_id)
        max_start = len(self.tokens) - cfg.seq_len - 1
        starts = rng.integers(0, max_start, size=cfg.host_batch)
        out = np.stack(
            [self.tokens[s : s + cfg.seq_len + 1] for s in starts]
        ).astype(np.int32)
        return np.minimum(out, cfg.vocab - 1)


class TokenPipeline:
    """Resumable (tokens, labels) iterator over a source."""

    def __init__(self, source, start_step: int = 0):
        self.source = source
        self.step = start_step

    def state(self) -> int:
        return self.step

    def restore(self, state: int) -> None:
        self.step = int(state)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        raw = self.source.batch(self.step)  # (B, S+1)
        self.step += 1
        tokens = raw[:, :-1]
        labels = raw[:, 1:].copy()
        return tokens, labels
