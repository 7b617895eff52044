"""Serving runtime: batched prefill + decode with KV-cache management.

The port of the JAX package's ``repro/runtime/serve.py``.  ``Server``
packs concurrent requests into a fixed-batch decode loop: prefill fills
each request's cache slot; ``decode_step`` advances every slot one
token; finished slots (EOS or max_tokens) are freed and refilled from
the queue — continuous batching at slot granularity.

As in the reference:

  * a request is admitted by a prefill of the whole batch, the prompt in
    its slot and zeros in the others, whose slot is then spliced into
    the live caches (:func:`_splice_slot`).  In a mixture of experts with
    capacity dispatch the zero rows compete for capacity, so a slot's
    routing depends on ``batch_slots``;
  * the slots share one cache ``length``, the largest of theirs.  A slot
    whose prompt is shorter than the live length decodes at that length's
    positions and attends over the zero K/V lines below it, so only the
    request that set the length decodes as it would alone.

The caches are the port model's: a list of per-layer dicts, batch first,
with a Python-int ``length``.  A decode tick reads one thing back to the
host, the sampled tokens; the tokens fed to the next tick stay on the
device.  Greedy sampling is exact; for ``temperature > 0`` tokens are
drawn from a ``torch.Generator`` seeded with ``ServeConfig.seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

Tensor = torch.Tensor
Caches = List[Dict[str, Any]]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (plen,) int32
    max_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_slots: int = 8
    max_seq: int = 512
    eos_id: int = -1  # -1: never
    seed: int = 0


class Server:
    """Slot-based continuous batching over a single model replica (an
    ``LM`` or ``EncDec`` of :mod:`repro_torch.models`, on its device)."""

    def __init__(self, model, cfg: ServeConfig, dtype: Any = torch.float32):
        self.model = model
        self.cfg = cfg
        self.dtype = dtype
        self.device = model.device
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * cfg.batch_slots
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        # per-slot caches: one cache tree of batch = slots
        self.caches = model.init_caches(cfg.batch_slots, cfg.max_seq, dtype=dtype)
        self.slot_tokens = torch.zeros((cfg.batch_slots, 1), dtype=torch.int64,
                                       device=self.device)
        self.steps = 0

    # -- queue ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        """Prefill queued requests into free slots (one at a time)."""
        for slot in range(self.cfg.batch_slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self._prefill_slot(slot, req)
            self.active[slot] = req

    @torch.no_grad()
    def _prefill_slot(self, slot: int, req: Request) -> None:
        plen = len(req.prompt)
        if plen >= self.cfg.max_seq:
            raise ValueError("prompt longer than max_seq")
        b = self.cfg.batch_slots
        toks = torch.zeros((b, plen), dtype=torch.int64)
        toks[slot] = torch.from_numpy(np.asarray(req.prompt, dtype=np.int64))
        fresh = self.model.init_caches(b, self.cfg.max_seq, dtype=self.dtype)
        logits, filled = self.model.prefill(toks.to(self.device), fresh, last_only=True)
        self.caches = _splice_slot(self.caches, filled, slot)
        nxt = self._sample(logits[slot : slot + 1, -1], [req])
        self.slot_tokens[slot] = nxt[0]
        req.out_tokens.append(int(nxt[0]))

    # -- decode ------------------------------------------------------------

    def _sample(self, logits: Tensor, reqs: List[Optional[Request]]) -> Tensor:
        """One token per row of ``logits`` (rows, vocab), on the device:
        the argmax, or a draw at the row's request's temperature."""
        nxt = torch.argmax(logits, dim=-1)
        for i, req in enumerate(reqs):
            if req is not None and req.temperature > 0.0:
                probs = torch.softmax(logits[i].float() / req.temperature, dim=-1)
                nxt[i] = torch.multinomial(probs, 1, generator=self.gen)[0]
        return nxt

    @torch.no_grad()
    def step(self) -> None:
        """One decode tick for all active slots."""
        self._admit()
        if not any(r is not None for r in self.active):
            return
        logits, self.caches = self.model.decode_step(self.slot_tokens, self.caches)
        self.steps += 1
        nxt = self._sample(logits[:, 0], self.active)
        live = [slot for slot, req in enumerate(self.active) if req is not None]
        for slot in live:  # a free slot keeps its last token, as in the reference
            self.slot_tokens[slot, 0] = nxt[slot]
        tokens = nxt.tolist()  # the tick's one read back to the host
        for slot in live:
            req = self.active[slot]
            req.out_tokens.append(tokens[slot])
            if tokens[slot] == self.cfg.eos_id or len(req.out_tokens) >= req.max_tokens:
                req.done = True
                self.active[slot] = None

    def run_until_done(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.active):
                return
            self.step()


# the batch-first cache tensors a slot owns a line of; every other key
# (``length``) is shared
_SLOT_LEAVES = ("k", "v", "c_kv", "k_rope", "conv", "ssm")


def _splice_slot(live: Caches, fresh: Caches, slot: int) -> Caches:
    """Copy slot ``slot``'s batch line from ``fresh`` into ``live`` (in
    place) and return it.  ``length`` adopts the larger of the two: slots
    shorter than it hold zero K/V lines past their own fill that only
    their own decode steps overwrite."""
    for mine, theirs in zip(live, fresh):
        for key, value in mine.items():
            if key in _SLOT_LEAVES:
                value[slot] = theirs[key][slot]
            elif key == "length":
                mine[key] = max(value, theirs[key])
            else:
                raise KeyError(f"cache leaf {key!r} has no splice rule")
    return live
