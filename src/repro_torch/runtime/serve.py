"""Serving runtime: batched prefill + decode with KV-cache management.

The port of the JAX package's ``repro/runtime/serve.py``.  ``Server``
packs concurrent requests into a fixed-batch decode loop: prefill fills
each request's cache slot; ``decode_step`` advances every slot one
token; finished slots (EOS or max_tokens) are freed and refilled from
the queue — continuous batching at slot granularity.

Every request decodes as it would alone: its tokens are those of a
batch-1 ``prefill`` then ``decode_step`` on a fresh cache (with dense or
ragged mixtures of experts; under capacity dispatch a decode token's
route depends on the batch, as GShard's does, and only the first token,
sampled at admission, is the request's alone).  To that end:

  * a request is admitted by a prefill of its prompt alone, on a batch-1
    cache of ``max_seq``, whose line is then spliced into the slot
    (:func:`_splice_slot`), its length with it;
  * each slot has its own cache length: one (slots,) int64 tensor on the
    model's device that every layer's ``length`` shares, so a slot writes
    its K/V at its own length and takes its RoPE position and key mask
    from it (each decode tick builds the write mask and the next lengths
    once for all layers: ``models.attention.row_step``);
  * a request whose prompt plus ``max_tokens`` exceeds ``max_seq`` is
    refused at admission with a ``ValueError``, so no live slot reaches
    the end of its line.  A free slot's length goes on growing with the
    ticks, and its writes past ``max_seq`` write nothing.

The JAX package's ``Server`` prefills the whole batch with zeros in the
other slots and keeps one shared length, the largest, so that only the
request that set it decodes as it would alone, where its docstrings
promise independent slots; this one keeps that promise.

The caches are the port model's: a list of per-layer dicts, batch first.
A decode tick reads one thing back to the host, the sampled tokens; the
tokens fed to the next tick stay on the device.  Greedy sampling is
exact; for ``temperature > 0`` tokens are drawn from a
``torch.Generator`` seeded with ``ServeConfig.seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.model import caches_length

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
        # per-slot caches: one cache tree of batch = slots, and one length
        # a slot that every layer shares
        self.caches = model.init_caches(cfg.batch_slots, cfg.max_seq, dtype=dtype)
        lengths = torch.zeros(cfg.batch_slots, dtype=torch.int64, device=self.device)
        for layer in self.caches:
            if "length" in layer:
                layer["length"] = lengths
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
        """Prefill ``req`` alone and splice it into ``slot``."""
        plen = len(req.prompt)
        if plen + req.max_tokens > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: a prompt of {plen} tokens plus max_tokens "
                f"{req.max_tokens} is {plen + req.max_tokens}, past max_seq {self.cfg.max_seq}")
        toks = torch.from_numpy(np.asarray(req.prompt, dtype=np.int64))[None]
        fresh = self.model.init_caches(1, self.cfg.max_seq, dtype=self.dtype)
        logits, filled = self.model.prefill(toks.to(self.device), fresh, last_only=True)
        self.caches = _splice_slot(self.caches, filled, slot)
        nxt = self._sample(logits[:, -1], [req])
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


# the batch-first cache tensors a slot owns a line of; its length is row
# ``slot`` of the ``length`` that the layers share
_SLOT_LEAVES = ("k", "v", "c_kv", "k_rope", "conv", "ssm")


def _splice_slot(live: Caches, fresh: Caches, slot: int) -> Caches:
    """Copy the batch-1 caches ``fresh`` into slot ``slot`` of ``live`` (in
    place) and return it: each cache line whole, and the slot's length."""
    for mine, theirs in zip(live, fresh):
        for key, value in mine.items():
            if key in _SLOT_LEAVES:
                value[slot] = theirs[key][0]
            elif key != "length":
                raise KeyError(f"cache leaf {key!r} has no splice rule")
    lengths = caches_length(live)
    if isinstance(lengths, Tensor):  # pure-SSM caches have none
        lengths[slot] = caches_length(fresh)
    return live
