"""Serve a small LM with batched, continuously-batched requests.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Ten requests (prompts of 3-19 tokens, 12 tokens each; greedy on even
ids, temperature 0.8 on odd ones) through ``repro_torch.runtime.Server``
with 4 slots, on a 4-layer float32 model drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.examples import add_common_args, card_label, device_of
from repro_torch.models import ModelConfig, build_model
from repro_torch.runtime import Request, ServeConfig, Server

CONFIG = ModelConfig(name="serve-demo", family="dense", n_layers=4, d_model=128, n_heads=8,
                     n_kv_heads=4, d_ff=512, vocab=2048, dtype=torch.float32)
N_REQUESTS = 10
MAX_TOKENS = 12


def serve(model, seed: int):
    """The ten requests, drawn from ``seed``, through a ``Server`` of
    ``model``: (the requests, done; the server; seconds to serve them)."""
    srv = Server(model, ServeConfig(batch_slots=4, max_seq=128, seed=seed),
                 dtype=torch.float32)
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(N_REQUESTS):
        plen = int(rng.integers(3, 20))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, model.cfg.vocab, size=plen).astype(np.int32),
            max_tokens=MAX_TOKENS,
            temperature=0.0 if rid % 2 == 0 else 0.8,
        ))
        srv.submit(reqs[-1])

    t0 = time.perf_counter()
    srv.run_until_done()
    return reqs, srv, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    model = build_model(CONFIG, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    reqs, srv, dt = serve(model, args.seed)
    total = N_REQUESTS * MAX_TOKENS
    where = card_label(dev)
    print(f"{N_REQUESTS} requests x {MAX_TOKENS} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {srv.steps} decode ticks, "
          f"{total / max(srv.steps, 1):.1f} tokens/tick batching efficiency) on {where}")
    return {
        "model": model,
        "requests": reqs,
        "seconds": dt,
        "tokens_per_s": total / dt,
        "ticks": srv.steps,
        "device": where,
    }


if __name__ == "__main__":
    main()
