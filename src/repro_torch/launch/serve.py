"""Serving launcher: batched continuous-batching server driver.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b --smoke \
        --requests 8 --max-tokens 16 --device cpu

The reference's flags (``repro/launch/serve.py``) and its traffic:
``--requests`` prompts of 2-11 tokens drawn from ``--seed``.  Runs on
the CUDA card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.runtime import Request, ServeConfig, Server


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=device,
                        generator=torch.Generator(device=device).manual_seed(args.seed))
    srv = Server(
        model,
        ServeConfig(batch_slots=args.slots, max_seq=args.max_seq, seed=args.seed),
        dtype=cfg.dtype,
    )
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(2, 12))
        srv.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, size=plen).astype(np.int32),
            max_tokens=args.max_tokens,
            temperature=args.temperature,
        ))
    t0 = time.perf_counter()
    srv.run_until_done()
    dt = time.perf_counter() - t0
    tokens = args.requests * args.max_tokens
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    print(f"[serve] {args.requests} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s), {srv.steps} decode ticks on {where}")
    return {"tokens": tokens, "seconds": dt, "ticks": srv.steps}


if __name__ == "__main__":
    main()
