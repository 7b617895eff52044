"""Long-context serving with an O(1)-state SSM (the `long_500k` story).

A mamba2-family model decodes with CONSTANT per-token state — no KV
cache growth — which is why the `long_500k` cell runs for the SSM and
hybrid archs and is skipped for full attention.  This demo decodes after
prefills of increasing length and measures each model's per-token decode
time and the cache it holds.  Both caches are allocated at ``MAX_SEQ``
positions before the prefill, so the held bytes do not change with the
prefill in either model: the SSM's state is the same at any context
length, and the GQA cache is its size at ``MAX_SEQ`` (a cache sized to
the context would grow with it, linearly).

    PYTHONPATH=src python -m repro_torch.examples.serve_long_context [--device cpu]

``decode_step`` runs eagerly (the reference jits it); on the card each
timed stretch of decode steps is bracketed by CUDA events, on the CPU by
the host's clock.  Times are printed with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.examples import add_common_args, card_label, device_of
from repro_torch.models import ModelConfig, build_model

SSM = ModelConfig(name="ssm", family="ssm", n_layers=4, d_model=128, n_heads=1, n_kv_heads=1,
                  d_ff=0, vocab=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=64,
                  dtype=torch.float32)
GQA = ModelConfig(name="gqa", family="dense", n_layers=4, d_model=128, n_heads=8, n_kv_heads=4,
                  d_ff=256, vocab=256, dtype=torch.float32)
PREFILLS = (128, 512, 1536)
MAX_SEQ = 2048  # positions both caches are allocated at, as the reference's


def cache_bytes(caches) -> int:
    """Bytes of the cache tensors held (every layer's leaves)."""
    return sum(v.numel() * v.element_size() for layer in caches for v in layer.values()
               if isinstance(v, torch.Tensor))


@torch.no_grad()
def bench_decode(model, prompt_len, n_tokens=8, max_seq=MAX_SEQ, seed=0):
    """(ms per decode step after a prefill of ``prompt_len``, MiB of cache)."""
    dev = model.device
    rng = np.random.default_rng(seed)
    prompt = torch.from_numpy(rng.integers(0, 256, size=(1, prompt_len)).astype(np.int64))
    caches = model.init_caches(1, max_seq, dtype=torch.float32)
    lg, caches = model.prefill(prompt.to(dev), caches)
    tok = torch.argmax(lg[:, -1:], dim=-1)
    lg2, caches = model.decode_step(tok, caches)  # warm-up, as the reference's compile
    if dev.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_tokens):
            lg2, caches = model.decode_step(tok, caches)
        stop.record()
        stop.synchronize()
        per_tok_ms = start.elapsed_time(stop) / n_tokens
    else:
        t0 = time.perf_counter()
        for _ in range(n_tokens):
            lg2, caches = model.decode_step(tok, caches)
        per_tok_ms = (time.perf_counter() - t0) / n_tokens * 1e3
    return per_tok_ms, cache_bytes(caches) / 2**20


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    m_ssm = build_model(SSM, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))
    m_gqa = build_model(GQA, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))

    where = card_label(dev)
    print(f"decode on {where}")
    print(f"{'prefill':>8} | {'SSM ms/tok':>10} {'SSM cacheMB':>11} | "
          f"{'GQA ms/tok':>10} {'GQA cacheMB':>11}")
    rows = {}
    for plen in PREFILLS:
        s_ms, s_mb = bench_decode(m_ssm, plen, seed=args.seed)
        g_ms, g_mb = bench_decode(m_gqa, plen, seed=args.seed)
        rows[plen] = dict(ssm_ms=s_ms, ssm_mb=s_mb, gqa_ms=g_ms, gqa_mb=g_mb)
        print(f"{plen:>8} | {s_ms:>10.2f} {s_mb:>11.2f} | "
              f"{g_ms:>10.2f} {g_mb:>11.2f}")
    print(f"\nSSM state is constant in sequence length (the long_500k cell "
          f"decodes 524k context with a few MB of state).  The GQA cache is "
          f"allocated at max_seq = {MAX_SEQ} positions whatever the prefill, so "
          f"its MB column is flat too: a cache sized to the context would grow "
          f"linearly with it.")
    return {"rows": rows, "device": where, "max_seq": MAX_SEQ}


if __name__ == "__main__":
    main()
