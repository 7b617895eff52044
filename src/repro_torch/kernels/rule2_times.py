"""Time the SSD chunk, histogram opt2 and the float32 routes of flash and
gmm of whichever ``repro_torch`` is on the path, at their timing shapes, on
one CUDA card.

Run from the root of a checkout, or point ``PYTHONPATH`` at another
checkout's ``src`` to time that tree's kernels with the same code (``-P``
keeps this file's directory off the path)::

    PYTHONPATH=src python3 -P src/repro_torch/kernels/rule2_times.py
    PYTHONPATH=/path/to/other/src python3 -P src/repro_torch/kernels/rule2_times.py --only flash,gmm

For the SSD chunk at Jamba-v0.1-52B's (128, 16, 256, 64, 16) and
Mamba2-2.7b's (80, 16, 256, 64, 128) in float32 and bfloat16, for
``hist_opt2`` at 16,777,216 ids into 2048 bins, and for float32 flash
(causal, bkv 64) and gmm (the model path's sorted expert ids) at
Jamba-v0.1-52B's widths at batch 1, seq 4096 (32 heads of 128; 4096 x
4096 x 14336 over 16 experts, bm 32) and at the registry's shapes ((4,
1024, 1024, 128); 1024 x 512 x 512 over 8 experts, bm 128), each beside
its library call
(``torch.bincount``, ``F.scaled_dot_product_attention``,
``torch._grouped_mm``), it prints one JSON line: the median time of a call
over 30 CUDA-event-timed calls (the timer of ``chip_smoke.py``,
``kernels.cuda_time_ms``: a call's host dispatch counts), the device time
of each device kernel of one call (``torch.profiler``) and the host's time
to issue one call with an empty queue.  ``--only`` takes a comma-separated
subset of ``ssd``, ``hist``, ``flash`` and ``gmm``.  This file imports only
torch, numpy and ``repro_torch``, and defines its own helpers, so that it
times an older tree's wrappers as they are.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

SSD_SHAPES = {"jamba": (128, 16, 256, 64, 16), "mamba2": (80, 16, 256, 64, 128)}
HIST_SHAPE = (16777216, 2048)
# (bh, sq, skv, d), causal, bkv 64, and (m, k, n, experts, bm): the
# timing shapes, then the registry's (kernels/__init__.py)
FLASH_SHAPES = {"": (32, 4096, 4096, 128), "_registry": (4, 1024, 1024, 128)}
GMM_SHAPES = {"": (4096, 4096, 14336, 16, 32), "_registry": (1024, 512, 512, 8, 128)}
PARTS = ("ssd", "hist", "flash", "gmm")
ITERS = 30


def host_ms(fn, iters: int = 20) -> float:
    """Median host time in ms to issue one ``fn()`` (checks, allocations and
    launches) with an empty queue; the card's time is not in it."""
    out = []
    for _ in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out[2:])


def device_kernels_ms(fn, iters: int = 10) -> dict:
    """{device kernel: ms a call} of ``fn()`` from ``torch.profiler`` (CUPTI)
    over ``iters`` calls: which of a wrapper's kernels takes the time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = getattr(evt, "cuda_time_total", 0)
        if total > 0:
            key = evt.key.replace("(anonymous namespace)::", "").removeprefix("void ")
            name = re.split(r"[<(]", key)[0]
            out[name] = out.get(name, 0.0) + total / 1e3 / iters
    return out


def _record(kreg, fn) -> dict:
    return dict(ms=kreg.cuda_time_ms(fn, ITERS), device_kernels_ms=device_kernels_ms(fn),
                host_ms=host_ms(fn))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=",".join(PARTS),
                        help=f"comma-separated subset of {', '.join(PARTS)}")
    parts = parser.parse_args(argv).only.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("rule2_times: no CUDA device")
    import repro_torch
    from repro_torch import kernels as kreg
    from repro_torch.kernels import flash, gmm, histogram, ssd

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    warm = torch.randn(4096, 4096, device=dev)
    kreg.cuda_time_ms(lambda: warm @ warm, 200)
    out = {"package": repro_torch.__file__, "card": card}
    if "ssd" in parts:
        for name, (bh, c, l, p, n) in SSD_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device=dev).manual_seed(0)
                x, b, cm = (torch.randn(bh, c, l, w, device=dev, generator=gen).to(dtype)
                            for w in (p, n, n))
                a = (-torch.randn(bh, c, l, device=dev, generator=gen).abs() * 0.4).to(dtype)
                rec = _record(kreg, lambda: ssd.ssd_chunk(x, a, b, cm))
                out[f"ssd_{name}_{str(dtype).replace('torch.', '')}"] = rec
                del x, b, cm, a
    if "hist" in parts:
        n_ids, n_bins = HIST_SHAPE
        cells = torch.randint(0, n_bins, (n_ids,), device=dev, dtype=torch.int32,
                              generator=torch.Generator(device=dev).manual_seed(1))
        out["hist_opt2"] = _record(kreg, lambda: histogram.hist_opt2(cells, n_bins))
        out["bincount"] = _record(kreg, lambda: torch.bincount(cells, minlength=n_bins))
        del cells
    for tag, (bh, sq, skv, d) in FLASH_SHAPES.items() if "flash" in parts else ():
        gen = torch.Generator(device=dev).manual_seed(2)
        q, k, v = (torch.randn(bh, s, d, device=dev, generator=gen) for s in (sq, skv, skv))
        out[f"flash_f32{tag}"] = _record(
            kreg, lambda: flash.flash_attention(q, k, v, causal=True, bkv=64))
        out[f"sdpa_f32{tag}"] = _record(kreg, lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True))
        del q, k, v
    for tag, (m, k, n, e, bm) in GMM_SHAPES.items() if "gmm" in parts else ():
        ids = np.sort(np.random.default_rng(0).integers(0, e, size=m // bm))
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(m, k, device=dev, generator=gen)
        w = torch.randn(e, k, n, device=dev, generator=gen)
        tile_ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
        offs = torch.from_numpy((np.cumsum(np.bincount(ids, minlength=e)) * bm).astype(np.int32)).to(dev)
        out[f"gmm_f32{tag}"] = _record(kreg, lambda: gmm.gmm(x, w, tile_ids, bm=bm))
        out[f"grouped_mm_f32{tag}"] = _record(kreg, lambda: torch._grouped_mm(x, w, offs=offs))
        del x, w
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
