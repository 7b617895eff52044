"""Time the ragged decode kernel over split lengths, on the card.

The kernel's split length comes from :func:`ragged_flash.split_len`, a
function of (S, bkv) alone.  This script overrides that rule for one call
at a time and times the kernel at each multiple of ``bkv`` that keeps a
sequence at most 32 splits, in float32 and bfloat16, gated, at Granite-20B's
decode widths on ``ragged_context(64, 8192)`` (the shape ``chip_smoke.py``
times).  Each length's output is held to ``tolerance()`` against the plain
version.  Run from the repository root on a CUDA device::

    PYTHONPATH=src python -m repro_torch.kernels.split_sweep

Each length gets two times: ``ms``, the median of CUDA-event-timed calls
(``kernels.cuda_time_ms``, which counts a call's host issue), and
``device_ms``, the time the card spends on a call, its two device kernels
together (``kernels.device_time_ms``).  It prints one line a (dtype,
length) and, last, one JSON object ``{"card": ..., "sweep": [{"dtype",
"split_len", "splits", "ms", "device_ms"}, ...]}``.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch import kernels as kreg
from repro_torch.kernels import ragged_flash

SHAPE = (64, 48, 8192, 128)  # (b, h, s, d): Granite-20B's decode step
LENGTHS = (256, 384, 512, 768, 1024, 2048)
ITERS = 30


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device", file=sys.stderr)
        return 1
    b, h, s, d = SHAPE
    ctx = ragged_flash.ragged_context(b, s)
    card = _card()
    print(f"card: {card}")
    rule = ragged_flash.split_len
    rows = []
    try:
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
                       for shape in ((b, h, d), (b, s, d), (b, s, d)))
            starts, ends = (torch.from_numpy(np.ascontiguousarray(ctx[key])).cuda()
                            for key in ("starts", "ends"))
            args = (q, k, v, starts, ends)
            want = ragged_flash.ragged_decode_plain(*args)
            tol = ragged_flash.tolerance(want, q)
            for length in LENGTHS:
                ragged_flash.split_len = lambda s_, bkv=ragged_flash.DEF_BKV, n=length: n
                got = ragged_flash.ragged_decode_attention(*args)
                torch.cuda.synchronize()
                over = float(((got.float() - want.float()).abs() / tol).max())
                if not over <= 1:
                    print(f"split_sweep: L {length} {dtype}: err/tol {over} > 1", file=sys.stderr)
                    return 1
                call = lambda: ragged_flash.ragged_decode_attention(*args)  # noqa: E731
                row = dict(dtype=str(dtype).replace("torch.", ""), split_len=length,
                           splits=ragged_flash.n_splits(s), ms=kreg.cuda_time_ms(call, ITERS),
                           device_ms=kreg.device_time_ms(call, ITERS), err_over_tol=over,
                           rule=length == rule(s))
                rows.append(row)
                print(f"{row['dtype']} L {length} ({row['splits']} splits"
                      f"{', the rule' if row['rule'] else ''}): {row['ms']:.4f} ms, device "
                      f"{row['device_ms']:.4f} ms, err/tol {over:.3f}")
    finally:
        ragged_flash.split_len = rule
    print(json.dumps({"card": card, "shape": list(SHAPE), "sweep": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
