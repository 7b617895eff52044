"""Time the SSD chunk, histogram opt2, the float32 routes of flash and gmm,
spmv_ell and every wrapper's host issue of whichever ``repro_torch`` is on
the path, on one CUDA card.

Run from the root of a checkout, or point ``PYTHONPATH`` at another
checkout's ``src`` to time that tree's kernels with the same code (``-P``
keeps this file's directory off the path)::

    PYTHONPATH=src python3 -P src/repro_torch/kernels/rule2_times.py
    PYTHONPATH=/path/to/other/src python3 -P src/repro_torch/kernels/rule2_times.py --only flash,gmm
    PYTHONPATH=src python3 -P src/repro_torch/kernels/rule2_times.py --only spmv,host,parts
    PYTHONPATH=src python3 -P src/repro_torch/kernels/rule2_times.py --only host --against /path/to/other/src

For the SSD chunk at Jamba-v0.1-52B's (128, 16, 256, 64, 16) and
Mamba2-2.7b's (80, 16, 256, 64, 128) in float32 and bfloat16, for
``hist_opt2`` at 16,777,216 ids into 2048 bins, and for float32 flash
(causal, bkv 64) and gmm (the model path's sorted expert ids) at
Jamba-v0.1-52B's widths at batch 1, seq 4096 (32 heads of 128; 4096 x
4096 x 14336 over 16 experts, bm 32) and at the registry's shapes ((4,
1024, 1024, 128); 1024 x 512 x 512 over 8 experts, bm 128), each beside
its library call
(``torch.bincount``, ``F.scaled_dot_product_attention``,
``torch._grouped_mm``), and for ``spmv_ell`` at the registry's 65,536 x 16
and the timing shape 1,048,576 x 32 beside ``torch.linalg.vecdot``, it
prints one JSON line: the median time of a call over 30 CUDA-event-timed
calls (``kernels.cuda_time_ms``: a call's host issue counts; the card's
time of a call is ``kernels.device_time_ms``), the device time of each
device kernel of one call (``torch.profiler``) and the host's time to
issue one call with an empty queue.  ``host`` gives, for every registry
variant that launches a kernel and for ``spmv_ell``, at the registry's
shapes, the host's time to issue one
call (a median over 200 calls), the event median and the device time by
kernel; with ``--against SRC`` two fresh processes, one of this tree and
one of that checkout, time the same calls in turn, ten rounds, so that the
two trees' host issue is compared on one host at one time.  ``parts``
splits the host's time of one ``spmv_ell`` call at the registry's shape by
part, beside the steps the launch path replaced.  ``timers`` (only when
named, and only for a tree that has ``kernels.device_time_ms``) reads the
registry's calls with both timers' designs, the profiler, a short sleep
and a thread spinning in Python beside them (``timer_check``).  ``--only``
takes a comma-separated subset of ``ssd``, ``hist``, ``flash``, ``gmm``,
``spmv``, ``host``, ``parts`` and ``timers``.  This file imports only torch, numpy and
``repro_torch``, and defines its own helpers, so that it times an older
tree's wrappers as they are.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SSD_SHAPES = {"jamba": (128, 16, 256, 64, 16), "mamba2": (80, 16, 256, 64, 128)}
HIST_SHAPE = (16777216, 2048)
# (bh, sq, skv, d), causal, bkv 64, and (m, k, n, experts, bm): the
# timing shapes, then the registry's (kernels/__init__.py)
FLASH_SHAPES = {"": (32, 4096, 4096, 128), "_registry": (4, 1024, 1024, 128)}
GMM_SHAPES = {"": (4096, 4096, 14336, 16, 32), "_registry": (1024, 512, 512, 8, 128)}
# (rows, ELL width): the registry's, then the timing shape
SPMV_SHAPES = {"_registry": (65536, 16), "": (1048576, 32)}
PARTS = ("ssd", "hist", "flash", "gmm", "spmv", "host", "parts")
TIMERS = "timers"  # not in the default: needs a tree with kernels.device_time_ms
ITERS = 30
HOST_ITERS = 200  # calls of the host-issue medians of ``host``
HOST_ROUNDS = 10  # turns of each tree with ``--against``


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
    over ``iters`` calls: which of a wrapper's kernels takes the time.

    Each kernel's figure is the mean of the launches the profiler recorded,
    times its launches a call: the profiler can miss a launch near the start
    of its window (one of ten gemm v01 launches on an H100), which a
    division by ``iters`` would take for a faster kernel.  This is the
    breakdown by kernel.  The figure to quote for a call is
    ``kernels.device_time_ms``, the card's time of one call, which the
    profiler's sum here cross-checks."""
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
            per_call = max(1, round(evt.count / iters))
            out[name] = out.get(name, 0.0) + total / 1e3 / evt.count * per_call
    return out


def _record(kreg, fn) -> dict:
    return dict(ms=kreg.cuda_time_ms(fn, ITERS), device_kernels_ms=device_kernels_ms(fn),
                host_ms=host_ms(fn))


def registry_calls(kreg, spmv, dev) -> dict:
    """{variant ref: a call at the registry's shapes}: every registry
    variant that launches a kernel, and ``spmv_ell`` at 65,536 x 16; each
    called once (a first call builds its library)."""
    calls = {}
    for name in kreg.names():
        for variant in kreg.get(name).variants:
            if variant.kernel is not None:
                args = variant.inputs(dev, torch.Generator(device=dev).manual_seed(0))
                calls[f"{name}:{variant.name}"] = functools.partial(
                    variant.kernel, *args, **dict(variant.kwargs))
    r, k = SPMV_SHAPES["_registry"]
    gen = torch.Generator(device=dev).manual_seed(4)
    calls["spmv_ell"] = functools.partial(
        spmv.spmv_ell, *(torch.randn(r, k, device=dev, generator=gen) for _ in range(2)))
    for call in calls.values():
        call()
    torch.cuda.synchronize()
    return calls


def host_by_wrapper(kreg, spmv, dev, against=None) -> dict:
    """{variant ref: {"host_ms", "ms", "device_kernels_ms"}} for
    ``registry_calls``; the host's issue is a median over ``HOST_ITERS``
    calls, since a few microseconds apart is the point.  With ``against``,
    another checkout's ``src``, each record also gets ``host_against``'s
    figures, taken first."""
    turns = host_against(against) if against else {}
    calls = registry_calls(kreg, spmv, dev)
    return {ref: dict(host_ms=host_ms(call, HOST_ITERS), ms=kreg.cuda_time_ms(call, ITERS),
                      device_kernels_ms=device_kernels_ms(call), **turns.get(ref, {}))
            for ref, call in calls.items()}


def host_against(against: str) -> dict:
    """{variant ref: {"rounds_host_ms", "against_host_ms", "rounds_won",
    "rounds"}}: two fresh processes, one of this tree and one of the
    checkout whose ``src`` is ``against``, time the same ``registry_calls``
    in turn, ``HOST_ROUNDS`` rounds of ``HOST_ITERS / HOST_ROUNDS`` calls a
    wrapper each, who goes first alternating by round; the medians of each
    side's round medians, and the rounds this tree's was the lower."""
    import repro_torch

    here = str(Path(repro_torch.__file__).resolve().parents[1])
    sides = {}
    for side, src in (("here", here), ("there", against)):
        sides[side] = subprocess.Popen(
            [sys.executable, "-P", __file__, "--serve-host"],
            env=dict(os.environ, PYTHONPATH=src), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True)
    refs = [json.loads(proc.stdout.readline()) for proc in sides.values()]
    shared = [ref for ref in refs[0] if ref in refs[1]]
    batch = HOST_ITERS // HOST_ROUNDS
    got = {side: {ref: [] for ref in shared} for side in sides}
    for rnd in range(HOST_ROUNDS):
        for ref in shared:
            for side in (("here", "there") if rnd % 2 == 0 else ("there", "here")):
                proc = sides[side]
                proc.stdin.write(f"{ref} {batch}\n")
                proc.stdin.flush()
                got[side][ref].append(json.loads(proc.stdout.readline()))
    for proc in sides.values():
        proc.stdin.close()
        proc.wait()
    return {ref: dict(rounds_host_ms=statistics.median(got["here"][ref]),
                      against_host_ms=statistics.median(got["there"][ref]),
                      rounds_won=sum(h < t for h, t in zip(got["here"][ref], got["there"][ref])),
                      rounds=HOST_ROUNDS)
            for ref in shared}


def serve_host() -> None:
    """The other side of ``host_by_wrapper(..., against=...)``: print the
    refs of ``registry_calls``, then answer each line ``ref n`` with
    ``host_ms`` of n calls of ref."""
    from repro_torch import kernels as kreg
    from repro_torch.kernels import spmv

    calls = registry_calls(kreg, spmv, torch.device("cuda", 0))
    print(json.dumps(list(calls)), flush=True)
    for line in sys.stdin:
        ref, n = line.split()
        print(json.dumps(host_ms(calls[ref], int(n))), flush=True)


def host_parts(spmv, dev) -> dict:
    """The host's time for each part of one ``spmv_ell`` call at 65,536 x
    16 (medians over ``HOST_ITERS`` calls, ms): the whole call, its checks,
    the allocation of y, the ctypes call of the bound entry point (which
    enqueues the kernel), and the steps the launch path takes beside the
    ones it replaced: the device check against ``torch.cuda.device``, the
    raw stream against ``current_stream(...).cuda_stream``, the bound
    function's lookup against setting argtypes on each call.  Needs a tree
    whose ``_build`` has ``launch``."""
    import ctypes

    from repro_torch.kernels import _build

    r, k = SPMV_SHAPES["_registry"]
    gen = torch.Generator(device=dev).manual_seed(4)
    vals, xg = (torch.randn(r, k, device=dev, generator=gen) for _ in range(2))
    y = vals.new_empty((r,))
    spmv.spmv_ell(vals, xg)
    fn = _build._BOUND[("spmv", "repro_spmv_ell")]
    args = (vals.data_ptr(), xg.data_ptr(), y.data_ptr(), r, k, spmv.lanes_per_row(k),
            torch._C._cuda_getCurrentRawStream(0))

    def rebind():
        fn.argtypes = spmv._ARGTYPES
        fn.restype = ctypes.c_int

    def guard():
        with torch.cuda.device(vals.device):
            pass

    steps = {
        "call": lambda: spmv.spmv_ell(vals, xg),
        "checks": lambda: spmv._check_operands(vals, xg),
        "allocation": lambda: vals.new_empty((r,)),
        "ctypes_call": lambda: fn(*args),
        "device_check": lambda: vals.get_device() == torch._C._cuda_getDevice(),
        "device_guard_replaced": guard,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "current_stream_replaced": lambda: torch.cuda.current_stream(vals.device).cuda_stream,
        "bound_lookup": lambda: _build._BOUND.get(("spmv", "repro_spmv_ell")),
        "argtypes_replaced": rebind,
    }
    return {name: host_ms(step, HOST_ITERS) for name, step in steps.items()}


def _paired(kreg, fn, iters: int, sleep_ms: float):
    """``iters`` calls of ``fn()``, each between its own event pair, behind
    a sleep of ``sleep_ms`` on the card: (the median pair in ms, the card's
    time a call outside the pairs from the sleep's end to the last stop,
    the calls issued after the card had finished the one before)."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    held = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(sleep_ms * kreg._cycles_per_ms()))
    held.record()
    before, late = held, 0
    for start, stop in pairs:
        start.record()
        fn()
        stop.record()
        late += before.query()
        before = stop
    torch.cuda.synchronize()
    marks = [(held.elapsed_time(a), held.elapsed_time(b)) for a, b in pairs]
    inside = [b - a for a, b in marks]
    return statistics.median(inside), (marks[-1][1] - sum(inside)) / iters, late


def timer_check(kreg, spmv, dev) -> dict:
    """How the timers read ``registry_calls`` on this card, ``ITERS`` calls
    each: ``held_ms`` (``kernels.device_time_ms``: the batch bracketed by two
    events behind a sleep), ``pairs_ms`` and ``between_ms`` (an event pair
    around each call behind a 50 ms sleep: the median pair, and the card's
    time a call outside the pairs; ``pairs_late`` calls issued after the
    card had finished the one before), ``profiler_ms`` (``torch.profiler``'s
    kernel sum), ``short_late`` and ``short_between_ms`` (the pairs behind a
    2 ms sleep), and ``spin_ms`` (``held_ms`` beside a thread spinning in
    Python); ``empty_held_ms``: an empty kernel's ``held_ms``."""
    import threading

    out = {"empty_held_ms": kreg.device_time_ms(lambda: torch.cuda._sleep(0), ITERS)}
    calls = registry_calls(kreg, spmv, dev)
    for ref, call in calls.items():
        pairs_ms, between_ms, pairs_late = _paired(kreg, call, ITERS, 50.0)
        _, short_between_ms, short_late = _paired(kreg, call, ITERS, 2.0)
        out[ref] = dict(held_ms=kreg.device_time_ms(call, ITERS), pairs_ms=pairs_ms,
                        between_ms=between_ms, pairs_late=pairs_late,
                        profiler_ms=sum(device_kernels_ms(call).values()),
                        short_late=short_late, short_between_ms=short_between_ms)
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    spinner = threading.Thread(target=spin)
    spinner.start()
    try:
        for ref, call in calls.items():
            out[ref]["spin_ms"] = kreg.device_time_ms(call, ITERS)
    finally:
        stop.set()
        spinner.join()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", default=",".join(PARTS),
                        help=f"comma-separated subset of {', '.join(PARTS + (TIMERS,))}")
    parser.add_argument("--against", metavar="SRC",
                        help="another checkout's src: time its wrappers' host issue in turn "
                             "with this tree's (part host)")
    parser.add_argument("--serve-host", action="store_true", help=argparse.SUPPRESS)
    opts = parser.parse_args(argv)
    if opts.serve_host:
        serve_host()
        return 0
    parts = opts.only.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("rule2_times: no CUDA device")
    import repro_torch
    from repro_torch import kernels as kreg
    from repro_torch.kernels import flash, gmm, histogram, spmv, ssd

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
    for tag, (r, k) in SPMV_SHAPES.items() if "spmv" in parts else ():
        gen = torch.Generator(device=dev).manual_seed(4)
        vals, xg = (torch.randn(r, k, device=dev, generator=gen) for _ in range(2))
        out[f"spmv_ell{tag}"] = _record(kreg, lambda: spmv.spmv_ell(vals, xg))
        out[f"vecdot{tag}"] = _record(kreg, lambda: torch.linalg.vecdot(vals, xg, dim=1))
        del vals, xg
    if "host" in parts:
        out["host"] = host_by_wrapper(kreg, spmv, dev, opts.against)
    if "parts" in parts:
        out["spmv_ell_host_parts"] = host_parts(spmv, dev)
    if TIMERS in parts:
        out[TIMERS] = timer_check(kreg, spmv, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
