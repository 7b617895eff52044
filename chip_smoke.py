#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases:

1. Print the card's name and power limit, then build every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` and print the build time and the
   compiler's register/spill report.  Count the tensor cores' ``HMMA``
   instructions in each kernel function of the flash, gmm, gemm, the
   ragged and paged decode and the ssd libraries (``cuobjdump -sass``):
   every bfloat16 kernel must hold some, and gemm's naive rungs (v00,
   v01) and the float32 flash, gmm and ssd kernels none (they must be
   there, on the CUDA cores); the six libraries are read at once.
2. For each GEMM kernel (v00, v01, v02) at the registry's 1024^3 shape,
   in float32 and bfloat16 on inputs from a fixed numpy seed: launch on
   the card, compare with the plain PyTorch version (float32 max abs
   error <= 1e-3; bfloat16 within 1e-2 of max|C|) and with the float64
   product on the host (within 1e-2 of max|C|), and time the kernel,
   the plain version and ``torch.matmul`` (the library yardstick, which
   the port never calls) as medians of CUDA-event-timed runs (``ITERS``;
   the plain versions, yardsticks of up to 0.1 s a call, ``PLAIN_ITERS``),
   the kernel and the yardstick also on the card alone
   (``kernels.device_time_ms``: the queue held behind a sleep, so the
   host's issue is not in it).
   Every share of the bound in this phase is the bound over the card's
   time, with the event median printed beside it.  v02
   (bfloat16 on the tensor cores) is also run at its timing shape,
   Jamba-v0.1-52B's MLP up-projection (M 4096, K 4096, N 14336), in
   float32 and bfloat16: against the plain version (float32 within 1e-6
   K, the model path's bound; bfloat16 within 1e-2 of max|C|) and the
   float64 product on the card (1e-2 of max|C|), timed beside the plain
   version and ``torch.matmul``; and called twice at both shapes, which
   must give the same bits.  At both shapes bfloat16 v02 also runs on
   the tile height its rule did not pick (64 or 128 rows), which must give
   the same bits, and that time is recorded beside the rule's.
   Then the same for the GRAMSCHM kernels (naive, opt) and the TTM
   kernels (scratch, fused), each at the registry's shape and at a
   timing shape whose operands exceed the card's 50 MB L2: compare with
   the plain version (GRAMSCHM max abs error <= 1e-3, TTM <= 1e-5 of
   max|Y|) and, at the registry's shape, with the float64 product on the
   host (the same tolerances); time the kernel, the plain version and
   the library yardstick (``torch.mv``, ``torch.bmm``).  GRAMSCHM opt,
   which splits the i loop over the card, is called a second time on the
   same inputs and must give the same bits.
   Then the same for the three histogram kernels (naive, opt, opt2; bit
   for bit against the plain version and ``np.bincount``, yardstick
   ``torch.bincount``) and ``spmv_ell`` through ``ops.spmv`` (within
   1e-5 of max|y| of the plain version and of the float64 CSR product,
   yardstick ``torch.linalg.vecdot``), at the registry's size and at a
   timing size larger than L2 (the histograms against ``np.bincount`` at
   both sizes); and every histogram kernel must drop ids outside [0,
   n_bins).  opt2 and ``spmv_ell``, called twice, must give the same
   bits.  ``spmv_ell`` also records, at both sizes, its device time by
   kernel (``torch.profiler``) and the host's time to issue one call,
   beside ``torch.linalg.vecdot``'s, and its scalar path
   (``SPMV_SCALAR_CASES``: bases off 16-byte alignment, K % 4 != 0) is held
   to the plain version and the float64 product on the card and called
   twice.  Every kernel records the host's time to issue one call at the
   registry's shape beside its library call's, printed together at the end
   of the phase.
   Then the model path's kernels: flash attention, the grouped matmul
   and the SSD chunk, each at the registry's shape (against the plain
   version and a float64 host product; flash and gmm in float32 and
   bfloat16) and at a timing shape from Jamba-v0.1-52B's widths at batch
   1, seq 4096 (flash (32, 4096, 4096, 128) causal and gmm M = 4096, K =
   4096, N = 14336 over 16 experts, in float32 and bfloat16, the bfloat16
   ones on the tensor cores; ssd (128, 16, 256, 64, 16) in float32 and
   bfloat16), the SSD chunk at Mamba2-2.7b's (80, 16, 256, 64, 128) in
   float32 and bfloat16 and at the full-width model run's (256, 1, 64,
   64, 16) in float32 (every SSD run against the plain version and a
   float64 product, and called twice, which must give the same bits;
   float32 flash and gmm, redesigned for the CUDA cores, are called twice
   at both of their shapes too, and record their device time by kernel
   and the host's time to issue one call), timed beside the plain
   version and the library yardstick
   (``F.scaled_dot_product_attention``; for gmm ``torch._grouped_mm`` on
   the padded groups, held to gmm's tolerance, with a refusal printed and
   recorded, and a dense ``torch.matmul`` of the same FLOPs beside it;
   ssd has none).
   Then the serving kernels, ragged and paged MQA decode attention, each
   gated and dense (``dense=True``, the registry's baseline rung): at the
   registry's shape in float32 and at Granite-20B's decode widths (64
   sequences, 48 query heads over one KV head of 128, an 8192-token cache;
   ragged bounds from ``ragged_context(64, 8192)``, pages of 64 in 128
   slots over a pool of 8192) in float32 and bfloat16.  Each is held per
   element to its module's ``tolerance()`` against the plain version and
   against a float64 host oracle (the largest |err| / tolerance is
   printed), and timed beside the plain version and the library yardstick
   (``F.scaled_dot_product_attention`` on (B, 1, H, D) x (B, 1, S, D) with
   a boolean mask; for paged, a page gather and that call: two calls).
   Both kernels, split over the KV axis, record their split length,
   splits and live splits under ``config`` (computed from the shapes, not
   measured), and a second call on the same inputs must give the same
   bits.
   Last, both timers on every registry variant that launches a kernel
   and on ``spmv_ell`` at the registry's shapes: the card's time
   (``DEVICE_REPEATS`` runs, their median and spread) must be no more
   than the event median, and within ``DEVICE_TOL`` plus
   ``DEVICE_SLACK_MS`` of ``torch.profiler``'s sum of the call's kernels.
3. For each family (gemm, spmv, histogram, gramschm, ttm, ragged_flash,
   paged_attn): set every launch count to 0 and drive the port's main
   path in process, through the CLI entry point: ``profile`` each rung
   into the family's session, then ``diff`` the family's pairs of
   iterations and ``report`` the last.  Each must exit 0, each diff must
   show the family's story (false sharing on C, misalignment on
   rowOffsets_shift1, false sharing on cell_count, strided on q, scratch
   abuse on Y_shr fixed; the serving families' dense -> gated drop in
   transfers and the classes it keeps or moves), and every kernel of the
   family must have been launched by that run (spmv is spec-only, and so
   are the serving families' prefill rungs).  Then set the counts to 0
   again and drive ``ops.spmv``, the entry point of ``spmv_ell``, once;
   and the same for Granite-20B's decode step in bfloat16 through
   ``ops.ragged_decode_attention`` and ``ops.paged_decode_attention``.
   Then the bfloat16 step at Jamba's widths: the counts set to 0, then
   ``ops.flash_attention``, ``ops.grouped_matmul`` and ``ops.ssd_chunk``
   once each at the timing shapes in bfloat16 (the tensor-core kernels),
   each held to its tolerance.  Then the model path, each run with the counts set to 0
   just before it and read just after: ``model`` on the three registry
   models (each
   must launch its kernels: flash and gemm_v01; flash, gmm and gemm_v01;
   ssd and gemm_v01); the full-width run, ``model moe-tiny`` with
   Jamba-v0.1-52B's widths and layout at one hybrid period (8 layers: its
   per-layer table must have the nine rows of that period, and flash,
   gmm, ssd and gemm_v01 must run at Jamba's widths within their
   tolerances), and ``report`` on it; ``profile`` of the attn and moe
   rungs of the model families, each pair diffed; and ``profile -k flash
   -k gmm -k ssd``.  Each ``model`` run ends with its op-level sweep on
   meta tensors, which allocate nothing; the full-width run must print its
   sweep line, and its peak memory is printed.
4. The closed tuning loop (the paper's §VI-A, ending on ``tune gemm``),
   through the CLI entry point, every launch count set to 0 just before
   each command and read just after: ``tune gemm --budget 3 --cache DIR
   --report`` at the registry's 1024^3 float32 (exit 0, at least one kernel
   improved, every rung with a kernel holds a run record within gemm's
   1e-3 of the plain version, the bundle has a "tuning trajectory"
   section, every GEMM kernel launched); the same again on the warm cache
   (no fresh grid walk, heat maps bit-identical to the cold run's, the runs
   measured and checked again); ``tune --all`` (no workers) over gemm, spmv,
   histogram, gramschm, ttm, ragged_flash and paged_attn (one line per
   family: transfers before -> after, the accepted moves, which must be
   ``TUNE_ALL_MOVES``'s); each tune
   command's run of a rung may be slower on the card (``device_ms``) than
   phase 3's run of that rung alone by no more than ``ALONE_TOL`` and
   ``ALONE_SLACK_MS``; on phase 3's gemm session (``profile -k gemm:v00``
   then ``-k gemm:v01``, the same commands in this process), ``check iter0
   --baseline iter1 --json -`` (exit exactly 1, ``"schema_version": 1``)
   and ``check SESSION --anomaly``.  ``lint --all`` and ``kernels --lint``
   (exit 0), static checks that need neither the card nor a quiet host,
   run in a process of their own beside phase 8 (``start_lint``).
   The cold and warm ``tune gemm`` wall times (in process: the host's
   turnaround of the command) are printed beside the card's name and
   power limit.
5. Sharded collection and fault tolerance on the card's host, through the
   CLI entry point, every launch count set to 0 just before each command
   and read just after, with W = min(4, os.cpu_count()) workers.  The
   phase keeps one clean pool for each worker count, started once and
   shared by its sharded commands (each session asks for it instead of
   starting its own); a run with injected faults starts its own, as a
   user's would.  First the walk of gemm:v00 (the registry's 1024^3, its
   sampler) split in process into the serial walk and flush, the W-worker
   pool's start, the walk on the started pool and the parent's flush, with
   the grid size from which W workers would pay (``shard_split``); then
   ``tune gemm --budget 3 --workers W`` on a fresh cache, on that pool (its
   trajectory equals phase 4's step for step, its turnaround is printed on
   the started pool and with the pool's start, beside phase 4's serial
   one, and each rung's time is held to phase 3's as in phase 4).  Its
   baseline is the W-worker walk of gemm:v00: held to phase 3's serial
   ``profile -k gemm:v00`` (the same command in this process; ``diff``
   prints ``unchanged``, the heat maps are bit-identical, the walk times
   and the shard count are printed).  Then ``profile -k gemm:v01 --sampler
   full`` serially, with ``--workers 2`` (the 2-worker pool's start
   counts), and with ``--workers 2 --inject-faults seed=7`` (exit 0,
   ``recovered faults:`` names pool-rebuild, shard-resplit, shard-timeout
   and worker-crash, the heat map equals the serial one, the manifest has
   its ``faults`` block; the recovery's overhead against the clean sharded
   walk is printed, each with its pool's start); and phase 3's full-width
   Jamba-v0.1-52B ``model`` run with ``--workers 2`` on the 2-worker pool,
   preempted by a SIGTERM the process sends itself after the first kernel
   (exit 3, journal kept), then ``--resume`` with the same flags (exit 0,
   journal removed, heat maps bit-identical to phase 3's).  Every pool is
   probed before it closes: no worker may hold a CUDA context, have loaded
   a kernel library or launched a kernel, and no library under ``build/``
   may be rebuilt.  Each number is printed beside the card's name and
   power limit and the host's core count.
6. The model forward at full width, through the port's entry points
   (``LM``, ``prefill``, ``decode_step``): Jamba-v0.1-52B from its
   published config, cut to one hybrid period (8 of 32 layers, every
   block kind), batch 1.  Each block kind (mamba+mlp, mamba+moe,
   attn+mlp) in float32 against float64 on the card, on the same
   parameters, at 512 tokens (``BLOCK_TOL``); then the cut in bfloat16
   (26.0 GB): a 4096-token prefill (median of ``FWD_RUNS`` CUDA-event
   runs) and 32 decode steps after it, with tokens/s, the parameter
   bytes, the peak memory, a ``torch.profiler`` breakdown of one prefill
   and one decode step (the card's busy time and idle share, the ops with
   the most device time), and the op sweep's FLOPs and bytes beside
   ``core/roofline.py``'s terms and the share of the bound reached (the
   memory term from the bytes each function needs: parameters, cache
   state, tokens and logits; the eager ops' own bytes are printed as a
   diagnostic), the decode step profiled and counted being the last timed
   one; the
   bfloat16 logits against the float32 cut's on the same draws
   (``BF16_TOL`` on the positions routed alike in both); float32
   prefill(504) plus 8 decode steps against the forward of 512
   (``DECODE_TOL``).  Each tolerance is stated with the constants and
   printed beside the value observed.
7. Serving on the card, through the port's entry points: Granite-8B from
   its published config, whole, in bfloat16 (16.1 GB).  First
   ``launch.serve.main`` with the reference's traffic (8 slots, max_seq
   2048, 16 requests of prompts of 2-11 tokens, 64 tokens each), then a
   ``Server`` with 8 slots and 16 prompts of 256-1024 tokens from a numpy
   seed.  For each: tokens/s, the median and largest decode tick,
   admissions and the prefill time of each, the card's busy time and idle
   share over decode ticks 10-19 (``torch.profiler``, the ops with the
   most device time by input shape), the peak memory, and each tick's
   bound (``core/roofline.py``: the weights read once plus each live
   slot's K/V up to its own length) with the share reached; every
   request must end with its 64 tokens.  Then the whole model in float32:
   16 requests over the 8 slots (prompts of 2-11 tokens, 8-16 tokens
   each, so that slots are refilled while others decode, some after a
   longer request), every one of which must decode token for token as a
   batch-1 ``prefill`` and ``decode_step`` of its own.
8. Training on the card: Granite-8B's widths at depth 16 of 36 (bf16
   parameters and gradients, float32 AdamW moments), batch 4 x 4096,
   ``remat="full"``, AdamW warmed up over 2000 steps to 3e-3, clipped at
   1.0, 8 steps of ``run`` on ``SyntheticSource``: the step times (median
   of steps 1-6), tokens/s, the peak memory, the share of the 6ND bound
   and of the op sweep's compute term, and the card's idle share in step
   7 (``torch.profiler``).  The loss and the gradient norm must be finite
   at every step and the loss must fall from step 0 to step 7.  Then
   ``launch.train.main --smoke`` on the card with ``--ckpt-dir``: a
   SIGTERM during step 6 writes the preemption checkpoint (and
   ``Preempted`` stops the run), the checkpoint's parameters restored on
   the card must hash equal to the saved, and ``--resume`` must start at
   step 6.  Beside this phase, which the card bounds, phase 4's lint
   commands (their process first times a fresh interpreter's import of
   the collector, then of torch, for phase 5) and phase 10's longest
   dry-run groups (``EARLY_DRYRUNS``) run in processes of their own on the
   host's other cores.  Each phase prints its time.
10. The mesh path on the card (run before the record): a one-rank NCCL
   group and a (1, 1) ("data", "model") mesh from ``launch.mesh``.  (a)
   Granite-8B's widths at depth 4, laid out by the training launcher's
   mesh code: one float32 step at batch 2 x 4096 against the same step
   with no mesh (loss within 1e-4, every parameter within 1e-3), then
   bfloat16 at 4 x 4096, 4 steps and one under ``torch.profiler`` each
   way (the median step, peak memory, idle share), and the host's time
   to issue a step at 2 x 256 each way (DTensor's host cost).  (b)
   ``moe_apply_ep`` at Jamba-v0.1-52B's MoE widths, 4096 tokens, float32:
   within 1e-4 of max|y| of ``moe_apply_capacity`` and of ``moe_ref`` on
   the positions kept; then each path's bfloat16 time and the NCCL
   kernels' device time.  (c) The dry-run of granite-3-2b x decode_32k on
   256 and 512 placeholder ranks, in a process of its own started first,
   and beside it, each in another (those of ``EARLY_DRYRUNS`` started
   before phase 8): granite-3-2b x train_4k and
   deepseek-v3-671b x train_4k at full depth on 512 (2 x 16 x 16; the
   first's step runs on the mesh's 32 x 16 flat view, the second's on the
   3-D mesh, its experts split over ("model", "data")), and each family's
   train step at the CPU test's cut depths (``DRYRUN_GROUPS``): chips,
   per-device bytes, FLOPs, wire bytes by collective, the bound and the
   seconds, with the card's name and power limit; each cell must finish
   within ``DRYRUN_TIMEOUT``, and torch 2.11's DTensor raises on a view it
   refuses.  Any failure fails the script.
11. The six examples of ``repro_torch.examples``, each in process on the
   card through its ``main`` (run before the record), every launch count
   set to 0 just before each and read just after, its printed report
   kept in ``build/chip_smoke_examples/<name>.log`` and its wall time
   printed beside the card's name and power limit: ``quickstart`` (gemm
   v00 and v01 launched through ``ops.matmul`` and agreeing within 1e-3,
   v01's modeled transfers at or below v00's), ``optimize_gemm`` (each
   rung's kernel launched and held to its plain version, the transfers
   per row of C at or below the last rung's from v00 to v02),
   ``heatmap_gallery`` (a report bundle for each of its two iterations,
   one entry per family's rung, every rung's kernel launched),
   ``serve_lm`` (all 10 requests end with their 12 tokens; every greedy
   request decodes token for token as a batch-1 ``prefill`` and
   ``decode_step`` of its own, as phase 7 checks its requests, and gives
   the tokens that the same ``Server`` gives on the CPU on a copy of the
   model; then again, warm, with the same greedy tokens), ``serve_long_context``
   (the per-token ms of the SSM and the GQA model after each prefill,
   printed with the card's name and power limit) and ``train_lm`` (``--steps
   8`` cut at step 3, then at step 6, and once more at 3 on a (1, 1)
   mesh: steps 3-5 after the restore give the losses of the run not yet
   cut there, bit for bit, and the mesh run's losses are within 1e-4 of
   the plain run's).  Any failure fails the script.
12. The regression gate on the card (run before the record), as the
   port's check-smoke CI job runs it on the CPU: in a temporary session,
   ``profile --kernel gemm:v01 --kernel gramschm:opt --kernel
   model.transformer-tiny.mlp:v02 --device cuda`` in process (each rung
   launched and held to its plain version by ``run_variant``, as in phase
   3), then ``check <iteration> --baseline artifacts/ci-baseline-torch
   --json <file>`` must exit 0 with a ``cuthermo-check`` document of
   schema version 1 that passed, every kernel's status ``pass``, and each
   heat map of the card's run must equal the committed one
   (``heatmaps_equal``); then ``profile --kernel gemm:v00 --device cuda``
   and ``check ... --threshold missing=off`` must exit exactly 1 with a
   "modeled transfers" failure.  The launches (gemm v00, v01, v02 and
   GRAMSCHM opt) go into each kernel's record as ``gate_launches``; the
   phase's time is printed beside the card's name and power limit.
9. Print the script's time, then one JSON line describing every kernel,
   each with the card's name and power limit under ``config``, then one
   line of every phase's time and the total (``phase times: {"1": ...,
   "total": ...}``), then the result line.  Every phase prints its time.

The kernels redesigned for the card as a whole (GRAMSCHM opt, the ragged
and paged decode, gemm v02, the SSD chunk, histogram opt2) also record, at
their timing shapes (gemm v02 at 1024^3 too, the SSD chunk at all five of
its shapes), the device time of each of their device kernels
(``torch.profiler``; for opt2 the memset of its ``torch.zeros`` output
too) and the host's time to issue one call of the kernel and (where there
is one) of its library yardstick: the event median counts both the host's
issue and the card's time of a call, ``device_ms`` the card's alone.

There is no fallback: without a CUDA device, or outside a checkout of
the repository, the script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# host turnarounds phase 4 measures and phase 5 sets its sharded ones beside
TURNAROUND = {}
# phase -> its seconds, and the script's under "total": the summary line
# printed just before the result line
PHASE_TIMES = {}
# (family, rung) -> the card's ms a call (the run's ``device_ms``) of phase
# 3's run of that rung, profiled alone: no tune command's run of the same
# rung may be slower on the card by more than ALONE_TOL
ALONE_MS = {}
# a tune run's device time may exceed the rung's alone by this share, plus
# ALONE_SLACK_MS.  kernels.device_time_ms holds the queue behind a sleep, so
# the host's issue, which moved the event median by up to 0.045 ms alone and
# 0.4-3.5 ms beside threads that walk in Python, is not in it: on an NVIDIA
# H100 80GB HBM3 at 700 W, DEVICE_REPEATS runs of each registry call moved
# by at most 0.00018 ms (ttm:fused, 6.5 %), and beside a thread spinning in
# Python by -3.4 to +4.8 % (spmv_ell, 0.00018 ms; rule2_times.py --only
# timers)
ALONE_TOL, ALONE_SLACK_MS = 0.05, 0.0005
# kernels.device_time_ms against torch.profiler's sum of a call's kernels
# (phase 2, every registry variant): within DEVICE_TOL of the sum plus
# DEVICE_SLACK_MS for each of the call's kernels.  The profiler times each
# kernel from its start to its end; back to back, the card also spends
# 0.8-1.5 us dispatching each (the same card: an empty kernel takes 2.0 us
# a call; the registry's calls 0.78-1.46 us over the profiler's sum with
# one kernel, 1.94-2.17 with two, 3.20 with three; rule2_times.py --only
# timers)
DEVICE_TOL, DEVICE_SLACK_MS = 0.05, 0.0015
DEVICE_REPEATS = 3  # device_time_ms runs a registry variant, for its spread

SHAPE = (1024, 1024, 1024)  # (m, n, k): the registry's gemm shape
# gemm v02's timing shape: Jamba-v0.1-52B's MLP up-projection at batch 1,
# seq 4096 (src/repro_torch/configs/archs.py:jamba_52b: d_model 4096, d_ff
# 14336), where the card's time is far above the host's dispatch
GEMM_TIMING_SHAPE = (4096, 14336, 4096)  # (m, n, k)
ITERS = 30  # CUDA-event-timed runs per median
# CUDA-event-timed runs of a plain version, a yardstick of 0.05-101 ms a
# call (the paged decode's at Granite-20B's widths 76-101 ms: 30 runs of
# the serving rows' plain versions took ~15 s of phase 2)
PLAIN_ITERS = 5

# Published peaks of an H100 SXM at its 700 W limit (NVIDIA data sheet,
# dense): device memory rate, and the peak rate for each input type.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

REPLACES = {
    "v00": "src/repro/kernels/gemm.py:40",
    "v01": "src/repro/kernels/gemm.py:81",
    "v02": "src/repro/kernels/gemm.py:123",
    "gramschm_k3_naive": "src/repro/kernels/gramschm.py:29",
    "gramschm_k3_opt": "src/repro/kernels/gramschm.py:60",
    "ttm_scratch": "src/repro/kernels/ttm.py:36",
    "ttm_fused": "src/repro/kernels/ttm.py:46",
    "hist_naive": "src/repro/kernels/histogram.py:38",
    "hist_opt": "src/repro/kernels/histogram.py:72",
    "hist_opt2": "src/repro/kernels/histogram.py:97",
    "spmv_ell": "src/repro/kernels/spmv.py:31",
    "flash_attention": "src/repro/kernels/flash.py:28",
    "gmm": "src/repro/kernels/gmm.py:49",
    "ssd_chunk": "src/repro/kernels/ssd.py:31",
    "ragged_decode_attention": "src/repro/kernels/ragged_flash.py:42",
    "paged_decode_attention": "src/repro/kernels/paged_attn.py:40",
}
SOURCE = "src/repro_torch/kernels/csrc/gemm.cu"

# the case-study families' timing shapes, beside the registry's: their
# operands exceed the 50 MB L2, so a launch streams from device memory
TIMING_SHAPES = {
    "gramschm": (4096, 4096, 4096),  # (ni, nj, nk)
    "ttm": (262144, 8, 32),  # (f, nf, r)
    "histogram": (16777216, 2048),  # (cells, n_bins): 64 MiB of ids
    "spmv": (1048576, 32),  # (rows, ELL width): 256 MiB of vals and xg
}
# the model path's timing shapes: Jamba-v0.1-52B's widths
# (src/repro_torch/configs/archs.py:jamba_52b) at batch 1, seq 4096
MODEL_TIMING_SHAPES = {
    "flash": (32, 4096, 4096, 128),  # (bh, sq, skv, d): 32 heads of 128, causal
    "gmm": (4096, 4096, 14336, 16, 32),  # (m, k, n, experts, bm)
    "ssd": (128, 16, 256, 64, 16),  # (bh, chunks, l, p, n): 128 SSD heads
}
# Mamba2-2.7b's SSD chunk (src/repro_torch/configs/archs.py:mamba2_2_7b:
# 80 heads of 64, state 128, chunks of 256) at batch 1, seq 4096
MAMBA2_SSD_SHAPE = (80, 16, 256, 64, 128)
# phase 6, the model forward: Jamba-v0.1-52B from its published config
# (src/repro_torch/configs/archs.py:jamba_52b) at full width, its depth cut
# to one hybrid period (8 of 32 layers: every block kind), in bfloat16
FWD_LAYERS = 8
FWD_PREFILL, FWD_DECODE = 4096, 32  # prompt tokens, then decode steps
FWD_RUNS = 3  # timed prefills (after one warm-up)
BLOCK_SEQ = 512  # tokens of the per-block float32-vs-float64 check
# max|float32 - float64| of a block's update (its output less its input)
# over max|float64 update|: float32's 2^-24 rounding summed over K = 14336
BLOCK_TOL = 1e-4
# |bf16 - float32| / |float32| of the logits (Frobenius norms), on the
# positions whose experts were the same in every MoE layer of both runs
# (bfloat16's 2^-9 rounding through 8 layers: 3.0-3.5% on the CPU at
# widths 64-512, about flat in the width; a position routed otherwise
# differs by a whole expert); and the least share of positions routed
# alike for that check to say anything
BF16_TOL, ALIKE_MIN = 5e-2, 0.5
# prefill(S - 8) then 8 decode steps against the forward of S, float32:
# max|err| over max|logits|, the CPU tests' whole-model tolerance
DECODE_SEQ, DECODE_STEPS, DECODE_TOL = 512, 8, 1e-4
# Jamba-v0.1-52B's fields that layout() and kind_spec read; the full-width
# run applies them to moe-tiny at one hybrid period (8 layers)
JAMBA_FIELDS = (
    "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "head_dim",
    "vocab_pad_multiple", "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_chunk",
    "hybrid_period", "hybrid_attn_index", "n_experts", "top_k", "moe_period",
    "n_dense_layers",
)
JAMBA_LAYERS = {
    "layer0": ["ssm", "mlp"], "layer1": ["ssm", "moe"], "layer2": ["ssm", "mlp"],
    "layer3": ["ssm", "moe"], "layer4": ["attn", "mlp"], "layer5": ["ssm", "moe"],
    "layer6": ["ssm", "mlp"], "layer7": ["ssm", "moe"], "head": ["unembed"],
}
# the serving kernels' timing shapes: Granite-20B's decode step
# (src/repro_torch/configs/archs.py:granite_20b: 48 query heads, one KV head
# of 128, an 8192-token context) at 64 sequences
SERVING_TIMING_SHAPES = {
    "ragged": (64, 48, 8192, 128),  # (b, h, s, d)
    "paged": (64, 48, 128, 64, 8192, 128),  # (b, h, d, page, pages, slots)
}
# the kernels redesigned for the card as a whole: a second call on the same
# inputs must give the same bits, and their timing shapes record the device
# time of each device kernel and the host's time to issue one call
REPEAT_CHECKED = ("gramschm_k3_opt", "ragged_decode_attention", "paged_decode_attention",
                  "gemm_v02", "ssd_chunk", "hist_opt2", "spmv_ell")
# ... and in float32 only: the model path's routes on the CUDA cores
REPEAT_CHECKED_F32 = ("flash_attention", "gmm")
# the model path's SSD chunk in the full-width Jamba-v0.1-52B run (batch 2,
# seq 64: 256 heads x batch, one chunk of 64)
MODEL_PATH_SSD_SHAPE = (256, 1, 64, 64, 16)
SPMV_COLS = 36417  # the registry's column count
SPMV_WIDTH = 16  # ELL width at the registry's 65,536 rows
# spmv_ell also records, at both of its shapes, its device time by kernel
# and the host's time to issue one call, beside torch.linalg.vecdot's
SPLIT_TIMED = ("spmv_ell",)
# spmv_ell's scalar path: (rows, ELL width, element offsets of the vals and
# xg views from their buffers' 16-byte-aligned starts); a base off 16-byte
# alignment, and K % 4 != 0 with K > 128
SPMV_SCALAR_CASES = ((65536, 16, (1, 3)), (65536, 130, (0, 0)))
# the host's time to issue one call at the registry's shape, and its library
# call's, of every kernel: {label: {"host_ms", "library_host_ms"}}
REGISTRY_HOST = {}
# phase 7, serving: Granite-8B from its published config
# (src/repro_torch/configs/archs.py:granite_8b, [arXiv:2405.04324]), whole,
# in bfloat16; the reference's entry point and traffic, then longer prompts
SERVE_ARGV = ["--arch", "granite-8b", "--slots", "8", "--max-seq", "2048",
              "--requests", "16", "--max-tokens", "64"]
SERVE_SLOTS, SERVE_REQUESTS, SERVE_MAX_TOKENS, SERVE_MAX_SEQ = 8, 16, 64, 2048
LONG_PROMPT = (256, 1024)  # prompt lengths of the library-level run, inclusive
SERVE_PROFILED = (10, 20)  # decode ticks under torch.profiler (no admission)
# the f32 check: every request against a direct batch-1 decode of its own;
# twice as many requests as slots, with max_tokens drawn from a range, so
# that slots are refilled while others decode
CHECK_PROMPTS = (11, 2, 10)  # request 0's length, then the others' range
CHECK_TOKENS = (8, 16)  # max_tokens of each request, inclusive
CHECK_REQUESTS, CHECK_MAX_SEQ = 16, 64
# phase 8, training: Granite-8B's widths at depth 16 of 36, bfloat16
# parameters and gradients, float32 AdamW moments (44.3 GB; 36 layers would
# need 96.6 GB), the train_4k length.  The first steps of a long run,
# warmed up over 2000 steps to the peak rate.  AdamW's first steps move
# every element by about the rate, and at these widths that moves the
# function far: on an H100 80GB HBM3 at 700 W, a rate of 3e-3 at step 1
# (the launcher's warmup of max(steps // 10, 1)) took the loss from 11.59
# to 24.23, 3e-5 (warmup 100) to 14.03, 1.5e-6 (warmup 2000) to 11.43 and
# down to 7.56 by step 7; at rate 0 it stays at 11.58-11.67
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 4, 4096, 8
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 3e-3, 2000, 100_000
# the training entry point on the card: the smoke config, a SIGTERM after
# PREEMPT_AT steps, then --resume
TRAIN_ARGV = ["--arch", "granite-8b", "--smoke", "--steps", "12", "--ckpt-every", "5",
              "--device", "cuda"]
PREEMPT_AT = 7

# phase 10, the mesh path on one card: a one-rank NCCL group and a (1, 1)
# ("data", "model") mesh.  (a) Granite-8B's widths
# (src/repro_torch/configs/archs.py:granite_8b, [arXiv:2405.04324]) at depth
# 4 of 36, laid out by the launcher's mesh code: one float32 step at batch
# 2 x 4096 against the same step with no mesh, then bfloat16 at 4 x 4096
# (train_4k's sequence), 4 timed steps each way and one under torch.profiler
MESH_LAYERS, MESH_CHECK_BATCH, MESH_BATCH, MESH_SEQ, MESH_STEPS = 4, 2, 4, 4096, 4
# DTensor's host cost: the host's time to issue a step where the card is
# not what bounds it (at 4 x 4096 the launch queue fills and the host
# waits on the card), batch 2 x 256
HOST_BATCH, HOST_SEQ = 2, 256
# the reference's tolerances (tests/test_sharding_multidevice.py:118-119)
MESH_LOSS_TOL, MESH_PARAM_TOL = 1e-4, 1e-3
# (b) Jamba-v0.1-52B's MoE widths (configs/archs.py:jamba_52b: 16 experts,
# top-2, d 4096, d_ff 14336), 4096 tokens: EP against capacity and moe_ref,
# float32, within EP_TOL of max|y| (on the positions routed alike and kept,
# against moe_ref, which drops nothing); then bfloat16 timings
MOE_TOKENS, EP_TOL, MOE_ITERS = 4096, 1e-4, 10
# (c) the dry-run of the reference test's cell on 256 and 512 placeholder
# ranks, of granite-3-2b x train_4k and deepseek-v3-671b x train_4k at full
# depth on 512 (ROADMAP queue 3 item 11), and of each family's train step
# at the CPU test's cut depths (tests/test_torch_dryrun_families.py), each
# group in a process of its own on the card's host, alongside (a) and (b).
# Each cell must finish within DRYRUN_TIMEOUT seconds; torch 2.11, the
# card's, raises on a view its DTensor refuses.  A group's cells: (arch,
# shape, on 2 x 16 x 16, depth or None for the config's)
DRYRUN_TIMEOUT = 300
DRYRUN_GROUPS = {
    "decode": [("granite-3-2b", "decode_32k", False, None),
               ("granite-3-2b", "decode_32k", True, None)],
    "train": [("granite-3-2b", "train_4k", True, None)],
    "deepseek": [("deepseek-v3-671b", "train_4k", True, None)],
    "moe": [("llama4-scout-17b-a16e", "train_4k", True, 1)],
    "mamba": [("mamba2-2.7b", "train_4k", True, 1)],
    "hybrid": [("jamba-v0.1-52b", "train_4k", True, 8)],
    "mla_moe": [("deepseek-v3-671b", "train_4k", True, 4)],
    "encdec": [("whisper-base", "train_4k", True, 1)],
    "vl": [("qwen2-vl-72b", "train_4k", True, 1)],
    "mla_prefill": [("deepseek-v3-671b", "prefill_32k", True, 4)],
}
# the groups started before phase 8, the two longest (deepseek-v3 and
# granite-3-2b x train_4k on 512 ranks: 75-103 s and 45-57 s, each on one
# core, where phase 10's mesh steps take 35-45 s)
EARLY_DRYRUNS = ("deepseek", "train")
DRYRUN_SCRIPT = """
import json, sys, time
from repro_torch.launch import dryrun
out = {}
for arch, shape, multi, layers in json.loads(sys.argv[1]):
    dryrun.fake_world(512 if multi else 256)
    t0 = time.perf_counter()
    res = dryrun.run_cell(arch, shape, multi, verbose=False, layers=layers)
    res["wall_s"] = time.perf_counter() - t0
    res["layers"] = layers
    out[f"{arch} x {shape} on {res['mesh']}" + (f" at depth {layers}" if layers else "")] = res
print(json.dumps(out))
"""

# phase 11, the examples: train_lm's steps, the two steps at which it is cut
# (steps 3-5 follow the restore in the first run and are not yet cut in the
# second), and the loss tolerance of its run on a (1, 1) mesh (phase 10's)
EXAMPLE_STEPS = 8
EXAMPLE_CUTS = (3, 6)
EXAMPLE_MESH_TOL = 1e-4

# the story each family's diffs must tell (phase 3), by pair of iterations;
# the histogram's and spmv's classes under the H100 geometry are ROADMAP
# queue 3 items 3, 4 and 12 (hot read on word temperatures: the naive
# histogram's cell_count and the gathered x are hot beside their false sharing)
STORIES = {
    "gemm": {(0, 1): ["[fixed] false-sharing on C"]},
    "spmv": {(0, 1): ["[fixed] misalignment on rowOffsets_shift1",
                      "[persisting] hot-random on x"]},
    "histogram": {
        (0, 1): ["[fixed] false-sharing on cell_count",
                 "[INTRODUCED] false-sharing on partials"],
        (0, 2): ["[fixed] false-sharing on cell_count", "[persisting] hot on cell_count"],
    },
    "gramschm": {(0, 1): ["[ improved] gramschm: transfers 41024 -> 34112",
                          "[fixed] strided on q"]},
    "ttm": {(0, 1): ["[fixed] scratch-abuse on Y_shr"]},
    # dense -> gated: the same classes, far fewer transfers (ROADMAP queue 3
    # item 7; each bound word is warm in all its sequence's warps: hot)
    "ragged_flash": {
        (0, 1): ["[ improved] ragged_flash: transfers 68824 -> 13104",
                 "[persisting] hot on starts"],
        (2, 3): ["[ improved] ragged_flash: transfers 393472 -> 149440"],
    },
    # the paged split blocks: the dense sweep reads Q from every split and each
    # split's own table words (false sharing); both rungs share the table words
    "paged_attn": {
        (0, 1): ["[ improved] paged_attn: transfers 71244 -> 23464",
                 "[fixed] hot on Q", "[fixed] false-sharing on block_tables",
                 "[persisting] hot on block_tables"],
        (2, 3): ["[ improved] paged_attn: transfers 360704 -> 208704"],
    },
}

# phase 12, the regression gate: the baseline rungs of
# tools/make_ci_baseline_torch.py, the committed baseline they are gated
# against, and the kernels they must launch (the model rung runs gemm v02
# at transformer-tiny's widths)
GATE_REFS = ("gemm:v01", "gramschm:opt", "model.transformer-tiny.mlp:v02")
GATE_BASELINE = ROOT / "artifacts" / "ci-baseline-torch"
GATE_MUST = ("gemm_v01", "gramschm_k3_opt", "gemm_v02")

# the moves phase 4's ``tune --all`` accepts, by family (the host's model:
# the same on any device); the decode families pin their bounds and tables
# (ROADMAP queue 3 item 7), spmv pins its hot-random x after the zigzag rung
# (items 4 and 12: 83734 -> 20937), gemm climbs the ladder (item 1)
TUNE_ALL_MOVES = {
    "gemm": ["ladder:v01", "ladder:v02"],
    "spmv": ["ladder:zigzag", "pin(x)"],
    "histogram": ["ladder:scratch"],
    "gramschm": ["ladder:opt"],
    "ttm": ["ladder:fused"],
    "ragged_flash": ["ladder:decode-ragged", "pin(starts)", "pin(ends)"],
    "paged_attn": ["ladder:decode-paged", "pin(context_lens)", "pin(block_tables)"],
}


def phase_took(phase: str, t0: float, tail: str = "") -> float:
    """Print phase ``phase``'s time since ``t0`` (``phase N took X s`` and
    ``tail``), keep it in ``PHASE_TIMES`` for the summary line, and return
    the clock's reading, the next phase's start."""
    now = time.perf_counter()
    PHASE_TIMES[phase] = round(now - t0, 1)
    print(f"phase {phase} took {now - t0:.1f} s{tail}")
    return now


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def bound_of(n_bytes: int, ops: int, dtype: str = "float32"):
    """(bound_ms, bound_by): the least time for work that must move
    ``n_bytes`` and do ``ops`` operations of ``dtype`` on this card."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bound(m: int, n: int, k: int, dtype: str, itemsize: int):
    """(bound_ms, bound_by): the least time for C = A·B on this card."""
    return bound_of((m * k + k * n + m * n) * itemsize, 2 * m * n * k, dtype)


def case_inputs(family: str, shape, dev):
    """One family's case at ``shape``, on inputs from a fixed numpy seed:
    {kernel name: (wrapper, args, kwargs)}, the float64 host product, the
    plain and library calls, and the bytes and FLOPs of the work."""
    import numpy as np
    import torch

    from repro_torch.kernels import GRAMSCHM_K, gramschm, histogram, ops, ref, ttm

    rng = np.random.default_rng(1)
    if family == "histogram":
        n, n_bins = shape
        cells_np = rng.integers(0, n_bins, size=n).astype(np.int32)
        cells = torch.from_numpy(cells_np).to(dev)
        return dict(
            kernels={
                f"hist_{v}": (getattr(histogram, f"hist_{v}"), (cells,), {"n_bins": n_bins})
                for v in ("naive", "opt", "opt2")
            },
            exact=lambda: np.bincount(cells_np, minlength=n_bins),
            plain=lambda: histogram.hist_plain(cells, n_bins),
            library=lambda: torch.bincount(cells, minlength=n_bins),
            # integer counts below 2**24 are exact in float32 in any order
            tol=lambda scale: 0.0,
            bytes=4 * (n + n_bins),
            flops=n,
            source="src/repro_torch/kernels/csrc/histogram.cu",
        )
    if family == "spmv":
        rows, width = shape
        vals, xg, csr = spmv_inputs(rows, width, dev, rng)
        k = vals.shape[1]
        return dict(
            kernels={"spmv_ell": (ops.spmv, (vals, xg), {})},
            exact=lambda: ref.spmv_csr_ref(*csr),
            plain=lambda: ref.spmv_ref(vals, xg),
            library=lambda: torch.linalg.vecdot(vals, xg, dim=1),
            # float32 sums of up to 32 products in another order
            tol=lambda scale: 1e-5 * scale,
            bytes=4 * (2 * rows * k + rows),
            flops=2 * rows * k,
            source="src/repro_torch/kernels/csrc/spmv.cu",
        )
    if family == "gramschm":
        ni, nj, nk = shape
        k = GRAMSCHM_K
        q_np = rng.standard_normal((ni, nk), dtype=np.float32)
        a_np = rng.standard_normal((ni, nj), dtype=np.float32)
        q = torch.from_numpy(q_np).to(dev)
        qt = q.t().contiguous()
        a = torch.from_numpy(a_np).to(dev)
        qk = q[:, k].contiguous()
        return dict(
            kernels={
                "gramschm_k3_naive": (gramschm.gramschm_k3_naive, (q, a), {"k": k}),
                "gramschm_k3_opt": (gramschm.gramschm_k3_opt, (qt, a), {"k": k}),
            },
            exact=lambda: q_np[:, k].astype(np.float64) @ a_np.astype(np.float64),
            plain=lambda: gramschm.gramschm_k3_plain(q, a, k),
            library=lambda: torch.mv(a.t(), qk),
            # float32 sums of up to 4096 N(0,1) products in another order
            tol=lambda scale: 1e-3,
            bytes=4 * (ni * nj + ni + nj),
            flops=2 * ni * nj,
            source="src/repro_torch/kernels/csrc/gramschm.cu",
        )
    f, nf, r = shape
    vals_np = rng.standard_normal((f, nf), dtype=np.float32)
    urows_np = rng.standard_normal((f, nf, r), dtype=np.float32)
    vals = torch.from_numpy(vals_np).to(dev)
    urows = torch.from_numpy(urows_np).to(dev)
    return dict(
        kernels={
            "ttm_scratch": (ttm.ttm_scratch, (vals, urows), {}),
            "ttm_fused": (ttm.ttm_fused, (vals, urows), {}),
        },
        exact=lambda: np.einsum(
            "fn,fnr->fr", vals_np.astype(np.float64), urows_np.astype(np.float64)
        ),
        plain=lambda: ttm.ttm_plain(vals, urows),
        library=lambda: torch.bmm(vals.unsqueeze(1), urows).squeeze(1),
        # sums of 8 products, so the error is relative to |Y|
        tol=lambda scale: 1e-5 * scale,
        bytes=4 * (f * nf + f * nf * r + f * r),
        flops=2 * f * nf * r,
        source="src/repro_torch/kernels/csrc/ttm.cu",
    )


def spmv_inputs(rows: int, width: int, dev, rng):
    """A seeded CSR matrix of ``rows`` rows with 1 to ``width`` nonzeros
    each over the registry's columns, as ELL ``vals`` and ``xg`` on the
    card (x gathered in PyTorch, outside the kernel), and its float64 CSR
    arrays on the host."""
    import numpy as np
    import torch

    from repro_torch.kernels import spmv

    counts = rng.integers(1, width + 1, size=rows)
    row_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    col_indices = rng.integers(0, SPMV_COLS, size=int(row_offsets[-1])).astype(np.int32)
    values = rng.standard_normal(col_indices.size, dtype=np.float32)
    x = rng.standard_normal(SPMV_COLS, dtype=np.float32)
    idx, val = spmv.csr_to_ell(row_offsets, col_indices, values, rows)
    vals = torch.from_numpy(val).to(dev)
    xg = torch.from_numpy(x).to(dev)[torch.from_numpy(idx).to(dev).long()]
    csr = (row_offsets, col_indices, values.astype(np.float64), x.astype(np.float64))
    return vals, xg.contiguous(), csr


def launch_count(name: str) -> int:
    """Launches so far of the case-study kernel ``name``'s counting wrapper."""
    from repro_torch.kernels import gramschm, histogram, spmv, ttm

    for module in (gramschm, histogram, spmv, ttm):
        if hasattr(module, name):
            return getattr(module, name).launches
    raise KeyError(name)


def check_out_of_range(dev):
    """Every histogram kernel drops ids outside [0, n_bins): 1024 ids of
    which 384 are -1, 64 or 70, into 64 bins.  Returns a failure message
    or None."""
    import torch

    from repro_torch.kernels import histogram

    cells = torch.tensor([-1, 0, 1, 63, 64, 70, 5, 5] * 128, dtype=torch.int32, device=dev)
    want = histogram.hist_plain(cells, 64)
    for name, fn in histogram.KERNELS.items():
        got = fn(cells, 64)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or float(got.sum()) != 640 or float(got[63]) != 128:
            return f"histogram {name}: out-of-range ids were counted (total {float(got.sum())})"
    print("histogram kernels drop ids outside [0, n_bins): total 640 of 1024 ids, as the plain version")
    return None


def host_ms(fn, iters: int = 20):
    """Median host time in ms to issue one ``fn()`` with an empty queue
    (``kernels/rule2_times.py:host_ms``); the card's time is not in it."""
    from repro_torch.kernels import rule2_times

    return rule2_times.host_ms(fn, iters)


def device_kernels_ms(fn, iters: int = 10):
    """{device kernel: ms a call} of ``fn()`` from ``torch.profiler``
    (``kernels/rule2_times.py:device_kernels_ms``)."""
    from repro_torch.kernels import rule2_times

    return rule2_times.device_kernels_ms(fn, iters)


def registry_host(label, fn, library=None):
    """{"host_ms", "library_host_ms"}: the host's time to issue one ``fn()``
    and one ``library()`` (None where there is none), kept under ``label``
    in ``REGISTRY_HOST`` for phase 2's summary line."""
    rec = dict(host_ms=host_ms(fn), library_host_ms=host_ms(library) if library else None)
    REGISTRY_HOST[label] = rec
    return rec


def times(kreg, fn):
    """{"ms", "device_ms"} of one ``fn()`` over ``ITERS`` calls: the median
    of CUDA-event pairs as a caller waits (host issue included) and the
    card's time (``kernels.device_time_ms``)."""
    return dict(ms=kreg.cuda_time_ms(fn, ITERS), device_ms=kreg.device_time_ms(fn, ITERS))


def library_times(kreg, fn):
    """``times`` of a library yardstick.  A call that waits for the card
    itself (``torch.bincount`` reads max(ids) on the host) cannot be queued
    behind a sleep, so the card's time of it is not measured
    (``device_ms`` None, ``kernels.device_time_ms`` raised QueueDrained);
    ``kernels_ms``, torch.profiler's sum of its kernels, stands beside it."""
    rec = dict(ms=kreg.cuda_time_ms(fn, ITERS))
    try:
        rec["device_ms"] = kreg.device_time_ms(fn, ITERS)
    except kreg.QueueDrained:
        rec.update(device_ms=None, kernels_ms=sum(device_kernels_ms(fn).values()))
    return rec


def library_fields(lib_t):
    """A library yardstick's ``library_times`` under its record's keys."""
    return {f"library_{k}": v for k, v in lib_t.items()}


def card_ms(rec):
    """A record's two times, the card's first."""
    if rec["device_ms"] is None:
        return (f"not measured on the card, the call waits for the card (torch.profiler's "
                f"kernels {rec['kernels_ms']:.4f} ms; event median {rec['ms']:.4f} ms)")
    return f"{rec['device_ms']:.4f} ms a call on the card (event median {rec['ms']:.4f} ms)"


def of_bound(bms, bby, rec):
    """The bound and the share of it that ``rec``'s call reaches on the
    card, with both times beside it."""
    return f"bound {bms:.5f} ms ({bby}), {bms / rec['device_ms']:.1%} of bound; {card_ms(rec)}"


def check_registry_times(kreg, dev):
    """Phase 2, the two timers on every registry variant that launches a
    kernel and on ``spmv_ell`` at the registry's shapes
    (``kernels/rule2_times.py:registry_calls``): the event median, the
    card's time ``DEVICE_REPEATS`` times (their median and spread) and
    ``torch.profiler``'s sum of one call's kernels.  The card's time must
    be no more than the event median, and within ``DEVICE_TOL`` of the
    profiler's sum plus ``DEVICE_SLACK_MS`` for each kernel of the call.
    {ref: record}, or a failure message."""
    import statistics

    from repro_torch.kernels import rule2_times, spmv

    out = {}
    for ref, call in rule2_times.registry_calls(kreg, spmv, dev).items():
        ms = kreg.cuda_time_ms(call, ITERS)
        runs = [kreg.device_time_ms(call, ITERS) for _ in range(DEVICE_REPEATS)]
        device_ms = statistics.median(runs)
        # a profile that recorded no kernel at all measured nothing: once more
        kernels = device_kernels_ms(call) or device_kernels_ms(call)
        summed = sum(kernels.values())
        limit = DEVICE_TOL * summed + DEVICE_SLACK_MS * len(kernels)
        rec = dict(kernel=call.func.__name__, ms=ms, device_ms=device_ms, device_runs=runs,
                   profiler_ms=summed, device_kernels_ms=kernels)
        out[ref] = rec
        print(f"{ref} at the registry's shape: {device_ms:.4f} ms a call on the card "
              f"(runs {', '.join(f'{r:.5f}' for r in runs)}), torch.profiler's "
              f"{len(kernels)} kernels {summed:.4f} ms (limit {limit:.4f} ms apart), event "
              f"median {ms:.4f} ms")
        if not device_ms <= ms:
            return f"{ref}: {device_ms:.4f} ms on the card, more than its event median {ms:.4f} ms"
        if not (kernels and abs(device_ms - summed) <= limit):
            return (f"{ref}: {device_ms:.4f} ms on the card, but torch.profiler's kernels "
                    f"{kernels}")
    return out


def check_spmv_scalar_path(dev):
    """spmv_ell's scalar path on the card (``SPMV_SCALAR_CASES``): within
    1e-5 of max|y| of the plain version and of the float64 product, the
    same bits on a second call.  {case: record}, or a failure message."""
    import torch

    from repro_torch import kernels as kreg
    from repro_torch.kernels import spmv

    out = {}
    for r, k, offsets in SPMV_SCALAR_CASES:
        gen = torch.Generator(device=dev).manual_seed(5)
        vals, xg = (torch.randn(off + r * k, device=dev, generator=gen)[off:].view(r, k)
                    for off in offsets)
        label = f"{r}x{k} at offsets {offsets}"
        want = spmv.spmv_ell_plain(vals, xg)
        exact = (vals.double() * xg.double()).sum(1)
        got = spmv.spmv_ell(vals, xg)
        again = spmv.spmv_ell(vals, xg)
        torch.cuda.synchronize()
        tol = 1e-5 * float(want.abs().max())
        err = float((got - want).abs().max())
        err64 = float((got.double() - exact).abs().max())
        if not (err <= tol and err64 <= tol):
            return f"spmv_ell scalar path {label}: max|err| {err}, vs float64 {err64} > {tol}"
        if not torch.equal(got, again):
            return f"spmv_ell scalar path {label}: a second call gave other bits"
        rec = dict(max_abs_err=err, max_abs_err_vs_float64=err64,
                   **times(kreg, lambda: spmv.spmv_ell(vals, xg)))
        print(f"spmv_ell scalar path {label}: max|err| {err:.3e}, vs float64 {err64:.3e} "
              f"(tol {tol:.3e}), a second call gives the same bits, {card_ms(rec)}")
        out[label] = rec
    return out


def check_cases(kreg, dev):
    """Phase 2 for the case-study kernels: {kernel name: record}, or a
    failure message."""
    import numpy as np
    import torch

    rows = {}
    registry_shapes = {
        "gramschm": kreg.GRAMSCHM_SHAPE,
        "ttm": kreg.TTM_SHAPE,
        "histogram": kreg.HIST_SHAPE,
        "spmv": (kreg.SPMV_SHAPE[0], SPMV_WIDTH),
    }
    for family, large in TIMING_SHAPES.items():
        for which, shape in (("registry", registry_shapes[family]), ("large", large)):
            case = case_inputs(family, shape, dev)
            want = case["plain"]()
            library = case["library"]()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            tol = case["tol"](scale)
            # the histogram's exact counts at both sizes (np.bincount is cheap)
            exact = case["exact"]() if which == "registry" or family == "histogram" else None
            err_lib = float((library.float() - want).abs().max())
            if not err_lib <= tol:
                return f"{family} {shape}: library call off by {err_lib} > {tol}"
            plain_ms = kreg.cuda_time_ms(case["plain"], PLAIN_ITERS)
            lib_t = library_times(kreg, case["library"])
            bms, bby = bound_of(case["bytes"], case["flops"])
            for name, (fn, args, kwargs) in case["kernels"].items():
                before = launch_count(name)
                got = fn(*args, **kwargs)
                torch.cuda.synchronize()
                if launch_count(name) != before + 1:
                    return f"{name} {shape}: the call did not launch the kernel"
                if got.shape != want.shape or got.dtype != torch.float32:
                    return f"{name} {shape}: output {tuple(got.shape)} {got.dtype}"
                if not bool(torch.isfinite(got).all()):
                    return f"{name} {shape}: non-finite output"
                err = float((got - want).abs().max())
                if name in REPEAT_CHECKED:
                    again = fn(*args, **kwargs)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        return f"{name} {shape}: a second call gave other bits"
                    print(f"{name} {which} {shape}: a second call gives the same bits")
                rec = dict(
                    shape=list(shape), max_abs_err=err,
                    **times(kreg, lambda: fn(*args, **kwargs)),
                    plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                    **library_fields(lib_t),
                )
                line = (
                    f"{name} {which} {shape}: max|err| {err:.3e} (tol {tol:.3e})"
                )
                if exact is not None:
                    rec["max_abs_err_vs_float64"] = float(
                        np.abs(got.double().cpu().numpy() - exact).max()
                    )
                    line += f", vs float64 {rec['max_abs_err_vs_float64']:.3e}"
                print(
                    f"{line}, plain {plain_ms:.4f} ms, library {card_ms(lib_t)}, "
                    f"{of_bound(bms, bby, rec)}"
                )
                if not err <= tol:
                    return f"{name} {shape}: max|err| {err} > {tol}"
                if exact is not None and not rec["max_abs_err_vs_float64"] <= tol:
                    return f"{name} {shape}: vs float64 {rec['max_abs_err_vs_float64']} > {tol}"
                if which == "registry":
                    rec.update(registry_host(name, lambda: fn(*args, **kwargs), case["library"]))
                if (name in REPEAT_CHECKED and which == "large") or name in SPLIT_TIMED:
                    rec["device_kernels_ms"] = device_kernels_ms(lambda: fn(*args, **kwargs))
                    if which != "registry":
                        rec["host_ms"] = host_ms(lambda: fn(*args, **kwargs))
                        rec["library_host_ms"] = host_ms(case["library"])
                    line = (f"{name} {which} {shape}: device time by kernel (torch.profiler) "
                            f"{rec['device_kernels_ms']}; host time to issue a call "
                            f"{rec['host_ms']:.4f} ms, the library's {rec['library_host_ms']:.4f} ms")
                    if name in SPLIT_TIMED:
                        rec["library_device_kernels_ms"] = device_kernels_ms(case["library"])
                        line += f"; the library's device time {rec['library_device_kernels_ms']}"
                    print(line)
                if which == "registry":
                    rows[name] = dict(source=case["source"], **rec)
                else:
                    rows[name]["large"] = rec
            del case, want, library
            torch.cuda.empty_cache()
    return rows


def ssd_float64(x, a, b, c):
    """The SSD chunk term and end state in float64 on the host (numpy)."""
    import numpy as np

    x, a, b, c = (np.asarray(t, np.float64) for t in (x, a, b, c))
    cum = np.cumsum(a, axis=-1)
    l = a.shape[-1]
    keep = np.tril(np.ones((l, l), bool))
    seg = np.where(keep, cum[..., :, None] - cum[..., None, :], 0.0)
    dec = np.where(keep, np.exp(seg), 0.0)
    y = np.einsum("gcln,gcsn->gcls", c, b) * dec @ x
    w = np.exp(cum[..., -1:] - cum)
    s = np.einsum("gclp,gcl,gcln->gcpn", x, w, b)
    return y, s


def ssd_float64_card(x, a, b, c):
    """The SSD chunk term and end state in float64 on the card (torch), for
    chunks too large for the host oracle: (y, s) as numpy arrays."""
    import torch

    x, a, b, c = (t.double() for t in (x, a, b, c))
    cum = torch.cumsum(a, dim=-1)
    l = a.shape[-1]
    keep = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    seg = (cum[..., :, None] - cum[..., None, :]).masked_fill(~keep, 0.0)
    dec = torch.exp(seg).masked_fill(~keep, 0.0)
    y = torch.matmul(torch.matmul(c, b.transpose(-1, -2)) * dec, x)
    w = torch.exp(cum[..., -1:] - cum)
    s = torch.matmul((x * w[..., None]).transpose(-1, -2), b)
    return y.cpu().numpy(), s.cpu().numpy()


def flash_float64(q, k, v):
    """Causal attention, mask aligned top-left, in float64 on the host."""
    import numpy as np

    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    s = q @ k.transpose(0, 2, 1) / np.sqrt(q.shape[-1])
    keep = np.tril(np.ones(s.shape[-2:], bool))
    s = np.where(keep, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def model_case(family: str, shape, dtype, dev, exact: bool):
    """One model-path kernel's case on inputs from a fixed numpy seed: the
    wrapper and its arguments, the plain and library calls, the float64
    host product (``exact``), the tolerance, and the bytes and operations
    of the work."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash, gmm, ssd
    from repro_torch.models.registry import _moe_ids

    rng = np.random.default_rng(3)
    dname = str(dtype).replace("torch.", "")
    size = torch.tensor([], dtype=dtype).element_size()

    def card(a):
        return torch.from_numpy(a).to(dev, dtype)

    if family == "flash":
        bh, sq, skv, d = shape
        q_np, k_np, v_np = (
            rng.standard_normal((bh, s, d), dtype=np.float32) for s in (sq, skv, skv)
        )
        q, k, v = card(q_np), card(k_np), card(v_np)
        return dict(
            name="flash_attention", dtype=dname,
            kernel=(flash.flash_attention, (q, k, v), {"causal": True, "bkv": 64}),
            plain=lambda: flash.flash_plain(q, k, v, True),
            # as (1, BH, S, D): SDPA's fused backends take 4-D inputs only
            library=lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True
            ),
            library_label="F.scaled_dot_product_attention(is_causal=True), 4-D",
            # the oracle sees the values the kernel sees (bf16-rounded in bf16)
            exact=(lambda: (flash_float64(*(t.float().cpu().numpy() for t in (q, k, v))),))
            if exact else None,
            tol=lambda want: flash.tolerance(want, q),
            bytes=size * bh * d * (2 * sq + 2 * skv),
            ops=4 * bh * d * sq * (sq + 1) // 2,
            source="src/repro_torch/kernels/csrc/flash.cu",
        )
    if family == "gmm":
        m, k, n, e, bm = shape
        ids_np = _moe_ids(m // bm, e)
        x_np = rng.standard_normal((m, k), dtype=np.float32)
        w = torch.randn((e, k, n), generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev, dtype=torch.float32).to(dtype)
        x = card(x_np)
        ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
        dense = w[0].reshape(k, n)
        # torch._grouped_mm takes the groups as cumulative end rows: the
        # padded groups of plan_groups, each expert's tiles consecutive
        assert bool(np.all(np.diff(ids_np) >= 0))
        offs = torch.from_numpy(
            (np.cumsum(np.bincount(ids_np, minlength=e)) * bm).astype(np.int32)
        ).to(dev)

        def exact_fn():
            w64 = w.double().cpu().numpy()
            x64 = x.double().cpu().numpy()
            out = np.empty((m, n))
            for i, ex in enumerate(ids_np):
                rows = slice(i * bm, (i + 1) * bm)
                out[rows] = x64[rows] @ w64[ex]
            return (out,)

        return dict(
            name="gmm", dtype=dname,
            kernel=(gmm.gmm, (x, w, ids), {"bm": bm}),
            plain=lambda: gmm.gmm_plain(x, w, ids, bm),
            library=lambda: torch._grouped_mm(x, w, offs=offs),
            library_label="torch._grouped_mm(x, w, offs) on the padded groups",
            dense=lambda: torch.matmul(x, dense),
            exact=exact_fn if exact else None,
            tol=lambda want: gmm.tolerance(want, x),
            bytes=size * (m * k + len(set(ids_np.tolist())) * k * n + m * n),
            ops=2 * m * k * n,
            source="src/repro_torch/kernels/csrc/gmm.cu",
        )
    bh, c, l, p_, n = shape
    x_np, b_np, c_np = (
        rng.standard_normal((bh, c, l, s), dtype=np.float32) for s in (p_, n, n)
    )
    a_np = -np.abs(rng.standard_normal((bh, c, l), dtype=np.float32)) * 0.4
    x, a, b, cm = card(x_np), card(a_np), card(b_np), card(c_np)
    # the host oracle for the registry's chunks, float64 on the card for
    # larger ones (Mamba2-2.7b's y alone is 168 MB in float64)
    oracle = (
        (lambda: ssd_float64(*(t.float().cpu().numpy() for t in (x, a, b, cm))))
        if bh * c * l * l * n <= 2**26 else (lambda: ssd_float64_card(x, a, b, cm))
    )
    return dict(
        name="ssd_chunk", dtype=dname,
        kernel=(ssd.ssd_chunk, (x, a, b, cm), {}),
        plain=lambda: ssd.ssd_plain(x, a, b, cm),
        library=None,
        library_label=None,
        exact=oracle if exact else None,
        tol=lambda want: ssd.tolerance(want, x),
        bytes=bh * c * (size * (l * p_ + l + 2 * l * n) + 4 * (l * p_ + p_ * n)),
        ops=bh * c * (l * (l + 1) // 2 * 2 * (n + p_) + 2 * l * p_ * n),
        source="src/repro_torch/kernels/csrc/ssd.cu",
    )


def check_model_kernels(kreg, dev):
    """Phase 2 for the model path's kernels: {kernel name: record}, or a
    failure message.  The top level of a record is the registry's shape in
    float32; ``registry_bf16``, ``large``, ``large_bf16``, ``mamba2`` and
    ``mamba2_bf16`` the other runs."""
    import numpy as np
    import torch

    registry_shapes = {
        "flash": kreg.FLASH_SHAPE,
        "gmm": (*kreg.GMM_SHAPE, kreg.GMM_BM),
        "ssd": kreg.SSD_SHAPE,
    }
    rows = {}
    for family, large in MODEL_TIMING_SHAPES.items():
        runs = [("registry", registry_shapes[family], torch.float32, True),
                ("large", large, torch.float32, family == "ssd")]
        if family == "ssd":
            runs += [("large_bf16", large, torch.bfloat16, True),
                     ("mamba2", MAMBA2_SSD_SHAPE, torch.float32, True),
                     ("mamba2_bf16", MAMBA2_SSD_SHAPE, torch.bfloat16, True),
                     ("model_path", MODEL_PATH_SSD_SHAPE, torch.float32, True)]
        else:
            runs += [("registry_bf16", registry_shapes[family], torch.bfloat16, True),
                     ("large_bf16", large, torch.bfloat16, False)]
        for which, shape, dtype, exact in runs:
            case = model_case(family, shape, dtype, dev, exact=exact)
            name = case["name"]
            fn, args, kwargs = case["kernel"]
            want = case["plain"]()
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            plain_ms = kreg.cuda_time_ms(case["plain"], PLAIN_ITERS)
            bms, bby = bound_of(case["bytes"], case["ops"], case["dtype"])
            before = fn.launches
            got = fn(*args, **kwargs)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            if fn.launches != before + 1:
                return f"{name} {shape}: the call did not launch the kernel"
            # each output is held per element to the kernel module's own
            # tolerance; ``over`` is the largest |err| / tolerance (pass <= 1)
            errs, over, tols = [], [], []
            for g, w in zip(got, want):
                if g.shape != w.shape or not bool(torch.isfinite(g.float()).all()):
                    return f"{name} {shape}: output {tuple(g.shape)} is not finite of {tuple(w.shape)}"
                diff = (g.float() - w.float()).abs()
                tol = torch.as_tensor(case["tol"](w), device=dev)
                errs.append(float(diff.max()))
                over.append(float((diff / tol).max()))
                tols.append(tol)
            # the library yardstick: timed, and held to the same tolerance
            # (recorded, not required); an op that refuses a type or shape
            # is a yardstick missing, not a failure of the port
            library_ms = lib_over = refusal = None
            lib_t = dict(ms=None, device_ms=None)
            if case["library"]:
                try:
                    lib_out = case["library"]()
                    torch.cuda.synchronize()
                except (RuntimeError, NotImplementedError, ValueError, TypeError) as exc:
                    refusal = f"{type(exc).__name__}: {str(exc).splitlines()[0][:160]}"
                    print(f"{name} {which} {shape} {case['dtype']}: {case['library_label']} "
                          f"refused: {refusal}")
                else:
                    lib_over = float(((lib_out.float() - want[0].float()).abs() / tols[0]).max())
                    lib_t = library_times(kreg, case["library"])
                    library_ms = lib_t["ms"]
                    del lib_out
            rec = dict(
                shape=list(shape), dtype=case["dtype"], max_abs_err=max(errs),
                max_err_over_tol=max(over),
                **times(kreg, lambda: fn(*args, **kwargs)),
                plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
                **library_fields(lib_t), library=case["library_label"],
                library_err_over_tol=lib_over, library_refused=refusal,
            )
            if "dense" in case:
                rec["dense_matmul_ms"] = kreg.cuda_time_ms(case["dense"], ITERS)
            if which.startswith("registry"):
                rec.update(registry_host(f"{name} {case['dtype']}", lambda: fn(*args, **kwargs),
                                         case["library"] if library_ms is not None else None))
            line = f"{name} {which} {shape} {case['dtype']}: max|err| {errs}, err/tol {over}"
            if name in REPEAT_CHECKED or (name in REPEAT_CHECKED_F32 and dtype == torch.float32):
                again = fn(*args, **kwargs)
                again = again if isinstance(again, tuple) else (again,)
                torch.cuda.synchronize()
                if not all(torch.equal(g, a_) for g, a_ in zip(got, again)):
                    return f"{name} {shape} {case['dtype']}: a second call gave other bits"
                del again
                rec["device_kernels_ms"] = device_kernels_ms(lambda: fn(*args, **kwargs))
                if "host_ms" not in rec:
                    rec["host_ms"] = host_ms(lambda: fn(*args, **kwargs))
                line += (f", a second call gives the same bits; device time by kernel "
                         f"(torch.profiler) {rec['device_kernels_ms']}; host time to issue "
                         f"a call {rec['host_ms']:.4f} ms")
            if case["exact"] is not None:
                exact_out = case["exact"]()
                diffs64 = [np.abs(g.double().cpu().numpy() - e) for g, e in zip(got, exact_out)]
                over64 = [
                    float((d / tol.double().cpu().numpy()).max()) for d, tol in zip(diffs64, tols)
                ]
                rec["max_abs_err_vs_float64"] = max(float(d.max()) for d in diffs64)
                rec["max_err_over_tol_vs_float64"] = max(over64)
                line += f", vs float64 {rec['max_abs_err_vs_float64']:.3e} (err/tol {over64})"
                del exact_out, diffs64
                if not all(o <= 1 for o in over64):
                    return f"{name} {shape} {case['dtype']}: vs float64 err/tol {over64} > 1"
            if library_ms is not None:
                lib = f"{card_ms(lib_t)} ({case['library_label']}, err/tol {lib_over:.3f})"
            else:
                lib = f"none (refused: {refusal})" if refusal else "none"
            if "dense_matmul_ms" in rec:
                lib += f", dense torch.matmul of the same FLOPs {rec['dense_matmul_ms']:.4f} ms"
            print(f"{line}, plain {plain_ms:.4f} ms, library {lib}, {of_bound(bms, bby, rec)}")
            if not all(o <= 1 for o in over):
                return f"{name} {shape} {case['dtype']}: err/tol {over} > 1"
            if which == "registry":
                rows[name] = dict(source=case["source"], **rec)
            else:
                rows[name][which] = rec
            del case, args, got, want, tols
            torch.cuda.empty_cache()
    return rows


def check_tensor_cores(_build):
    """Phase 1: the ``HMMA`` count of each kernel function of the flash,
    gmm, gemm, the two decode and the ssd libraries, {library: {function:
    count}}, or a failure message if a bfloat16 kernel (``*_tc_kernel``)
    holds none, if gemm's naive rungs (v00, v01) hold any, or if a float32
    kernel of flash, gmm or ssd (``flash_kernel``, ``gmm_kernel``,
    ``ssd_chunk_kernel``) is missing or holds any."""
    from concurrent.futures import ThreadPoolExecutor

    f32_of = {"flash": "flash_kernel", "gmm": "gmm_kernel", "ssd": "ssd_chunk_kernel"}
    tc_of = {"flash": "flash_tc_kernel", "gmm": "gmm_tc_kernel", "gemm": "gemm_v02_tc_kernel",
             "ragged_decode": "ragged_split_tc_kernel",
             "paged_decode": "paged_split_tc_kernel", "ssd": "ssd_tc_kernel"}
    # one cuobjdump a library, all at once
    with ThreadPoolExecutor(len(tc_of)) as pool:
        read = dict(zip(tc_of, pool.map(lambda name: _build.sass_counts(name, "HMMA"), tc_of)))
    counts = {}
    for name, tc in tc_of.items():
        per_fn = read[name]
        tc_fns = {fn: c for fn, c in per_fn.items() if tc in fn}
        print(f"{name}: HMMA per kernel function (cuobjdump -sass): "
              + ", ".join(f"{fn.split('_cu_')[-1][:64]}: {c}" for fn, c in per_fn.items()))
        if not tc_fns or min(tc_fns.values()) < 1:
            return f"{name}: a bfloat16 kernel holds no HMMA instruction ({per_fn})"
        naive = {fn: c for fn, c in per_fn.items() if "gemm_v00" in fn or "gemm_v01" in fn}
        if any(naive.values()):
            return f"gemm: a naive rung holds HMMA instructions ({naive})"
        f32 = {fn: c for fn, c in per_fn.items() if name in f32_of and f32_of[name] in fn}
        if name in f32_of and (not f32 or any(f32.values())):
            return f"{name}: the float32 kernel functions are missing or hold HMMA ({f32})"
        counts[name] = per_fn
    return counts


def other_tile(kreg, a, b, got):
    """bfloat16 gemm v02 on the tile height its rule did not pick (the
    kernel takes 64 or 128 rows; kernels/gemm.py:block_rows picks one from
    the grid size): {block_rows, ms, device_ms}, timed as the wrapper is,
    or a failure message if its bits differ from ``got`` (each element sums
    its K products in the same order on either height); None in float32,
    which has one height.  Not counted as a launch: it only keeps the
    rule's choice measured."""
    import torch

    from repro_torch.kernels import gemm

    if a.dtype != torch.bfloat16:
        return None
    bm = 192 - gemm.block_rows(a.shape[0], b.shape[1], a.dtype)

    def call():
        return gemm._launch("repro_gemm_v02", a, b, bm)

    out = call()
    torch.cuda.synchronize()
    if not torch.equal(out, got):
        return f"gemm_v02 {tuple(a.shape)} on {bm}-row tiles: other bits than the rule's tiles"
    return dict(block_rows=bm, **times(kreg, call))


def check_gemm_large(kreg, dev):
    """Phase 2 for gemm v02 at its timing shape (``GEMM_TIMING_SHAPE``), in
    float32 and bfloat16 on inputs from a seeded generator on the card:
    {dtype name: record}, or a failure message.  Held against the plain
    version (float32: 1e-6 K, the model path's bound for sums of K N(0, 1)
    products in another order, which is 1e-3 at the registry's K = 1024;
    bfloat16: 1e-2 of max|C|) and against the float64 product on the card
    (1e-2 of max|C|); timed beside the plain version and ``torch.matmul``;
    the device time by kernel and the host's time to issue one call."""
    import torch

    from repro_torch.kernels import gemm

    m, n, k = GEMM_TIMING_SHAPE
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        gen = torch.Generator(device=dev).manual_seed(3)
        a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
        want = gemm.gemm_plain(a, b)
        exact = a.double() @ b.double()
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        tol = 1e-6 * k if dtype == torch.float32 else 1e-2 * scale
        tol_exact = 1e-2 * scale
        before = gemm.gemm_v02.launches
        got = gemm.gemm_v02(a, b)
        again = gemm.gemm_v02(a, b)
        torch.cuda.synchronize()
        if gemm.gemm_v02.launches != before + 2:
            return f"gemm_v02 {dname} {m}x{n}x{k}: the call did not launch the kernel"
        if tuple(got.shape) != (m, n) or got.dtype != dtype or not bool(torch.isfinite(got).all()):
            return f"gemm_v02 {dname} {m}x{n}x{k}: output {tuple(got.shape)} {got.dtype} not finite"
        if not torch.equal(got, again):
            return f"gemm_v02 {dname} {m}x{n}x{k}: a second call gave other bits"
        err = float((got.float() - want.float()).abs().max())
        err_exact = float((got.double() - exact).abs().max())
        lib_err = float((torch.matmul(a, b).float() - want.float()).abs().max())
        del exact
        bms, bby = bound(m, n, k, dname, a.element_size())
        lib_t = library_times(kreg, lambda: torch.matmul(a, b))
        rec = dict(
            shape=[m, n, k], max_abs_err=err, max_abs_err_vs_float64=err_exact,
            library_err=lib_err,
            **times(kreg, lambda: gemm.gemm_v02(a, b)),
            plain_ms=kreg.cuda_time_ms(lambda: gemm.gemm_plain(a, b), PLAIN_ITERS),
            bound_ms=bms, bound_by=bby,
            **library_fields(lib_t),
            block_rows=gemm.block_rows(m, n, dtype),
            device_kernels_ms=device_kernels_ms(lambda: gemm.gemm_v02(a, b)),
            host_ms=host_ms(lambda: gemm.gemm_v02(a, b)),
            library_host_ms=host_ms(lambda: torch.matmul(a, b)),
            other_tile=other_tile(kreg, a, b, got),
        )
        if isinstance(rec["other_tile"], str):
            return rec["other_tile"]
        print(
            f"gemm_v02 {dname} {m}x{n}x{k} (tiles of {rec['block_rows']} x 128): max|err| "
            f"{err:.3e} (tol {tol:.3e}), vs float64 {err_exact:.3e} (tol {tol_exact:.3e}), "
            f"torch.matmul vs plain {lib_err:.3e}, a second call gives the same bits, plain "
            f"{rec['plain_ms']:.4f} ms, torch.matmul {card_ms(lib_t)}, "
            f"{of_bound(bms, bby, rec)}; device "
            f"time by kernel (torch.profiler) {rec['device_kernels_ms']}; host "
            f"time to issue a call {rec['host_ms']:.4f} ms, torch.matmul's "
            f"{rec['library_host_ms']:.4f} ms; the other tile height: {rec['other_tile']}"
        )
        if not (err <= tol and err_exact <= tol_exact):
            return f"gemm_v02 {dname} {m}x{n}x{k}: max|err| {err} (tol {tol}), vs float64 {err_exact}"
        out[dname] = rec
        del a, b, want, got, again
        torch.cuda.empty_cache()
    return out


def drive_tensor_core_step(dev):
    """Phase 3 for the bfloat16 routes: attention, the expert FFN and the
    SSD chunk at Jamba-v0.1-52B's widths in bfloat16 through ``ops``, with
    the counts set to 0 just before.  {kernel name: launches}, or a failure
    message."""
    import torch

    from repro_torch import kernels as kreg
    from repro_torch.kernels import ops

    entry = {"flash": ops.flash_attention, "gmm": ops.grouped_matmul, "ssd": ops.ssd_chunk}
    cases = [model_case(family, MODEL_TIMING_SHAPES[family], torch.bfloat16, dev, exact=False)
             for family in entry]
    kreg.reset_launch_counts()
    outs = [entry[family](*c["kernel"][1], **c["kernel"][2]) for family, c in zip(entry, cases)]
    torch.cuda.synchronize()
    counts = {c["name"]: c["kernel"][0].launches for c in cases}
    print(f"main-path launches (Jamba-v0.1-52B bfloat16 step): {counts}")
    for c, out in zip(cases, outs):
        wants = c["plain"]()
        outs_ = out if isinstance(out, tuple) else (out,)
        wants = wants if isinstance(wants, tuple) else (wants,)
        over = max(float(((o.float() - w.float()).abs() / c["tol"](w)).max())
                   for o, w in zip(outs_, wants))
        finite = all(bool(torch.isfinite(o.float()).all()) for o in outs_)
        print(f"{c['name']} through ops at {[tuple(o.shape) for o in outs_]} bfloat16: finite "
              f"{finite}, err/tol {over:.3f}")
        if counts[c["name"]] < 1 or not finite or over > 1:
            return f"{c['name']}: the bfloat16 step did not launch it or is off (err/tol {over})"
    del cases, outs
    torch.cuda.empty_cache()
    return counts


def serving_case(kind: str, shape, dtype, dev, dense: bool):
    """One serving kernel's case on inputs from a seeded generator on the
    card and the registry's seeded context: the wrapper and its arguments,
    the plain and library calls, the live K and V rows of each sequence
    (for the float64 host oracle), and the bytes and operations of the
    work (the live rows only: the function is the same in dense mode)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attn, ragged_flash

    gen = torch.Generator(device=dev).manual_seed(4)
    size = torch.tensor([], dtype=dtype).element_size()

    def randn(*shp):
        return torch.randn(shp, generator=gen, device=dev, dtype=torch.float32).to(dtype)

    def card(a):
        return torch.from_numpy(a).to(dev)

    if kind == "ragged":
        b, h, s, d = shape
        ctx = ragged_flash.ragged_context(b, s)
        q, k, v = randn(b, h, d), randn(b, s, d), randn(b, s, d)
        starts, ends = card(ctx["starts"]), card(ctx["ends"])
        args = (q, k, v, starts, ends)
        kwargs = {"bkv": ragged_flash.DEF_BKV, "dense": dense}
        lo = np.clip(ctx["starts"], 0, s)
        hi = np.clip(ctx["ends"], 0, s)
        pos = torch.arange(s, device=dev)
        mask = ((pos >= starts[:, None].long()) & (pos < ends[:, None].long()))[:, None, None, :]

        def live_rows(bi):
            return k[bi, lo[bi]:hi[bi]], v[bi, lo[bi]:hi[bi]]

        def library():
            return F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], attn_mask=mask)[:, 0]

        live = hi - lo
        length = ragged_flash.split_len(s, kwargs["bkv"])
        live_splits = int(sum((z - 1) // length - a // length + 1 for a, z in zip(lo, hi) if a < z))
        return dict(
            name="ragged_decode_attention", fn=ragged_flash.ragged_decode_attention,
            config=dict(split_len=length, splits=ragged_flash.n_splits(s, kwargs["bkv"]),
                        live_splits=live_splits),
            args=args, kwargs=kwargs,
            plain=lambda: ragged_flash.ragged_decode_plain(*args, **kwargs),
            library=library,
            library_label="F.scaled_dot_product_attention, (B, 1, H, D) x (B, 1, S, D), boolean mask",
            live_rows=live_rows, tol=lambda want: ragged_flash.tolerance(want, q),
            bytes=size * (2 * b * h * d + 2 * int(live.sum()) * d) + 4 * 2 * b,
            ops=4 * h * d * int(live.sum()),
            source="src/repro_torch/kernels/csrc/ragged_decode.cu",
        )
    b, h, d, page, pages, slots = shape
    ctx = paged_attn.paged_context(b, pages, slots, page)
    q = randn(b, h, d)
    lens = card(ctx["context_lens"])
    if dense:  # the contiguous per-row cache under the identity table
        k_pages, tables = paged_attn.contiguous_pages(randn(b, slots * page, d), page)
        v_pages, _ = paged_attn.contiguous_pages(randn(b, slots * page, d), page)
    else:
        k_pages, v_pages = randn(1, pages, page, d), randn(1, pages, page, d)
        tables = card(ctx["block_tables"])
    args = (q, k_pages, v_pages, tables, lens)
    ctx_np = np.clip(ctx["context_lens"], 0, slots * page)
    pos = torch.arange(slots * page, device=dev)
    mask = (pos < lens[:, None].long())[:, None, None, :]

    def live_rows(bi):
        rows = tables[bi].long()
        return (k_pages[0][rows].reshape(-1, d)[:ctx_np[bi]],
                v_pages[0][rows].reshape(-1, d)[:ctx_np[bi]])

    def library():
        kg = k_pages[0][tables.long()].reshape(b, 1, slots * page, d)
        vg = v_pages[0][tables.long()].reshape(b, 1, slots * page, d)
        return F.scaled_dot_product_attention(q[:, None], kg, vg, attn_mask=mask)[:, 0]

    walked = int(sum(-(-int(c) // page) for c in ctx_np))
    length = ragged_flash.split_len(slots * page, page)
    live_splits = int(sum(-(-int(c) // length) for c in ctx_np))
    return dict(
        name="paged_decode_attention", fn=paged_attn.paged_decode_attention,
        config=dict(split_len=length, splits=ragged_flash.n_splits(slots * page, page),
                    live_splits=live_splits),
        args=args, kwargs={"dense": dense},
        plain=lambda: paged_attn.paged_decode_plain(*args, dense=dense),
        library=library,
        library_label="page gather + F.scaled_dot_product_attention (two calls)",
        live_rows=live_rows, tol=lambda want: paged_attn.tolerance(want, q),
        bytes=size * (2 * b * h * d + 2 * int(ctx_np.sum()) * d) + 4 * (b + walked),
        ops=4 * h * d * int(ctx_np.sum()),
        source="src/repro_torch/kernels/csrc/paged_decode.cu",
    )


def decode_float64(q, rows):
    """MQA decode attention of q (H, D) over live rows (K, V) on the host in
    float64; no live row gives 0."""
    import numpy as np

    k, v = (np.asarray(t.double().cpu().numpy()) for t in rows)
    q = np.asarray(q.double().cpu().numpy())
    if k.shape[0] == 0:
        return np.zeros_like(q)
    s = q @ k.T / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def check_serving_kernels(kreg, dev):
    """Phase 2 for the serving kernels: {kernel name: record}, or a failure
    message.  The top level of a record is the registry's shape in float32,
    gated; ``dense`` the same in dense mode; ``large``, ``large_dense``,
    ``large_bf16`` and ``large_bf16_dense`` Granite-20B's decode widths."""
    import numpy as np
    import torch

    registry_shapes = {"ragged": kreg.RAGGED_SHAPE, "paged": kreg.PAGED_SHAPE}
    rows = {}
    for kind, large in SERVING_TIMING_SHAPES.items():
        for which, shape, dtype in (("registry", registry_shapes[kind], torch.float32),
                                    ("large", large, torch.float32),
                                    ("large_bf16", large, torch.bfloat16)):
            for dense in (False, True):
                case = serving_case(kind, shape, dtype, dev, dense)
                name, fn = case["name"], case["fn"]
                dname = str(dtype).replace("torch.", "")
                want = case["plain"]()
                library = case["library"]()
                torch.cuda.synchronize()
                tol = case["tol"](want)
                before = fn.launches
                got = fn(*case["args"], **case["kwargs"])
                torch.cuda.synchronize()
                if fn.launches != before + 1:
                    return f"{name} {shape}: the call did not launch the kernel"
                if got.shape != want.shape or got.dtype != dtype or not bool(torch.isfinite(got.float()).all()):
                    return f"{name} {shape}: output {tuple(got.shape)} {got.dtype} is not finite of {tuple(want.shape)}"
                if name in REPEAT_CHECKED:
                    again = fn(*case["args"], **case["kwargs"])
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        return f"{name} {which} {shape} {dname}: a second call gave other bits"
                diff = (got.float() - want.float()).abs()
                over = float((diff / tol).max())
                q = case["args"][0]
                exact = np.stack([decode_float64(q[bi], case["live_rows"](bi)) for bi in range(q.shape[0])])
                tol_np = tol.double().cpu().numpy()
                over64 = float((np.abs(got.double().cpu().numpy() - exact) / tol_np).max())
                lib_over = float(((library.float() - want.float()).abs() / tol).max())
                bms, bby = bound_of(case["bytes"], case["ops"], dname)
                lib_t = library_times(kreg, case["library"])
                rec = dict(
                    shape=list(shape), dtype=dname, dense=dense, max_abs_err=float(diff.max()),
                    max_err_over_tol=over, max_err_over_tol_vs_float64=over64,
                    **times(kreg, lambda: fn(*case["args"], **case["kwargs"])),
                    plain_ms=kreg.cuda_time_ms(case["plain"], PLAIN_ITERS), bound_ms=bms,
                    bound_by=bby,
                    **library_fields(lib_t),
                    library=case["library_label"], library_err_over_tol=lib_over,
                )
                if "config" in case:
                    rec["config"] = case["config"]
                mode = "dense" if dense else "gated"
                split = "".join(f", {key} {val}" for key, val in case.get("config", {}).items())
                print(
                    f"{name} {which} {mode} {shape} {dname}{split}: max|err| {rec['max_abs_err']:.3e}, "
                    f"err/tol {over:.3f}, vs float64 err/tol {over64:.3f}, plain "
                    f"{rec['plain_ms']:.4f} ms, library {card_ms(lib_t)} ({case['library_label']}, "
                    f"err/tol {lib_over:.3f}), {of_bound(bms, bby, rec)}"
                )
                if not (over <= 1 and over64 <= 1):
                    return f"{name} {which} {mode} {dname}: err/tol {over}, vs float64 {over64} > 1"
                key = which + ("_dense" if dense else "")
                if which == "registry":
                    rec.update(registry_host(f"{name} {mode}", lambda: fn(*case["args"], **case["kwargs"]),
                                             case["library"]))
                if name in REPEAT_CHECKED and which != "registry":
                    rec["device_kernels_ms"] = device_kernels_ms(
                        lambda: fn(*case["args"], **case["kwargs"]))
                    rec["host_ms"] = host_ms(lambda: fn(*case["args"], **case["kwargs"]))
                    rec["library_host_ms"] = host_ms(case["library"])
                    print(f"{name} {which} {mode} {dname}: device time by kernel "
                          f"(torch.profiler) {rec['device_kernels_ms']}; host time to issue "
                          f"a call {rec['host_ms']:.4f} ms, the library's "
                          f"{rec['library_host_ms']:.4f} ms")
                if key == "registry":
                    rows[name] = dict(source=case["source"], **rec)
                else:
                    rows[name]["dense" if key == "registry_dense" else key] = rec
                del case, want, library, got, diff, tol
                torch.cuda.empty_cache()
    return rows


def drive_serving_step(dev):
    """Phase 3 for the serving kernels at full width: Granite-20B's decode
    step in bfloat16 through the public entry points, with the counts set
    to 0 just before.  {kernel name: launches}, or a failure message."""
    import torch

    from repro_torch import kernels as kreg
    from repro_torch.kernels import ops

    cases = [serving_case(kind, shape, torch.bfloat16, dev, dense=False)
             for kind, shape in SERVING_TIMING_SHAPES.items()]
    entry = {"ragged_decode_attention": ops.ragged_decode_attention,
             "paged_decode_attention": ops.paged_decode_attention}
    kreg.reset_launch_counts()
    outs = [entry[c["name"]](*c["args"]) for c in cases]
    torch.cuda.synchronize()
    counts = {c["name"]: c["fn"].launches for c in cases}
    print(f"main-path launches (Granite-20B decode step): {counts}")
    for c, out in zip(cases, outs):
        want = c["plain"]()
        over = float(((out.float() - want.float()).abs() / c["tol"](want)).max())
        print(f"{c['name']} through ops at {tuple(out.shape)}: finite "
              f"{bool(torch.isfinite(out.float()).all())}, err/tol {over:.3f}")
        if counts[c["name"]] < 1 or not bool(torch.isfinite(out.float()).all()) or over > 1:
            return f"{c['name']}: the decode step did not launch it or is off (err/tol {over})"
    return counts


def jamba_argv(out: Path):
    """The full-width model run: Jamba-v0.1-52B's widths and layout on
    moe-tiny at one hybrid period (8 of 32 layers)."""
    from repro_torch.configs.archs import jamba_52b

    cfg = jamba_52b()
    overrides = [f"{key}={getattr(cfg, key)}" for key in JAMBA_FIELDS]
    argv = ["model", "moe-tiny", "--out", str(out), "--sampler", "window:8:2"]
    for item in (*overrides, "n_layers=8", "name=jamba-v0.1-52b-cut8"):
        argv += ["-c", item]
    return argv


def drive_model_path(cli, kreg, load_iteration, smi):
    """Phase 3 for the model path: {kernel name: launches of the full-width
    run}, or a failure message."""
    import torch

    from repro_torch.kernels import flash, gemm, gmm, ssd

    counted = {"flash_attention": flash.flash_attention, "gmm": gmm.gmm,
               "ssd_chunk": ssd.ssd_chunk, "gemm_v01": gemm.gemm_v01}
    root = ROOT / "build" / "chip_smoke_session" / "model"
    shutil.rmtree(root, ignore_errors=True)

    outputs = {}

    def run_counted(argv, must):
        kreg.reset_launch_counts()
        rc, out = run_cli(cli, argv)
        outputs["last"] = out
        counts = {name: fn.launches for name, fn in counted.items()}
        print(f"launches: {counts}")
        if rc != 0:
            return None, f"{' '.join(argv[:2])} exited {rc}"
        missing = [name for name in must if counts[name] < 1]
        if missing:
            return None, f"{' '.join(argv[:2])} did not launch {missing}"
        return counts, None

    for name, must in (("transformer-tiny", ("flash_attention", "gemm_v01")),
                       ("moe-tiny", ("flash_attention", "gmm", "gemm_v01")),
                       ("mamba-tiny", ("ssd_chunk", "gemm_v01"))):
        _, msg = run_counted(["model", name, "--out", str(root / name)], must)
        if msg:
            return msg

    # the full-width run: Jamba-v0.1-52B at one hybrid period; the launches
    # do not depend on the sampler, which keeps the host walk to one corner
    # of each grid.  Its op sweep counts the float32 cut's forward on meta
    # tensors: the peak memory is the launches' alone.
    torch.cuda.reset_peak_memory_stats()
    launches, msg = run_counted(jamba_argv(root / "jamba"), tuple(counted))
    if msg:
        return msg
    print(f"full-width model run: peak memory {torch.cuda.max_memory_allocated()} B "
          f"(torch.cuda.max_memory_allocated), on {smi}")
    if "  op sweep (forward): " not in outputs["last"]:
        return "the full-width model run printed no op sweep line"
    it = load_iteration(root / "jamba" / "iter0")
    rows = {row["path"]: row["kinds"] for row in it.layers["table"]}
    if rows != JAMBA_LAYERS:
        return f"the full-width table has rows {rows}, not {JAMBA_LAYERS}"
    shapes = {pk.name.split(".")[-1]: pk.run["shapes"] for pk in it.kernels if pk.run}
    want = {
        "attn": [[64, 64, 128]] * 3,
        "mlp": [[128, 4096], [4096, 14336]],
        "moe": [[128, 4096], [16, 4096, 14336], [4]],
        "ssm": [[256, 1, 64, 64], [256, 1, 64], [256, 1, 64, 16], [256, 1, 64, 16]],
        "unembed": [[128, 4096], [4096, 65536]],
    }
    if shapes != want:
        return f"the full-width run records shapes {shapes}, not {want}"
    for pk in it.kernels:
        if pk.run and "shared_with" not in pk.run:
            print(f"full width {pk.name}: {pk.run['shapes']} max|err| "
                  f"{pk.run['max_abs_err']:.3e}, {card_ms(pk.run)}")
    rc, out = run_cli(cli, ["report", str(root / "jamba" / "iter0")])
    report = (root / "jamba" / "iter0" / "report" / "report.md").read_text()
    if rc != 0 or "## per-layer attribution — moe-tiny" not in report:
        return f"report on the full-width run exited {rc} or lacks the per-layer section"

    # the model families' rungs, and the registry's model-path families
    for family, (a, b), must in (
        ("model.transformer-tiny.attn", ("base", "wide-kv"), ("flash_attention",)),
        ("model.moe-tiny.moe", ("tile32", "tile64"), ("gmm",)),
    ):
        sess = root / family
        for rung in (a, b):
            _, msg = run_counted(["profile", "-k", f"{family}:{rung}", "--out", str(sess), "-q"], must)
            if msg:
                return msg
        rc, _ = run_cli(cli, ["diff", str(sess / "iter0"), str(sess / "iter1")])
        if rc != 0:
            return f"diff {family} exited {rc}"
        for i, rung in enumerate((a, b)):
            pk = load_iteration(sess / f"iter{i}").kernels[0]
            print(f"{family}:{rung} modeled transfers {pk.transactions}, "
                  f"measured {card_ms(pk.run)} at {pk.run['shapes'][0]}")
    _, msg = run_counted(
        ["profile", "-k", "flash", "-k", "gmm", "-k", "ssd", "--out", str(root / "families"), "-q"],
        ("flash_attention", "gmm", "ssd_chunk"),
    )
    return msg or launches


def loaded(its):
    """A stand-in for a session whose iterations ``its`` are loaded
    already: ``trajectories_from_session`` reads only ``iterations()``."""
    import types

    return types.SimpleNamespace(iterations=lambda: its)


def trajectory_steps(its):
    """(baseline transfers, best transfers, [(candidate, accepted)]) of the
    one tuning run in the loaded iterations ``its``."""
    from repro_torch.core.tuner import trajectories_from_session

    (traj,) = trajectories_from_session(loaded(its))
    return (traj["baseline"]["transactions"], traj["best"]["transactions"],
            [(s["candidate"]["label"], s["accepted"]) for s in traj["steps"]])


def against_alone(label, name, rung, run):
    """None when a tune command's run of ``name:rung`` is no slower on the
    card than phase 3's run of that rung alone (by more than ALONE_TOL and
    ALONE_SLACK_MS), else a failure message: a timer that let the host's
    work into the card's time would read slow beside other work."""
    alone = ALONE_MS.get((name, rung))
    if alone is None:
        return f"{label} {name}:{rung}: phase 3 has no time of the rung alone"
    if run["device_ms"] - alone > ALONE_TOL * alone + ALONE_SLACK_MS:
        return (f"{label} {name}:{rung}: {run['device_ms']:.4f} ms on the card, but "
                f"{alone:.4f} ms alone in phase 3")
    return None


def drive_tuning_loop(cli, kreg, smi):
    """Phase 4, the closed tuning loop: {kernel name: launches made by the
    phase's commands}, or a failure message."""
    import torch

    from repro_torch.core.render import run_text
    from repro_torch.core.session import ProfileSession, heatmaps_equal
    from repro_torch.core.tuner import trajectories_from_session

    card = torch.cuda.get_device_name(0)
    wrappers = kreg.wrappers()
    root = ROOT / "build" / "chip_smoke_session" / "tune"
    shutil.rmtree(root, ignore_errors=True)
    cache = str(root / "cache")
    launches = {name: 0 for name in wrappers}

    def counted(argv, want_rc=0):
        kreg.reset_launch_counts()
        t0 = time.perf_counter()
        rc, out = run_cli(cli, argv)
        wall = time.perf_counter() - t0
        made = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        print(f"launches: {made}")
        for name, count in made.items():
            launches[name] += count
        if rc != want_rc:
            return None, None, f"{' '.join(argv[:2])} exited {rc}, not {want_rc}"
        return out, wall, None

    def checked_runs(sess_dir, label):
        """Every rung with a kernel holds a run on this card within its
        variant's tolerance; returns the iterations or a failure message."""
        its = ProfileSession(sess_dir, create=False).iterations()
        for it in its:
            pk = it.kernels[0]
            tuning = it.tuning or {}
            cand = tuning.get("candidate") or {}
            if tuning.get("role") == "baseline":
                rung = pk.variant
            elif cand.get("source") == "ladder":
                rung = cand.get("variant")
            else:
                rung = None  # a generated candidate: spec surgery, no kernel
            variant = kreg.get(pk.name).variant(rung) if rung else None
            if variant is None or variant.kernel is None:
                if pk.run is not None:
                    return f"{label} {it.path.name}: a run on a rung with no kernel"
                continue
            run = pk.run or {}
            if run.get("device") != card or not run.get("device_ms"):
                return f"{label} {it.path.name}: no run on the card ({run})"
            # run_variant held every element to the variant's tolerance (a
            # miss is exit 1); a plain number is checked again here
            tol = variant.atol
            if run["launches"] < 1 or (not callable(tol) and run["max_abs_err"] > tol):
                return f"{label} {it.path.name}: run {run} outside {tol}"
            msg = against_alone(label, pk.name, variant.name, run)
            if msg:
                return msg
            print(f"{label} {it.path.name} {pk.name}:{variant.name}: {run_text(run)} "
                  f"(alone in phase 3: {ALONE_MS[(pk.name, variant.name)]:.4f} ms on the card)")
        return its

    # -- tune gemm, cold then warm ------------------------------------------------
    walls = {}
    for turn in ("cold", "warm"):
        sess = root / f"gemm-{turn}"
        argv = ["tune", "gemm", "--budget", "3", "--cache", cache, "--out", str(sess)]
        out, walls[turn], msg = counted(argv + (["--report"] if turn == "cold" else []))
        if msg:
            return msg
        if "tuned 1 kernel(s): 1 improved" not in out:
            return f"tune gemm ({turn}) improved no kernel"
        for v in ("v00", "v01", "v02"):
            if wrappers[f"gemm_{v}"].launches < 1:
                return f"tune gemm ({turn}) did not launch gemm_{v}"
        its = checked_runs(sess, f"tune gemm ({turn})")
        if isinstance(its, str):
            return its
        if turn == "cold":
            cold = its
            html = (sess / "report" / "index.html").read_text()
            if "tuning trajectory" not in html:
                return "tune gemm --report: no tuning trajectory section"
            continue
        misses = re.search(r"cache: \d+ hits \(\d+ memory, \d+ disk\), (\d+) misses", out)
        if misses is None or int(misses.group(1)) != 0:
            return f"tune gemm (warm) walked a grid: {misses and misses.group(0)}"
        if len(its) != len(cold) or not all(
            heatmaps_equal(a.kernels[0].heatmap, b.kernels[0].heatmap)
            for a, b in zip(cold, its)
        ):
            return "tune gemm (warm): heat maps differ from the cold run's"
    print(f"tune gemm wall time (in process, host turnaround): cold {walls['cold']:.2f} s, "
          f"warm {walls['warm']:.2f} s, on {smi}")
    TURNAROUND.update(tune_gemm_cold=walls["cold"], tune_gemm_steps=trajectory_steps(cold))

    # -- tune --all, no workers --------------------------------------------------------
    families = ["gemm", "spmv", "histogram", "gramschm", "ttm", "ragged_flash", "paged_attn"]
    sess = root / "all"
    out, wall, msg = counted(["tune", *families, "--all", "--budget", "24", "--cache", cache,
                              "--out", str(sess), "-q"])
    if msg:
        return msg
    its = checked_runs(sess, "tune --all")
    if isinstance(its, str):
        return its
    for traj in trajectories_from_session(loaded(its)):
        moves = [s["candidate"].get("label") for s in traj["steps"] if s["accepted"]]
        print(f"tune --all {traj['kernel']}: transfers {traj['baseline']['transactions']} -> "
              f"{traj['best']['transactions']}, accepted {moves or 'nothing'}")
        if moves != TUNE_ALL_MOVES[traj["kernel"]]:
            return (f"tune --all {traj['kernel']} accepted {moves}, not "
                    f"{TUNE_ALL_MOVES[traj['kernel']]}")
    print(f"tune --all wall time (in process): {wall:.2f} s")

    # -- the regression gate, and lint ------------------------------------------------
    # on phase 3's gemm session: gemm:v00 (iter0) against gemm:v01 (iter1),
    # each profiled by the same command in this process
    sess = ROOT / "build" / "chip_smoke_session" / "gemm"
    out, _, msg = counted(["check", str(sess / "iter0"), "--baseline", str(sess / "iter1"),
                           "--json", "-"], want_rc=1)
    if msg:
        return msg
    if '"schema_version": 1' not in out:
        return "check --json -: no schema_version 1 document"
    kreg.reset_launch_counts()
    rc, _ = run_cli(cli, ["check", str(sess), "--anomaly"])
    if rc not in (0, 1):
        return f"check --anomaly exited {rc}"
    return launches


# phase 4's static checks, run in a process of their own beside phase 8,
# which first times its own imports, a fresh interpreter's (phase 5's
# shard split: what a pool's worker pays before it walks): the seconds
# and each command's exit code on the last line; the output goes to LINT_LOG
LINT_SCRIPT = """
import time
t0 = time.perf_counter()
import repro_torch.core.collector
t1 = time.perf_counter()
import torch
t2 = time.perf_counter()
import json
from repro_torch import cli
rcs = {}
for argv in (["lint", "--all", "-q"], ["kernels", "--lint"]):
    rcs[" ".join(argv)] = cli.main(argv)
print(json.dumps({"import_collector_s": t1 - t0, "import_torch_s": t2 - t1, "rcs": rcs}))
"""
LINT_LOG = ROOT / "build" / "chip_smoke_lint.log"
LINT_TIMEOUT = 300


def start_lint():
    """The loop's static checks, ``lint --all -q`` and ``kernels --lint``,
    through the CLI entry point in a process of their own on the host (no
    kernel runs: they read specs and replay walks), after timing its own
    imports; ``read_lint`` reads them."""
    LINT_LOG.parent.mkdir(exist_ok=True)
    with open(LINT_LOG, "w") as log:
        return subprocess.Popen([sys.executable, "-c", LINT_SCRIPT], stdout=log,
                                stderr=subprocess.STDOUT, cwd=ROOT,
                                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def read_lint(proc, where, smi):
    """Wait for ``start_lint``'s process and print what it printed; None
    when both commands exited 0, else a failure message."""
    proc.wait(timeout=LINT_TIMEOUT)
    out = LINT_LOG.read_text()
    print(out.rstrip())
    rec = json.loads(out.strip().splitlines()[-1]) if proc.returncode == 0 else {}
    rcs = rec.get("rcs")
    print(f"lint --all and kernels --lint, {where}: exit codes {rcs}")
    if not rcs or any(rc != 0 for rc in rcs.values()):
        return f"lint --all / kernels --lint: process exit {proc.returncode}, commands {rcs}"
    print(f"fresh import ({where}): collector {rec['import_collector_s']:.2f} s, then torch "
          f"{rec['import_torch_s']:.2f} s, on {smi}, host {os.cpu_count()} cores")
    return None


def run_cli(cli, argv, with_err=False):
    """Run one CLI command in process; returns (exit code, its stdout), and
    its stderr too with ``with_err``."""
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.ExitStack() as stack:
        if with_err:
            stack.enter_context(contextlib.redirect_stderr(err))
        rc = cli.main(argv)
    out = buf.getvalue()
    print(f"$ cuthermo {' '.join(argv)}  -> exit {rc}")
    print(out.rstrip())
    if with_err:
        print(err.getvalue().rstrip())
        return rc, out, err.getvalue()
    return rc, out


def sigterm_after(n, fn):
    """``fn`` that sends this process SIGTERM after its n-th call: a
    deterministic preemption, raised in process (the tests' hook)."""
    import signal

    calls = []

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(1)
        if len(calls) == n:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    return wrapped


def shard_split(kreg, sc, on):
    """Where a sharded walk of gemm:v00 (the registry's 1024^3, its sampler)
    goes on this host, on the host's clock: the serial walk and its flush;
    the start of ``sc``'s pool (spawn, and the registry import, torch's
    among it), the walk on the started pool and the parent's flush of its
    chunks (a fresh interpreter's import of the collector, then of torch,
    is timed beside phase 8: ``start_lint``).  The walk and flush grow with
    the grid and the start does not,
    so W workers pay from ``break_even`` times this walk's grid points.
    ``sc`` must not be started yet; it stays up for the phase's later
    sharded commands.  Prints the numbers and returns them."""
    from repro_torch.core.collector import collect
    from repro_torch.core.heatmap import Analyzer
    from repro_torch.core.trace import sampled_grid_size

    entry, _ = kreg.resolve("gemm:v00")
    spec, ctx = kreg.build("gemm:v00")
    sampler = entry.sampler()
    workers = sc.workers

    def flush_s(bufs):
        t0 = time.perf_counter()
        an = Analyzer(spec.name, spec.grid, sampler.describe())
        for buf in bufs:
            an.ingest(buf)
        an.flush()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    buf, _ = collect(spec, sampler, ctx)
    row = dict(points=sampled_grid_size(spec.grid, sampler), workers=workers,
               serial_walk_s=time.perf_counter() - t0, serial_flush_s=flush_s([buf]))
    row["pool_start_s"] = sc.warmup()
    t0 = time.perf_counter()
    bufs, infos = sc.collect(spec, sampler, ctx)
    row["walk_s"] = time.perf_counter() - t0
    row["slowest_shard_s"] = max(i.wall_s for i in infos)
    row["flush_s"] = flush_s(bufs)
    gain = row["serial_walk_s"] + row["serial_flush_s"] - row["walk_s"] - row["flush_s"]
    row["break_even"] = row["pool_start_s"] / gain if gain > 0 else None
    pays = (f"{row['break_even']:.1f}x this grid ({row['break_even'] * row['points']:.0f} "
            "points)" if gain > 0 else "never: the sharded walk and flush are no faster")
    print(f"gemm:v00 walk split ({row['points']} grid points): serial walk "
          f"{row['serial_walk_s']:.3f} s + flush {row['serial_flush_s']:.3f} s; {workers} "
          f"workers: pool start {row['pool_start_s']:.3f} s, walk {row['walk_s']:.3f} s "
          f"(slowest shard {row['slowest_shard_s']:.3f} s), flush {row['flush_s']:.3f} s; "
          f"{workers} workers pay from {pays}, {on}")
    return row


def drive_scale_out(cli, kreg, smi, load_iteration):
    """Phase 5: sharded collection, fault recovery and resume on the card's
    host; {kernel name: launches made by the phase's commands}, or a
    failure message."""
    from repro_torch.core import model_profile
    from repro_torch.core.collector import ShardedCollector
    from repro_torch.core.session import ProfileSession, heatmaps_equal
    from repro_torch.kernels import _build

    cores = os.cpu_count() or 1
    workers = min(4, cores)
    on = f"on {smi}, host {cores} cores"
    print(f"scale-out: W = {workers} workers, {on}")
    wrappers = kreg.wrappers()
    launches = {name: 0 for name in wrappers}
    root = ROOT / "build" / "chip_smoke_session" / "scale"
    shutil.rmtree(root, ignore_errors=True)
    libs = {p: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")}

    # probe every pool before it closes: its workers walked, nothing more
    states = []
    close = ShardedCollector.close

    def probing_close(self):
        if self._pool is not None:
            states.extend(self.worker_states())
        close(self)

    # one clean pool for each worker count, shared by the phase's sharded
    # commands: a session asks for it instead of starting its own, and it
    # is probed and closed at the phase's end.  The W-worker pool is
    # started (and timed) by shard_split; the 2-worker one by the first
    # command that walks on it.  A session with injected faults starts
    # its own pool, as a user's would.
    shared = {workers: ShardedCollector(workers)}
    session_collector = ProfileSession.collector

    def shared_collector(self, n=None):
        n = self.workers if n is None else max(1, int(n))
        if n <= 1 or self.fault_plan is not None:
            return session_collector(self, n)
        if n not in shared:
            shared[n] = ShardedCollector(n)
        return shared[n]

    def counted(argv, want_rc=0):
        kreg.reset_launch_counts()
        t0 = time.perf_counter()
        rc, out, err = run_cli(cli, argv, with_err=True)
        wall = time.perf_counter() - t0
        made = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        print(f"launches: {made}")
        for name, count in made.items():
            launches[name] += count
        if rc != want_rc:
            return None, None, None, f"{' '.join(argv[:3])} exited {rc}, not {want_rc}"
        return out, err, wall, None

    def walk_s(sess, i):
        pk = load_iteration(sess / f"iter{i}").kernels[0]
        return pk, pk.wall_s

    ShardedCollector.close = probing_close
    ProfileSession.collector = shared_collector
    try:
        # -- gemm v00 at 1024^3: the walk split, on the W-worker pool it starts ----
        split = shard_split(kreg, shared[workers], on)

        # -- tune gemm with W workers on a fresh cache, on the started pool --------
        # its baseline is the sharded walk of gemm:v00 (the registry's sampler),
        # held to phase 3's serial walk of the same command in this process
        sess = root / "tune-gemm"
        out, _, wall, msg = counted(["tune", "gemm", "--budget", "3", "--workers", str(workers),
                                     "--cache", str(root / "cache"), "--out", str(sess)])
        if msg:
            return msg
        its = ProfileSession(sess, create=False).iterations()
        for it in its:
            pk = it.kernels[0]
            if pk.run is not None:
                cand = (it.tuning or {}).get("candidate") or {}
                msg = against_alone(f"tune gemm --workers {workers}", pk.name,
                                    cand.get("variant") or pk.variant, pk.run)
                if msg:
                    return msg

        got, want = trajectory_steps(its), TURNAROUND["tune_gemm_steps"]
        if got != want or got[:2] != (168820736, 3276800):
            return f"tune gemm --workers {workers}: trajectory {got}, phase 4's {want}"
        print(f"tune gemm trajectory {got}: equal to phase 4's")
        print(f"tune gemm cold turnaround: serial {TURNAROUND['tune_gemm_cold']:.2f} s (phase 4), "
              f"{workers} workers {wall:.2f} s on the started pool, "
              f"{wall + split['pool_start_s']:.2f} s with its start, {on}")
        serial_dir = ROOT / "build" / "chip_smoke_session" / "gemm" / "iter0"
        serial, sharded = load_iteration(serial_dir).kernels[0], its[0].kernels[0]
        if (serial.variant, sharded.variant, (its[0].tuning or {}).get("role")) != (
                "v00", "v00", "baseline"):
            return (f"the serial and sharded walks are of {serial.variant} and "
                    f"{sharded.variant}, not gemm:v00")
        if len(sharded.shards) != workers:
            return f"tune gemm --workers {workers}: its baseline walked in {len(sharded.shards)} shards"
        if not heatmaps_equal(serial.heatmap, sharded.heatmap):
            return "gemm:v00: the sharded heat map differs from the serial one"
        rc, diff_out = run_cli(cli, ["diff", str(serial_dir), str(its[0].path)])
        if rc != 0 or "[unchanged] gemm" not in diff_out:
            return "diff of the serial and sharded gemm:v00 is not 'unchanged'"
        print(f"gemm:v00 1024^3 walk: serial {serial.wall_s:.3f} s (phase 3), "
              f"{len(sharded.shards)} shards on {workers} workers {sharded.wall_s:.3f} s on the "
              f"started pool (tune's baseline), {sharded.wall_s + split['pool_start_s']:.3f} s "
              f"with its start, {on}")

        # -- gemm v01 full grid: serial, clean sharded, injected faults -----------
        sess = root / "faults"
        base = ["profile", "-k", "gemm:v01", "--sampler", "full", "--out", str(sess), "-q"]
        for extra in ([], ["--workers", "2"], ["--workers", "2", "--inject-faults", "seed=7"]):
            _, err, _, msg = counted(base + extra)
            if msg:
                return msg
        # a healthy shard slower than the plan's 1.5 s watchdog is re-run
        # too, so the counts may grow; the four kinds must all be there
        kinds = ("pool-rebuild", "shard-resplit", "shard-timeout", "worker-crash")
        line = next((l for l in err.splitlines() if l.startswith("recovered faults:")), "")
        if not all(f"{kind} x" in line for kind in kinds):
            return f"the injected run reported {line!r}, not all of {kinds}"
        (serial, t_serial), (clean, t_clean), (faulty, t_faulty) = (
            walk_s(sess, i) for i in range(3)
        )
        if not (heatmaps_equal(serial.heatmap, clean.heatmap)
                and heatmaps_equal(serial.heatmap, faulty.heatmap)):
            return "gemm:v01: a sharded heat map differs from the serial one"
        manifest = json.loads((sess / "iter2" / "manifest.json").read_text())
        if {f["kind"] for f in manifest.get("faults", ())} != set(kinds):
            return "the injected run's manifest lacks its faults block"
        print(f"gemm:v01 1024^3 walk: serial {t_serial:.3f} s, 2 workers {t_clean:.3f} s, "
              f"2 workers with seed=7 faults {t_faulty:.3f} s (fault_recovery overhead "
              f"{100 * (t_faulty - t_clean) / t_clean:.1f} %; each pool's start "
              f"included), {on}")

        # -- the full-width model run, preempted then resumed -----------------------
        out_dir = root / "jamba"
        argv = jamba_argv(out_dir) + ["--workers", "2"]
        profile = model_profile.profile_kernel
        model_profile.profile_kernel = sigterm_after(1, profile)
        try:
            _, err, _, msg = counted(argv, want_rc=3)
        finally:
            model_profile.profile_kernel = profile
        if msg:
            return msg
        journal = out_dir / model_profile.MODEL_JOURNAL
        if not journal.is_file() or "preempted after 1/" not in err:
            return "the preempted model run left no journal"
        partial = load_iteration(out_dir / json.loads(journal.read_text())["partial"])
        out, _, _, msg = counted(argv + ["--resume"])
        if msg:
            return msg
        if journal.exists():
            return "model --resume left its journal"
        if "  op sweep (forward): " not in out:
            return "the resumed model run printed no op sweep line"
        got = load_iteration(out_dir / "iter1")
        want = load_iteration(ROOT / "build" / "chip_smoke_session" / "model" / "jamba" / "iter0")
        if got.layers != want.layers or [pk.name for pk in got.kernels] != [
            pk.name for pk in want.kernels
        ] or not all(heatmaps_equal(a.heatmap, b.heatmap) for a, b in zip(got.kernels, want.kernels)):
            return "the resumed model run's heat maps differ from phase 3's"
        if got.kernels[0].run != partial.kernels[0].run:
            return "the resumed model run dropped the run measured before the preemption"
        print(f"model (Jamba-v0.1-52B, 8 layers, 2 workers): preempted after "
              f"{len(partial.kernels)} kernel, resumed to {len(got.kernels)} kernels, "
              f"heat maps equal to phase 3's")
    finally:
        ProfileSession.collector = session_collector
        try:
            for sc in shared.values():
                probing_close(sc)
        finally:
            ShardedCollector.close = close

    bad = [s for s in states if s["cuda_initialized"] or s["libraries"] or s["launches"]]
    print(f"pool workers probed: {len(states)}, with a CUDA context, a library or a "
          f"launch: {bad}")
    if not states or bad:
        return f"pool workers touched the card: {bad or 'none probed'}"
    if {p: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")} != libs:
        return "a kernel library was rebuilt during the sharded runs"
    for name in ("gemm_v00", "gemm_v01", "gemm_v02", "flash_attention", "gmm", "ssd_chunk"):
        if launches[name] < 1:
            return f"the scale-out phase did not launch {name}"
    return launches


def cast_tree(tree, dtype):
    """A nested dict of tensors, each cast to ``dtype``."""
    return {k: cast_tree(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}


def recording_routes(moe_mod, routes):
    """A stand-in for ``moe._router`` that appends each call's expert ids
    (sorted per token) to ``routes``."""
    router = moe_mod._router

    def record(params, x2d, cfg):
        out = router(params, x2d, cfg)
        routes.append(out[0].sort(dim=-1).values)
        return out

    return router, record


def state_bytes(caches, kv_slots):
    """Bytes of a cache tree's state: each KV buffer (``k``, ``v``) at
    ``kv_slots`` of its sequence slots, every other tensor (SSM and
    convolution state) whole."""
    import torch

    if isinstance(caches, dict):
        return sum(v[:, :kv_slots].numel() * v.element_size() if k in ("k", "v")
                   else state_bytes(v, kv_slots) for k, v in caches.items())
    if isinstance(caches, (list, tuple)):
        return sum(state_bytes(c, kv_slots) for c in caches)
    return caches.numel() * caches.element_size() if isinstance(caches, torch.Tensor) else 0


def event_ms(fn):
    """(result, ms, host ms) of one call: the CUDA-event time (synchronised)
    and the host's time to return from issuing it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), host


def device_breakdown(label, fn, smi, measured_ms, top=8):
    """Profile one call of ``fn`` (``torch.profiler``, CPU and CUDA) and
    print the card's busy time (the device time of the kernels each aten
    op launched, summed), its idle share against the CUDA-event median
    ``measured_ms``, and the ops with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels appear twice, as their own rows and in their op's self time:
    # count the ops (CPU rows) only
    rows = [(e.self_device_time_total / 1e3, e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CPU") and e.self_device_time_total > 0]
    busy = sum(ms for ms, _, _ in rows)
    print(f"{label} under torch.profiler: card busy {busy:.3f} ms against the measured "
          f"{measured_ms:.3f} ms, idle share {max(0.0, 1 - busy / measured_ms):.3f}, on {smi}")
    for ms, key, n in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:10.3f} ms  {n:5d}x  {key}")


def drive_model_forward(smi, base=None, dev=None):
    """Phase 6: the model forward at full width on the card, through the
    port's entry points (``LM``, ``prefill``, ``decode_step``); None, or a
    failure message.  ``base`` and ``dev`` (the Jamba cut, the card) are
    for a rehearsal at a small size."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.archs import jamba_52b
    from repro_torch.core import op_cost, roofline
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import LM
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import block_apply, block_defs

    dev = dev or torch.device("cuda", 0)
    base = base or dataclasses.replace(jamba_52b(), n_layers=FWD_LAYERS, name="jamba-v0.1-52b-cut8")
    total, active = base.param_counts()
    print(f"model forward: {base.name} (d_model {base.d_model}, {base.n_heads} heads over "
          f"{base.n_kv_heads} KV of {base.head_dim}, d_ff {base.d_ff}, {base.n_experts} experts "
          f"top-{base.top_k} {base.moe_impl}, SSD state {base.ssm_state}, vocab {base.vocab}), "
          f"{FWD_LAYERS} of 32 layers: {total} parameters, {active} active, on {smi}")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # -- each block kind at full width: float32 against float64 ---------------
    scfg = dataclasses.replace(base, dtype=torch.float32).stack_config()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, BLOCK_SEQ, base.d_model)).astype(np.float32)).to(dev)
    pos = torch.arange(BLOCK_SEQ, device=dev)[None]
    for kind in sorted(set(base.layout()), key=lambda k: k.tag()):
        with torch.no_grad():
            p32 = init_params(block_defs(scfg, kind), gen(1), dtype=torch.float32, device=dev)
            y32, _, _ = block_apply(p32, x, pos, scfg, kind)
            p64 = cast_tree(p32, torch.float64)
            del p32
            y64, _, _ = block_apply(p64, x.double(), pos, scfg, kind)
            del p64
            upd32, upd64 = y32.double() - x.double(), y64 - x.double()
            err = float((upd32 - upd64).abs().max() / upd64.abs().max())
        torch.cuda.empty_cache()
        print(f"block {kind.tag()} (1 x {BLOCK_SEQ}): float32 vs float64 max|err| / max|update| "
              f"{err:.3e} (tol {BLOCK_TOL:.0e})")
        if not err <= BLOCK_TOL:
            return f"block {kind.tag()}: float32 vs float64 {err:.3e} > {BLOCK_TOL:.0e}"

    # -- the bfloat16 cut: prefill, then decode ---------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(base, device=dev, generator=gen(0))
    torch.cuda.synchronize()
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"built the bfloat16 cut in {time.perf_counter() - t0:.1f} s: {param_bytes / 1e9:.2f} GB "
          f"of parameters")
    toks = torch.randint(0, base.vocab, (1, FWD_PREFILL + FWD_DECODE), generator=gen(2),
                         device=dev)
    prompt = toks[:, :FWD_PREFILL]
    with torch.no_grad():
        empty = model.init_caches(1, FWD_PREFILL + FWD_DECODE, dtype=torch.bfloat16)

        def prefill():
            return model.prefill(prompt, empty, last_only=True)

        prefill()  # warm-up
        pre, pre_host = zip(*(event_ms(prefill)[1:] for _ in range(FWD_RUNS)))
        (logits, caches), _, _ = event_ms(prefill)
        if tuple(logits.shape) != (1, 1, base.padded_vocab) or not bool(torch.isfinite(logits).all()):
            return f"prefill: logits {tuple(logits.shape)} are not finite of the padded vocab"
        prefill_out = caches
        dec, dec_host = [], []
        for t in range(FWD_DECODE):
            last_in = caches  # the caches the last timed step reads
            (logits, caches), ms, host = event_ms(
                lambda: model.decode_step(toks[:, FWD_PREFILL + t : FWD_PREFILL + t + 1], caches))
            dec.append(ms)
            dec_host.append(host)
            if not bool(torch.isfinite(logits).all()):
                return f"decode step {t}: logits are not finite"
        peak16 = torch.cuda.max_memory_allocated()
        pre_ms, dec_ms = float(np.median(pre)), float(np.median(dec))
        # the last timed step again (caches are values, so it is the same
        # step at the same position), profiled and counted
        def last_step():
            return model.decode_step(toks[:, -1:], last_in)

        device_breakdown("prefill", prefill, smi, pre_ms)
        device_breakdown("decode step", last_step, smi, dec_ms)
        _, pre_cost = op_cost.count(prefill)
        _, dec_cost = op_cost.count(last_step)
        # the bytes each function needs: the parameters once, the caches'
        # state written (prefill) or read and written (decode: the KV up to
        # its position read, one slot written), the tokens and the logits
        io = toks.element_size() + logits.numel() * logits.element_size()
        pos = FWD_PREFILL + FWD_DECODE - 1
        pre_need = (param_bytes + state_bytes(prefill_out, FWD_PREFILL)
                    + FWD_PREFILL * toks.element_size() + logits.numel() * logits.element_size())
        dec_need = (param_bytes + state_bytes(last_in, pos + 1) + state_bytes(last_in, 1) + io)
    print(f"prefill 1 x {FWD_PREFILL} (bfloat16, last position unembedded): median {pre_ms:.3f} ms "
          f"of {[round(v, 3) for v in pre]}, {FWD_PREFILL / pre_ms * 1e3:.1f} tokens/s; the host "
          f"issues it in {float(np.median(pre_host)):.3f} ms; on {smi}")
    print(f"decode {FWD_DECODE} steps at 1 x {FWD_PREFILL}..{FWD_PREFILL + FWD_DECODE - 1}: median "
          f"{dec_ms:.3f} ms (min {min(dec):.3f}, max {max(dec):.3f}), {1e3 / dec_ms:.1f} tokens/s; "
          f"the host issues a step in {float(np.median(dec_host)):.3f} ms; on {smi}")
    print(f"parameters {param_bytes} B, peak memory {peak16} B (torch.cuda.max_memory_allocated)")
    for label, cost, need, ms, model_flops in (
            ("prefill", pre_cost, pre_need, pre_ms, 2.0 * active * FWD_PREFILL),
            ("decode step", dec_cost, dec_need, dec_ms, 2.0 * active)):
        terms = roofline.from_raw(label, 1, cost.flops, need, cost.wire_bytes,
                                  model_flops=model_flops)
        print(f"{label} op sweep: {cost.flops:.4e} flops ({cost.product_flops:.4e} in products), "
              f"{cost.bytes:.4e} bytes moved by the eager ops ({cost.bytes / roofline.HBM_BW * 1e3:.3f} "
              f"ms at 3.35 TB/s, a diagnostic), {cost.collective_count} collectives; roofline (H100 "
              f"SXM datasheet, bf16): compute {terms.compute_s * 1e3:.3f} ms, memory "
              f"{terms.memory_s * 1e3:.3f} ms for the {need:.4e} bytes the function needs -> "
              f"{terms.bound}-bound at {terms.step_s * 1e3:.3f} ms; share of the bound reached "
              f"{terms.share_of_bound(ms / 1e3):.3f}; active-parameter FLOPs {model_flops:.4e}; "
              f"on {smi}")
    weights_ms = param_bytes / roofline.HBM_BW * 1e3
    print(f"decode step reads every parameter (capacity dispatch runs every expert): "
          f"{param_bytes / 1e9:.2f} GB / 3.35 TB/s = {weights_ms:.3f} ms; measured {dec_ms:.3f} ms, "
          f"{weights_ms / dec_ms:.3f} of it")

    # -- bfloat16 logits against float32's, the same draws unrounded ------------
    routes16 = []
    router, record = recording_routes(moe_mod, routes16)
    moe_mod._router = record
    try:
        with torch.no_grad():
            logits16, _, _ = model.apply(prompt)
    finally:
        moe_mod._router = router
    del model, empty, caches, logits, prefill_out, last_in
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg32 = dataclasses.replace(base, dtype=torch.float32)
    model = LM(cfg32, device=dev, generator=gen(0))
    routes32 = []
    router, record = recording_routes(moe_mod, routes32)
    moe_mod._router = record
    try:
        with torch.no_grad():
            logits32, _, _ = model.apply(prompt)
    finally:
        moe_mod._router = router
    alike = torch.stack([(a == b).all(dim=-1) for a, b in zip(routes16, routes32)]).all(dim=0)
    scale = float(logits32.abs().max())
    diff = (logits16 - logits32)[0]
    share = float(alike.float().mean())
    rel_alike = (float(diff[alike].norm() / logits32[0, alike].norm()) if bool(alike.any())
                 else float("inf"))
    rel = float(diff.norm() / logits32.norm())
    agree = float((logits16.argmax(-1) == logits32.argmax(-1)).float().mean())
    print(f"bfloat16 vs float32 logits (1 x {FWD_PREFILL}, {len(routes32)} MoE layers): positions "
          f"routed alike {share:.4f} (least {ALIKE_MIN}); on them |err| / |logits| "
          f"{rel_alike:.3e} (tol {BF16_TOL:.0e}); over all positions {rel:.3e}, max|err| / "
          f"max|logits| {float(diff.abs().max()) / scale:.3e}, argmax agreement {agree:.4f}")
    del logits16, diff
    if not (share >= ALIKE_MIN and rel_alike <= BF16_TOL):
        return f"bfloat16 vs float32 logits: {share:.4f} routed alike, {rel_alike:.3e} on them"

    # -- float32: prefill(S - 8) and 8 decode steps against the forward of S --------
    # Capacity dispatch drops by the group's length, so the forward of S and a
    # prefill of S - 8 would drop different tokens: at capacity factor
    # n_experts / top_k no token drops.  The SSD chunk must divide the
    # sequence (ssd_ref raises otherwise): 8 divides both S - 8 and S.
    model.cfg = dataclasses.replace(cfg32, capacity_factor=float(base.n_experts / base.top_k),
                                    ssm_chunk=DECODE_STEPS)
    model.stack_cfg = model.cfg.stack_config()
    seq = toks[:, :DECODE_SEQ]
    with torch.no_grad():
        full, _, _ = model.apply(seq)
        out, caches = model.prefill(seq[:, :-DECODE_STEPS],
                                    model.init_caches(1, DECODE_SEQ, dtype=torch.float32))
        steps = [out]
        for t in range(DECODE_SEQ - DECODE_STEPS, DECODE_SEQ):
            out, caches = model.decode_step(seq[:, t : t + 1], caches)
            steps.append(out)
        err = float((torch.cat(steps, dim=1) - full).abs().max() / full.abs().max())
    peak32 = torch.cuda.max_memory_allocated()
    print(f"float32 prefill({DECODE_SEQ - DECODE_STEPS}) + {DECODE_STEPS} decode steps vs the "
          f"forward of {DECODE_SEQ}: max|err| / max|logits| {err:.3e} (tol {DECODE_TOL:.0e}); "
          f"float32 cut's peak memory {peak32} B")
    del model, full, caches, out, steps, logits32
    torch.cuda.empty_cache()
    if not err <= DECODE_TOL:
        return f"float32 decode vs forward: {err:.3e} > {DECODE_TOL:.0e}"
    return None


def card_busy_ms(prof, by_shape=False):
    """(busy ms, rows) of a ``torch.profiler`` run: the device time of every
    kernel, copy and memset (each once: the CUDA rows; an op's CPU row
    holds its kernels' time again, and so does a "Command Buffer Full"
    row when the launch queue was full), and (ms, op, calls) for each aten
    op (its input shapes too with ``by_shape``, recorded with
    ``record_shapes=True``)."""
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3
    rows = [(e.self_device_time_total / 1e3,
             f"{e.key} {e.input_shapes}" if by_shape else e.key, e.count)
            for e in prof.key_averages(group_by_input_shape=by_shape)
            if str(e.device_type).endswith("CPU") and e.key.startswith("aten::")
            and e.self_device_time_total > 0]
    return busy, rows


@contextlib.contextmanager
def serve_timer(server_cls):
    """Time a ``Server``'s work from outside while in use, by wrapping the
    class's ``step`` and ``_prefill_slot``: each admission's prefill, and
    each decode tick (a step less its admissions) with the slots live in it
    and the sum of their cache lengths after it (the K/V tokens the tick
    must read), on the host's clock (both end in a read of the sampled
    tokens, which waits for the card).  The ticks
    ``SERVE_PROFILED`` run under ``torch.profiler``: their busy time on the
    card against their wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step, prefill = server_cls.step, server_cls._prefill_slot
    rec = dict(prefill_ms=[], ticks=[], busy_ms=None, window_ms=0.0, top=[])
    prof, admitted = [], []

    def timed_prefill(srv, slot, req):
        t0 = time.perf_counter()
        prefill(srv, slot, req)
        rec["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
        admitted.append(req)

    def timed_step(srv):
        idx = len(rec["ticks"])
        if idx == SERVE_PROFILED[0] and not prof:
            torch.cuda.synchronize()
            prof.append(profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                record_shapes=True))
            prof[0].__enter__()
        n_adm, before = len(rec["prefill_ms"]), srv.steps
        live = [r for r in srv.active if r is not None]
        t0 = time.perf_counter()
        step(srv)
        ms = (time.perf_counter() - t0) * 1e3 - sum(rec["prefill_ms"][n_adm:])
        if srv.steps > before:
            live += admitted[n_adm:]  # a slot's length: its prompt and every token but the last
            rec["ticks"].append(dict(ms=ms, live=len(live), kv_tokens=sum(
                len(r.prompt) + len(r.out_tokens) - 1 for r in live)))
            if SERVE_PROFILED[0] <= idx < SERVE_PROFILED[1]:
                rec["window_ms"] += ms + sum(rec["prefill_ms"][n_adm:])
        if prof and rec["busy_ms"] is None and len(rec["ticks"]) == SERVE_PROFILED[1]:
            torch.cuda.synchronize()
            prof[0].__exit__(None, None, None)
            rec["busy_ms"], rows = card_busy_ms(prof[0], by_shape=True)
            rec["top"] = sorted(rows, reverse=True)[:6]

    server_cls.step, server_cls._prefill_slot = timed_step, timed_prefill
    try:
        yield rec
    finally:
        server_cls.step, server_cls._prefill_slot = step, prefill
        if prof and rec["busy_ms"] is None:  # the run ended inside the window
            prof[0].__exit__(None, None, None)


def report_serving(label, rec, wall_s, reqs, cfg, param_bytes, smi):
    """Print a serving run's numbers (each beside the card), check that
    every request ended with its max_tokens tokens; None or a failure."""
    import numpy as np

    from repro_torch.core import roofline

    short = [r.rid for r in reqs if len(r.out_tokens) != r.max_tokens or not r.done]
    if short:
        return f"{label}: requests {short} did not end with their max_tokens tokens"
    ticks = rec["ticks"]
    tick_ms = np.array([t["ms"] for t in ticks])
    generated = sum(len(r.out_tokens) for r in reqs)
    kv_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim_ * 2  # K and V, bf16
    bounds = []
    for t in ticks:
        need = param_bytes + t["kv_tokens"] * kv_token
        terms = roofline.from_raw(label, 1, cfg.model_flops_decode(t["live"]), need, 0.0)
        bounds.append(terms.step_s * 1e3)
    bounds = np.array(bounds)
    share = bounds / tick_ms
    pre = np.array(rec["prefill_ms"])
    print(f"{label}: {len(reqs)} requests, {generated} tokens in {wall_s:.3f} s, "
          f"{generated / wall_s:.1f} tokens/s; {len(ticks)} decode ticks, median "
          f"{float(np.median(tick_ms)):.3f} ms, max {float(tick_ms.max()):.3f} ms, "
          f"{sum(t['live'] for t in ticks) / tick_ms.sum() * 1e3:.1f} tokens/s over the ticks; "
          f"{len(pre)} admissions, prefill median {float(np.median(pre)):.3f} ms, max "
          f"{float(pre.max()):.3f} ms per admission; on {smi}")
    print(f"{label}: decode tick bound (core/roofline.py: the {param_bytes / 1e9:.2f} GB of "
          f"weights read once plus each live slot's K/V up to its own length, over 3.35 "
          f"TB/s) median {float(np.median(bounds)):.3f} ms (min {float(bounds.min()):.3f}, max "
          f"{float(bounds.max()):.3f}); share of the bound reached: median "
          f"{float(np.median(share)):.3f}, least {float(share.min()):.3f}")
    if rec["busy_ms"] is not None:
        print(f"{label}: ticks {SERVE_PROFILED[0]}..{SERVE_PROFILED[1] - 1} under "
              f"torch.profiler: card busy {rec['busy_ms']:.3f} ms of {rec['window_ms']:.3f} ms, "
              f"idle share {max(0.0, 1 - rec['busy_ms'] / rec['window_ms']):.3f}")
        for ms, key, n in rec["top"]:
            print(f"  {ms:10.3f} ms  {n:5d}x  {key}")
    return None


def direct_greedy(model, prompt, n, max_seq, dtype):
    """``n`` greedy tokens of a batch-1 ``prefill`` then ``decode_step``."""
    import torch

    dev = model.device
    with torch.no_grad():
        caches = model.init_caches(1, max_seq, dtype=dtype)
        logits, caches = model.prefill(torch.from_numpy(prompt).long()[None].to(dev), caches)
        toks = [int(logits[0, -1].argmax())]
        for _ in range(n - 1):
            logits, caches = model.decode_step(torch.tensor([[toks[-1]]], device=dev), caches)
            toks.append(int(logits[0, 0].argmax()))
    return toks


def drive_serving(smi, cfg=None, dev=None):
    """Phase 7: Granite-8B served whole on the card, through the port's
    entry points (``launch.serve.main``, ``Server``); None, or a failure
    message.  ``cfg`` and ``dev`` are for a rehearsal at a small size."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.archs import granite_8b
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import LM
    from repro_torch.runtime import Request, ServeConfig, Server

    dev = dev or torch.device("cuda", 0)
    cfg = cfg or granite_8b()
    total, _ = cfg.param_counts()
    param_bytes = total * 2
    print(f"serving: {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers, {cfg.n_heads} "
          f"heads over {cfg.n_kv_heads} KV of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"tied), whole: {total} parameters, {param_bytes / 1e9:.2f} GB in bfloat16, on {smi}")

    # -- the reference's entry point and traffic ------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got = []
    real_submit = Server.submit
    Server.submit = lambda srv, req: (got.append(req), real_submit(srv, req))[1]
    try:
        with serve_timer(Server) as rec:
            t0 = time.perf_counter()
            out = launch_serve.main(SERVE_ARGV)
            wall = time.perf_counter() - t0
    finally:
        Server.submit = real_submit
    print(f"launch.serve.main({' '.join(SERVE_ARGV)}) -> {out}; wall {wall:.3f} s with the "
          f"model's build; peak memory {torch.cuda.max_memory_allocated()} B")
    msg = report_serving("serve (entry point, prompts of 2-11 tokens)", rec, out["seconds"],
                         got, cfg, param_bytes, smi)
    if msg:
        return msg

    # -- longer prompts, through the library ------------------------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(
        LONG_PROMPT[0], LONG_PROMPT[1] + 1))).astype(np.int32), max_tokens=SERVE_MAX_TOKENS)
        for i in range(SERVE_REQUESTS)]
    srv = Server(model, ServeConfig(batch_slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ),
                 dtype=cfg.dtype)
    for r in reqs:
        srv.submit(r)
    with serve_timer(Server) as rec:
        t0 = time.perf_counter()
        srv.run_until_done()
        wall = time.perf_counter() - t0
    print(f"serve (library, prompts of {LONG_PROMPT[0]}-{LONG_PROMPT[1]} tokens: "
          f"{sorted(len(r.prompt) for r in reqs)}): peak memory "
          f"{torch.cuda.max_memory_allocated()} B")
    msg = report_serving(f"serve (library, prompts of {LONG_PROMPT[0]}-{LONG_PROMPT[1]})", rec,
                         wall, reqs, cfg, param_bytes, smi)
    del model, srv
    torch.cuda.empty_cache()
    if msg:
        return msg

    # -- float32: every request against a direct decode of its own ---------------------
    torch.cuda.reset_peak_memory_stats()
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = LM(cfg32, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(8)
    lengths = [CHECK_PROMPTS[0]] + [int(rng.integers(CHECK_PROMPTS[1], CHECK_PROMPTS[2] + 1))
                                    for _ in range(CHECK_REQUESTS - 1)]
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_tokens=int(rng.integers(CHECK_TOKENS[0], CHECK_TOKENS[1] + 1)))
            for i, n in enumerate(lengths)]
    srv = Server(model, ServeConfig(batch_slots=SERVE_SLOTS, max_seq=CHECK_MAX_SEQ),
                 dtype=torch.float32)
    for r in reqs:
        srv.submit(r)
    held, seen = [[] for _ in range(SERVE_SLOTS)], set()  # each slot's requests in turn
    while srv.queue or any(r is not None for r in srv.active):
        srv.step()
        for slot, r in enumerate(srv.active):
            if r is not None and r.rid not in seen:
                seen.add(r.rid)
                held[slot].append(r)
    # admitted into a slot whose last request ended longer than its prompt
    after_longer = [b.rid for line in held for a, b in zip(line, line[1:])
                    if len(a.prompt) + a.max_tokens - 1 > len(b.prompt)]
    direct = [direct_greedy(model, r.prompt, r.max_tokens, CHECK_MAX_SEQ, torch.float32)
              for r in reqs]
    differ = [r.rid for r, d in zip(reqs, direct) if r.out_tokens != d]
    print(f"float32 (whole, {cfg.n_layers} of {cfg.n_layers} layers, {total * 4 / 1e9:.2f} GB; peak "
          f"{torch.cuda.max_memory_allocated()} B): {CHECK_REQUESTS} requests over "
          f"{SERVE_SLOTS} slots in {srv.steps} ticks (prompts {lengths}, max_tokens "
          f"{[r.max_tokens for r in reqs]}; each slot's requests "
          f"{[[r.rid for r in line] for line in held]}; admitted after a longer request: "
          f"{after_longer}) against a batch-1 prefill + decode_step each: "
          f"{'all equal' if not differ else f'{differ} DIFFERENT'}")
    del model, srv
    torch.cuda.empty_cache()
    if differ:
        return (f"serving float32: requests {differ} gave "
                f"{[r.out_tokens for r in reqs if r.rid in differ]}, their direct decodes "
                f"{[d for r, d in zip(reqs, direct) if r.rid in differ]}")
    if not after_longer or sum(map(len, held)) != CHECK_REQUESTS:
        return (f"serving float32: no slot was refilled after a longer request, or a "
                f"request was never seen in a slot: {[[r.rid for r in line] for line in held]}")
    return None


def drive_training(smi, cfg=None, dev=None):
    """Phase 8: training at Granite-8B's widths on the card, through the
    port's entry points (``build_train_step``, ``run``, ``launch.train.main``);
    None, or a failure message.  ``cfg`` and ``dev`` are for a rehearsal at
    a small size."""
    import dataclasses
    import hashlib
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import restore_tree
    from repro_torch.configs.archs import granite_8b
    from repro_torch.core import roofline
    from repro_torch.core.model_profile import op_sweep
    from repro_torch.data import DataConfig, SyntheticSource, TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime import (
        Preempted, TrainConfig, build_train_step, init_state, model_loss, run,
    )
    from torch.profiler import ProfilerActivity, profile

    dev = dev or torch.device("cuda", 0)
    cfg = cfg or dataclasses.replace(granite_8b(), n_layers=TRAIN_LAYERS,
                                     name=f"granite-8b-cut{TRAIN_LAYERS}")
    total, _ = cfg.param_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    opt = adamw(cosine_warmup(TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL))
    tc = TrainConfig(max_grad_norm=1.0)
    state = init_state(dict(model.named_parameters()), opt, tc)
    step = build_train_step(lambda p, t, l: model_loss(model, p, t, l), opt, tc)
    pipe = TokenPipeline(SyntheticSource(DataConfig(global_batch=TRAIN_BATCH,
                                                    seq_len=TRAIN_SEQ, vocab=cfg.vocab)))
    print(f"training: {cfg.name} ({cfg.n_layers} of 36 layers at Granite-8B's widths, "
          f"remat {cfg.remat}): {total} parameters in bfloat16, AdamW moments in float32 "
          f"(peak rate {TRAIN_LR} after {TRAIN_WARMUP} warmup steps of {TRAIN_TOTAL}, "
          f"clipped at 1.0); batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, the first {TRAIN_STEPS} "
          f"steps, on {smi}")
    times, losses, norms = [], [], []
    clock = [time.perf_counter()]

    def record(i, st, metrics):
        losses.append(float(metrics["loss"]))  # waits for the step
        norms.append(float(metrics["grad_norm"]))
        now = time.perf_counter()
        times.append(now - clock[0])
        clock[0] = now
        print(f"  step {i}: loss {losses[-1]:.4f}, grad_norm {norms[-1]:.4f}, "
              f"{times[-1] * 1e3:.1f} ms")

    state, _ = run(step, state, pipe, TRAIN_STEPS - 1, (record,))
    # the last step under torch.profiler: the card's busy time in a step
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        clock[0] = time.perf_counter()
        state, _ = run(step, state, pipe, 1, (record,), start_step=TRAIN_STEPS - 1)
    busy, rows = card_busy_ms(prof)
    peak = torch.cuda.max_memory_allocated()
    steady = np.array(times[1:-1]) * 1e3  # the first step allocates, the last is profiled
    med = float(np.median(steady))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    model_flops = cfg.model_flops_train(TRAIN_BATCH, TRAIN_SEQ)
    sweep = op_sweep(cfg, TRAIN_BATCH, TRAIN_SEQ, backward=True)["cost"]
    terms = roofline.from_raw(cfg.name, 1, sweep["flops"], 0.0, 0.0, model_flops=model_flops)
    model_bound = model_flops / roofline.PEAK_FLOPS_BF16 * 1e3
    print(f"training step: median {med:.1f} ms over steps 1..{TRAIN_STEPS - 2} (min "
          f"{float(steady.min()):.1f}, max {float(steady.max()):.1f}; first {times[0] * 1e3:.1f}), "
          f"{tokens / med * 1e3:.1f} tokens/s; peak memory {peak} B; on {smi}")
    print(f"training step bound: 6 N D = {model_flops:.4e} FLOPs over 989 TFLOP/s = "
          f"{model_bound:.1f} ms, share reached {model_bound / med:.3f}; the op sweep (loss + "
          f"grad with remat, meta tensors) counts {sweep['flops']:.4e} FLOPs "
          f"({sweep['product_flops']:.4e} in products) -> {terms.compute_s * 1e3:.1f} ms, share "
          f"{terms.compute_s * 1e3 / med:.3f}")
    print(f"training step {TRAIN_STEPS - 1} under torch.profiler: card busy {busy:.1f} ms of "
          f"{times[-1] * 1e3:.1f} ms, idle share {max(0.0, 1 - busy / (times[-1] * 1e3)):.3f}")
    for ms, key, n in sorted(rows, reverse=True)[:8]:
        print(f"  {ms:10.3f} ms  {n:5d}x  {key}")
    del state, step, model, prof
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        return f"training: a loss or grad norm is not finite: {losses}, {norms}"
    if not losses[-1] < losses[0]:
        return f"training: the loss did not fall ({losses[0]:.4f} -> {losses[-1]:.4f})"

    # -- the entry point: preempted by SIGTERM, then resumed --------------------------
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        argv = TRAIN_ARGV + ["--ckpt-dir", ckpt]
        real = launch_train.build_train_step
        launch_train.build_train_step = lambda *a, **k: sigterm_after(PREEMPT_AT, real(*a, **k))
        try:
            launch_train.main(argv)
            return "launch.train: the SIGTERM did not stop the run"
        except Preempted as e:
            print(f"launch.train.main({' '.join(argv)}) with a SIGTERM after step "
                  f"{PREEMPT_AT - 1}: {e}")
        finally:
            launch_train.build_train_step = real
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt) if d.startswith("step_"))
        if steps != [5, PREEMPT_AT - 1]:
            return f"launch.train: checkpoints at steps {steps}, want [5, {PREEMPT_AT - 1}]"
        step_dir = Path(ckpt) / f"step_{PREEMPT_AT - 1:08d}"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        target = {"params": {name[len("params/"):]: torch.empty(
            m["shape"], dtype=getattr(torch, m["dtype"]), device=dev)
            for name, m in manifest["leaves"].items()}}
        restored, _, extra = restore_tree(ckpt, target, PREEMPT_AT - 1)

        def sha(t):
            t = t.cpu()
            raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
            return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]

        bad = [k for k, t in restored["params"].items()
               if t.device != dev or sha(t) != manifest["leaves"][f"params/{k}"]["sha"]]
        print(f"the preemption checkpoint (step {PREEMPT_AT - 1}, data_step "
              f"{extra['data_step']}): {len(restored['params'])} parameters restored on "
              f"{dev}, {len(restored['params']) - len(bad)} hash-equal to the saved")
        if bad:
            return f"launch.train: restored parameters differ from the saved: {bad[:4]}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = launch_train.main(argv + ["--resume"])
        print(buf.getvalue().rstrip())
        print(f"launch.train.main(... --resume) -> {out}")
        if f"resumed from step {PREEMPT_AT - 1}" not in buf.getvalue():
            return "launch.train --resume did not start at the preemption's step"
        if not np.isfinite(out["final_loss"]):
            return f"launch.train --resume: final loss {out['final_loss']}"
    return None


def timed_steps(step, state, batches, dev, n):
    """Run ``n`` steps of ``step`` on ``batches`` (each ends in a read of the
    loss); (state, losses, wall ms each, host ms to issue each)."""
    losses, wall, host = [], [], []
    for toks, labs in batches[:n]:
        t0 = time.perf_counter()
        state, metrics = step(state, toks, labs)
        host.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        wall.append((time.perf_counter() - t0) * 1e3)
    return state, losses, wall, host


def mesh_training(mesh, smi, dev, cfg=None, batch=None, check_batch=None, seq=None):
    """Phase 10 (a): the launcher's mesh layout of a training step against
    no mesh; None, or a failure message."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.archs import granite_8b
    from repro_torch.data import DataConfig, SyntheticSource, TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import LM
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.runtime import TrainConfig, build_train_step, init_state, model_loss

    cfg = cfg or dataclasses.replace(granite_8b(), n_layers=MESH_LAYERS,
                                     name=f"granite-8b-cut{MESH_LAYERS}")
    batch, check_batch, seq = batch or MESH_BATCH, check_batch or MESH_CHECK_BATCH, seq or MESH_SEQ
    opt = adamw(cosine_warmup(TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL))
    tc = TrainConfig(max_grad_norm=1.0)

    def batches(b, n, seq=seq):
        pipe = TokenPipeline(SyntheticSource(DataConfig(global_batch=b, seq_len=seq,
                                                        vocab=cfg.vocab)))
        return [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in next(pipe))
                for _ in range(n)]

    # the float32 check: one step of the same state, with and without the mesh
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = LM(cfg32, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params = dict(model.named_parameters())
    toks, labs = batches(check_batch, 1)[0]

    def loss(p, t, l):
        return model_loss(model, p, t, l)

    plain, m1 = build_train_step(loss, opt, tc, donate=False)(init_state(params, opt, tc),
                                                              toks, labs)
    plain = {k: v.detach() for k, v in plain.params.items()}
    rules, specs, dparams = launch_train.layout_params(model, params, mesh)
    state, m2 = build_train_step(loss, opt, tc, mesh=mesh, rules=rules)(
        init_state(dparams, opt, tc), toks, labs)
    loss_err = abs(float(m1["loss"]) - float(m2["loss"]))
    param_err = max(float((state.params[k].full_tensor() - v).abs().max())
                    for k, v in plain.items())
    kinds = sorted({str(p) for sp in specs.values() for p in sp})
    print(f"mesh step {cfg32.name} float32, batch {check_batch} x {seq}, on a (1, 1) "
          f"(data, model) mesh over one NCCL rank (specs use {kinds}): loss "
          f"{float(m2['loss']):.6f} against {float(m1['loss']):.6f} with no mesh, |err| "
          f"{loss_err:.3e} (tol {MESH_LOSS_TOL:.0e}); parameters max|err| {param_err:.3e} "
          f"(tol {MESH_PARAM_TOL:.0e}); on {smi}")
    del model, params, plain, dparams, state
    torch.cuda.empty_cache()
    if not (loss_err <= MESH_LOSS_TOL and param_err <= MESH_PARAM_TOL):
        return f"mesh step: loss |err| {loss_err}, parameters {param_err}"

    # bfloat16 at batch x seq: the same steps with and without the mesh
    steps = batches(batch, MESH_STEPS + 1)
    small = batches(HOST_BATCH, MESH_STEPS, seq=HOST_SEQ)
    rec = {}
    for label in ("no mesh", "mesh"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = LM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        params = dict(model.named_parameters())
        kw = {}
        if label == "mesh":
            rules, _, params = launch_train.layout_params(model, params, mesh)
            kw = dict(mesh=mesh, rules=rules)

        def loss(p, t, l, model=model):
            return model_loss(model, p, t, l)

        step = build_train_step(loss, opt, tc, **kw)
        state, losses, wall, host = timed_steps(step, init_state(params, opt, tc), steps, dev,
                                                MESH_STEPS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, metrics = step(state, *steps[MESH_STEPS])
            float(metrics["loss"])
            prof_ms = (time.perf_counter() - t0) * 1e3
        busy, _ = card_busy_ms(prof)
        peak = torch.cuda.max_memory_allocated()
        state, _, small_wall, small_host = timed_steps(step, state, small, dev, MESH_STEPS)
        rec[label] = dict(med=float(np.median(wall[1:])), host=float(np.median(host[1:])),
                          peak=peak, losses=losses, idle=max(0.0, 1 - busy / prof_ms),
                          busy=busy, prof_ms=prof_ms, small_host=float(np.median(small_host[1:])),
                          small_wall=float(np.median(small_wall[1:])))
        r = rec[label]
        print(f"mesh step {cfg.name} bfloat16, batch {batch} x {seq}, {label}: median "
              f"{r['med']:.1f} ms over steps 1..{MESH_STEPS - 1} (first {wall[0]:.1f}), host "
              f"issue {r['host']:.1f} ms median; peak memory {r['peak']} B; step "
              f"{MESH_STEPS} under torch.profiler: card busy {busy:.1f} of {prof_ms:.1f} ms, "
              f"idle share {r['idle']:.3f}; losses {[round(x, 4) for x in losses]}; at batch "
              f"{HOST_BATCH} x {HOST_SEQ}: host issue {r['small_host']:.1f} ms, step "
              f"{r['small_wall']:.1f} ms (medians of steps 1..{MESH_STEPS - 1}); on {smi}")
        del model, params, state, step, prof
        if not all(np.isfinite(losses)):
            return f"mesh step bfloat16 ({label}): a loss is not finite: {losses}"
    a, b = rec["mesh"], rec["no mesh"]
    print(f"DTensor's host cost of a step (batch {HOST_BATCH} x {HOST_SEQ}): issue "
          f"{a['small_host']:.1f} ms against {b['small_host']:.1f} ms with no mesh "
          f"(+{a['small_host'] - b['small_host']:.1f} ms); at {batch} x {seq}: step "
          f"{a['med']:.1f} against {b['med']:.1f} ms ({a['med'] / b['med']:.3f}x), idle share "
          f"{a['idle']:.3f} against {b['idle']:.3f}, peak {a['peak']} against {b['peak']} B; "
          f"on {smi}")
    torch.cuda.empty_cache()
    return None


def mesh_ep(mesh, smi, dev, moe_cfg=None, tokens=None):
    """Phase 10 (b): expert parallelism against the capacity path and the
    dense oracle; None, or a failure message."""
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.archs import jamba_52b
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.params import init_params
    from repro_torch.parallel.context import use_mesh, use_rules
    from repro_torch.parallel.sharding import make_rules

    mcfg = moe_cfg or dataclasses.replace(jamba_52b().moe_config(), moe_impl="ep")
    tokens = tokens or MOE_TOKENS
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(moe_mod.moe_defs(mcfg), gen, dtype=torch.float32, device=dev)
    x = torch.randn((1, tokens, mcfg.d_model), generator=gen, device=dev)

    def ep(p, x):
        with use_mesh(mesh), use_rules(make_rules()):
            return moe_mod.moe_apply_ep(p, x, mcfg)

    y_ep, aux_ep = ep(params, x)
    y_cap, aux_cap = moe_mod.moe_apply_capacity(params, x, mcfg)
    y_ref, _ = moe_mod.moe_ref(params, x, mcfg)
    # the positions every one of whose slots the capacity kept
    top_e, _, _ = moe_mod._router(params, x.reshape(tokens, -1), mcfg)
    flat = top_e.reshape(-1)
    onehot = (flat[:, None] == torch.arange(mcfg.n_experts, device=dev)).long()
    pos = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1)
    kept = (pos < moe_mod.capacity(mcfg, tokens)).reshape(tokens, mcfg.top_k).all(-1)
    scale = float(y_cap.abs().max())
    err_cap = float((y_ep - y_cap).abs().max()) / scale
    err_ref = float((y_ep - y_ref)[0][kept].abs().max()) / scale
    print(f"EP {tokens} tokens, {mcfg.n_experts} experts top-{mcfg.top_k}, d {mcfg.d_model}, "
          f"d_ff {mcfg.d_ff}, float32, on the (1, 1) mesh: against capacity max|err| "
          f"{err_cap:.3e} of max|y| (aux {float(aux_ep):.6f} / {float(aux_cap):.6f}), against "
          f"moe_ref {err_ref:.3e} on the {int(kept.sum())} of {tokens} positions kept (tol "
          f"{EP_TOL:.0e}); on {smi}")
    del y_ep, y_cap, y_ref
    if not (err_cap <= EP_TOL and err_ref <= EP_TOL):
        return f"EP: max|err| {err_cap} against capacity, {err_ref} against moe_ref"

    p16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    x16 = x.to(torch.bfloat16)
    del params
    for label, fn in (("capacity", lambda: moe_mod.moe_apply_capacity(p16, x16, mcfg)),
                      ("EP", lambda: ep(p16, x16))):
        for _ in range(2):
            fn()
        calls = [event_ms(fn) for _ in range(MOE_ITERS)]
        ms = float(np.median([c[1] for c in calls]))
        host = float(np.median([c[2] for c in calls]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy, rows = card_busy_ms(prof)
        # the NCCL kernels (the exchanges), each once: not their "nccl:" annotations
        a2a = [(e.self_device_time_total / 1e3, e.key, e.count) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.key.startswith("ncclDevKernel")]
        print(f"{label} bfloat16, {tokens} tokens: {ms:.3f} ms median of {MOE_ITERS} (CUDA "
              f"events), host issue {host:.3f} ms; under torch.profiler the card busy "
              f"{busy:.3f} ms; NCCL kernels {sum(t for t, _, _ in a2a):.3f} ms in "
              f"{sum(n for _, _, n in a2a)} launches; on {smi}")
        for t, key, n in sorted(rows, reverse=True)[:6]:
            print(f"  {t:10.3f} ms  {n:5d}x  {key}")
    return None


def start_dryruns(groups):
    """Start each of ``DRYRUN_GROUPS``'s ``groups`` in a process of its own
    on the host; {group: process}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return {g: subprocess.Popen([sys.executable, "-c", DRYRUN_SCRIPT,
                                 json.dumps(DRYRUN_GROUPS[g])],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=env, cwd=ROOT) for g in groups}


def stop(procs):
    """Kill and reap every process of ``procs`` still running."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def drive_mesh(smi, dev=None, early=None):
    """Phase 10: the mesh path on one card — (a) the sharded training step,
    (b) EP against capacity, (c) the dry-run, each group in a process of
    its own (``early``: {group: process} already started); None, or a
    failure message."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    dev = dev or torch.device("cuda", 0)
    early = early or {}
    dries = [*early.values(),
             *start_dryruns([g for g in DRYRUN_GROUPS if g not in early]).values()]
    try:
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                    world_size=1)
            try:
                mesh = make_mesh((1, 1), ("data", "model"), "cuda")
                msg = mesh_training(mesh, smi, dev) or mesh_ep(mesh, smi, dev)
            finally:
                dist.destroy_process_group()
        if msg:
            return msg
        cells = {}
        for dry in dries:
            out, err = dry.communicate(timeout=DRYRUN_TIMEOUT)
            if dry.returncode != 0:
                return f"dry-run exited {dry.returncode}: {err[-2000:]}"
            cells.update(json.loads(out.strip().splitlines()[-1]))
        for cell, r in cells.items():
            print(f"dry-run {cell} placeholder ranks (step on "
                  f"{r['mesh_view']}; the card's host): chips {r['chips']}, per-device bytes "
                  f"{r['per_device_bytes']} (parameters {r['param_bytes_per_device']}), FLOPs "
                  f"{r['cost']['flops']:.4e} ({r['cost']['product_flops']:.4e} in products), "
                  f"bytes {r['cost']['bytes']:.4e}, wire bytes {r['collectives']['by_op']}, "
                  f"bound {r['bound']} ({r['roofline']['step_s'] * 1e3:.3f} ms), "
                  f"wall_s {r['wall_s']:.1f}; {smi}")
            if not (r["ok"] and r["cost"]["flops"] > 0
                    and r["cost"]["product_flops"] * r["chips"] >= r["model_flops"]):
                return f"dry-run {cell}: {r}"
            if r["wall_s"] >= DRYRUN_TIMEOUT:
                return f"dry-run {cell} took {r['wall_s']:.1f} s, over {DRYRUN_TIMEOUT} s"
        for want in ("granite-3-2b x train_4k on 2x16x16", "deepseek-v3-671b x train_4k on 2x16x16"):
            if want not in cells:
                return f"dry-run: no {want} cell ({sorted(cells)})"
        return None
    finally:
        stop(dries)


def drive_examples(smi, kreg):
    """Phase 11: the six examples in process on the card; (launches by
    kernel over the phase, wall seconds by example), or a failure message."""
    import copy

    import torch

    from repro_torch.examples import (
        heatmap_gallery, optimize_gemm, quickstart, serve_lm, serve_long_context, train_lm,
    )

    out_dir = ROOT / "build" / "chip_smoke_examples"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    launches, walls = {}, {}

    def run(label, module, argv):
        """``module.main(argv)`` with the counts set to 0 just before it;
        its report goes to a log, its last lines and wall time here."""
        kreg.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = module.main(argv)
        walls[label] = time.perf_counter() - t0
        counts = {k: n for k, n in kreg.launch_counts().items() if n}
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        (out_dir / f"{label}.log").write_text(buf.getvalue())
        tail = buf.getvalue().rstrip().splitlines()[-3:]
        print(f"example {label} ({' '.join(argv)}): wall {walls[label]:.3f} s on {smi}; "
              f"launches {counts}")
        for line in tail:
            print(f"  | {line}")
        return got, counts

    # quickstart: v00 and v01 through ops.matmul, and the modeled fix
    got, counts = run("quickstart", quickstart,
                      ["--device", "cuda", "--out", str(out_dir / "quickstart")])
    print(f"quickstart: transfers {got['transfers']}, max|v00 - v01| {got['max_abs_diff']:.3e} "
          f"(tol 1e-3) on {got['device']}")
    if not (counts.get("gemm_v00", 0) >= 1 and counts.get("gemm_v01", 0) >= 1):
        return f"quickstart launched {counts}, not gemm_v00 and gemm_v01"
    if not got["transfers"]["v01"] <= got["transfers"]["v00"]:
        return f"quickstart: v01's transfers above v00's: {got['transfers']}"
    if not got["max_abs_diff"] <= 1e-3 or not Path(got["report"]).is_file():
        return f"quickstart: max|v00 - v01| {got['max_abs_diff']}, report {got['report']}"

    # optimize_gemm: every rung launched and checked, the ladder's direction
    got, counts = run("optimize_gemm", optimize_gemm, ["--device", "cuda"])
    rungs = ("v00", "v01", "v02")
    per_row = [got[r]["per_row"] for r in rungs]
    print(f"optimize_gemm: transfers per C row {per_row}; kernel ms a call on the card "
          f"{[got[r]['run']['device_ms'] for r in rungs]}, event medians "
          f"{[got[r]['run']['ms'] for r in rungs]} on {smi}; max|err| vs plain "
          f"{[got[r]['run']['max_abs_err'] for r in rungs]}")
    for r in rungs:
        if counts.get(f"gemm_{r}", 0) < 1 or got[r]["run"]["device_ms"] is None:
            return f"optimize_gemm: gemm_{r} was not launched on the card ({counts})"
    if not per_row[0] >= per_row[1] >= per_row[2]:
        return f"optimize_gemm: transfers per row do not fall v00 -> v01 -> v02: {per_row}"

    # heatmap_gallery: a bundle per iteration, an entry per family's rung
    got, counts = run("heatmap_gallery", heatmap_gallery,
                      ["--device", "cuda", "--out", str(out_dir / "gallery")])
    families = kreg.names()
    want = {"baseline": [(n, kreg.get(n).variants[0].name) for n in families],
            "optimized": [(n, kreg.get(n).variants[-1].name) for n in families]}
    if got["rungs"] != want:
        return f"heatmap_gallery: rungs {got['rungs']}, want {want}"
    for label, index in got["bundles"].items():
        entries = sorted(q.stem for q in Path(index).parent.glob("*.csv"))
        if not Path(index).is_file() or entries != sorted(families):
            return f"heatmap_gallery {label}: bundle {index} holds {entries}"
    kernels = {kreg.get(n).variant(v).kernel.__name__ for rungs_ in want.values()
               for n, v in rungs_ if kreg.get(n).variant(v).kernel is not None}
    missing = sorted(k for k in kernels if counts.get(k, 0) < 1)
    print(f"heatmap_gallery: {len(families)} families x 2 rungs, "
          f"{len(got['runs'])} runs on the card, kernels launched {sorted(kernels)}")
    if missing:
        return f"heatmap_gallery: {missing} not launched"

    # serve_lm: every request ends; every greedy request as a direct decode of
    # its own, and as the same Server gives it on the CPU on these weights
    got, _ = run("serve_lm", serve_lm, ["--device", "cuda"])
    reqs = got["requests"]
    if not all(r.done and len(r.out_tokens) == serve_lm.MAX_TOKENS for r in reqs) \
            or len(reqs) != serve_lm.N_REQUESTS:
        return f"serve_lm: {[(r.rid, r.done, len(r.out_tokens)) for r in reqs]}"
    greedy = [r for r in reqs if r.temperature == 0.0]
    direct = {r.rid: direct_greedy(got["model"], r.prompt, serve_lm.MAX_TOKENS, 128,
                                   torch.float32) for r in greedy}
    alone = [r.rid for r in greedy if r.out_tokens != direct[r.rid]]
    on_cpu, _, _ = serve_lm.serve(copy.deepcopy(got["model"]).to("cpu"), 0)
    cpu = {r.rid: r.out_tokens for r in on_cpu if r.temperature == 0.0}
    differ = [r.rid for r in greedy if r.out_tokens != cpu[r.rid]]
    print(f"serve_lm: {len(reqs)} requests done, {got['tokens_per_s']:.1f} tokens/s, "
          f"{got['ticks']} ticks in {got['seconds']:.3f} s on {smi}; greedy requests "
          f"{sorted(direct)} against a batch-1 prefill + decode_step each: "
          f"{'all equal' if not alone else f'{alone} DIFFERENT'}; against the same Server on "
          f"the CPU on these weights: {'all equal' if not differ else f'{differ} DIFFERENT'}")
    if alone:
        return (f"serve_lm: greedy requests {alone} gave "
                f"{[r.out_tokens for r in greedy if r.rid in alone]}, their direct decodes "
                f"{[direct[rid] for rid in alone]}")
    if differ:
        return (f"serve_lm: greedy requests {differ} gave "
                f"{[r.out_tokens for r in greedy if r.rid in differ]} on the card, "
                f"{[cpu[rid] for rid in differ]} on the CPU")
    # again, warm: the first run pays the process's first launches of each op
    again, _ = run("serve_lm_warm", serve_lm, ["--device", "cuda"])
    if [r.out_tokens for r in again["requests"] if r.temperature == 0.0] != \
            [r.out_tokens for r in greedy]:
        return "serve_lm: a second run gave other greedy tokens"
    print(f"serve_lm, warm: {again['tokens_per_s']:.1f} tokens/s, {again['ticks']} ticks in "
          f"{again['seconds']:.3f} s on {smi}")
    del got, again

    # serve_long_context: per-token ms with the card's name and limit
    got, _ = run("serve_long_context", serve_long_context, ["--device", "cuda"])
    for plen, r in got["rows"].items():
        print(f"serve_long_context: prefill {plen}: SSM {r['ssm_ms']:.4f} ms/token "
              f"({r['ssm_mb']:.2f} MB of state), GQA {r['gqa_ms']:.4f} ms/token "
              f"({r['gqa_mb']:.2f} MB of cache) on {got['device']}")
    if got["device"] != smi or not all(r["ssm_ms"] > 0 and r["gqa_ms"] > 0
                                       for r in got["rows"].values()):
        return f"serve_long_context: {got}"

    # train_lm: cut at two steps; the steps between equal the run not yet cut
    base = ["--device", "cuda", "--steps", str(EXAMPLE_STEPS)]
    runs = {}
    for cut in EXAMPLE_CUTS:
        runs[cut], _ = run(f"train_lm_cut{cut}", train_lm, base + ["--restart-at", str(cut)])
    mesh, _ = run("train_lm_mesh", train_lm, base + [
        "--restart-at", str(EXAMPLE_CUTS[0]), "--mesh", "1x1"])
    a, b = EXAMPLE_CUTS
    after, whole = runs[a]["losses"][a:b], runs[b]["losses"][a:b]
    mesh_err = max(abs(x - y) for x, y in zip(mesh["losses"], runs[a]["losses"]))
    print(f"train_lm: losses {runs[a]['losses']} (cut at {a}); steps {a}-{b - 1} after the "
          f"restore {after}, the run cut at {b} {whole}: "
          f"{'equal' if after == whole else 'DIFFERENT'}; on a (1, 1) mesh "
          f"{mesh['losses']}, max|err| {mesh_err:.3e} (tol {EXAMPLE_MESH_TOL}); {smi}")
    if after != whole:
        return f"train_lm: after the restore {after}, uninterrupted {whole}"
    if not mesh_err <= EXAMPLE_MESH_TOL or mesh["mesh"] != {"data": 1, "model": 1}:
        return f"train_lm on a (1, 1) mesh: max|err| {mesh_err}, mesh {mesh['mesh']}"
    return launches, walls


def drive_gate(cli, kreg, load_iteration, smi):
    """Phase 12, the regression gate on the card: {kernel name: launches
    made by the phase's commands}, or a failure message."""
    import tempfile

    import torch

    from repro_torch.core.session import heatmaps_equal

    card = torch.cuda.get_device_name(0)
    wrappers = kreg.wrappers()
    launches = {}

    def counted(argv, want_rc, must=()):
        kreg.reset_launch_counts()
        rc, _ = run_cli(cli, argv)
        made = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        print(f"launches: {made}")
        for name, count in made.items():
            launches[name] = launches.get(name, 0) + count
        if rc != want_rc:
            return f"{' '.join(argv[:2])} exited {rc}, not {want_rc}"
        missing = [name for name in must if made.get(name, 0) < 1]
        if missing:
            return f"{' '.join(argv)} did not launch {missing}"
        return None

    def ran_on_card(kernels):
        for pk in kernels:
            run = pk.run or {}
            if run.get("device") != card or run.get("launches", 0) < 1 or not run.get("device_ms"):
                return f"gate {pk.name}:{pk.variant}: no run on the card ({run})"
            print(f"gate {pk.name}:{pk.variant}: modeled transfers {pk.transactions}, "
                  f"max|err| vs plain {run['max_abs_err']:.3e}, {card_ms(run)} "
                  f"at {run['shapes']} on {smi}")
        return None

    def checked(doc_path, want_rc, it_dir, extra):
        msg = counted(["check", str(it_dir), "--baseline", str(GATE_BASELINE),
                       "--json", str(doc_path), *extra], want_rc)
        return msg, (None if msg else json.loads(doc_path.read_text()))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        tmp = Path(tmp)
        argv = ["profile"]
        for ref in GATE_REFS:
            argv += ["--kernel", ref]
        msg = counted(argv + ["--device", "cuda", "--out", str(tmp / "cand"), "-q"], 0,
                      GATE_MUST)
        if msg:
            return msg
        cand = tmp / "cand" / "iter0"
        fresh = load_iteration(cand).kernels
        msg = ran_on_card(fresh)
        if msg:
            return msg
        msg, doc = checked(tmp / "check-pass.json", 0, cand, [])
        if msg:
            return msg
        status = {k["kernel"]: k["status"] for k in doc["kernels"]}
        if (doc["format"], doc["schema_version"], doc["passed"]) != ("cuthermo-check", 1, True) \
                or status != {ref.split(":")[0]: "pass" for ref in GATE_REFS}:
            return (f"check against {GATE_BASELINE.name}: format {doc['format']}, schema "
                    f"{doc['schema_version']}, passed {doc['passed']}, statuses {status}")
        base = {pk.name: pk for pk in load_iteration(GATE_BASELINE).kernels}
        for pk in fresh:
            if not heatmaps_equal(pk.heatmap, base[pk.name].heatmap):
                return f"gate {pk.name}: the card's heat map differs from the committed one"
        print(f"gate: {sorted(status)} pass against {GATE_BASELINE.name}, heat maps "
              f"equal to the committed ones")

        msg = counted(["profile", "--kernel", "gemm:v00", "--device", "cuda",
                       "--out", str(tmp / "detiled"), "-q"], 0, ("gemm_v00",))
        msg = msg or ran_on_card(load_iteration(tmp / "detiled" / "iter0").kernels)
        if msg:
            return msg
        msg, doc = checked(tmp / "check-fail.json", 1, tmp / "detiled" / "iter0",
                           ["--threshold", "missing=off"])
        if msg:
            return msg
        if doc["passed"] or not any("modeled transfers" in f for f in doc["failures"]):
            return f"check of gemm:v00: passed {doc['passed']}, failures {doc['failures']}"
        print(f"gate: gemm:v00 rejected with exit 1: {doc['failures'][0]}")
    return launches


def drive_main_path(cli, kreg, load_iteration, smi, dev):
    """Phase 3, the main path: (launches by kernel of the families' runs,
    of Granite-20B's decode step, of the bfloat16 step at Jamba's widths,
    of the full-width model run), or a failure message.  Phases 4-5 read
    what it leaves: its sessions under ``build/chip_smoke_session`` and
    each rung's time alone (``ALONE_MS``)."""
    import numpy as np
    import torch

    from repro_torch.kernels import (
        gemm, gramschm, histogram, ops, paged_attn, ragged_flash, ref, spmv, ttm,
    )

    # family -> [(registry ref, kernel name or None, counting wrapper or None)]
    families = {
        "gemm": [(f"gemm:{v}", f"gemm_{v}", fn) for v, fn in gemm.KERNELS.items()],
        "spmv": [(f"spmv:{v}", None, None) for v in kreg.get("spmv").variant_names()],
        "histogram": [
            (f"histogram:{v}", fn.__name__, fn) for v, fn in histogram.KERNELS.items()
        ],
        "gramschm": [
            (f"gramschm:{v}", f"gramschm_k3_{v}", fn)
            for v, fn in gramschm.KERNELS.items()
        ],
        "ttm": [(f"ttm:{v}", f"ttm_{v}", fn) for v, fn in ttm.KERNELS.items()],
    }
    # the serving families: the decode rungs launch, the prefill rungs are spec only
    for family, fn in (("ragged_flash", ragged_flash.ragged_decode_attention),
                       ("paged_attn", paged_attn.paged_decode_attention)):
        families[family] = [
            (f"{family}:{v}", fn.__name__, fn) if v.startswith("decode") else (f"{family}:{v}", None, None)
            for v in kreg.get(family).variant_names()
        ]
    launches = {}
    for family, members in families.items():
        sess = ROOT / "build" / "chip_smoke_session" / family
        shutil.rmtree(sess, ignore_errors=True)
        kreg.reset_launch_counts()
        for kref, _, _ in members:
            rc, _ = run_cli(cli, ["profile", "-k", kref, "--out", str(sess), "-q"])
            if rc != 0:
                return f"profile {kref} exited {rc}"
        counts = {name: fn.launches for _, name, fn in members if fn is not None}
        for (a, b), lines in STORIES[family].items():
            rc, out = run_cli(cli, ["diff", str(sess / f"iter{a}"), str(sess / f"iter{b}")])
            if rc != 0:
                return f"diff {family} iter{a} iter{b} exited {rc}"
            for line in lines:
                if line not in out:
                    return f"diff {family} iter{a} iter{b} does not show {line!r}"
        rc, _ = run_cli(cli, ["report", str(sess / f"iter{len(members) - 1}")])
        if rc != 0:
            return f"report {family} exited {rc}"
        print(f"main-path launches ({family}): {counts}")
        for name, count in counts.items():
            if count < 1:
                return f"{name} was not launched by the main path"
        launches.update(counts)
        for i, (kref, _, _) in enumerate(members):
            pk = load_iteration(sess / f"iter{i}").kernels[0]
            classes = sorted(f"{r.pattern}@{r.region}" for r in pk.reports)
            if pk.run:
                ALONE_MS[(pk.name, pk.variant)] = pk.run["device_ms"]
            measured = (
                f"measured {card_ms(pk.run)} on {pk.run['device']}"
                if pk.run else "spec only"
            )
            print(f"{kref} modeled transfers {pk.transactions}, patterns {classes}, {measured}")

    # spmv_ell's entry point is ops.spmv (the spmv family is spec-only)
    vals, xg, csr = spmv_inputs(
        kreg.SPMV_SHAPE[0], SPMV_WIDTH, dev, np.random.default_rng(2)
    )
    kreg.reset_launch_counts()
    y = ops.spmv(vals, xg)
    torch.cuda.synchronize()
    launches["spmv_ell"] = spmv.spmv_ell.launches
    print(f"main-path launches (ops.spmv): {{'spmv_ell': {launches['spmv_ell']}}}")
    if launches["spmv_ell"] < 1:
        return "spmv_ell was not launched by ops.spmv"
    want = ref.spmv_ref(vals, xg)
    tol = 1e-5 * float(want.abs().max())
    if tuple(y.shape) != (vals.shape[0],) or not bool(torch.isfinite(y).all()):
        return f"ops.spmv: output {tuple(y.shape)} is not finite of {vals.shape[0]} rows"
    err = float((y - want).abs().max())
    err_exact = float(np.abs(y.double().cpu().numpy() - ref.spmv_csr_ref(*csr)).max())
    print(f"ops.spmv {tuple(vals.shape)}: max|err| {err:.3e}, vs float64 CSR {err_exact:.3e} (tol {tol:.3e})")
    if not (err <= tol and err_exact <= tol):
        return f"ops.spmv: max|err| {err}, vs float64 {err_exact} > {tol}"

    step_launches = drive_serving_step(dev)
    if isinstance(step_launches, str):
        return step_launches

    tc_launches = drive_tensor_core_step(dev)
    if isinstance(tc_launches, str):
        return tc_launches

    model_launches = drive_model_path(cli, kreg, load_iteration, smi)
    if isinstance(model_launches, str):
        return model_launches
    return launches, step_launches, tc_launches, model_launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: no CUDA device")
    t_start = t_phase = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import cli
    from repro_torch import kernels as kreg
    from repro_torch.core.session import load_iteration
    from repro_torch.kernels import _build, gemm

    # -- phase 1: the card, and the build ----------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, {card}")
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        for line in Path(f"{path}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    hmma = check_tensor_cores(_build)
    if isinstance(hmma, str):
        return fail(hmma)

    t_phase = phase_took("1", t_phase)

    # -- phase 2: each kernel against its plain version ----------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    m, n, k = SHAPE
    rng = np.random.default_rng(0)
    a_np = rng.standard_normal((m, k), dtype=np.float32)
    b_np = rng.standard_normal((k, n), dtype=np.float32)
    rows = {}
    # bring the card to its working clocks before the first timed call
    warm = torch.from_numpy(a_np).to(dev)
    kreg.cuda_time_ms(lambda: torch.matmul(warm, warm), iters=200)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        a = torch.from_numpy(a_np).to(dev, dtype)
        b = torch.from_numpy(b_np).to(dev, dtype)
        want = gemm.gemm_plain(a, b)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        tol = 1e-3 if dtype == torch.float32 else 1e-2 * scale
        # an independent yardstick: the float64 product on the host, so a
        # kernel and a plain version that agree are also right
        exact = a.double().cpu().numpy() @ b.double().cpu().numpy()
        tol_exact = 1e-2 * scale
        plain_ms = kreg.cuda_time_ms(lambda: gemm.gemm_plain(a, b), PLAIN_ITERS)
        lib_t = library_times(kreg, lambda: torch.matmul(a, b))
        bms, bby = bound(m, n, k, dname, a.element_size())
        for v, fn in gemm.KERNELS.items():
            got = fn(a, b)
            torch.cuda.synchronize()
            if tuple(got.shape) != (m, n) or got.dtype != dtype:
                return fail(f"gemm_{v} {dname}: output {got.shape} {got.dtype}")
            if not bool(torch.isfinite(got).all()):
                return fail(f"gemm_{v} {dname}: non-finite output")
            err = float((got.float() - want.float()).abs().max())
            err_exact = float(np.abs(got.double().cpu().numpy() - exact).max())
            rows[(v, dname)] = dict(
                max_abs_err=err, **times(kreg, lambda: fn(a, b)), plain_ms=plain_ms,
                bound_ms=bms, bound_by=bby, **library_fields(lib_t),
                max_abs_err_vs_float64=err_exact,
            )
            rows[(v, dname)].update(registry_host(
                f"gemm_{v} {dname}", lambda: fn(a, b), lambda: torch.matmul(a, b)))
            if f"gemm_{v}" in REPEAT_CHECKED:
                if not torch.equal(fn(a, b), got):
                    return fail(f"gemm_{v} {dname}: a second call gave other bits")
                rec = rows[(v, dname)]
                rec["block_rows"] = gemm.block_rows(m, n, dtype)
                rec["device_kernels_ms"] = device_kernels_ms(lambda: fn(a, b))
                rec["other_tile"] = other_tile(kreg, a, b, got)
                if isinstance(rec["other_tile"], str):
                    return fail(rec["other_tile"])
                print(f"gemm_{v} {dname} {m}x{n}x{k} (tiles of {rec['block_rows']} x 128): a "
                      f"second call gives the same bits; device time by kernel "
                      f"(torch.profiler) {rec['device_kernels_ms']}; host time to issue a "
                      f"call {rec['host_ms']:.4f} ms, torch.matmul's "
                      f"{rec['library_host_ms']:.4f} ms; the other tile height: "
                      f"{rec['other_tile']}")
            print(
                f"gemm_{v} {dname} {m}x{n}x{k}: max|err| {err:.3e} "
                f"(tol {tol:.3e}), vs float64 {err_exact:.3e} (tol "
                f"{tol_exact:.3e}), launches so far {fn.launches}, plain {plain_ms:.4f} ms, "
                f"torch.matmul {card_ms(lib_t)}, {of_bound(bms, bby, rows[(v, dname)])}"
            )
            if not err <= tol:
                return fail(f"gemm_{v} {dname}: max|err| {err} > {tol}")
            if not err_exact <= tol_exact:
                return fail(f"gemm_{v} {dname}: vs float64 {err_exact} > {tol_exact}")

    gemm_large = check_gemm_large(kreg, dev)
    if isinstance(gemm_large, str):
        return fail(gemm_large)
    for dname, rec in gemm_large.items():
        rows[("v02", dname)]["large"] = rec

    cases = check_cases(kreg, dev)
    if isinstance(cases, str):
        return fail(cases)
    scalar = check_spmv_scalar_path(dev)
    if isinstance(scalar, str):
        return fail(scalar)
    cases["spmv_ell"]["scalar_path"] = scalar
    msg = check_out_of_range(dev)
    if msg:
        return fail(msg)
    model_rows = check_model_kernels(kreg, dev)
    if isinstance(model_rows, str):
        return fail(model_rows)
    serving_rows = check_serving_kernels(kreg, dev)
    if isinstance(serving_rows, str):
        return fail(serving_rows)
    registry_times = check_registry_times(kreg, dev)
    if isinstance(registry_times, str):
        return fail(registry_times)
    print(f"host time to issue one call at the registry's shape, ms, beside the library "
          f"call's (none: no library call) on {smi}: {json.dumps(REGISTRY_HOST)}")

    t_phase = phase_took("2", t_phase)

    # -- phase 3: the main path, profile -> diff -> report --------------------
    main_path = drive_main_path(cli, kreg, load_iteration, smi, dev)
    if isinstance(main_path, str):
        return fail(main_path)
    launches, step_launches, tc_launches, model_launches = main_path

    t_phase = phase_took("3", t_phase)

    # -- phase 4: the closed tuning loop ----------------------------------------
    tune_launches = drive_tuning_loop(cli, kreg, smi)
    if isinstance(tune_launches, str):
        return fail(tune_launches)
    t_phase = phase_took("4", t_phase)

    # -- phase 5: sharded collection, fault recovery, resume --------------------
    scale_launches = drive_scale_out(cli, kreg, smi, load_iteration)
    if isinstance(scale_launches, str):
        return fail(scale_launches)
    t_phase = phase_took("5", t_phase)

    # -- phase 6: the model forward at full width --------------------------------
    msg = drive_model_forward(smi)
    if msg:
        return fail(msg)
    t_phase = phase_took("6", t_phase)

    # -- phase 7: serving Granite-8B whole -----------------------------------------
    msg = drive_serving(smi)
    if msg:
        return fail(msg)
    t_phase = phase_took("7", t_phase)

    # -- phase 8: training at Granite-8B's widths -------------------------------------
    # phase 4's static checks, which need neither the card nor a quiet host,
    # and the dry-run's longest groups start here, each on one of the host's
    # cores, beside phase 8's steps, which the card bounds; phase 10 reads
    # the dry-runs
    lint = start_lint()
    early = start_dryruns(EARLY_DRYRUNS)
    try:
        msg = drive_training(smi) or read_lint(lint, "beside phase 8's steps", smi)
        if msg:
            return fail(msg)
        t_phase = phase_took("8", t_phase)

        # -- phase 10: the mesh path on one card --------------------------------------
        msg = drive_mesh(smi, early=early)
        if msg:
            return fail(msg)
        t_phase = phase_took("10", t_phase)
    finally:
        stop([*early.values(), lint])

    # -- phase 11: the six examples on the card ---------------------------------------
    examples = drive_examples(smi, kreg)
    if isinstance(examples, str):
        return fail(examples)
    example_launches, example_walls = examples
    walls = json.dumps({k: round(v, 3) for k, v in example_walls.items()})
    t_phase = phase_took("11", t_phase, f"; wall by example {walls} on {smi}")

    # -- phase 12: the regression gate against the committed baseline ------------------
    gate_launches = drive_gate(cli, kreg, load_iteration, smi)
    if isinstance(gate_launches, str):
        return fail(gate_launches)
    phase_took("12", t_phase, f" on {smi}")

    # -- phase 9: the record --------------------------------------------------
    kernels = []
    for v in gemm.KERNELS:
        row = rows[(v, "float32")]
        kernels.append(
            dict(
                name=f"gemm_{v}", route="cuda", source=SOURCE,
                replaces=REPLACES[v], launches=launches[f"gemm_{v}"], **row,
                bf16=rows[(v, "bfloat16")],
            )
        )
    for name, row in cases.items():
        kernels.append(
            dict(
                name=name, route="cuda", replaces=REPLACES[name],
                launches=launches[name], **row,
            )
        )
    # the model path's kernels: launches of the full-width run (float32),
    # and of the bfloat16 step on the tensor cores (flash, gmm, ssd)
    lib_of = {"flash_attention": "flash", "gmm": "gmm", "ssd_chunk": "ssd"}
    for name, row in model_rows.items():
        extra = {}
        if name in lib_of:
            extra = dict(bf16_step_launches=tc_launches[name],
                         hmma_per_function=hmma[lib_of[name]])
        kernels.append(
            dict(
                name=name, route="cuda", replaces=REPLACES[name],
                launches=model_launches[name], **extra, **row,
            )
        )
    # the serving kernels: launches of their families' profile -> diff ->
    # report run, and of the Granite-20B decode step
    for name, row in serving_rows.items():
        kernels.append(
            dict(
                name=name, route="cuda", replaces=REPLACES[name],
                launches=launches[name], decode_step_launches=step_launches[name], **row,
            )
        )
    # what the records were measured on, kept apart from the measurements;
    # and the launches of phase 4's tune commands (0: not on the tune path)
    for row in kernels:
        row["config"] = dict(row.get("config", {}), card=smi)
        row["tune_launches"] = tune_launches.get(row["name"], 0)
        row["scale_out_launches"] = scale_launches.get(row["name"], 0)
        row["examples_launches"] = example_launches.get(row["name"], 0)
        row["gate_launches"] = gate_launches.get(row["name"], 0)
        row["registry_times"] = {ref: t for ref, t in registry_times.items()
                                 if t["kernel"] == row["name"]}
    PHASE_TIMES["total"] = round(time.perf_counter() - t_start, 1)
    print(f"chip_smoke.py took {PHASE_TIMES['total']:.1f} s on {smi}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(f"phase times: {json.dumps(PHASE_TIMES)}")
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": card,
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
