"""repro_torch.examples — the JAX package's six example scripts, ported.

Each runs as ``python -m repro_torch.examples.<name>`` and keeps its
reference's steps and printed report (``examples/<name>.py``):

  * ``quickstart`` — the paper's loop on gemm v00 -> v01 through a session;
  * ``optimize_gemm`` — the v00 -> v01 -> v02 ladder, round by round;
  * ``heatmap_gallery`` — every registry family's first and last rung;
  * ``serve_lm`` — continuous batching of 10 requests on a 4-layer LM;
  * ``serve_long_context`` — per-token decode cost, SSM against GQA;
  * ``train_lm`` — training with checkpoints and a simulated restart.

Every example takes ``--device`` (default ``cuda``) and ``--seed``, and
draws its values from ``torch.Generator``s seeded from it.  Without a
card, ``--device cuda`` raises: nothing drops to the CPU unasked.  Each
``main(argv)`` returns what it measured, so a caller can check it.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess

import torch


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """``--device`` and ``--seed``, as every example takes them."""
    ap.add_argument("--device", default="cuda",
                    help="where tensors live and kernels run (default: cuda; 'cpu' "
                    "runs the plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generator the example draws from (default: 0)")


def device_of(name: str) -> torch.device:
    """``name`` as a device; a CUDA device with no card visible raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass --device cpu to run on the CPU")
    return dev


def card_label(dev: torch.device) -> str:
    """What a time was taken on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if shutil.which("nvidia-smi"):
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(index)}, power limit not read"
