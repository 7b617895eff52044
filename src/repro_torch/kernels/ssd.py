"""The Mamba-2 SSD intra-chunk term, hand-written for Hopper.

``csrc/ssd.cu`` computes, for every (batch*head, chunk) cell with x
(L, P), log-decays a (L,), B and C (L, N), the diagonal-block term and the
chunk's end state of the SSD dual form (``repro/kernels/ssd.py``)::

    y = ((C Bᵀ) ∘ L) x        L[i, j] = exp(cum[i] - cum[j]) for j <= i, else 0
    s = xᵀ (decay ∘ B)        decay[t] = exp(cum[L-1] - cum[t])

with ``cum = cumsum(a)``, float32 sums and both outputs float32.  One block
of 8 warps per cell stages the chunk's x and B in shared memory, and each
warp brings the 4 rows of C of its current row group into a slice of its
own; the decay is masked before the exponential, so a long chunk cannot
overflow into NaN.  ``a``
must hold log-decays (<= 0): a positive ``a`` makes the end-state decay
grow without bound.

The wrapper ``ssd_chunk(x, a, bmat, cmat)`` returns ``(y, s)``, checks its
operands (and that the chunk fits the 227 KB of shared memory a block can
have: it raises rather than launch a kernel the card would refuse),
launches on the current stream and counts its launches in
``ssd_chunk.launches``.  Given CPU tensors it computes the plain version
(``ssd_plain``) instead; given CUDA tensors it launches the kernel or
raises.  ``ssd_chunk_spec`` describes what each warp of the CUDA kernel
touches under the H100 sector geometry.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.collector import KernelSpec, OperandSpec

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256
WARPS = THREADS // 32
#: y rows per warp group, and the widest head the kernel's registers hold.
ROWS = 4
MAX_P = 128
#: Shared memory a block can opt in to on an H100 (227 KB).
MAX_SMEM = 232448
_GRID_Y_MAX = 65535


def smem_bytes(l: int, p: int, n: int) -> int:
    """Shared memory of one block (``csrc/ssd.cu``): x and B of the chunk
    (B's rows padded to N + 1), cum and the end-state decays, the warps'
    4 x 33 score tiles, and each warp's 4 rows of C (padded to N + 1)."""
    return 4 * (l * p + l * (n + 1) + 2 * l + WARPS * ROWS * 33 + WARPS * ROWS * (n + 1))


def _check_operands(x, a, bmat, cmat) -> None:
    """Raise on anything the kernel does not take."""
    if not all(isinstance(t, torch.Tensor) for t in (x, a, bmat, cmat)):
        raise TypeError("ssd operands x, a, bmat, cmat must be torch tensors")
    if x.dim() != 4 or a.dim() != 3 or bmat.dim() != 4 or bmat.shape != cmat.shape:
        raise ValueError(
            f"ssd needs x (BH, C, L, P), a (BH, C, L) and bmat, cmat "
            f"(BH, C, L, N), got {tuple(x.shape)}, {tuple(a.shape)}, "
            f"{tuple(bmat.shape)}, {tuple(cmat.shape)}"
        )
    if tuple(a.shape) != tuple(x.shape[:3]) or tuple(bmat.shape[:3]) != tuple(x.shape[:3]):
        raise ValueError(
            f"a {tuple(a.shape)} and bmat {tuple(bmat.shape)} do not match "
            f"x {tuple(x.shape)}"
        )
    if not (x.dtype == a.dtype == bmat.dtype == cmat.dtype) or x.dtype not in _DTYPES:
        raise TypeError(
            f"ssd takes float32 or bfloat16 operands of one dtype, got "
            f"{x.dtype}, {a.dtype}, {bmat.dtype}, {cmat.dtype}"
        )
    if not (x.device == a.device == bmat.device == cmat.device) or x.device.type not in (
        "cpu", "cuda",
    ):
        raise ValueError("ssd operands must share one cpu or cuda device")
    if not all(t.is_contiguous() for t in (x, a, bmat, cmat)):
        raise ValueError("ssd operands must be contiguous (row-major)")
    bh, c, l, p = x.shape
    n = bmat.shape[-1]
    if min(bh, c, l, p, n) < 1 or p > MAX_P or bh > _GRID_Y_MAX or c >= 2**31:
        raise ValueError(
            f"unsupported ssd shape bh={bh} c={c} l={l} p={p} n={n} "
            f"(p <= {MAX_P}, bh <= {_GRID_Y_MAX})"
        )
    need = smem_bytes(l, p, n)
    if need > MAX_SMEM:
        raise ValueError(
            f"an ssd chunk of L={l}, P={p}, N={n} needs {need} bytes of shared "
            f"memory (smem_bytes), above the limit of {MAX_SMEM} a block can have"
        )


def ssd_plain(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (y (BH, C, L, P), s (BH, C, P, N)), float32.

    As the Pallas kernel, the scores and the decayed x are rounded to x's
    type before their products (a no-op in float32; the JAX oracle
    ``ssd_chunk_ref`` does not round).  The decay is masked before the
    exponential.
    """
    cum = torch.cumsum(a.float(), dim=-1)
    l = a.shape[-1]
    seg = cum[..., :, None] - cum[..., None, :]
    keep = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    # masked to 0 before the exp and to 0 after it (an exp of -inf lanes is
    # sometimes off by 1e-4 on the first CPU call in a process)
    dec = torch.exp(seg.masked_fill(~keep, 0.0)).masked_fill(~keep, 0.0)
    scores = torch.matmul(cmat.float(), bmat.float().transpose(-1, -2)) * dec
    y = torch.matmul(scores.to(x.dtype).float(), x.float())
    decay = torch.exp(cum[..., -1:] - cum)
    xw = (x.float() * decay[..., None]).to(x.dtype).float()
    s = torch.matmul(xw.transpose(-1, -2), bmat.float())
    return y, s


def tolerance(want: torch.Tensor, x: torch.Tensor, *_) -> float:
    """The largest |kernel - plain| accepted on ``want``, either output of
    the plain version for ``x``, as a share of its largest value.  float32:
    each decay is the exp of a difference of two cumulative sums of up to L
    log-decays, each rounded to float32 at |cum| (~0.3 L on the seeded
    inputs), so the decays agree to ~1e-5 at L = 256; bfloat16: a score or
    a decayed x rounded on the other side of a bf16 step.
    """
    share = 3e-5 if x.dtype == torch.float32 else 1e-2
    return share * float(want.float().abs().max())


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def ssd_chunk(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
              cmat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, s) of every (batch*head, chunk) cell with ``csrc/ssd.cu``."""
    _check_operands(x, a, bmat, cmat)
    if x.device.type == "cpu":
        return ssd_plain(x, a, bmat, cmat)
    bh, c, l, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty((bh, c, l, p), dtype=torch.float32, device=x.device)
    s = torch.empty((bh, c, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _build.call(
            "ssd", "repro_ssd_chunk", _ARGTYPES,
            x.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            y.data_ptr(), s.data_ptr(), bh, c, l, p, n, _DTYPES[x.dtype], stream,
        )
    ssd_chunk.launches += 1
    return y, s


ssd_chunk.launches = 0

KERNELS = {"ssd": ssd_chunk}


# ---------------------------------------------------------------------------
# profiler spec: what each warp of the CUDA kernel touches
# ---------------------------------------------------------------------------


def warp_elems(total: int, w: int) -> np.ndarray:
    """Elements ``e < total`` that warp ``w`` touches when thread ``e mod
    256`` of the block handles element ``e``: runs of 32 at stride 256."""
    starts = np.arange(32 * w, total, THREADS, dtype=np.int64)
    idx = (starts[:, None] + np.arange(32, dtype=np.int64)).reshape(-1)
    return idx[idx < total]


def warp_rows(l: int, w: int) -> np.ndarray:
    """Rows of y that warp ``w`` computes: groups ``w, w + 8, ...`` of 4."""
    groups = np.arange(w, -(-l // ROWS), WARPS, dtype=np.int64)
    rows = (groups[:, None] * ROWS + np.arange(ROWS, dtype=np.int64)).reshape(-1)
    return rows[rows < l]


def ssd_chunk_spec(
    bh: int, c: int, l: int, p: int, n: int, dtype=np.float32
) -> KernelSpec:
    """Warp footprints of ``ssd_chunk_kernel`` (``csrc/ssd.cu``).

    Program ``(h, ch, w)`` is warp ``w`` (0..7) of the block of cell
    ``(h, ch)``, over a grid ``(bh, c, 8)``.  It stages elements ``e`` of
    the cell's x and B with ``e mod 256`` in ``[32w, 32w + 32)``; it reads
    the rows of C of its row groups (``warp_rows``) in full; warp 0 reads
    the cell's ``a``; it stores the rows of y of its row groups and the
    elements of the (P, N) state ``s`` with ``e mod 256`` in ``[32w, 32w +
    32)``.  Index walks, as the row groups interleave.  Shared memory is
    not modeled.
    """

    def cell(pid) -> int:
        return pid[0] * c + pid[1]

    def x_walk(pid, **_):
        return cell(pid) * l * p + warp_elems(l * p, pid[2])

    def b_walk(pid, **_):
        return cell(pid) * l * n + warp_elems(l * n, pid[2])

    def c_walk(pid, **_):
        rows = warp_rows(l, pid[2])
        return cell(pid) * l * n + (rows[:, None] * n + np.arange(n)).reshape(-1)

    def a_walk(pid, **_):
        if pid[2] != 0:
            return np.empty(0, np.int64)
        return cell(pid) * l + np.arange(l, dtype=np.int64)

    def y_walk(pid, **_):
        rows = warp_rows(l, pid[2])
        return cell(pid) * l * p + (rows[:, None] * p + np.arange(p)).reshape(-1)

    def s_walk(pid, **_):
        return cell(pid) * p * n + warp_elems(p * n, pid[2])

    def spec_of(name, shape, dt, kind="load"):
        return OperandSpec(name, shape, dt, shape, lambda h, ch, w: (0,) * len(shape),
                           kind=kind)

    return KernelSpec(
        name="ssd_chunk",
        grid=(bh, c, WARPS),
        operands=(
            spec_of("X", (bh, c, l, p), dtype),
            spec_of("A", (bh, c, l), dtype),
            spec_of("B", (bh, c, l, n), dtype),
            spec_of("C", (bh, c, l, n), dtype),
            spec_of("Y", (bh, c, l, p), np.float32, kind="store"),
            spec_of("S", (bh, c, p, n), np.float32, kind="store"),
        ),
        dynamic=(("X", x_walk), ("A", a_walk), ("B", b_walk), ("C", c_walk),
                 ("Y", y_walk), ("S", s_walk)),
    )
