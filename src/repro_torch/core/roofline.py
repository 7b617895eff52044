"""Three-term roofline model for one NVIDIA H100 SXM.

    compute term    = FLOPs per device      / peak FLOP/s
    memory term     = bytes per device      / HBM bandwidth
    collective term = wire bytes per device / NVLink bandwidth

The port's counterpart of the JAX package's ``repro/core/roofline.py``
(whose constants are a TPU v5e's).  The terms here come from NVIDIA's
H100 SXM datasheet, dense rates without sparsity, at the full 700 W
power limit (a card set lower runs slower under load):

  * 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside
    them (the peak a run is held to is the one of its dtype:
    ``peak_flops``);
  * 3.35 TB/s of HBM3, 80 GB of it;
  * NVLink 4: 900 GB/s per GPU counting both directions, so 450 GB/s
    each way.  The collective term divides the bytes a device sends by
    the per-direction rate (:data:`LINK_BW`).

``from_raw`` takes the op-level sweep's counts
(:mod:`repro_torch.core.op_cost`), ``from_heatmap`` a kernel heat map's
modeled transfers.  The reference's ``from_compiled`` reads an XLA
compiled module and has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

# NVIDIA H100 SXM (datasheet, dense, 700 W)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s on the tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s outside the tensor cores
HBM_BW = 3.35e12  # B/s
NVLINK_BW_BIDIR = 900e9  # B/s per GPU, both directions together
LINK_BW = NVLINK_BW_BIDIR / 2  # B/s each way: what the collective term uses
HBM_PER_CHIP = 80e9  # B


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three terms (seconds per step) and their inputs.

    ``hlo_flops`` / ``hlo_bytes`` / ``collective_bytes`` are per device
    (what one card executes and moves; the names are the reference's);
    ``model_flops`` is the global useful work.
    """

    name: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float  # wire bytes per device
    model_flops: float = 0.0  # 2*N*D or 6*N*D useful work (global)
    peak_flops: float = PEAK_FLOPS_BF16

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def step_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_fraction(self) -> float:
        """MODEL_FLOPS / (chips * counted FLOPs)."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total > 0 else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        if self.step_s <= 0:
            return 0.0
        return self.model_flops / (self.step_s * self.chips * self.peak_flops)

    @property
    def roofline_fraction(self) -> float:
        """compute_s / step_s (1.0 = compute-bound at peak)."""
        return self.compute_s / self.step_s if self.step_s > 0 else 0.0

    def share_of_bound(self, measured_s: float) -> float:
        """The roofline step time over a measured one: 1.0 = at the bound."""
        return self.step_s / measured_s if measured_s > 0 else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "peak_flops": self.peak_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "step_s": self.step_s,
            "mfu": self.mfu,
            "useful_flop_fraction": self.useful_flop_fraction,
            "roofline_fraction": self.roofline_fraction,
        }

    def summary(self) -> str:
        return (
            f"{self.name}: compute {self.compute_s*1e3:.2f}ms | "
            f"memory {self.memory_s*1e3:.2f}ms | "
            f"collective {self.collective_s*1e3:.2f}ms -> {self.bound}-bound; "
            f"useful-FLOP {100*self.useful_flop_fraction:.0f}%, "
            f"MFU@roofline {100*self.mfu:.1f}%"
        )


def from_heatmap(
    name: str,
    hm,
    chips: int = 1,
    flops: float = 0.0,
    model_flops: float = 0.0,
    collective_bytes: float = 0.0,
    peak_flops: float = PEAK_FLOPS_BF16,
) -> RooflineTerms:
    """Build terms from a kernel heat map's modeled transfers: every
    modeled transaction of an HBM region moves one sector
    (``geometry.sector_bytes``), so the heat map's sector temperatures are
    the byte-traffic model."""
    hlo_bytes = 0.0
    for rh in hm.regions:
        if rh.region.space != "hbm":
            continue
        hlo_bytes += float(int(rh.sector_temps_array.sum()) * rh.region.geometry.sector_bytes)
    return RooflineTerms(
        name=name,
        chips=chips,
        hlo_flops=flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops,
        peak_flops=peak_flops,
    )


def from_raw(
    name: str,
    chips: int,
    hlo_flops: float,
    hlo_bytes: float,
    collective_bytes: float,
    model_flops: float = 0.0,
    peak_flops: float = PEAK_FLOPS_BF16,
) -> RooflineTerms:
    return RooflineTerms(
        name=name,
        chips=chips,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops,
        peak_flops=peak_flops,
    )
