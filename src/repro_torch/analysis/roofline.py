"""Roofline terms of a step from its operation, byte and collective counts.

    compute term    = FLOPs / peak
    memory term     = bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

All inputs are per device, as in the JAX package (``chips`` only divides
the whole-model FLOPs of the useful-compute ratio).  The arithmetic is the
JAX package's; the default hardware is the card the port runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HWSpec:
    """One NVIDIA H100 SXM5 80GB at its 700 W limit, NVIDIA's data sheet
    values (dense rates, no sparsity): 989 TFLOP/s in bf16 (the default
    peak), 67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM3,
    450 GB/s of NVLink in each direction.  A card set below 700 W runs
    slower than these."""
    peak_flops: float = 989e12      # bf16 / fp16 dense
    hbm_bw: float = 3.35e12         # bytes/s
    link_bw: float = 450e9          # bytes/s, NVLink, one direction
    peak_flops_fp32: float = 67e12  # fp32, CUDA cores

    def fp32(self) -> "HWSpec":
        """The same card with the fp32 rate as its peak."""
        return dataclasses.replace(self, peak_flops=self.peak_flops_fp32)


HW = HWSpec()


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_accessed: float
    collective_bytes: float
    model_flops: Optional[float] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        if self.model_flops is None or self.flops <= 0:
            return None
        return self.model_flops / self.flops

    def as_row(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "flops": self.flops, "bytes": self.bytes_accessed,
                "coll_bytes": self.collective_bytes,
                "model_flops": self.model_flops,
                "useful_ratio": self.useful_flops_ratio}


def roofline_terms(per_device_flops: float, per_device_bytes: float,
                   per_device_collective_bytes: float,
                   model_flops_total: Optional[float] = None,
                   chips: int = 1, hw: HWSpec = HW) -> RooflineTerms:
    """All inputs per device; ``model_flops_total`` is the whole-model
    figure and gets divided by ``chips`` for the useful-compute ratio."""
    return RooflineTerms(
        compute_s=per_device_flops / hw.peak_flops,
        memory_s=per_device_bytes / hw.hbm_bw,
        collective_s=per_device_collective_bytes / hw.link_bw,
        flops=per_device_flops,
        bytes_accessed=per_device_bytes,
        collective_bytes=per_device_collective_bytes,
        model_flops=(model_flops_total / chips
                     if model_flops_total is not None else None))
