"""Hardware specification registry.

The paper dissects three GPUs (A100 / RTX4090 / H800) and derives a
quantitative hardware model from microbenchmarks.  The port's target is
the NVIDIA H100 SXM (``TARGET``), with its data-sheet peaks.  The
paper's GPUs are kept so parity tables can print the published numbers
next to the measured ones, and ``TPU_V5E`` is kept as a data entry so
the tile model (core/mxu_model.py) can be driven with the reference's
chip in the parity tests.

This file holds vendor-published peaks only; every measured rate comes
from a benchmark run on the card.  ``MeshSpec`` describes a production
mesh of such chips for the analytic roofline (core/analytic.py) and the
dry run (launch/dryrun.py): ``SINGLE_POD`` (16 x 16) and ``MULTI_POD``
(2 x 16 x 16), the reference's grids.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Peak specification of one accelerator chip."""

    name: str
    # Peak dense matmul throughput, FLOP/s, by input dtype.
    peak_flops: Dict[str, float]
    hbm_bytes: int
    hbm_gbps: float                 # HBM bandwidth, GB/s (1e9)
    # Software-managed on-chip memory one tile may use (VMEM on a TPU,
    # the shared memory of one thread block on an H100).
    vmem_bytes: int
    # Inter-chip interconnect, per link, GB/s, and links per chip.
    ici_gbps_per_link: float
    ici_links: int
    # Vector unit: lanes × sublanes (TPU VPU is 8×128).
    vpu_lanes: int
    mxu_dim: int                    # matrix unit edge (128 for TPU)
    clock_ghz: float
    tdp_watts: float

    @property
    def ici_gbps_total(self) -> float:
        return self.ici_gbps_per_link * self.ici_links

    def peak_for(self, dtype: str) -> float:
        """Peak FLOP/s for a matmul with inputs of `dtype` (falls back sanely)."""
        d = str(dtype)
        aliases = {
            "float32": "fp32", "bfloat16": "bf16", "float16": "bf16",
            "int8": "int8", "float8_e4m3fn": "fp8", "float8_e5m2": "fp8",
            "fp8_e4m3": "fp8", "fp8_e5m2": "fp8", "tf32": "tf32",
        }
        key = aliases.get(d, d)
        if key in self.peak_flops:
            return self.peak_flops[key]
        # No native unit for this dtype: runs at the bf16 rate after upcast.
        return self.peak_flops.get("bf16", max(self.peak_flops.values()))


# --- TPU v5e: the reference's target, kept as data for the parity tests ---
TPU_V5E = ChipSpec(
    name="tpu-v5e",
    peak_flops={
        "bf16": 197e12,
        "fp32": 197e12 / 4,
        "int8": 394e12,
        "fp8": 197e12,
    },
    hbm_bytes=16 * 1024**3,
    hbm_gbps=819.0,
    vmem_bytes=128 * 1024**2,
    ici_gbps_per_link=50.0,
    ici_links=4,
    vpu_lanes=8 * 128,
    mxu_dim=128,
    clock_ghz=0.94,
    tdp_watts=200.0,
)

# --- The paper's three GPUs (Table III), for parity printing only ---
A100_PCIE = ChipSpec(
    name="a100-pcie",
    peak_flops={"bf16": 312e12, "fp32": 19.5e12, "tf32": 156e12, "int8": 624e12},
    hbm_bytes=40 * 1024**3, hbm_gbps=1555.0, vmem_bytes=40 * 1024**2,
    ici_gbps_per_link=64.0, ici_links=1, vpu_lanes=64, mxu_dim=16,
    clock_ghz=1.41, tdp_watts=250.0,
)
H800_PCIE = ChipSpec(
    name="h800-pcie",
    peak_flops={"bf16": 756.5e12, "fp32": 51e12, "tf32": 378e12,
                "int8": 1513e12, "fp8": 1513e12},
    hbm_bytes=80 * 1024**3, hbm_gbps=2039.0, vmem_bytes=50 * 1024**2,
    ici_gbps_per_link=50.0, ici_links=8, vpu_lanes=128, mxu_dim=16,
    clock_ghz=1.755, tdp_watts=350.0,
)
RTX4090 = ChipSpec(
    name="rtx4090",
    peak_flops={"bf16": 330.3e12, "fp32": 82.6e12, "tf32": 82.6e12,
                "int8": 660.6e12, "fp8": 660.6e12},
    hbm_bytes=24 * 1024**3, hbm_gbps=1008.0, vmem_bytes=72 * 1024**2,
    ici_gbps_per_link=0.0, ici_links=0, vpu_lanes=128, mxu_dim=16,
    clock_ghz=2.52, tdp_watts=450.0,
)

# --- NVIDIA H100 SXM (data sheet, dense rates): the port's target ---
H100_SXM = ChipSpec(
    name="h100-sxm",
    peak_flops={"bf16": 989.4e12, "tf32": 494.7e12, "fp32": 66.9e12,
                "int8": 1978.9e12, "fp8": 1978.9e12},
    hbm_bytes=80 * 1024**3, hbm_gbps=3350.0,
    # shared memory one thread block may use (227 KB of the SM's 256 KB)
    vmem_bytes=232448,
    ici_gbps_per_link=50.0, ici_links=18,     # NVLink 4: 900 GB/s
    vpu_lanes=128, mxu_dim=16,
    clock_ghz=1.98, tdp_watts=700.0,
)

CHIPS: Dict[str, ChipSpec] = {
    c.name: c for c in (TPU_V5E, A100_PCIE, H800_PCIE, RTX4090, H100_SXM)
}

TARGET = H100_SXM


# Per-GPU rate across hosts (the `pod` axis): a DGX H100 gives each of
# its 8 GPUs one 400 Gb/s ConnectX-7 NIC (NVIDIA DGX H100 data sheet),
# 50 GB/s.
DGX_H100_NIC_GBPS = 50.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A production mesh of `chip`s (the reference's ``MeshSpec``).

    Collectives along `data` and `model` get two links' worth of the
    chip's interconnect (the reference's ring over one torus dimension:
    ``2 * chip.ici_gbps_per_link``); the `pod` axis crosses hosts at
    ``dcn_gbps`` a chip."""

    shape: tuple
    axis_names: tuple
    chip: ChipSpec = TARGET
    dcn_gbps: float = DGX_H100_NIC_GBPS   # inter-host rate a chip, GB/s

    @property
    def num_chips(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def axis_bandwidth_gbps(self, name: str) -> float:
        """Per-chip bandwidth available to collectives along `name`."""
        if name == "pod":
            return self.dcn_gbps
        # bidirectional ring: 2 links
        return 2.0 * self.chip.ici_gbps_per_link


SINGLE_POD = MeshSpec(shape=(16, 16), axis_names=("data", "model"))
MULTI_POD = MeshSpec(shape=(2, 16, 16), axis_names=("pod", "data", "model"))
