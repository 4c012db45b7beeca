"""Analytical matrix-unit / memory-hierarchy tile model.

The paper's Tables VII–X measure tensor-core latency/throughput per
instruction shape and derive rules ("use wgmma with N>=64", "sparse SS
mode cannot hide shared-memory traffic").  Here the unit of that sweep
is a matmul *tile* (bm, bn, bk) staged through on-chip memory.

This module is the quantitative model those sweeps are set beside:

  * tile alignment efficiency  (partial matrix-unit passes waste lanes)
  * on-chip working set        (tiles + pipeline stages must fit)
  * device-memory traffic      (A read N/bn times, B read M/bm times)
  * compute-vs-memory bound    -> predicted sustained FLOP/s
  * single-tile latency        (the "completion latency" analog)

The chip is passed in (``hw.TARGET``, the H100, by default); the peaks,
memory rate and on-chip capacity come from it.  The alignment and
latency terms are still the reference's 128-wide systolic form (a
128x128 array fed 8 sublanes at a time), not Hopper's: given
``hw.TPU_V5E`` every number here equals the reference's, and a wgmma
model fitted to the measured Hopper tables is later work.

`pick_tile` is the autotuner the kernel wrappers consume.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core import hw

_IN_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1,
             "float8_e4m3fn": 1, "float8_e5m2": 1}
_MXU = 128          # systolic edge
_SUBLANE = 8        # sublane granularity (second-minor dim)


def _ru(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def in_bytes(dtype: str) -> int:
    return _IN_BYTES.get(str(dtype), 4)


def alignment_efficiency(bm: int, bn: int, bk: int) -> float:
    """Fraction of matrix-unit lanes doing useful work for one tile.

    Output rows pack at sublane granularity (8); output cols and the
    contraction feed the 128-wide systolic dimensions.
    """
    eff_m = bm / _ru(bm, _SUBLANE)
    eff_n = bn / _ru(bn, _MXU)
    eff_k = bk / _ru(bk, _MXU)
    return eff_m * eff_n * eff_k


def tile_latency_cycles(bm: int, bn: int, bk: int, dtype: str = "bfloat16") -> float:
    """Completion latency (cycles) of one tile matmul.

    Analog of the paper's mma/wgmma LAT columns: passes*128 issue cycles
    plus a fill+drain of ~2*128. fp32 runs at 1/4 rate (multi-pass).
    """
    passes = (_ru(bm, _MXU) // _MXU) * (_ru(bn, _MXU) // _MXU) * (_ru(bk, _MXU) // _MXU)
    rate = 4.0 if str(dtype) == "float32" else 1.0
    return passes * _MXU * rate + 2 * _MXU


def vmem_working_set(bm: int, bn: int, bk: int, dtype: str,
                     stages: int = 2, acc_bytes: int = 4) -> int:
    """Bytes of on-chip memory a pipelined tile needs (stages x input
    buffers + acc)."""
    ib = in_bytes(dtype)
    return stages * (bm * bk + bk * bn) * ib + bm * bn * acc_bytes


@dataclasses.dataclass
class MatmulModel:
    M: int
    N: int
    K: int
    bm: int
    bn: int
    bk: int
    dtype: str
    chip: hw.ChipSpec
    stages: int = 2

    @property
    def flops(self) -> float:
        return 2.0 * self.M * self.N * self.K

    @property
    def hbm_bytes(self) -> float:
        """Device-memory traffic for the (m,n) grid with k innermost."""
        ib = in_bytes(self.dtype)
        n_rep = math.ceil(self.N / self.bn)   # times A streams in
        m_rep = math.ceil(self.M / self.bm)   # times B streams in
        out_b = 2 if self.dtype != "float32" else 4
        return (self.M * self.K * ib * n_rep
                + self.K * self.N * ib * m_rep
                + self.M * self.N * out_b)

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.hbm_bytes

    @property
    def compute_s(self) -> float:
        eff = alignment_efficiency(self.bm, self.bn, self.bk)
        peak = self.chip.peak_for(self.dtype)
        return self.flops / (peak * max(eff, 1e-9))

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chip.hbm_gbps * 1e9)

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def predicted_flops_per_s(self) -> float:
        return self.flops / max(self.compute_s, self.memory_s)

    @property
    def utilization(self) -> float:
        return self.predicted_flops_per_s / self.chip.peak_for(self.dtype)

    def fits_vmem(self) -> bool:
        return (vmem_working_set(self.bm, self.bn, self.bk, self.dtype,
                                 self.stages) <= self.chip.vmem_bytes * 0.9)


def candidate_tiles(M: int, N: int, K: int) -> Iterable[Tuple[int, int, int]]:
    ms = [m for m in (128, 256, 512) if m <= _ru(M, _SUBLANE)] or [_ru(M, _SUBLANE)]
    ns = [n for n in (128, 256, 512, 1024) if n <= _ru(N, _MXU)] or [_ru(N, _MXU)]
    ks = [k for k in (128, 256, 512, 1024, 2048) if k <= _ru(K, _MXU)] or [_ru(K, _MXU)]
    for bm in ms:
        for bn in ns:
            for bk in ks:
                yield bm, bn, bk


def pick_tile(M: int, N: int, K: int, dtype: str = "bfloat16",
              chip: hw.ChipSpec = hw.TARGET, stages: int = 2) -> MatmulModel:
    """Autotuner: best-predicted tile that fits on-chip memory."""
    best: Optional[MatmulModel] = None
    for bm, bn, bk in candidate_tiles(M, N, K):
        m = MatmulModel(M, N, K, bm, bn, bk, dtype, chip, stages)
        if not m.fits_vmem():
            continue
        if best is None or m.predicted_flops_per_s > best.predicted_flops_per_s:
            best = m
    assert best is not None, "no tile fits VMEM"
    return best


def n_sweep(M: int = 4096, K: int = 4096, dtype: str = "bfloat16",
            chip: hw.ChipSpec = hw.TARGET,
            ns: Tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512)
            ) -> List[Dict[str, float]]:
    """Table X analog: predicted throughput vs output-tile width bn.

    Mirrors the paper's finding that wgmma needs N>=64 to hide operand
    traffic: small bn collapses arithmetic intensity and the tile goes
    memory-bound.
    """
    rows = []
    for bn in ns:
        m = MatmulModel(M, bn * 16, K, 128, bn, 512, dtype, chip)
        rows.append({
            "bn": bn,
            "ai": m.arithmetic_intensity,
            "align_eff": alignment_efficiency(128, bn, 512),
            "tflops": m.predicted_flops_per_s / 1e12,
            "bound": 1.0 if m.bound == "compute" else 0.0,
            "latency_cycles": tile_latency_cycles(128, bn, 512, dtype),
        })
    return rows
