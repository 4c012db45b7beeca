"""Tables VI-XI analog: tensor-core dissection on the card.

  * mma_table    — single-block kernel latency/throughput per dtype and
                   problem shape (paper Table VII), through
                   ``single_tile_matmul`` (mma.sync on the tensor cores
                   for bf16/int8, fmaf for float32, fed by TMA stages)
  * wgmma_table  — the tiled multi-block kernel (paper Tables VIII/IX),
                   plus the fp8 (QGMMA analog) product
  * n_sweep      — throughput vs output-tile width (paper Table X):
                   measured on the device + tile-model prediction
  * energy_model — modeled TFLOPS/W from data-sheet peaks and TDP
                   (paper Table XI; no power counters are read)

Measured rows carry the device's TFLOP/s in the derived column; model
rows use ``hw.TARGET`` and carry its name.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks import device_label, tflops
from repro_torch.core import hw, mxu_model
from repro_torch.core.bench import register
from repro_torch.core.timer import Timing, measure
from repro_torch.kernels import ops
from repro_torch.kernels.matmul import single_tile_matmul

RNG = np.random.default_rng(3)


def _mk(shape, dtype, device) -> torch.Tensor:
    return torch.from_numpy(RNG.standard_normal(shape)).to(
        device=device, dtype=getattr(torch, dtype))


@register("tc_mma", "Tables VI/VII")
def mma_table(device):
    """Single-block (synchronous mma analog) latency + model columns."""
    rows = []
    chip = hw.TARGET
    label = device_label(device)
    for dtype in ("float32", "bfloat16", "int8"):
        for (m, n, k) in [(128, 128, 128), (128, 256, 128),
                          (256, 256, 256)]:
            if dtype == "int8":
                a = torch.from_numpy(RNG.integers(-8, 8, (m, k))).to(
                    device=device, dtype=torch.int8)
                b = torch.from_numpy(RNG.integers(-8, 8, (k, n))).to(
                    device=device, dtype=torch.int8)
            else:
                a, b = _mk((m, k), dtype, device), _mk((k, n), dtype, device)
            t = measure(lambda a=a, b=b: single_tile_matmul(a, b),
                        name=f"mma/{dtype}/m{m}n{n}k{k}", warmup=2, reps=5)
            t.derived = tflops(2 * m * n * k, t.us_per_call)
            t.derived_name = f"TFLOPs({label})"
            rows.append(t)
            lat_cyc = mxu_model.tile_latency_cycles(m, n, k, dtype)
            rows.append(Timing(
                f"model({chip.name})/mma/{dtype}/m{m}n{n}k{k}/latency_cycles",
                0.0, 0, 1, derived=lat_cyc))
    # paper parity rows (H800 mma finding: only 62.9% of peak)
    rows.append(Timing("paper/H800/mma_avg_peak_fraction", 0, 0, 1,
                       derived=0.629))
    return rows


@register("tc_wgmma", "Tables VIII/IX")
def wgmma_table(device):
    """The tiled kernel at 512^3: bm = bk = 128, bn 128 or 256, float32
    and bf16, and the e4m3 product at 128^3 tiles (QGMMA analog)."""
    rows = []
    label = device_label(device)
    M = N = K = 512
    for dtype in ("float32", "bfloat16"):
        a, b = _mk((M, K), dtype, device), _mk((K, N), dtype, device)
        for bn in (128, 256):
            t = measure(
                lambda a=a, b=b, bn=bn: ops.matmul(a, b, bm=128, bn=bn,
                                                   bk=128),
                name=f"wgmma/{dtype}/bn{bn}", warmup=2, reps=5)
            t.derived = tflops(2 * M * N * K, t.us_per_call)
            t.derived_name = f"TFLOPs({label})"
            rows.append(t)
    # fp8 storage variant (QGMMA analog)
    e4m3 = torch.float8_e4m3fn
    aq = torch.from_numpy(RNG.standard_normal((M, K))).to(e4m3).to(device)
    bq = torch.from_numpy(RNG.standard_normal((K, N))).to(e4m3).to(device)
    sx = torch.ones((), dtype=torch.float32, device=device)
    t = measure(lambda: ops.fp8_matmul(aq, bq, sx, sx, bm=128, bn=128,
                                       bk=128),
                name="wgmma/fp8_e4m3(QGMMA)", warmup=2, reps=5)
    t.derived = tflops(2 * M * N * K, t.us_per_call)
    t.derived_name = f"TFLOPs({label})"
    rows.append(t)
    rows.append(Timing("paper/H800/wgmma_peak_fraction_zero_init", 0, 0, 1,
                       derived=0.95))
    return rows


@register("tc_n_sweep", "Table X")
def n_sweep(device):
    """Throughput vs output-tile width bn — the wgmma N sweep."""
    rows = []
    label = device_label(device)
    for r in mxu_model.n_sweep(chip=hw.TARGET):
        rows.append(Timing(
            f"model({hw.TARGET.name})/bn{int(r['bn'])}", 0.0, 0, 1,
            derived=r["tflops"], derived_name="TFLOPs"))
    M = K = 256
    a = _mk((M, K), "float32", device)
    b = _mk((K, 256), "float32", device)
    for bn in (32, 64, 128, 256):
        t = measure(lambda bn=bn: ops.matmul(a, b, bm=128, bn=bn, bk=128),
                    name=f"measured({label})/bn{bn}", warmup=2, reps=5)
        t.derived = tflops(2 * M * 256 * K, t.us_per_call)
        t.derived_name = f"TFLOPs({label})"
        rows.append(t)
    return rows


@register("tc_energy", "Table XI")
def energy_model(device):
    """Modeled efficiency (TFLOPS/W) from data-sheet peaks and TDP."""
    rows = []
    for chip in hw.CHIPS.values():
        for dtype in ("bf16", "int8"):
            if dtype not in chip.peak_flops:
                continue
            eff = chip.peak_flops[dtype] / 1e12 / chip.tdp_watts
            rows.append(Timing(f"model/{chip.name}/{dtype}", 0.0, 0, 1,
                               derived=eff, derived_name="TFLOPS_per_W"))
    # paper measured: H800 dense mma avg 1.6x A100 efficiency
    rows.append(Timing("paper/H800_vs_A100_dense_eff", 0, 0, 1,
                       derived=1.60))
    return rows
