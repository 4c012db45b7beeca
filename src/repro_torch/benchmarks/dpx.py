"""Figs. 6/7 analog: DPX function latency and throughput.

Fused (one kernel calling Hopper's DPX instruction,
``kernels/dpx_kernel.dpx_fused``) vs emulated (the same math as separate
torch ops, one kernel each, the pre-Hopper software sequence), across
int32/int16, plus the DP kernels built on them (tropical matmul,
Smith-Waterman).  Measured rows carry the device's label.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks import device_label
from repro_torch.core import dpx
from repro_torch.core.bench import register
from repro_torch.core.timer import Timing, measure_jitted
from repro_torch.kernels import ops

RNG = np.random.default_rng(13)


def _ints(lo, hi, shape, dtype, device) -> torch.Tensor:
    return torch.from_numpy(RNG.integers(lo, hi, shape)).to(
        device=device, dtype=dtype)


@register("dpx_functions", "Figs. 6/7")
def dpx_functions(device):
    rows = []
    label = device_label(device)
    n = 1 << 16
    for dtype in (torch.int32, torch.int16):
        dt = str(dtype).replace("torch.", "")
        a, b, c = (_ints(-100, 100, n, dtype, device) for _ in range(3))
        for name in ("viaddmax", "viaddmax_relu", "vimax3"):
            tf = measure_jitted(dpx.FUSED[name], (a, b, c),
                                name=f"measured({label})/fused/{name}/{dt}",
                                warmup=3, reps=8, inner=4)
            te = measure_jitted(dpx.EMULATED[name], (a, b, c),
                                name=f"measured({label})/emulated/{name}/{dt}",
                                warmup=3, reps=8, inner=4)
            tf.derived = te.us_per_call / max(tf.us_per_call, 1e-9)
            tf.derived_name = "fused_speedup"
            rows.extend([tf, te])
    # paper reference: H800 16-bit relu variants up to 13x vs emulation
    rows.append(Timing("paper/H800/16bit_relu_max_speedup", 0, 0, 1,
                       derived=13.0))
    return rows


@register("dpx_kernels", "Figs. 6/7 (application)")
def dpx_kernels(device):
    rows = []
    label = device_label(device)
    a = _ints(-50, 50, (64, 64), torch.int32, device)
    b = _ints(-50, 50, (64, 64), torch.int32, device)
    t = measure_jitted(lambda x, y: ops.tropical_matmul(x, y), (a, b),
                       name=f"measured({label})/kernel/tropical_matmul_64",
                       warmup=2, reps=5)
    t.derived = 64 ** 3 / (t.us_per_call * 1e-6) / 1e9
    t.derived_name = "G_DP_cells_per_s"
    rows.append(t)

    sa = _ints(0, 4, (4, 64), torch.int32, device)
    sb = _ints(0, 4, (4, 64), torch.int32, device)
    t = measure_jitted(lambda x, y: ops.smith_waterman(x, y), (sa, sb),
                       name=f"measured({label})/kernel/smith_waterman_4x64x64",
                       warmup=2, reps=5)
    t.derived = 4 * 64 * 64 / (t.us_per_call * 1e-6) / 1e9
    t.derived_name = "G_DP_cells_per_s"
    rows.append(t)
    return rows
