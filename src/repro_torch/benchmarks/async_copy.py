"""Tables XIII/XIV analog: sync vs async staged data movement.

The paper's globalToShmemAsyncCopy: tiled matmul where global->shared
copies either block (SyncShare) or pipeline stages deep (AsyncPipe).
Here: ``pipelined_matmul`` (kernels/async_pipeline.py), stages=1 (one
TMA buffer: copy, wait, compute) vs stages 2 and 3 (a TMA + mbarrier
ring: the next slices' copies in flight while one computes), swept over
block sizes.
Measured rows carry the device's TFLOP/s; the model rows carry the
overlap speedup t_sync / t_async with t_sync = t_copy + t_compute and
t_async = max(t_copy, t_compute) at ``hw.TARGET``'s memory and float32
rates — the regime logic behind the paper's 39.5% small-block win
shrinking to -1.8% at 32x32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.benchmarks import device_label, tflops
from repro_torch.core import hw
from repro_torch.core.bench import register
from repro_torch.core.timer import Timing, measure
from repro_torch.kernels import ops

RNG = np.random.default_rng(17)


def _model_speedup(bm: int, bk: int, n: int, dtype_bytes: int = 4
                   ) -> float:
    chip = hw.TARGET
    t_copy = 2 * bm * bk * dtype_bytes / (chip.hbm_gbps * 1e9)
    t_comp = 2 * bm * bk * n / chip.peak_for("float32")
    t_sync = t_copy + t_comp
    t_async = max(t_copy, t_comp)
    return t_sync / t_async


@register("async_copy", "Tables XIII/XIV")
def async_copy(device):
    rows = []
    label = device_label(device)
    M = K = 128
    N = 64
    a = torch.from_numpy(RNG.standard_normal((M, K))).to(
        device=device, dtype=torch.float32)
    b = torch.from_numpy(RNG.standard_normal((K, N))).to(
        device=device, dtype=torch.float32)
    for bs in (16, 32, 64):
        for stages, name in ((1, "SyncShare"), (2, "AsyncPipe"),
                             (3, "AsyncPipe3")):
            t = measure(
                lambda bs=bs, st=stages: ops.pipelined_matmul(
                    a, b, bm=bs, bn=min(bs, N), bk=bs, stages=st),
                name=f"measured({label})/{name}/block{bs}", warmup=1, reps=3)
            t.derived = tflops(2 * M * N * K, t.us_per_call)
            t.derived_name = f"TFLOPs({label})"
            rows.append(t)
    # paper reference points
    rows.append(Timing("paper/H800/8x8_async_gain", 0, 0, 1,
                       derived=1.395))
    rows.append(Timing("paper/H800/32x32_async_gain", 0, 0, 1,
                       derived=0.982))
    # model: small blocks copy-bound (speedup ~2x), big blocks
    # compute-bound (speedup ~1x)
    for bs in (8, 16, 32, 64, 128):
        rows.append(Timing(f"model({hw.TARGET.name})/block{bs}", 0, 0, 1,
                           derived=_model_speedup(bs, bs, N)))
    return rows
