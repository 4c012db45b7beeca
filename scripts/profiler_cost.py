#!/usr/bin/env python3
"""What torch.profiler costs around one training step of full-width
zamba2-2.7b cut to 2 super-blocks (12 layers, remat dots, B=2 x 2048,
random float32 parameters, seed 0), the step chip_smoke.py phase 13
profiles: the step's wall time under the profiler and the time to read
its device kernels, with host-side op records (CPU and CUDA activity,
read through prof.events()) and without them (CUDA activity alone, read
from the raw trace, as chip_smoke.py reads it, then through
prof.events()).  Each reading's event count and device ms are printed;
the two readings of the device-only run must agree exactly.

    PYTHONPATH=src python3 scripts/profiler_cost.py

It prints the card's name and power limit, then a line a run and a
line a reading.
"""

from __future__ import annotations

import collections
import dataclasses
import subprocess
import tempfile
import time


def _by_events(prof):
    from torch.autograd import DeviceType
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            by_name[e.name] += us / 1e3
    return by_name


def _by_trace(prof):
    from torch.autograd import DeviceType
    by_name = collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] += e.duration_ns() / 1e6
    return by_name


def _count(prof, trace: bool) -> int:
    from torch.autograd import DeviceType
    if trace:
        return sum(1 for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.runtime.trainer import Trainer
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=12,
                              remat="dots")
    cpu_cuda = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as td:
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=100, ckpt_every=10 ** 6, ckpt_dir=td)
        tr = Trainer(cfg, tcfg, data=SyntheticLMData(cfg.vocab_size, 2, 2048),
                     device="cuda")
        tr.init()
        tr.run(2)
        torch.cuda.synchronize()
        runs = {}
        for label, acts in (("host records + device", cpu_cuda),
                            ("device alone", [ProfilerActivity.CUDA])):
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                tr.run(1)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            t2 = time.perf_counter()
            runs[label] = prof
            print(f"{label}: step under the profiler {t1 - t0:.2f} s, "
                  f"profiler exit {t2 - t1:.2f} s", flush=True)
    got = {}
    for label, trace in (("device alone", True), ("device alone", False),
                         ("host records + device", False)):
        prof = runs[label]
        t0 = time.perf_counter()
        by_name = _by_trace(prof) if trace else _by_events(prof)
        n = _count(prof, trace)
        how = "raw trace" if trace else "prof.events()"
        got[(label, how)] = (n, by_name)
        print(f"{label}, read through {how}: {time.perf_counter() - t0:.2f}"
              f" s; {n} device events, {sum(by_name.values()):.3f} device "
              f"ms", flush=True)
    a = got[("device alone", "prof.events()")]
    b = got[("device alone", "raw trace")]
    if a[0] != b[0] or any(abs(a[1][k] - b[1][k]) > 1e-6
                           for k in set(a[1]) | set(b[1])):
        raise SystemExit("the raw trace and prof.events() disagree")
    print("the raw trace gives prof.events()'s device events and ms",
          flush=True)


if __name__ == "__main__":
    main()
