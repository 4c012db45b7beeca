"""Steady-state measurement harness.

Mirrors the paper's methodology (III-B-2): explicit warmup, many
repetitions inside the timed region, and throughput computed from
elapsed time (never from clock-cycle counts, which drift with
frequency — the paper makes exactly this point for the H800 power
limit).

A sample of work whose output lies on a CUDA device is timed with CUDA
events around its `inner` calls (PyTorch returns before the device
finishes, so a host clock would time the enqueue); any other work is
timed with the host clock.  The first warm-up call's output decides
which clock, so at least one warm-up call is made.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Optional, Sequence

import torch


@dataclasses.dataclass
class Timing:
    name: str
    us_per_call: float
    std_us: float
    reps: int
    # Optional derived metric, e.g. TFLOP/s or GB/s; filled by callers.
    derived: Optional[float] = None
    derived_name: str = ""

    def row(self) -> str:
        d = f"{self.derived:.3f}" if self.derived is not None else ""
        return f"{self.name},{self.us_per_call:.3f},{d}"


def _cuda_device(tree: Any) -> Optional[torch.device]:
    """The CUDA device of the first CUDA tensor in `tree`, if any."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            dev = _cuda_device(x)
            if dev is not None:
                return dev
    return None


def _block(tree: Any) -> None:
    dev = _cuda_device(tree)
    if dev is not None:
        torch.cuda.synchronize(dev)


def measure(
    fn: Callable[[], Any],
    *,
    name: str = "",
    warmup: int = 3,
    reps: int = 10,
    inner: int = 1,
) -> Timing:
    """Time `fn` (already arg-bound); returns trimmed-mean microseconds.

    `inner`: calls per timed sample (amortizes dispatch overhead, the
    analog of the paper's 1024-iteration unrolled kernels).
    """
    out = None
    for _ in range(max(warmup, 1)):
        out = fn()
        _block(out)
    dev = _cuda_device(out)
    samples = []
    for _ in range(reps):
        if dev is not None:
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(inner):
                    fn()
                end.record()
                end.synchronize()
            samples.append(start.elapsed_time(end) * 1e3 / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            samples.append((time.perf_counter() - t0) / inner * 1e6)
    samples.sort()
    trimmed = samples[: max(1, int(len(samples) * 0.8))]  # drop slowest 20%
    return Timing(
        name=name,
        us_per_call=statistics.mean(trimmed),
        std_us=statistics.pstdev(trimmed) if len(trimmed) > 1 else 0.0,
        reps=reps,
    )


def measure_graph(
    fn: Callable[[], Any],
    *,
    name: str = "",
    calls: int = 10,
    reps: int = 3,
) -> Timing:
    """Device time of one call of CUDA work: `calls` calls captured in
    one CUDA graph (no host time between launches), replayed once to
    warm and then `reps` times, each replay timed with CUDA events.
    One eager call first (it builds and loads what the capture needs)."""
    _block(fn())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e3 / calls)
    del graph
    return Timing(name=name, us_per_call=statistics.mean(samples),
                  std_us=statistics.pstdev(samples), reps=reps)


def measure_jitted(
    fn: Callable[..., Any],
    args: Sequence[Any],
    *,
    name: str = "",
    warmup: int = 3,
    reps: int = 10,
    inner: int = 1,
) -> Timing:
    """One untimed first call (where the reference compiles; here it
    builds and loads a kernel on first use), then steady state."""
    _block(fn(*args))
    return measure(lambda: fn(*args), name=name, warmup=warmup, reps=reps,
                   inner=inner)
