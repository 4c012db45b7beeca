"""Benchmark registry.

Each paper table/figure is one registered benchmark returning rows of
``name,us_per_call,derived``.  A registered function takes the device
it runs on, ``fn(device)``.  ``repro_torch.benchmarks.run`` iterates
the registry.
"""

from __future__ import annotations

import dataclasses
import traceback
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.timer import Timing
from repro_torch.models.common import resolve_device

BenchFn = Callable[[torch.device], List[Timing]]

_REGISTRY: Dict[str, "Benchmark"] = {}


@dataclasses.dataclass
class Benchmark:
    name: str
    paper_ref: str           # e.g. "Table IV"
    fn: BenchFn
    tags: tuple = ()


def register(name: str, paper_ref: str, tags: tuple = ()):
    def deco(fn: BenchFn) -> BenchFn:
        _REGISTRY[name] = Benchmark(name=name, paper_ref=paper_ref, fn=fn,
                                    tags=tags)
        return fn
    return deco


def registry() -> Dict[str, Benchmark]:
    return dict(_REGISTRY)


def run_all(names: Optional[List[str]] = None, fail_fast: bool = False,
            device=None) -> int:
    """Run (a subset of) the registry on `device` (the CUDA device
    unless the caller names one; without CUDA that raises), printing
    CSV.  Returns #failures."""
    device = resolve_device(device)
    failures = 0
    print("name,us_per_call,derived")
    for bname, bench in _REGISTRY.items():
        if names and bname not in names:
            continue
        print(f"# --- {bname} ({bench.paper_ref}) ---")
        try:
            for t in bench.fn(device):
                print(t.row())
        except Exception:  # noqa: BLE001 - report and continue
            failures += 1
            print(f"# FAILED {bname}")
            traceback.print_exc()
            if fail_fast:
                raise
    return failures
