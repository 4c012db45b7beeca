"""Benchmark runner: one registered benchmark per paper table.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [names...] [--device cpu]

Registers the tensor-core (``tc_mma``, ``tc_wgmma``, ``tc_n_sweep``,
``tc_energy``), async-copy (``async_copy``), DPX (``dpx_functions``,
``dpx_kernels``) and distributed-shared-memory (``dsm``) benchmarks and
prints ``name,us_per_call,derived`` CSV (plus # section markers).  Runs on the
CUDA device unless ``--device`` names another; without CUDA and without
``--device cpu`` it raises.  Exits non-zero if any benchmark failed.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

# importing registers every benchmark
from repro_torch.benchmarks import (async_copy, dpx, dsm,  # noqa: F401
                                    tensorcore)
from repro_torch.core.bench import run_all
from repro_torch.models.common import resolve_device


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("names", nargs="*", help="benchmarks to run (all if none)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    failures = run_all(args.names or None, device=device)
    if failures:
        raise SystemExit(f"{failures} benchmark(s) failed")


if __name__ == "__main__":
    main()
