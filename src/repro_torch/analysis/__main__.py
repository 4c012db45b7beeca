"""CLI: ``python -m repro_torch.analysis [--strict] [--report out.json]``.

Runs the three analyzer layers over the port and prints findings; exit
1 on any error-severity finding (and on warnings under ``--strict``).
``--suppress RULE`` moves a rule's findings into the report's
``suppressed`` section without failing the run.  The graph and kernel
layers run on the CUDA device unless ``--device cpu`` is given; without
a CUDA device and without ``--device cpu`` they raise (there is no
silent CPU run).  ``--layer ast`` alone needs no device.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.analysis import ast_lint, graph_check, kernel_lint
from repro_torch.analysis.report import RULES, Report
from repro_torch.models.common import resolve_device

LAYERS = ("ast", "kernel", "graph")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Serving-contract analyzer of the port "
                    "(work-unit graphs + launch plans + AST layers)")
    p.add_argument("--strict", action="store_true",
                   help="fail on warnings too, not just errors")
    p.add_argument("--report", metavar="PATH",
                   help="write the JSON report here")
    p.add_argument("--suppress", action="append", default=[],
                   metavar="RULE", help="suppress a rule id (repeatable)")
    p.add_argument("--layer", action="append", choices=LAYERS,
                   default=[], metavar="LAYER",
                   help=f"run only these layers {LAYERS} (repeatable; "
                        f"default: all)")
    p.add_argument("--max-combos", type=int, default=None,
                   help="cap the graph layer's serving flag matrix")
    p.add_argument("--spread", type=int, default=0, metavar="N",
                   help="add the reference's tensor-parallel combos to "
                        "the graph layer (N >= 2 mesh positions, laid "
                        "on the one device)")
    p.add_argument("--repo-root", default=".",
                   help="repo root for the AST layer (default: cwd)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule registry and exit")
    p.add_argument("--device", default=None,
                   help="device of the graph and kernel layers (default: "
                        "the CUDA device; `cpu` runs them on the CPU)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rule, (sev, desc) in RULES.items():
            print(f"{rule}  [{sev:7s}]  {desc}")
        return 0

    layers = args.layer or list(LAYERS)
    report = Report(suppress=args.suppress)
    device = (resolve_device(args.device)
              if {"kernel", "graph"} & set(layers) else None)
    seconds = {}
    if "ast" in layers:
        print("[analysis] layer 3: AST lint "
              "(runtime/ + models/ + obs/ work-unit bodies)", flush=True)
        t0 = time.perf_counter()
        ast_lint.run(report, repo_root=args.repo_root)
        seconds["ast"] = time.perf_counter() - t0
    if "kernel" in layers:
        print(f"[analysis] layer 2: launch lint (kernels/ workload sweep, "
              f"{device})", flush=True)
        t0 = time.perf_counter()
        kernel_lint.run(report, device=device)
        seconds["kernel"] = time.perf_counter() - t0
    if "graph" in layers:
        print(f"[analysis] layer 1: work-unit contracts (serving flag "
              f"matrix, {device})", flush=True)
        t0 = time.perf_counter()
        graph_check.run(report, device=device, max_combos=args.max_combos,
                        spread=args.spread)
        seconds["graph"] = time.perf_counter() - t0
    report.extras["layer_seconds"] = seconds
    report.extras["device"] = str(device) if device is not None else None

    for f in report.findings:
        print(f)
    n_err = len(report.errors())
    n_warn = len(report.findings) - n_err
    if report.findings:
        by_rule = ", ".join(f"{k}={v}"
                            for k, v in report.summary().items())
        print(f"[analysis] {n_err} error(s), {n_warn} warning(s), "
              f"{len(report.suppressed)} suppressed ({by_rule})")
    else:
        print(f"[analysis] clean: 0 findings "
              f"({len(report.suppressed)} suppressed)")
    if args.report:
        with open(args.report, "w") as fh:
            fh.write(report.to_json(strict=args.strict))
        print(f"[analysis] report written to {args.report}")
    return report.exit_code(args.strict)


if __name__ == "__main__":
    sys.exit(main())
