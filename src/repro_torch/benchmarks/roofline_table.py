"""Per-(arch x shape) roofline baseline table from dry-run artifacts.

PyTorch counterpart of ``benchmarks/roofline_table.py``: reads the
port's dry-run records (``artifacts/dryrun_torch/*.json``, written by
``python -m repro_torch.launch.dryrun``; ``REPRO_TORCH_DRYRUN_DIR``
names another directory) and returns the single-pod roofline rows.
A cell without an ``ok`` record gets its analytic row
(core/analytic.py on ``hw.SINGLE_POD`` of the H100), as the reference
does.  Rows: the roofline's step time in µs and its MFU.
"""

from __future__ import annotations

import json
import os

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.core import analytic, hw
from repro_torch.core.bench import register
from repro_torch.core.timer import Timing


def _art_dir() -> str:
    return os.environ.get("REPRO_TORCH_DRYRUN_DIR", "artifacts/dryrun_torch")


def _cell_rows(arch: str, shape_name: str) -> Timing:
    path = os.path.join(_art_dir(), f"{arch}__{shape_name}__pod1.json")
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            a = rec["analytic"]
            return Timing(
                f"{arch}/{shape_name}/{rec['plan']}",
                a["step_s"] * 1e6, 0, 1,
                derived=a["mfu"],
                derived_name=f"mfu(dom={a['dominant']})")
    cfg = get_config(arch)
    cell = analytic.analyze_cell(cfg, SHAPES[shape_name], hw.SINGLE_POD)
    rf = cell.roofline(hw.SINGLE_POD)
    return Timing(f"{arch}/{shape_name}/analytic-only",
                  rf.step_s * 1e6, 0, 1, derived=rf.mfu,
                  derived_name=f"mfu(dom={rf.dominant})")


@register("roofline_baselines", "EXPERIMENTS §Roofline")
def roofline_table(device=None):
    """Every assigned arch x shape; `device` is unused (no kernel
    runs)."""
    rows = []
    for arch in ASSIGNED:
        for shape_name in SHAPES:
            try:
                rows.append(_cell_rows(arch, shape_name))
            except Exception as e:  # noqa: BLE001
                rows.append(Timing(f"{arch}/{shape_name}/ERROR:{e}",
                                   0, 0, 1))
    return rows
