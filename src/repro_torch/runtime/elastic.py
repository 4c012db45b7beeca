"""Elastic re-meshing: rebuild the mesh when the device set changes.

PyTorch counterpart of ``repro/runtime/elastic.py`` over the port's
``Mesh`` (sharding/axes.py).  When a host loses devices, the surviving
count rarely matches the old factorization.  `remesh` picks the best
(data, model) factorization of the survivors (keeping `model` <= the old
TP degree so TP-sharded dims still fit), and `replan_batch` rescales the
per-device batch so the global batch is kept where divisibility allows.
Checkpoints are sharding-agnostic (ckpt/checkpoint.py saves whole host
arrays under the unsharded keys), so a restore after a remesh reshards
on load: a `Trainer(mesh=remesh(...), plan=...)` resumes by laying each
saved array over the new mesh (sharding/axes.Sharded.from_full, as
models/convert.shard_params lays a fresh tree).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.axes import Mesh


def factorizations(n: int) -> List[Tuple[int, int]]:
    out = []
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            out.append((n // d, d))
            if d != n // d:
                out.append((d, n // d))
    return sorted(out)


def best_shape(n_devices: int, *, max_model: Optional[int] = None,
               prefer_model: int = 16) -> Tuple[int, int]:
    """(data, model) for the survivors: model nearest prefer_model."""
    best = None
    for data, model in factorizations(n_devices):
        if max_model and model > max_model:
            continue
        score = (abs(model - prefer_model), abs(data - n_devices // model))
        if best is None or score < best[0]:
            best = (score, (data, model))
    if best is None:
        raise ValueError(f"no (data, model) factorization of {n_devices} "
                         f"with model <= {max_model}")
    return best[1]


def remesh(devices: Optional[Sequence] = None, *,
           max_model: Optional[int] = None,
           prefer_model: int = 16) -> Mesh:
    """A ("data", "model") mesh over `devices` (default: the visible CUDA
    devices; it raises when there are none)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= to remesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    data, model = best_shape(len(devices), max_model=max_model,
                             prefer_model=prefer_model)
    grid = np.empty(data * model, dtype=object)
    grid[:] = devices[: data * model]
    return Mesh(grid.reshape(data, model), ("data", "model"))


def replan_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Global batch after a remesh: kept when it divides over new_data,
    else the nearest multiple of new_data (at least new_data)."""
    if global_batch % new_data == 0:
        return global_batch
    per_dev = max(1, round(global_batch / new_data))
    return per_dev * new_data
