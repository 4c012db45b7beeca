"""Mesh builders: the tensor-parallel serving mesh, small host meshes,
and the production grid.

PyTorch counterpart of ``repro/launch/mesh.py``.  The port's ``Mesh``
(sharding/axes.py) is a grid of ``torch.device``s that one Python
process drives.  Functions, not module constants, so importing this
module touches no device.

Spreading: the reference's CPU tests fan one host out into several
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=N``).  The
port's counterpart is explicit: ``spread=<device>`` lays all the
positions of a mesh on that one device (each position still holds its
own shards and pools), and an explicit ``devices=`` list may repeat a
device.  Nothing spreads a device unless asked, and nothing falls back
to the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.axes import Mesh


def _visible_cuda() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production grid as a description: 16x16 (256 positions) or
    2x16x16 (512), axes ("data", "model") / ("pod", "data", "model"),
    every position on the meta device (no device is touched; the dry
    run reads shapes and specs off it)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(shape, dtype=object)
    grid[...] = torch.device("meta")
    return Mesh(grid, axes)


def make_tp_mesh(tp: int, axis: str = "tp", *,
                 devices: Optional[Sequence] = None,
                 spread=None) -> Mesh:
    """1-axis tensor-parallel serving mesh of `tp` positions
    (sharding/plans.ServingPlan documents the axis contract).

    By default the first `tp` visible CUDA devices; it raises when fewer
    are visible.  ``spread=<device>`` lays every position on that one
    device instead (``"cuda:0"``, or ``"cpu"`` for the tests); an
    explicit ``devices`` list (of `tp` entries, repeats allowed) is used
    as given."""
    if tp < 1:
        raise ValueError(f"tp={tp} must be >= 1")
    if devices is not None and spread is not None:
        raise ValueError("pass devices= or spread=, not both")
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != tp:
            raise ValueError(f"tp={tp} needs {tp} devices, got {len(devs)}")
    elif spread is not None:
        devs = [torch.device(spread)] * tp
        if devs[0].type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"spread over {devs[0]} requested but CUDA "
                               "is not available")
    else:
        visible = _visible_cuda()
        if tp > len(visible):
            raise ValueError(
                f"tp={tp} needs {tp} devices but only {len(visible)} CUDA "
                f"device(s) are visible; pass spread='cuda:0' (or "
                f"spread='cpu') to lay {tp} mesh positions on one device")
        devs = visible[:tp]
    return Mesh(devs, (axis,))


def make_host_mesh(shape: Tuple[int, ...] = None,
                   axes: Optional[Tuple[str, ...]] = None, *,
                   devices: Optional[Sequence] = None,
                   spread=None) -> Mesh:
    """An n-D mesh (tests, examples, the sharded training step):
    ``("data", "model")`` by default, ``("pod", "data", "model")`` for a
    3-D shape.

    By default the visible CUDA devices, one a position; it raises when
    fewer are visible than the shape needs (never falls back to the
    CPU).  ``spread=<device>`` lays every position on that one device
    (``"cuda"``, or ``"cpu"`` for the tests), as ``make_tp_mesh``'s; an
    explicit ``devices`` list (repeats allowed) is used in order.
    Without a shape, the mesh takes every device given and puts 4, 2 or
    1 of them on `model`."""
    if devices is not None and spread is not None:
        raise ValueError("pass devices= or spread=, not both")
    if spread is not None:
        if shape is None:
            raise ValueError("spread= needs the mesh shape")
        dev = torch.device(spread)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"spread over {dev} requested but CUDA is "
                               "not available")
        devs = [dev] * int(np.prod(shape))
    elif devices is not None:
        devs = [torch.device(d) for d in devices]
    else:
        devs = _visible_cuda()
    n = len(devs)
    if shape is None:
        model = 1
        for m in (4, 2, 1):
            if n % m == 0:
                model = m
                break
        shape = (n // model, model) if n else (0, 1)
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    size = int(np.prod(shape))
    if size > n or size == 0:
        raise ValueError(
            f"mesh {shape} needs {size} devices, {n} given or visible; pass "
            f"spread='cuda' (or spread='cpu') to lay its positions on one "
            f"device")
    grid = np.empty(size, dtype=object)
    grid[:] = devs[:size]
    return Mesh(grid.reshape(shape), axes)
