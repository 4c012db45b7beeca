"""Logical-axis sharding: meshes, rules and the placement rule.

PyTorch counterpart of ``repro/sharding/axes.py``.  The reference hands
GSPMD a ``jax.sharding.Mesh`` and ``PartitionSpec``s; the port is a
single controller (one Python process) over a ``Mesh`` of its own: an
ordered grid of ``torch.device``s with named axes, whose positions may
name one physical device more than once (a *spread* mesh, the
counterpart of the reference's forced host-device fan-out,
launch/mesh.make_tp_mesh).  ``PartitionSpec`` is a tuple of mesh axes,
one entry per tensor dim (None: not split).

Params carry logical axis names in their ParamSpec (models/common.py);
a plan (plans.py) maps logical names to mesh axes, and ``resolve`` turns
a leaf's names into its PartitionSpec.  The port places every tensor
explicitly: models/convert.shard_params lays each leaf's slices on their
mesh positions by that spec, and the serving forward
(models/transformer.py) computes each shard's part where it lives.  So
``constrain``, the reference's ``with_sharding_constraint``, is the
identity here: there is no compiler to tell where an activation goes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_state = threading.local()


class PartitionSpec(tuple):
    """Mesh axis (a name, a tuple of names, or None) per tensor dim."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def physical_device(d) -> torch.device:
    """`d` as a torch.device, a CUDA device without an index as the
    current one (so positions compare equal to their tensors' devices)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An n-D grid of torch devices with named axes.

    ``devices`` is an object array of ``torch.device`` (shape = the mesh
    shape); ``shape`` maps axis name -> size, as ``jax.sharding.Mesh``'s.
    A position is one entry of the grid; ``positions`` lists them in
    row-major order.  Several positions may name one physical device (a
    spread mesh); ``physical`` lists the distinct devices in the order
    they first appear."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = physical_device(src[idx])
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} do not match "
                             f"axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes {axis_names} repeat a name")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def positions(self) -> List[torch.device]:
        return list(self.devices.flat)

    @property
    def physical(self) -> List[torch.device]:
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def current_rules() -> Optional[Dict[str, object]]:
    return getattr(_state, "rules", None)


def current_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_rules(mesh: Mesh, rules: Dict[str, object]):
    prev = (current_mesh(), current_rules())
    _state.mesh, _state.rules = mesh, rules
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def resolve(names: Sequence[Optional[str]],
            rules: Optional[Dict[str, object]] = None,
            dims: Optional[Sequence[int]] = None,
            mesh_sizes: Optional[Dict[str, int]] = None) -> PartitionSpec:
    """Logical axis names -> PartitionSpec (a mesh axis used at most
    once; with `dims` and `mesh_sizes` a dim that does not divide its
    mesh axes stays replicated)."""
    rules = rules if rules is not None else (current_rules() or {})
    used = set()
    out = []
    for i, n in enumerate(names):
        m = rules.get(n) if n is not None else None
        if m is not None and dims is not None and mesh_sizes is not None:
            axs = (m,) if isinstance(m, str) else tuple(m)
            total = 1
            for a in axs:
                total *= mesh_sizes.get(a, 1)
            if dims[i] % total:
                m = None
        if m is None or m in used:
            out.append(None)
        else:
            used.add(m)
            out.append(m)
    return PartitionSpec(*out)


def split_dim(spec: Sequence, axis: str) -> Optional[int]:
    """The dim a PartitionSpec splits over mesh axis `axis` (None when
    it is replicated over it)."""
    for i, m in enumerate(spec):
        axs = (m,) if isinstance(m, str) else tuple(m or ())
        if axis in axs:
            return i
    return None


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """The identity: the port places every shard explicitly (module
    docstring), so an activation is already where its spec says."""
    return x


def shard_slices(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of `parts` equal slices of a dim of n."""
    if n % parts:
        raise ValueError(f"{n} does not split into {parts} parts")
    k = n // parts
    return [(r * k, (r + 1) * k) for r in range(parts)]
