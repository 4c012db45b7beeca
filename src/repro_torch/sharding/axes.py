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
mesh positions by that spec, and the serving forward and the sharded
training step (models/transformer.py) compute each shard's part where
it lives.  So ``constrain``, the reference's
``with_sharding_constraint``, is the identity here: there is no
compiler to tell where an activation goes.

A training leaf over an n-D mesh is a ``Sharded``: the spec may split
several dims, each over its own mesh axis, and every distinct block of
the leaf is held once, by its owner (the first position in mesh order
that holds it).  Other positions read the owner's block through a
``.to(device)`` copy, so autograd sums every use's gradient into the
owner; ``Sharded.at`` is a position's block with the dim split over one
axis (`data`, for FSDP) gathered in mesh order, and ``Sharded.span`` an
index range along a split dim read from the blocks that cover it (the
Mamba mixers' w_in columns of one position's channels or heads, which
`model`'s contiguous blocks cut elsewhere).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_state = threading.local()

# the training mesh's axes (plans.py): `model` splits the compute
MODEL_AXIS, DATA_AXIS = "model", "data"


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


# ----------------------------------------------------------------------
# blocks of a leaf over an n-D mesh
# ----------------------------------------------------------------------

def _spec_axis(entry) -> Optional[str]:
    """The mesh axis of one spec entry (None: not split).  A parameter
    dim is split over one axis at most (plans' param rules name one)."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry
    entry = tuple(entry)
    if len(entry) != 1:
        raise ValueError(f"a parameter dim split over {entry}: one mesh "
                         "axis a dim")
    return entry[0]


def spec_axes(spec: Sequence, ndim: int) -> Tuple[Optional[str], ...]:
    """The mesh axis splitting each of `ndim` dims (a spec shorter than
    the rank leaves the trailing dims whole)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(_spec_axis(e) for e in spec[:ndim])


def _mesh_axes(spec, ndim: int, mesh: Mesh) -> Tuple[Optional[str], ...]:
    """`spec_axes`, refusing an axis the mesh does not have."""
    axes = spec_axes(spec, ndim)
    missing = {a for a in axes if a is not None} - set(mesh.axis_names)
    if missing:
        raise ValueError(f"spec {tuple(spec)} names {sorted(missing)}, not "
                         f"mesh axes {mesh.axis_names}")
    return axes


def mesh_coords(mesh: Mesh) -> List[Dict[str, int]]:
    """Each position's coordinates {axis: index}, in mesh order."""
    return [dict(zip(mesh.axis_names, idx))
            for idx in np.ndindex(mesh.devices.shape)]


def block_index(axes_of_dims: Sequence[Optional[str]],
                coord: Dict[str, int]) -> Tuple[int, ...]:
    """The block a position holds: its index along each dim's axis (0
    along a whole dim)."""
    return tuple(0 if a is None else coord[a] for a in axes_of_dims)


def span_pieces(n: int, parts: int, lo: int, hi: int
                ) -> List[Tuple[int, int, int]]:
    """The pieces of elements [lo, hi) of a dim of n cut into `parts`
    equal blocks: (block, start, stop) within each covering block, in
    order."""
    size = n // parts
    return [(j, max(lo, j * size) - j * size, min(hi, (j + 1) * size)
             - j * size) for j in range(lo // size, (hi - 1) // size + 1)]


def block_slices(shape: Sequence[int], axes_of_dims, mesh_shape,
                 index: Sequence[int]) -> Tuple[slice, ...]:
    """The slice of a leaf of `shape` that block `index` covers."""
    out = []
    for n, a, i in zip(shape, axes_of_dims, index):
        parts = 1 if a is None else mesh_shape[a]
        lo, hi = shard_slices(n, parts)[i]
        out.append(slice(lo, hi))
    return tuple(out)


class Sharded:
    """One leaf of `shape` over `mesh` by `spec`: ``blocks`` maps each
    distinct block index (one entry a dim) to its owner tensor, on the
    device of the first position in mesh order that holds the block.
    Every element has exactly one owner, so an optimizer that walks the
    blocks updates it once and a norm counts it once."""

    def __init__(self, shape, spec, mesh: Mesh,
                 blocks: Dict[Tuple[int, ...], torch.Tensor]):
        self.shape = tuple(shape)
        self.axes = _mesh_axes(spec, len(self.shape), mesh)
        self.spec = PartitionSpec(*self.axes)
        self.mesh = mesh
        self.blocks = blocks

    # -- layout ----------------------------------------------------------
    def parts(self, axis: str) -> int:
        """The number of slices `axis` cuts this leaf into (1: whole)."""
        return self.mesh.shape[axis] if axis in self.axes else 1

    def split(self, axis: str) -> Optional[int]:
        """The dim split over `axis` into more than one slice, or None."""
        if self.parts(axis) <= 1:
            return None
        return self.axes.index(axis)

    @classmethod
    def from_full(cls, t: torch.Tensor, spec, mesh: Mesh) -> "Sharded":
        """`t` cut into its blocks, each copied once onto its owner's
        device (a contiguous tensor of its own), in block order."""
        axes_of_dims = _mesh_axes(spec, t.ndim, mesh)
        owners: Dict[Tuple[int, ...], torch.device] = {}
        for c, d in zip(mesh_coords(mesh), mesh.positions):
            owners.setdefault(block_index(axes_of_dims, c), d)
        blocks = {}
        for idx, dev in sorted(owners.items()):
            sl = t[block_slices(t.shape, axes_of_dims, mesh.shape, idx)]
            blocks[idx] = torch.empty(sl.shape, dtype=t.dtype,
                                      device=dev).copy_(sl)
        return cls(t.shape, spec, mesh, blocks)

    def with_blocks(self, blocks) -> "Sharded":
        """The same layout over other tensors (one a block, in order)."""
        return Sharded(self.shape, self.spec, self.mesh,
                       dict(zip(self.blocks, blocks)))

    def layers(self) -> List["Sharded"]:
        """The leading dim's slices (a stacked [L, ...] leaf, its layer
        dim whole), each block unbound once."""
        if self.axes[0] is not None:
            raise ValueError("the leading dim is split")
        per = {k: b.unbind(0) for k, b in self.blocks.items()}
        return [Sharded(self.shape[1:], self.axes[1:], self.mesh,
                        {k[1:]: per[k][i] for k in self.blocks})
                for i in range(self.shape[0])]

    # -- reading -----------------------------------------------------------
    def at(self, coord: Dict[str, int], device, *,
           gather: Optional[str] = None) -> torch.Tensor:
        """The block that position `coord` holds, on `device`; with
        `gather`, the dim split over that axis is concatenated from the
        blocks of every index along it, in mesh order.  Differentiable:
        each block is read through ``.to(device)``."""
        idx = block_index(self.axes, coord)
        dim = self.split(gather) if gather is not None else None
        if dim is None:
            return self.blocks[idx].to(device)
        parts = []
        for i in range(self.parts(gather)):
            k = idx[:dim] + (i,) + idx[dim + 1:]
            parts.append(self.blocks[k].to(device))
        return torch.cat(parts, dim=dim)

    def span(self, coord: Dict[str, int], dim: int, lo: int, hi: int,
             at, *, gather: Optional[str] = None) -> torch.Tensor:
        """Elements [lo, hi) along `dim` of what position `coord` reads
        through `at(coord)` (a block, the dim split over `gather`
        gathered: ``self.at`` or a memo of it), where `dim` may be split
        over a mesh axis: the blocks along that axis that cover the
        range, each read as position `coord` moved along the axis reads
        it, narrowed and concatenated in order.  Differentiable: each
        piece's gradient reaches its owner."""
        axis = self.axes[dim]
        if axis is None or axis == gather or self.parts(axis) == 1:
            return at(coord).narrow(dim, lo, hi - lo)
        pieces = [at({**coord, axis: j}).narrow(dim, a, b - a) for j, a, b
                  in span_pieces(self.shape[dim], self.parts(axis), lo, hi)]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim)

    def full(self, device=None) -> torch.Tensor:
        """The whole leaf, its blocks concatenated in mesh order."""
        device = device if device is not None else \
            next(iter(self.blocks.values())).device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for idx, b in self.blocks.items():
            out[block_slices(self.shape, self.axes, self.mesh.shape,
                             idx)] = b.to(device)
        return out

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.blocks.values())).dtype
