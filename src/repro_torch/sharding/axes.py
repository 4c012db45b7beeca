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
`model`'s contiguous blocks cut elsewhere).  A decode cache's dim may
be split over two axes at once (plans.cache_pspecs: the KV sequence
over ("model", "data") when neither heads nor batch split): its blocks
are numbered row-major over those axes.

The collective log (``collective_log``): while its ``with`` block is
open, the sharded steps record each logical transfer between mesh
positions (kind, the bytes a receiving position takes in, the number of
receivers): what ``Sharded.at(gather=)`` reads from blocks other
positions own (all-gather; its gradient sent back to the owner,
reduce-scatter), the partials ``common.xshard_sum`` and the decode
combine take from other shards (all-reduce), and moe dispatch and
combine through the first position (all-to-all).  On a mesh spread over
one device ``.to(device)`` moves nothing, so physical copies would show
nothing; the log counts what a mesh of distinct devices would move.
Closed (the default) it adds no work and no host sync.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

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


# ----------------------------------------------------------------------
# the collective log
# ----------------------------------------------------------------------

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


class CollectiveLog:
    """Logical transfers between mesh positions: entries (kind, bytes a
    receiving position takes in, receivers)."""

    def __init__(self):
        self.entries: List[Tuple[str, int, int]] = []

    def add(self, kind: str, nbytes: int, receivers: int = 1) -> None:
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        if nbytes and receivers:
            self.entries.append((kind, int(nbytes), int(receivers)))

    def bytes(self) -> Dict[str, int]:
        """Bytes taken in over every receiving position, by kind."""
        out = dict.fromkeys(COLLECTIVE_KINDS, 0)
        for kind, n, r in self.entries:
            out[kind] += n * r
        return out

    def ops(self) -> Dict[str, int]:
        """Logged transfers, by kind."""
        out = dict.fromkeys(COLLECTIVE_KINDS, 0)
        for kind, _, _ in self.entries:
            out[kind] += 1
        return out


# module-global, not thread-local: the backward may run on autograd's
# device threads
_LOG: List[Optional[CollectiveLog]] = [None]


@contextlib.contextmanager
def collective_log():
    """Record the sharded steps' logical transfers while open (module
    docstring); yields the ``CollectiveLog``."""
    prev, _LOG[0] = _LOG[0], CollectiveLog()
    try:
        yield _LOG[0]
    finally:
        _LOG[0] = prev


def logging_collectives() -> bool:
    return _LOG[0] is not None


class _BackLog(torch.autograd.Function):
    """The identity; its backward logs the gradient's transfer."""

    @staticmethod
    def forward(ctx, x, kind, nbytes, receivers):
        ctx.entry = (kind, nbytes, receivers)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if _LOG[0] is not None:
            _LOG[0].add(*ctx.entry)
        return g, None, None, None


def log_transfer(x: torch.Tensor, kind: str, *, nbytes: Optional[int] = None,
                 receivers: int = 1, back: Optional[str] = None
                 ) -> torch.Tensor:
    """`x` as taken in by `receivers` positions (`nbytes` each, default
    x's bytes), logged under `kind` when the log is open; with `back`,
    its gradient's return is logged under `back` in the backward.
    Returns `x` (as is when the log is closed)."""
    log = _LOG[0]
    if log is None:
        return x
    nbytes = x.nbytes if nbytes is None else nbytes
    log.add(kind, nbytes, receivers)
    if back is not None and x.requires_grad:
        return _BackLog.apply(x, back, nbytes, receivers)
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

DimAxes = Union[None, str, Tuple[str, ...]]


def _spec_axis(entry) -> DimAxes:
    """The mesh axis of one spec entry (None: not split), or the tuple
    of axes of a dim split over several (a decode cache's sequence;
    parameter dims take one axis at most)."""
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry
    entry = tuple(entry)
    if not entry:
        return None
    return entry[0] if len(entry) == 1 else entry


def _names(a: DimAxes) -> Tuple[str, ...]:
    return () if a is None else ((a,) if isinstance(a, str) else a)


def spec_axes(spec: Sequence, ndim: int) -> Tuple[DimAxes, ...]:
    """The mesh axis splitting each of `ndim` dims (a spec shorter than
    the rank leaves the trailing dims whole)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(_spec_axis(e) for e in spec[:ndim])


def axes_parts(a: DimAxes, mesh_shape: Dict[str, int]) -> int:
    """The number of blocks the axes `a` cut a dim into."""
    n = 1
    for x in _names(a):
        n *= mesh_shape[x]
    return n


def _mesh_axes(spec, ndim: int, mesh: Mesh) -> Tuple[DimAxes, ...]:
    """`spec_axes`, refusing an axis the mesh does not have."""
    axes = spec_axes(spec, ndim)
    missing = {x for a in axes for x in _names(a)} - set(mesh.axis_names)
    if missing:
        raise ValueError(f"spec {tuple(spec)} names {sorted(missing)}, not "
                         f"mesh axes {mesh.axis_names}")
    return axes


def mesh_coords(mesh: Mesh) -> List[Dict[str, int]]:
    """Each position's coordinates {axis: index}, in mesh order."""
    return [dict(zip(mesh.axis_names, idx))
            for idx in np.ndindex(mesh.devices.shape)]


def block_index(axes_of_dims: Sequence[DimAxes], coord: Dict[str, int],
                mesh_shape: Optional[Dict[str, int]] = None
                ) -> Tuple[int, ...]:
    """The block a position holds: its index along each dim's axis (0
    along a whole dim; row-major over the axes of a dim split over
    several, which needs `mesh_shape`)."""
    out = []
    for a in axes_of_dims:
        if a is None or isinstance(a, str):
            out.append(0 if a is None else coord[a])
            continue
        i = 0
        for x in a:
            i = i * mesh_shape[x] + coord[x]
        out.append(i)
    return tuple(out)


def span_pieces(n: int, parts: int, lo: int, hi: int
                ) -> List[Tuple[int, int, int]]:
    """The pieces of elements [lo, hi) of a dim of n cut into `parts`
    equal blocks: (block, start, stop) within each covering block, in
    order."""
    size = n // parts
    return [(j, max(lo, j * size) - j * size, min(hi, (j + 1) * size)
             - j * size) for j in range(lo // size, (hi - 1) // size + 1)]


@functools.lru_cache(maxsize=256)
def block_owners(axes_of_dims: Tuple[DimAxes, ...], mesh: Mesh
                 ) -> Dict[Tuple[int, ...], Dict[str, int]]:
    """Each distinct block's owner: the coordinates of the first
    position in mesh order that holds it."""
    owners: Dict[Tuple[int, ...], Dict[str, int]] = {}
    for c in mesh_coords(mesh):
        owners.setdefault(block_index(axes_of_dims, c, mesh.shape), c)
    return owners


def _owner_device(mesh: Mesh, coord: Dict[str, int]) -> torch.device:
    return mesh.devices[tuple(coord[a] for a in mesh.axis_names)]


def block_slices(shape: Sequence[int], axes_of_dims, mesh_shape,
                 index: Sequence[int]) -> Tuple[slice, ...]:
    """The slice of a leaf of `shape` that block `index` covers."""
    out = []
    for n, a, i in zip(shape, axes_of_dims, index):
        lo, hi = shard_slices(n, axes_parts(a, mesh_shape))[i]
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
        blocks = {}
        for idx, c in sorted(block_owners(axes_of_dims, mesh).items()):
            sl = t[block_slices(t.shape, axes_of_dims, mesh.shape, idx)]
            blocks[idx] = torch.empty(sl.shape, dtype=t.dtype,
                                      device=_owner_device(mesh, c)
                                      ).copy_(sl)
        return cls(t.shape, spec, mesh, blocks)

    @classmethod
    def zeros(cls, shape, dtype: torch.dtype, spec, mesh: Mesh
              ) -> "Sharded":
        """A leaf of zeros laid out by `spec`, each block made on its
        owner's device (meta positions: shapes only)."""
        axes_of_dims = _mesh_axes(spec, len(shape), mesh)
        blocks = {}
        for idx, c in sorted(block_owners(axes_of_dims, mesh).items()):
            sl = block_slices(shape, axes_of_dims, mesh.shape, idx)
            blocks[idx] = torch.zeros([s.stop - s.start for s in sl],
                                      dtype=dtype,
                                      device=_owner_device(mesh, c))
        return cls(shape, spec, mesh, blocks)

    def block_at(self, coord: Dict[str, int]) -> Tuple[int, ...]:
        """The index of the block position `coord` holds."""
        return block_index(self.axes, coord, self.mesh.shape)

    def block_range(self, idx: Sequence[int]) -> Tuple[slice, ...]:
        """The slice of the whole leaf that block `idx` covers."""
        return block_slices(self.shape, self.axes, self.mesh.shape, idx)

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
        idx = self.block_at(coord)
        dim = self.split(gather) if gather is not None else None
        if dim is None:
            return self.blocks[idx].to(device)
        parts = []
        for i in range(self.parts(gather)):
            k = idx[:dim] + (i,) + idx[dim + 1:]
            b = self.blocks[k].to(device)
            if i != idx[dim]:              # another position's block
                b = log_transfer(b, "all-gather", back="reduce-scatter")
            parts.append(b)
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
