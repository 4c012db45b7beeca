"""Bridge the reference's parameters into the port.

``from_reference_tree`` takes a parameter tree of the reference as
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``: nested
dicts) and returns the port's tree on `device`, checked leaf by leaf
against a spec tree of the port (a model's ``api.param_shapes(cfg)``,
a TE layer's ``transformer_layer_specs(cfg)``, ...);
``from_reference`` is the walk over a model's specs.  The two packages
share the layout, so each leaf keeps its shape and values and both
compute the same function.  ``shard_params`` splits a full tree (the
port's, or the reference's as numpy) into one tree a position of a
tensor-parallel serving mesh, by the serving plan's specs, or, given a
training plan's ``rules``, into a tree of ``Sharded`` leaves over an
n-D mesh (sharding/axes.py: each distinct block once, on its owner);
``gather_params`` is the way back, the full tree from the blocks in
mesh order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.models.common import is_spec, resolve_device


def to_torch(a: np.ndarray, device=None) -> torch.Tensor:
    """One numpy array as a tensor.  ``ml_dtypes.bfloat16`` and
    ``ml_dtypes.float8_e4m3fn`` arrays have no torch dtype to come
    through ``from_numpy``, so their bits travel as int16 / uint8 and
    are reinterpreted as bfloat16 / float8_e4m3fn; the same for
    ``ml_dtypes.float8_e5m2``."""
    a = np.array(a, copy=True, order="C")     # writable, owned
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    elif a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        t = torch.from_numpy(a.view(np.uint8)).view(
            getattr(torch, a.dtype.name))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_reference_tree(np_params: Dict[str, Any], specs,
                        device=None) -> Dict[str, Any]:
    """A numpy parameter tree as the port's tensors, checked leaf by
    leaf (keys and shapes) against the spec tree `specs`."""
    dev = resolve_device(device)

    def walk(spec, tree, path):
        if is_spec(spec):
            if tuple(tree.shape) != spec.shape:
                raise ValueError(f"{path}: shape {tuple(tree.shape)} is "
                                 f"not {spec.shape}")
            return to_torch(tree, dev)
        if set(tree) != set(spec):
            raise ValueError(f"{path}: keys {sorted(tree)} are not "
                             f"{sorted(spec)}")
        return {k: walk(spec[k], tree[k], f"{path}/{k}") for k in spec}

    return walk(specs, np_params, "")


def from_reference(np_params: Dict[str, Any], cfg,
                   device=None) -> Dict[str, Any]:
    """The reference's numpy model parameters as the port's, checked
    against ``api.param_shapes(cfg)``."""
    return from_reference_tree(np_params, api.param_shapes(cfg), device)


def shard_params(params: Dict[str, Any], cfg, mesh,
                 axis: Optional[str] = None, *,
                 rules: Optional[Dict[str, Any]] = None):
    """With ``rules`` (a training plan's param_rules): the tree of
    ``Sharded`` leaves over `mesh` (any rank) by ``api.pspecs(cfg,
    rules, mesh.shape)``: a dim that does not divide its mesh axis stays
    whole, as the reference's ``resolve``, and each distinct block is
    copied once onto the device of the first position holding it.

    Without: the tree of each position of a 1-axis serving `mesh`, by
    ``sharding.plans.serving_plan(mesh, axis).param_shardings(cfg)``:
    a leaf split over the axis gives position r its r-th equal slice of
    that dim (heads, kv heads and MLP columns of the projections, rows
    of wo and w_down, the vocab of the embedding and unembedding), as a
    contiguous tensor of its own on r's device; a replicated leaf is
    copied once a distinct physical device and shared by the positions
    there.  Leaves may be tensors or numpy arrays."""
    from repro_torch.sharding.axes import Sharded, shard_slices, split_dim
    from repro_torch.sharding.plans import serving_plan
    if rules is not None:
        if axis is not None:
            raise ValueError("pass axis= (serving) or rules= (training)")
        with torch.no_grad():
            return _walk_specs(
                params, api.pspecs(cfg, rules, mesh.shape),
                lambda t, spec: Sharded.from_full(
                    t if isinstance(t, torch.Tensor) else to_torch(t), spec,
                    mesh))
    plan = serving_plan(mesh, axis or mesh.axis_names[0])
    positions = mesh.positions

    def own(t: torch.Tensor, device) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            if set(tree) != set(spec):
                raise ValueError(f"{path}: keys {sorted(tree)} are not "
                                 f"{sorted(spec)}")
            parts = {k: walk(tree[k], spec[k], f"{path}/{k}") for k in spec}
            return [{k: parts[k][r] for k in spec}
                    for r in range(len(positions))]
        t = tree if isinstance(tree, torch.Tensor) else to_torch(tree)
        dim = split_dim(spec, plan.axis)
        if dim is None:
            copies = {d: own(t, d) for d in mesh.physical}
            return [copies[d] for d in positions]
        return [own(t.narrow(dim, a, b - a), d) for (a, b), d in
                zip(shard_slices(t.shape[dim], len(positions)), positions)]

    with torch.no_grad():
        return walk(params, plan.param_shardings(cfg), "")


def _walk_specs(tree, specs, fn, path=""):
    """`fn(leaf, spec)` over a parameter tree and its spec tree, checked
    key by key."""
    if not isinstance(tree, dict):
        return fn(tree, specs)
    if set(tree) != set(specs):
        raise ValueError(f"{path}: keys {sorted(tree)} are not "
                         f"{sorted(specs)}")
    return {k: _walk_specs(tree[k], specs[k], fn, f"{path}/{k}")
            for k in specs}


def gather_params(sharded: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The full tree of a ``shard_params(..., rules=)`` tree: each leaf's
    blocks concatenated in mesh order on `device` (default: the owner
    device of its first block)."""
    from repro_torch.sharding.axes import Sharded

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, Sharded):
            return t.full(device)
        return t if device is None else t.to(device)

    with torch.no_grad():
        return walk(sharded)
