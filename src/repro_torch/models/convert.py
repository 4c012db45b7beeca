"""Bridge the reference's parameters into the port.

``from_reference`` takes the reference's parameter tree as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``: nested dicts with
stacked ``[L, ...]`` layer leaves) and returns the port's tree on
`device`.  The two packages share the layout, so each leaf keeps its
shape and values and both compute the same function.
"""

from __future__ import annotations

from typing import Any, Dict

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


def from_reference(np_params: Dict[str, Any], cfg,
                   device=None) -> Dict[str, Any]:
    """The reference's numpy parameter tree as the port's parameters,
    checked leaf by leaf against ``api.param_shapes(cfg)``."""
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

    return walk(api.param_shapes(cfg), np_params, "")
