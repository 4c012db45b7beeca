"""Async checkpointing: npz shards + manifest, crash-safe restore.

PyTorch counterpart of ``repro/ckpt/checkpoint.py``, with the same
layout per step:  <dir>/step_<N>/arrays.npz + manifest.json, keys
spelled as the reference's (core/tree.py).  The manifest is written
*after* the arrays (write-then-rename), so a crash mid-save leaves the
previous step restorable.  Saves run on a background thread
(`async_save=True`), copying to host first so the training loop only
blocks for the device->host copy.

Checkpoints are sharding-agnostic: a tree of ``Sharded`` leaves (a
sharded training state, sharding/axes.py) is saved as the whole host
arrays under the unsharded keys, its blocks put together in mesh
order, and a restore lays each array over the `tree_like` leaf's mesh
and spec (or onto its device), so a state saved on one mesh restores
onto another mesh or onto one device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import items_with_path, tree_map_with_path
from repro_torch.sharding.axes import Sharded

Params = Any


def _is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def _flatten(tree: Params) -> Dict[str, np.ndarray]:
    out = {}
    for key, leaf in items_with_path(tree, is_leaf=_is_sharded):
        t = (leaf.full(torch.device("cpu")) if _is_sharded(leaf)
             else leaf).detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16) or \
                "float8" in str(t.dtype):
            # npz has no bf16/fp8: upcast losslessly; restore casts back
            # to the tree_like leaf dtype
            t = t.float()
        out[key] = t.numpy()
    return out


def _unflatten(tree_like: Params, arrays: Dict[str, np.ndarray]) -> Params:
    def restore(key, leaf):
        t = torch.from_numpy(np.array(arrays[key]))
        if _is_sharded(leaf):
            if tuple(t.shape) != leaf.shape:
                raise ValueError(f"{key}: checkpoint shape "
                                 f"{tuple(t.shape)} is not {leaf.shape}")
            return Sharded.from_full(t.to(leaf.dtype), leaf.spec, leaf.mesh)
        return t.to(device=leaf.device, dtype=leaf.dtype)

    with torch.no_grad():
        return tree_map_with_path(restore, tree_like, is_leaf=_is_sharded)


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------
    def save(self, step: int, tree: Params) -> None:
        host = _flatten(tree)                    # block only for D2H
        if self.async_save:
            self.wait()                          # one save in flight max
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host: Dict[str, np.ndarray]) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(host.keys()),
            "bytes": int(sum(a.nbytes for a in host.values())),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                    # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Params, step: Optional[int] = None
                ) -> Tuple[int, Params]:
        """(step, a tree like `tree_like`: each leaf on its leaf's device
        and in its dtype) of checkpoint `step`, by default the latest."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        if sorted(arrays.keys()) != manifest["keys"]:
            raise ValueError(f"corrupt checkpoint {path}: arrays and "
                             "manifest disagree")
        return step, _unflatten(tree_like, arrays)
