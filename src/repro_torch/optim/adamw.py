"""AdamW with cosine schedule, warmup, and global-norm clipping.

PyTorch counterpart of ``repro/optim/adamw.py``.  Parameters, gradients
and moments are trees of tensors (core/tree.py); the step count is a
0-d int32 tensor on the parameters' device, so no update reads the
host.  The arithmetic is the reference's, leaf by leaf and in its
order; the port writes the new parameters and moments into their own
storage (the reference returns new arrays and donates the old ones), so
a full-width step holds one copy of each.  Leaves with ``ndim >= 2``
are decayed, as in the reference: in the stacked [L, d] layout that
includes the norm scales.

A sharded tree (``Sharded`` leaves, sharding/axes.py) flattens to its
owner blocks (core/tree.py), so each parameter element is updated once
and counted once in the global norm, whatever the mesh; the blocks may
lie on several devices: the norm's per-block sums are added in leaf
order on the first block's device, and the step's scalars are copied
once to each other device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.tree import leaves, tree_map

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Params
    v: Params


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    # bf16 moments halve the optimizer's memory
    moment_dtype: str = "float32"

    def init(self, params: Params) -> AdamWState:
        mdt = _DTYPES[self.moment_dtype]
        first = leaves(params)[0]
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            m=tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                             device=p.device), params),
            v=tree_map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                             device=p.device), params))

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(self.total_steps - self.warmup_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return self.learning_rate * warm * (0.1 + 0.9 * cos)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params
               ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
        """One step.  Returns (params, state, {"grad_norm", "lr"}); the
        returned params and moments are the given tensors, updated in
        place."""
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = (torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
                 if self.grad_clip else torch.ones((), device=gnorm.device))
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.pow(b1, step.float())
        bc2 = 1.0 - torch.pow(b2, step.float())

        on = {}

        def scalars(device):
            if device not in on:
                on[device] = tuple(x.to(device)
                                   for x in (scale, lr, bc1, bc2))
            return on[device]

        def upd(p, g, m, v):
            scale, lr, bc1, bc2 = scalars(p.device)
            g = g.float() * scale
            m32 = b1 * m.float() + (1 - b1) * g
            v32 = b2 * v.float() + (1 - b2) * torch.square(g)
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + self.eps)
            if p.ndim >= 2 and self.weight_decay:   # no decay on vectors
                delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m32)
            v.copy_(v32)

        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            upd(p, g, m, v)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return params, AdamWState(step=step, m=state.m, v=state.v), metrics


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every element, each once (a
    sharded tree's owner blocks), on the first leaf's device."""
    flat = leaves(tree)
    dev = flat[0].device
    return torch.sqrt(sum(torch.sum(torch.square(x.float())).to(dev)
                          for x in flat))
