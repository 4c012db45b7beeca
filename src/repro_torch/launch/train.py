"""Training entry point + microbatched train-step factory.

PyTorch counterpart of ``repro/launch/train.py``.
`make_train_step(cfg, opt, n_micro=...)` accumulates gradients over
`n_micro` contiguous slices of the global batch (live activations at
1/n_micro), in `acc_dtype` accumulators (float32 by default), then
takes one AdamW step.  With ``mesh=`` and ``plan=`` the step runs
sharded (runtime/trainer.py): the accumulators are laid like the
parameters, and each microbatch's rows are split over the data groups
as a batch's are.

CLI: PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --steps 20
(reduced config unless --full; on the CUDA device unless --device).
Training keeps 16 bytes a parameter (float32 parameters, gradients and
two AdamW moments): full-width yi-6b at its 32 layers (97 GB) does not
fit one 80 GB H100 (chip_smoke.py trains it cut to 8 layers, 30.5 GB).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Any, Callable, List, Optional

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.tree import leaves, tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.trainer import value_and_grad

Params = Any


def estimate_microbatches(cfg: ModelConfig, tokens_dev: float,
                          budget_bytes: float = 6e9,
                          seq_shard: int = 1) -> int:
    """Pick n_micro so remat-full activations fit the memory budget:
    ~4 residual-sized saves per layer under remat=full (the reference's
    coefficient).  `seq_shard`: activation sequence-sharding degree."""
    act = 4.0 * cfg.num_layers * tokens_dev * cfg.d_model * 2 / seq_shard
    n = 1
    while act / n > budget_bytes and n < 64:
        n *= 2
    return n


def _micro_rows(B: int, n_micro: int) -> List[slice]:
    """The batch rows of each microbatch: the contiguous k-th slice of
    the global batch, as the reference's (over a mesh the sharded step
    then splits each microbatch's rows over the data groups, so a moe
    layer's capacity, drops and aux loss see the reference's tokens)."""
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         "microbatches")
    k = B // n_micro
    return [slice(mb * k, (mb + 1) * k) for mb in range(n_micro)]


def make_train_step(cfg: ModelConfig, opt: AdamW, *, n_micro: int = 1,
                    acc_dtype: Optional[torch.dtype] = None, mesh=None,
                    plan=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    batch leaves are [B, ...]; B must divide by n_micro.  Gradients are
    averaged over microbatches, each microbatch's gradient divided by
    n_micro and cast to `acc_dtype` before it is added.
    """
    acc_dtype = acc_dtype or torch.float32
    sharded = dict(mesh=mesh, plan=plan)

    def train_step(params, opt_state, batch):
        if n_micro == 1:
            loss, grads = value_and_grad(cfg, params, batch, **sharded)
        else:
            B = next(iter(batch.values())).shape[0]
            micro = _micro_rows(B, n_micro)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for rows in micro:
                l, g = value_and_grad(
                    cfg, params,
                    {k: v[rows] for k, v in batch.items()},
                    **sharded)
                grads = tree_map(lambda a, gi: a + (gi / n_micro).to(a.dtype),
                                 grads, g)
                loss = loss + l / n_micro
        new_params, new_opt, metrics = opt.update(grads, opt_state, params)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def main(argv: Optional[List[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced_config(args.arch)
    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=2,
                       ckpt_every=max(args.steps // 2, 1),
                       ckpt_dir=args.ckpt_dir, learning_rate=args.lr,
                       microbatch=args.microbatch)
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.runtime.trainer import Trainer
    data = SyntheticLMData(cfg.vocab_size, args.batch, args.seq)
    tr = Trainer(cfg, tcfg, data=data, device=args.device)
    if not tr.resume():
        tr.init()
    hist = tr.run(args.steps)
    for m in hist[:3] + hist[-3:]:
        print(f"step {m.step:5d} loss {m.loss:.4f} "
              f"gnorm {m.grad_norm:.3f} {m.step_time_s*1e3:.1f} ms")
    print(f"done: {tr.step} steps, {tr.straggler_events} straggler events,"
          f" {tr.restarts} restarts")
    return hist


if __name__ == "__main__":
    main()
