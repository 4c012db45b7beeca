"""Fault-tolerant training loop.

PyTorch counterpart of ``repro/runtime/trainer.py``, on one device or,
with ``mesh=`` and ``plan=`` (the reference's arguments), sharded:

  * a train step = loss, gradients by autograd, one AdamW update
    (parameters and moments updated in place); with a mesh the
    parameters and moments are trees of ``Sharded`` leaves laid by the
    plan's param rules (models/convert.shard_params) and the loss runs
    sharded (api.loss_fn with mesh=; every family)
  * async checkpoint every `ckpt_every` steps; crash-safe manifests
  * restart-from-latest on (injected or real) failure: `run()` survives
    `SimulatedFailure` and the loss stream continues bit-exact (the
    data pipeline is (seed, step)-deterministic and every op of the
    step is deterministic on the device it runs on)
  * straggler watchdog: step-time EWMA; steps > 3 x EWMA are counted
    and flagged

Checkpoints hold the whole arrays under the unsharded keys
(ckpt/checkpoint.py), so a run saved on one mesh resumes on another or
on one device.  The reference's gradient compression is not wired into
the step (optim/compress.py ports it on its own).  ``Trainer.init``
places the parameters on the CUDA device unless the trainer or the call
names another device (``"cpu"`` for the tests; a mesh's first position
with a mesh); with no CUDA device and no explicit choice it raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.tree import leaves, unflatten
from repro_torch.models import api, convert
from repro_torch.models.common import resolve_device
from repro_torch.optim.adamw import AdamW

Params = Any


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclasses.dataclass
class StepMetrics:
    step: int
    loss: float
    grad_norm: float
    step_time_s: float
    straggler: bool


def value_and_grad(cfg: ModelConfig, params: Params, batch, *, mesh=None,
                   plan=None):
    """(loss, gradient tree like `params`) of the training objective;
    over a mesh the gradients are those of each owner block."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = api.loss_fn(cfg, params, batch, mesh=mesh, plan=plan)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt: AdamW, *, mesh=None,
                    plan=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(cfg, params, batch, mesh=mesh,
                                     plan=plan)
        new_params, new_opt, metrics = opt.update(grads, opt_state, params)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, *,
                 data, mesh=None, plan=None,
                 fail_at_step: Optional[int] = None, device=None):
        """`data` must expose ``batches(start_step) -> iterator`` so a
        restart can replay the stream from the restored step exactly
        (data/pipeline.SyntheticLMData does).  `device` is where
        ``init`` puts the parameters (None: the CUDA device).  With
        `mesh` and `plan` (a training plan) the state is sharded over
        the mesh and every step runs sharded."""
        if (mesh is None) != (plan is None):
            raise ValueError("pass mesh= and plan= together")
        if mesh is not None:
            api.check_family(cfg)
            if device is not None:
                raise ValueError("a mesh places the state: pass mesh= or "
                                 "device=, not both")
            device = mesh.positions[0]
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data
        self.mesh = mesh
        self.plan = plan
        self.device = device
        self.fail_at_step = fail_at_step
        self.opt = AdamW(learning_rate=tcfg.learning_rate,
                         b1=tcfg.b1, b2=tcfg.b2,
                         weight_decay=tcfg.weight_decay,
                         grad_clip=tcfg.grad_clip,
                         warmup_steps=tcfg.warmup_steps,
                         total_steps=tcfg.total_steps)
        self.ckpt = Checkpointer(tcfg.ckpt_dir,
                                 async_save=tcfg.async_ckpt)
        self.train_step = make_train_step(cfg, self.opt, mesh=mesh,
                                          plan=plan)
        self.params: Optional[Params] = None
        self.opt_state = None
        self.step = 0
        self._ewma: Optional[float] = None
        self.straggler_events = 0
        self.restarts = 0
        self.history: list = []

    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = None, *, device=None) -> None:
        """float32 parameters from `seed` (default tcfg.seed) on
        `device` (default: the trainer's; None means CUDA), and fresh
        optimizer state.  With a mesh, the parameters are drawn on its
        first position and laid over it by the plan."""
        if self.mesh is not None and device is not None:
            raise ValueError("a mesh places the state")
        self.device = resolve_device(device if device is not None
                                     else self.device)
        self.set_params(api.init(self.cfg,
                                 self.tcfg.seed if seed is None else seed,
                                 device=self.device, dtype=torch.float32))

    def set_params(self, params: Params) -> None:
        """Start from `params` (a full tree; sharded over the mesh when
        the trainer has one) with fresh optimizer state, at step 0."""
        if self.mesh is not None:
            params = convert.shard_params(params, self.cfg, self.mesh,
                                          rules=self.plan.param_rules)
        self.params = params
        self.opt_state = self.opt.init(self.params)
        self.step = 0

    def resume(self) -> bool:
        """Restore the latest checkpoint; True if one was found."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        if self.params is None:
            self.init()
        state = {"params": self.params, "opt": self.opt_state}
        step, state = self.ckpt.restore(state, latest)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    def save(self) -> None:
        self.ckpt.save(self.step,
                       {"params": self.params, "opt": self.opt_state})

    # ------------------------------------------------------------------
    def _watchdog(self, dt: float) -> bool:
        straggler = False
        if self._ewma is not None and dt > 3.0 * self._ewma:
            straggler = True
            self.straggler_events += 1
        self._ewma = dt if self._ewma is None else \
            0.9 * self._ewma + 0.1 * dt
        return straggler

    def run(self, num_steps: int, *, max_restarts: int = 2) -> list:
        """Run with automatic restart-on-failure."""
        if self.params is None:
            raise RuntimeError("call init() or resume() first")
        target = self.step + num_steps
        data_it = self.data.batches(self.step)
        while self.step < target:
            try:
                self._run_inner(target, data_it)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                self.ckpt.wait()
                self.resume()
                data_it = self.data.batches(self.step)
        self.ckpt.wait()
        return self.history

    def _run_inner(self, target: int, data_it) -> None:
        while self.step < target:
            # over a mesh the step moves each group's rows to its devices
            batch = next(data_it)
            if self.mesh is None:
                batch = {k: v.to(self.device) for k, v in batch.items()}
            t0 = time.perf_counter()
            if (self.fail_at_step is not None
                    and self.step == self.fail_at_step):
                self.fail_at_step = None          # fail once
                raise SimulatedFailure(f"injected at step {self.step}")
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step += 1
            straggler = self._watchdog(dt)
            self.history.append(StepMetrics(
                step=self.step, loss=loss,
                grad_norm=float(metrics["grad_norm"]),
                step_time_s=dt, straggler=straggler))
            if self.step % self.tcfg.ckpt_every == 0:
                self.save()
