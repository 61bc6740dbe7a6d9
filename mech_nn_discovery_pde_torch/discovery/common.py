"""Shared discovery-training utilities: step parameterization, the
training-step factory and the checkpoint/resume harness."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from scipy.special import logit

from mech_nn_discovery_pde_torch.utils.checkpoint import Checkpointer
from mech_nn_discovery_pde_torch.utils.profiling import PhaseTimer, span


def fixed_steps(step_size: float, bs: int, dim: int, lo: float = None, hi: float = None,
                device="cuda") -> torch.Tensor:
    """Reference step parameterization: sigmoid(logit(h)) expanded over the
    grid, optionally clipped.  Steps are fixed buffers (not trained)."""
    s = 1.0 / (1.0 + np.exp(-logit(step_size)))
    if lo is not None:
        s = np.clip(s, lo, hi)
    return torch.full((bs, dim - 1), float(s), dtype=torch.float64, device=device)


def make_update(loss_fn: Callable, optimizer: torch.optim.Optimizer,
                scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None):
    """(*batch) -> (loss, aux): one gradient step of `loss_fn(*batch)` ->
    (loss, aux) on the optimizer's parameters, then one step of the LR
    schedule where there is one (step k updates at the schedule's value at
    k, as optax evaluates a schedule at the count before the update).  A
    step is the span `step` (utils/profiling)."""

    def update(*batch):
        with span("step"):
            optimizer.zero_grad(set_to_none=True)
            loss, aux = loss_fn(*batch)
            loss.backward()
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            return loss.detach(), aux

    return update


class TrainHarness:
    """Checkpoint/resume + phase timing for the discovery training loops.

    The state saved every `ckpt_every` epochs is the model's, the
    optimizer's (Adam's moments and step counts) and, where the run has one,
    the LR scheduler's (its step count, which carries a cosine decay and a
    frozen-group window across a restart).  On construction the latest
    checkpoint in `log_dir` is loaded into the three objects in place, onto
    `device`, and `start_epoch` follows it.

    Usage:
        harness = TrainHarness(log_dir, model, optimizer, scheduler, log=log)
        for epoch in range(harness.start_epoch, cfg.epochs):
            with harness.timer.phase("update", sync=loss):
                ...train steps...
            harness.end_epoch(epoch)
    """

    def __init__(
        self,
        log_dir: str,
        model: torch.nn.Module,
        optimizer: torch.optim.Optimizer,
        scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
        resume: bool = True,
        ckpt_every: int = 25,
        log=None,
        device="cuda",
    ):
        self.ckpt = Checkpointer(log_dir)
        self.ckpt_every = ckpt_every
        self.timer = PhaseTimer()
        self.log = log
        self.model, self.optimizer, self.scheduler = model, optimizer, scheduler
        self.start_epoch = 0
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                self.load_state_dict(self.ckpt.restore(latest, map_location=device))
                self.start_epoch = latest + 1
                if log:
                    log.info(f"resumed from checkpoint at epoch {latest}")

    def state_dict(self) -> Dict[str, Any]:
        sd = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}
        if self.scheduler is not None:
            sd["scheduler"] = self.scheduler.state_dict()
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])

    def end_epoch(self, epoch: int) -> None:
        if self.ckpt_every and (epoch + 1) % self.ckpt_every == 0:
            with self.timer.phase("checkpoint"):
                self.ckpt.save(epoch, self.state_dict())
            if self.log:
                self.log.info("phase timings:\n" + self.timer.report())
