"""Shared discovery-training utilities: step parameterization and the
training-step factory."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from scipy.special import logit


def fixed_steps(step_size: float, bs: int, dim: int, lo: float = None, hi: float = None,
                device="cuda") -> torch.Tensor:
    """Reference step parameterization: sigmoid(logit(h)) expanded over the
    grid, optionally clipped.  Steps are fixed buffers (not trained)."""
    s = 1.0 / (1.0 + np.exp(-logit(step_size)))
    if lo is not None:
        s = np.clip(s, lo, hi)
    return torch.full((bs, dim - 1), float(s), dtype=torch.float64, device=device)


def make_update(loss_fn: Callable, optimizer: torch.optim.Optimizer):
    """(*batch) -> (loss, aux): one gradient step of `loss_fn(*batch)` ->
    (loss, aux) on the optimizer's parameters."""

    def update(*batch):
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(*batch)
        loss.backward()
        optimizer.step()
        return loss.detach(), aux

    return update
