"""Faults planted under a run's timed path, to see the comparison catch
them: each is a context manager that patches the program while it is open.

  frozen      the optimizer's step returns the state unchanged
  half_batch  the loader's second half of every batch repeats the first:
              half the batch left out, the mean taken over the rest
  altered     the layer's first answer is replaced by the second's where it
              is produced
(The exchange between chips has no fault here: every cell takes one chip.)

LOWER holds the program run below the precision its configuration states:
  bf16_networks  every linear layer and convolution computes in bfloat16"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from mech_nn_discovery_pde_torch.data.datasets import PatchLoader
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer


@contextlib.contextmanager
def _patched(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def frozen():
    return _patched(torch.optim.Adam, "step", lambda old: lambda self, closure=None: None)


def half_batch():
    def new(old):
        def it(self):
            for batch in old(self):
                out = []
                for a in batch:
                    a = np.array(a)
                    h = a.shape[0] // 2
                    a[a.shape[0] - h:] = a[:h]
                    out.append(a)
                yield tuple(out)
        return it
    return _patched(PatchLoader, "__iter__", new)


def altered():
    stack = contextlib.ExitStack()

    def new(old):
        def call(self, *args):
            _, u, stats = old(self, *args)
            u = u.clone()
            u[0] = u[1].detach()
            return u[..., 0], u, stats
        return call

    for cls in (MultigridLayer, PDEDenseLayer):
        stack.enter_context(_patched(cls, "__call__", new))
    return stack


FAULTS = {"frozen": frozen, "half_batch": half_batch, "altered": altered}


def bf16_networks():
    bf = torch.bfloat16
    stack = contextlib.ExitStack()
    stack.enter_context(_patched(torch.nn.Linear, "forward", lambda old: lambda self, x: F.linear(
        x.to(bf), self.weight.to(bf), self.bias.to(bf)).to(x.dtype)))
    stack.enter_context(_patched(torch.nn.Conv2d, "forward", lambda old: lambda self, x: (
        self._conv_forward(x.to(bf), self.weight.to(bf), self.bias.to(bf)).to(x.dtype))))
    return stack


LOWER = {"bf16_networks": bf16_networks}
