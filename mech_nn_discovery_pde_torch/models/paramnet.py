"""ParamNet: learned-input MLP emitting PDE basis coefficients.

A trainable 512-vector fed through a ReLU MLP producing n_out coefficients
(2 hidden layers for GL).  Initialisation follows the JAX package's flax
defaults (input ~ N(0, 1), Dense kernels lecun-normal truncated at 2 std,
zero biases), drawn from an explicit `torch.Generator`; the tests load the
JAX package's parameters instead (`state_dict_from_flax`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


@torch.no_grad()
def lecun_normal_(layer: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default init of a Dense or Conv layer: weight ~ lecun-normal
    (variance_scaling(1, fan_in, truncated_normal), truncated at 2 std, with
    fan_in = in features x kernel volume), bias 0."""
    w = layer.weight
    fan_in = w.shape[1] * int(np.prod(w.shape[2:]))
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    layer.bias.zero_()


class ParamNet(nn.Module):
    def __init__(self, n_out: int, width: int = 1024, in_dim: int = 512, depth: int = 2,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.input = nn.Parameter(torch.empty((1, in_dim), **kw))
        dims = [in_dim] + [width] * depth + [n_out]
        self.layers = nn.ModuleList(nn.Linear(a, b, **kw) for a, b in zip(dims[:-1], dims[1:]))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.input.normal_(0.0, 1.0, generator=generator)
        for lin in self.layers:
            lecun_normal_(lin, generator)

    def forward(self) -> torch.Tensor:
        x = self.input
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.layers[-1](x)


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax ParamNet's parameters ({'params': {'input', 'Dense_i':
    {'kernel', 'bias'}}}, numpy arrays) as a ParamNet state_dict (CPU
    tensors).  flax Dense kernels are (in, out); nn.Linear weights are
    (out, in)."""
    p = params.get("params", params)
    sd = {"input": np.asarray(p["input"])}
    i = 0
    while f"Dense_{i}" in p:
        sd[f"layers.{i}.weight"] = np.asarray(p[f"Dense_{i}"]["kernel"]).T
        sd[f"layers.{i}.bias"] = np.asarray(p[f"Dense_{i}"]["bias"])
        i += 1
    return {k: torch.tensor(v) for k, v in sd.items()}
