"""ParamNet: learned-input MLP emitting PDE basis coefficients.

A trainable 512-vector fed through a ReLU MLP producing n_out coefficients
(3 hidden layers for Burgers, 2 for GL and Kamani).  Initialisation follows
the JAX package's flax defaults (input ~ N(0, 1), Dense kernels lecun-normal
truncated at 2 std, zero biases), drawn from an explicit `torch.Generator`;
the tests load the JAX package's parameters instead (`state_dict_from_flax`).

The JAX package's knobs, with its defaults: `dtype` (its `param_dtype`: f32
or f64 nets), `torch_init` (PyTorch's own Linear/Conv default, U(+-1/sqrt(
fan_in)) for weight and bias, in place of flax's), `zero_out_init` (the head
starts at exactly 0) and `out_scale` (multiplies the head's output).
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


@torch.no_grad()
def torch_default_(layer: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """PyTorch's default init of a Linear or Conv layer (its
    `reset_parameters`: weight kaiming-uniform with a = sqrt(5), i.e.
    U(+-1/sqrt(fan_in)), bias U(+-1/sqrt(fan_in))), the same calls in the
    same order, drawn from `generator` instead of the global RNG."""
    nn.init.kaiming_uniform_(layer.weight, a=math.sqrt(5), generator=generator)
    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(layer.weight)
    bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
    nn.init.uniform_(layer.bias, -bound, bound, generator=generator)


def init_layer_(layer: nn.Module, torch_init: bool,
                generator: Optional[torch.Generator] = None) -> None:
    """flax's default init, or PyTorch's with `torch_init`."""
    (torch_default_ if torch_init else lecun_normal_)(layer, generator)


class ParamNet(nn.Module):
    def __init__(self, n_out: int, width: int = 1024, in_dim: int = 512, depth: int = 2,
                 dtype=torch.float32, torch_init: bool = False, zero_out_init: bool = False,
                 out_scale: float = 1.0, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.torch_init, self.zero_out_init, self.out_scale = torch_init, zero_out_init, out_scale
        self.input = nn.Parameter(torch.empty((1, in_dim), **kw))
        dims = [in_dim] + [width] * depth + [n_out]
        self.layers = nn.ModuleList(nn.Linear(a, b, **kw) for a, b in zip(dims[:-1], dims[1:]))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.input.normal_(0.0, 1.0, generator=generator)
        for lin in self.layers:
            init_layer_(lin, self.torch_init, generator)
        if self.zero_out_init:
            self.layers[-1].weight.zero_()
            self.layers[-1].bias.zero_()

    def forward(self) -> torch.Tensor:
        x = self.input
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.out_scale * self.layers[-1](x)


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
