"""The networks of the discovery problems, plainly, on a dict of leaves
(name -> tensor) in the names the weights are made under (inputs/*.py), and
Adam as torch.optim.Adam defines it."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F


def paramnet(w: Dict[str, torch.Tensor], prefix: str, depth: int) -> torch.Tensor:
    """A learned 512-vector through `depth` ReLU layers and a linear head:
    the basis coefficients, (n_out,)."""
    x = w[f"{prefix}.input"]
    for i in range(depth + 1):
        x = x @ w[f"{prefix}.layers.{i}.weight"].T + w[f"{prefix}.layers.{i}.bias"]
        if i < depth:
            x = torch.relu(x)
    return x[0]


def resnet(w: Dict[str, torch.Tensor], prefix: str, n_convs: int, x: torch.Tensor) -> torch.Tensor:
    """5x5 convolutions (zero padding 2), each inner layer adding the
    previous layer's pre-activation, ReLU between: x (bs, C, H, W)."""
    conv = lambda i, t: F.conv2d(t, w[f"{prefix}.convs.{i}.weight"],
                                 w[f"{prefix}.convs.{i}.bias"], padding=2)
    x = conv(0, x)
    prev = x
    x = torch.relu(x)
    for i in range(1, n_convs - 1):
        x = conv(i, x) + prev
        prev = x
        x = torch.relu(x)
    return conv(n_convs - 1, x)


class Adam:
    """Adam with torch.optim.Adam's defaults (betas 0.9, 0.999, eps 1e-8,
    no weight decay), leaf by leaf."""

    def __init__(self, names: List[str], lr: float, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0
        self.names = names

    @torch.no_grad()
    def step(self, w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for n in self.names:
            g = grads[n]
            m = self.m.get(n, torch.zeros_like(g)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(n, torch.zeros_like(g)) * self.b2 + (1 - self.b2) * g * g
            self.m[n], self.v[n] = m, v
            w[n] -= (self.lr / bc1) * m / (v.sqrt() / bc2**0.5 + self.eps)
