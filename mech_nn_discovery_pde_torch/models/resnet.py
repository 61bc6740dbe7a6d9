"""Learned denoising transforms: convolutional ResNets (port of the JAX
package's models/resnet.py).

- `ResNet`: a plain 2D ResNet, 5x5 convs at `width` channels (128), `depth`
  (12) residual layers each adding the previous layer's pre-activation, ReLU.
- `ResNet1D`, `ResNet2D`, `ResNet3D` (`_ResNetND`): a pointwise lift to
  `width`, `depth` blocks of a 5^n conv plus a 1^n shortcut conv and ReLU,
  then a pointwise head width -> 128 -> ReLU -> out.  1D pads circularly.

Layout: every public forward takes and returns the JAX package's
channels-last layout ((bs, H, W, C) and its 1D / 3D analogues); inside, the
convs run channels-first (NCHW), the layout of torch's convolutions, with one
transpose on the way in and one on the way out.  On CUDA the convs go through
cuDNN, which PyTorch lets use TF32 unless `torch.backends.cudnn.allow_tf32`
is False.

Initialisation follows the JAX package's flax defaults (kernels lecun-normal
truncated at 2 std with fan_in = in channels x kernel volume, zero biases),
drawn from an explicit `torch.Generator`; the tests load the JAX package's
parameters instead (`state_dict_from_flax`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mech_nn_discovery_pde_torch.models.paramnet import lecun_normal_

_CONV = {1: nn.Conv1d, 2: nn.Conv2d, 3: nn.Conv3d}


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


class ResNet(nn.Module):
    """(bs, H, W, in_channels) -> (bs, H, W, out_channels)."""

    def __init__(self, out_channels: int = 1, in_channels: int = 1, width: int = 128,
                 depth: int = 12, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        chans = [in_channels] + [width] * (depth + 1) + [out_channels]
        self.convs = nn.ModuleList(
            nn.Conv2d(a, b, 5, padding=2, device=device) for a, b in zip(chans[:-1], chans[1:]))
        for c in self.convs:
            lecun_normal_(c, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs[0](_to_channels_first(x))
        prev = x
        x = torch.relu(x)
        for conv in self.convs[1:-1]:
            x = conv(x) + prev
            prev = x
            x = torch.relu(x)
        return _to_channels_last(self.convs[-1](x))


class _ResBlock(nn.Module):
    """5^n conv + 1^n shortcut conv, then ReLU."""

    def __init__(self, width: int, ndim: int, circular: bool, device, generator):
        super().__init__()
        mode = "circular" if circular else "zeros"
        self.conv = _CONV[ndim](width, width, 5, padding=2, padding_mode=mode, device=device)
        self.shortcut = _CONV[ndim](width, width, 1, device=device)
        lecun_normal_(self.conv, generator)
        lecun_normal_(self.shortcut, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(x) + self.shortcut(x))


class _ResNetND(nn.Module):
    """Pointwise lift -> residual conv blocks -> pointwise head, channels-last
    at the boundary: (bs, *spatial, in_channels) -> (bs, *spatial,
    out_channels)."""

    def __init__(self, ndim: int, out_channels: int = 1, in_channels: int = 1, width: int = 100,
                 depth: int = 9, circular: bool = False, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lift = nn.Linear(in_channels, width, device=device)
        self.blocks = nn.ModuleList(
            _ResBlock(width, ndim, circular, device, generator) for _ in range(depth))
        self.head = nn.Linear(width, 128, device=device)
        self.out = nn.Linear(128, out_channels, device=device)
        for lin in (self.lift, self.head, self.out):
            lecun_normal_(lin, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _to_channels_first(self.lift(x))
        for blk in self.blocks:
            x = blk(x)
        return self.out(torch.relu(self.head(_to_channels_last(x))))


def ResNet1D(out_channels: int = 1, in_channels: int = 1, width: int = 100, depth: int = 9,
             **kw) -> _ResNetND:
    """(bs, L, C) -> (bs, L, out_channels); circular padding."""
    return _ResNetND(1, out_channels, in_channels, width, depth, circular=True, **kw)


def ResNet2D(out_channels: int = 1, in_channels: int = 1, width: int = 100, depth: int = 9,
             **kw) -> _ResNetND:
    """(bs, H, W, C) -> (bs, H, W, out_channels)."""
    return _ResNetND(2, out_channels, in_channels, width, depth, **kw)


def ResNet3D(out_channels: int = 1, in_channels: int = 1, width: int = 64, depth: int = 7,
             **kw) -> _ResNetND:
    """(bs, D, H, W, C) -> (bs, D, H, W, out_channels)."""
    return _ResNetND(3, out_channels, in_channels, width, depth, **kw)


def _conv(p) -> Dict[str, np.ndarray]:
    """A flax Conv's {'kernel': (k..., in, out), 'bias'} as torch's weight
    (out, in, k...) and bias."""
    k = np.asarray(p["kernel"])
    n = k.ndim - 2
    return {"weight": np.transpose(k, (n + 1, n, *range(n))), "bias": np.asarray(p["bias"])}


def _dense(p) -> Dict[str, np.ndarray]:
    """A flax Dense's kernel (in, out) as nn.Linear's weight (out, in)."""
    return {"weight": np.asarray(p["kernel"]).T, "bias": np.asarray(p["bias"])}


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """A flax ResNet's or _ResNetND's parameters (numpy arrays, with or
    without the top-level 'params' key) as the matching module's
    state_dict (CPU tensors)."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}

    def put(prefix, d):
        sd.update({f"{prefix}.{k}": v for k, v in d.items()})

    if "Dense_0" in p:  # _ResNetND
        put("lift", _dense(p["Dense_0"]))
        put("head", _dense(p["Dense_1"]))
        put("out", _dense(p["Dense_2"]))
        i = 0
        while f"_ResBlock_{i}" in p:
            put(f"blocks.{i}.conv", _conv(p[f"_ResBlock_{i}"]["Conv_0"]))
            put(f"blocks.{i}.shortcut", _conv(p[f"_ResBlock_{i}"]["Conv_1"]))
            i += 1
    else:  # ResNet
        i = 0
        while f"Conv_{i}" in p:
            put(f"convs.{i}", _conv(p[f"Conv_{i}"]))
            i += 1
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
