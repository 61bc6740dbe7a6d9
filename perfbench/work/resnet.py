"""The work of the 2D ResNet in one training step, on the whole field
(H x W, one image): each k x k convolution's forward (2 Cin Cout k^2 H W
operations), its weight gradient (as many) and, past the first layer, its
input gradient (as many), in float32 (TF32 off).  The bytes count each
layer's input and output activations once a pass."""

from __future__ import annotations

from typing import Dict, List

from perfbench.lib.roofline import Op


def ops(cfg: Dict, solves, n_steps: int) -> List[Op]:
    r = cfg["resnet"]
    H, W = cfg["field"]["nt"], cfg["field"]["nx"]
    k = r["kernel"]
    chans = [1] + [r["width"]] * (r["depth"] + 1) + [1]
    out = []
    for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
        passes = 2 if i == 0 else 3
        out.append(Op(f"resnet.conv{i}", n_steps * passes, 2 * a * b * k * k * H * W,
                      4 * (a + b) * H * W))
    return out
