"""Seeds: one run's `--seed` (any whole number) split into independent
streams by name, and the weights drawn on the device in one call."""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List

import numpy as np
import torch


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the named stream of `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(stream_seed(seed, stream))


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def draw_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 leaves from one normal draw: a leaf named *.input stays N(0, 1),
    *.bias is 0.1 N(0, 1) / sqrt(fan_in) of its layer, every other leaf is a
    weight (out, in, ...) scaled by 1 / sqrt(fan_in) (LeCun's normal)."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights", device),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    fan = {}
    for name, shape in shapes.items():
        if name.endswith(".weight"):
            fan[name[: -len(".weight")]] = math.prod(shape[1:])
    for (name, shape), n in zip(shapes.items(), sizes):
        t = flat[off: off + n].view(shape)
        off += n
        if name.endswith(".weight"):
            t = t / math.sqrt(fan[name[: -len(".weight")]])
        elif name.endswith(".bias"):
            t = 0.1 * t / math.sqrt(fan[name[: -len(".bias")]])
        out[name] = t.contiguous()
    return out


def loader_plan(total: int, bs: int, loader_seed: int, n: int) -> List[np.ndarray]:
    """The item numbers of the first n batches of a shuffling, drop-last
    loader over `total` items whose NumPy generator is seeded with
    `loader_seed` and shuffles anew every epoch (the port's PatchLoader)."""
    rng = np.random.default_rng(loader_seed)
    out: List[np.ndarray] = []
    while len(out) < n:
        idx = np.arange(total)
        rng.shuffle(idx)
        out += [idx[b * bs:(b + 1) * bs] for b in range(total // bs)]
    return out[:n]
