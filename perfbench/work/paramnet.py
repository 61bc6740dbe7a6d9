"""The work of the ParamNets in one training step: each net's forward
matmuls (1 x in -> width -> ... -> n_out), their backward (the weight and
input gradients: twice the forward's operations) and Adam's update of every
parameter (read p, g, m, v; write p, m, v: 28 bytes a float32 parameter).
The bytes of the matmuls count each weight read once a pass."""

from __future__ import annotations

from typing import Dict, List

from perfbench.lib.roofline import Op


def ops(cfg: Dict, solves, n_steps: int) -> List[Op]:
    p = cfg["paramnets"]
    dims = [p["in_dim"]] + [p["width"]] * p["depth"] + [p["n_out"]]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    params = macs + sum(dims[1:]) + p["in_dim"]
    n = p["count"] * n_steps
    return [Op("paramnet.fwd_bwd", n, 3 * 2 * macs, 3 * 4 * macs),
            Op("paramnet.adam", n, 0, 28 * params)]
