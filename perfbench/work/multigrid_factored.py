"""The work of the multigrid layer's steps in 'bf16_factored' storage:
work/multigrid.py's count (levels, K1, the coarsest level, CGS2), with the
block applies counted as kernel K3 on the bfloat16 factors W = L^-T
(roofline.block_apply(..., entry_bytes=2, factored=True): W's upper
triangle read once, 4 operations an entry) and each block's factor as its
Cholesky and the triangular inverse that forms W (bw^3 / 3 operations
each; B read in float32, W written in bfloat16)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.lib.roofline import Op, block_apply
from perfbench.work import multigrid


def ops(cfg: Dict, solves: Dict[str, List[int]], n_steps: int) -> List[Op]:
    lv = multigrid.levels(cfg)
    m = 1 + 2 * len(lv[0])
    bs = cfg["batch_size"]
    point = cfg["pde"]["mg_block_smoother"] == "point"
    out: List[Op] = []
    for o in multigrid.ops(cfg, solves, n_steps):
        kind, _, k = o.name.partition(".level")
        if kind not in ("k2", "factor"):
            out.append(o)
            continue
        dims = lv[int(k)]
        N = int(np.prod(dims))
        nt = 1 if point else dims[0]
        bw, S = nt * m, N // nt
        if kind == "k2":
            k3 = block_apply(S * bs, bw, N * m * bs, entry_bytes=2, factored=True)
            k3.name, k3.count = f"k3.level{k}", o.count
            out.append(k3)
        else:
            out.append(Op(o.name, o.count, 2 * bw**3 / 3, (4 + 2) * bw * bw))
    return out
