"""The work of the dense layer's steps (forward + IFT backward) under the
'f32_ir' policy, from the configuration: per sample AtA formed from the
pairs of entries that share a row (2 operations a pair; the n x n float32
matrix written once), its equilibration (read and written once), the
float32 Cholesky (n^3 / 3 operations), and in each of the two solves
ir_steps + 1 preconditioner applications (two triangular solves: n^2
operations and the factor's triangle read, each) and ir_steps products
with the float64 normal operator through A (4 operations an entry)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from perfbench.lib.roofline import PEAK_F64_FLOPS, Op
from perfbench.reference import constraints


def ops(cfg: Dict, solves, n_steps: int) -> List[Op]:
    dims = tuple(cfg["solver_dim"])
    s = constraints.build(dims, [1.0] * len(dims), np.zeros(dims, dtype=bool))
    k = np.bincount(s.rows, minlength=s.n_rows)
    k[s.eq_rows] += s.m  # the equation entries are not in s.rows
    k[s.bnd_rows] = 1
    pairs = int((k.astype(np.int64) ** 2).sum())
    nnz = int(k.sum())
    n, bs = s.n_vars, cfg["batch_size"]
    steps = cfg["pde"]["ir_steps"]
    m = n_steps * bs
    return [Op("dense.normal", m, 2 * pairs, 4 * n * n),
            Op("dense.equilibrate", m, 2 * n * n, 8 * n * n),
            Op("dense.cholesky", m, n**3 / 3, 8 * n * n),
            Op("dense.trsv", m * 2 * 2 * (steps + 1), n * n, 4 * n * n / 2),
            Op("dense.normal_matvec", m * 2 * steps, 4 * nnz, 8 * (2 * nnz + 2 * n),
               PEAK_F64_FLOPS)]
