"""The work of the multigrid layer's steps (forward + IFT backward), counted
from the solver's configuration and the iterations its solves ran, never
from the program's launch counters, so that the work counted stays the same
whatever implements it.  Where a count is uncertain it counts less.

Per step: one hierarchy (per smoothed level a 21-step power iteration for
lmax: 21 stencil applies and 21 block applies; the blocks' Cholesky and
inverse; the coarsest level's Cholesky and inverse), then one FGMRES solve
forward and one backward.  A solve of W windows of R iterations (every
window runs for the whole batch while any sample runs) takes 1 + W (R + 2)
fine stencil applies (W (2) with the fused matvec), W R V-cycles and W R
Gram-Schmidt passes (CGS2: 4 products with the basis built so far).  A
V-cycle takes on each smoothed level s_pre + s_post + 2 stencil applies
(one fewer with the residual reuse) and s_pre + s_post block applies, and
one product with the coarsest level's inverse.

Stencil apply (K1) on a level of N points, m unknowns a point, NC fields:
reads the fields and x, writes y (4 bytes each); 2 (m^2 + 2 nb) operations a
point, nb = NC - m^2 the off-point bands.  Block apply (K2):
roofline.block_apply."""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

import numpy as np

from perfbench.lib.roofline import Op, block_apply
from perfbench.reference import constraints


@lru_cache(maxsize=None)
def bands(dims: tuple) -> int:
    """Off-point couplings of the normal matrix on a grid: distinct
    (grid offset > 0 in C order, unknown i, unknown j) over the pairs of
    entries that share a row (the equation and boundary rows couple a
    point with itself only)."""
    n = len(dims)
    s = constraints.build(dims, [1.0] * n, np.zeros(dims, dtype=bool))
    m = s.m
    inv = np.argsort(s.point_of)
    coords = np.stack(np.unravel_index(inv[s.cols // m], dims), axis=1)
    counts = np.bincount(s.rows)
    K = int(counts.max())
    order = np.argsort(s.rows, kind="stable")
    slot = np.arange(s.rows.size) - np.repeat(np.cumsum(counts) - counts, counts)
    E = np.full((counts.size, K), -1)
    E[s.rows[order], slot] = order
    a = np.repeat(E, K, axis=1).reshape(-1)
    b = np.tile(E, (1, K)).reshape(-1)
    ok = (a >= 0) & (b >= 0)
    a, b = a[ok], b[ok]
    d = coords[b] - coords[a]
    base = 2 * max(dims) + 1
    key = sum(d[:, c] * base ** (n - 1 - c) for c in range(n))
    pos = key > 0
    keys = np.stack([key[pos], s.cols[a[pos]] % m, s.cols[b[pos]] % m], axis=1)
    return int(np.unique(keys, axis=0).shape[0])


def levels(cfg: Dict) -> List[tuple]:
    dims = np.array(cfg["solver_dim"])
    out = []
    for _ in range(cfg["n_grid"]):
        out.append(tuple(int(d) for d in dims))
        if cfg["downsample_first"]:
            dims = dims // 2
        else:
            dims = np.concatenate([dims[:1], dims[1:] // 2])
    return out


def ops(cfg: Dict, solves: Dict[str, List[int]], n_steps: int) -> List[Op]:
    """The operations of n_steps steps whose forward and backward solves
    ran `solves['fwd_max']` and `solves['bwd_max']` iterations (the most of
    any sample, per solve)."""
    p = cfg["pde"]
    bs = cfg["batch_size"]
    R_f, R_b = p["mg_fgmres_restarts_forward"], p["mg_fgmres_restarts_backward"]
    s_pre, s_post = p["mg_smoother_steps_pre"], p["mg_smoother_steps_post"]
    reuse, fused = p["mg_smoother_residual"], p["mg_fused_matvec"]
    lv = levels(cfg)
    n = len(lv[0])
    m = 1 + 2 * n
    n_win = [sum(-(-i // R_f) for i in solves["fwd_max"]),
             sum(-(-i // R_b) for i in solves["bwd_max"])]
    vcycles = n_win[0] * R_f + n_win[1] * R_b
    out: List[Op] = []
    for k, dims in enumerate(lv[:-1]):
        N = int(np.prod(dims))
        nb = bands(dims)
        k1 = Op(f"k1.level{k}", 0, 2 * (m * m + 2 * nb) * N * bs,
                4 * ((m * m + nb) + 2 * m) * N * bs)
        k1.count = 21 * n_steps + vcycles * (s_pre + s_post + (1 if reuse else 2))
        if k == 0:
            n_solves = len(solves["fwd_max"]) + len(solves["bwd_max"])
            k1.count += n_solves + sum(w * (2 if fused else R + 2)
                                       for w, R in zip(n_win, (R_f, R_b)))
        nt = 1 if p["mg_block_smoother"] == "point" else dims[0]
        bw = nt * m
        S = N // nt
        k2 = block_apply(S * bs, bw, N * m * bs)
        k2.name = f"k2.level{k}"
        k2.count = 21 * n_steps + vcycles * (s_pre + s_post)
        fac = Op(f"factor.level{k}", n_steps * S * bs, bw**3, 2 * bw * bw * 4)
        out += [k1, k2, fac]
    nc = int(np.prod(lv[-1])) * m
    out.append(Op("coarse_factor", n_steps * bs, nc**3, 2 * nc * nc * 4))
    out.append(Op("coarse_apply", vcycles, 2 * nc * nc * bs, 4 * nc * nc * bs))
    n0 = int(np.prod(lv[0])) * m
    # CGS2: iteration j of a window projects on j + 1 basis vectors, 4 products
    for w, R, name in zip(n_win, (R_f, R_b), ("fwd", "bwd")):
        rows = w * R * (R + 1) / 2
        out.append(Op(f"orth.{name}", rows, 4 * 2 * n0 * bs, 4 * n0 * 4 * bs))
    return out
