"""The least-squares constraint system of a mechanistic PDE layer, written
plainly from the formulation (Pervez et al., "Mechanistic PDE Networks for
Discovery of Governing Equations", ICML 2025, arXiv 2502.18377), with no
code of the program.

On a grid of `dims` points every point carries m = 1 + 2n unknowns: the value
u, the n first partials and the n pure second partials.  The rows are
  - equation rows at interior points (t >= 1, every spatial coordinate off
    its two faces): sum_mi c_mi(p) u_mi(p) = f(p);
  - boundary rows u(p) = g(p) at the points the problem lists;
  - for each coordinate c and order k in (1, 2), at every point, a 5-point
    4th-order stencil of the values against the derivative:
    sum_i w_i u(p + o_i e_c) - h_c^k u_{c^k}(p) = 0, centred in the
    interior and one-sided (o = 0..4, or 0..-4) within 2 of an edge;
  - Taylor rows along c, forward where p + e_c is on the grid and backward
    where p - e_c is:  u(p) +- h u_c(p) + h^2/2 u_cc(p) - u(p +- e_c) = 0.
Steps are uniform per coordinate.  The rows are unweighted, so the solution
is that of the same least-squares problem whatever the order of rows.

Unknowns are numbered in the reference's own order: grid axes rotated so the
last axis is outermost (point (a_last, a_0, .., a_{n-2}) in C order), then mi.
The normal matrix then couples a plane of the last axis with the planes
within 4 of it only, which `banded.py` uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

_CENTRAL = (np.array([-2, -1, 0, 1, 2]),
            np.array([1 / 12, -2 / 3, 0.0, 2 / 3, -1 / 12]),
            np.array([-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12]))
_EDGE1 = np.array([-25 / 12, 4.0, -3.0, 4 / 3, -1 / 4])
_EDGE2 = np.array([35 / 12, -26 / 3, 19 / 2, -14 / 3, 11 / 12])


@dataclass
class System:
    dims: tuple
    m: int
    n_vars: int
    n_rows: int
    # static entries (derivative and boundary rows): rows, cols, values
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    # equation rows: row of each interior point, the point's grid index
    # (C order of `dims`), and its m columns
    eq_rows: np.ndarray
    eq_points: np.ndarray
    eq_cols: np.ndarray  # (n_eq, m)
    # boundary rows: row, grid index of the point
    bnd_rows: np.ndarray
    bnd_points: np.ndarray
    # grid index (C order of `dims`) -> reference point number
    point_of: np.ndarray

    def value_col(self, points: np.ndarray, mi: int = 0) -> np.ndarray:
        return self.point_of[points] * self.m + mi


def build(dims: Sequence[int], steps: Sequence[float], boundary: np.ndarray) -> System:
    """The system on a grid `dims` with uniform `steps`, boundary rows at the
    points where `boundary` (bool, shape dims) is true, equation rows at the
    interior points."""
    dims = tuple(int(d) for d in dims)
    n = len(dims)
    m = 1 + 2 * n
    G = int(np.prod(dims))
    grid = np.indices(dims).reshape(n, -1)  # (n, G), C order
    rot = [n - 1] + list(range(n - 1))
    point_of = np.ravel_multi_index(grid[rot], tuple(dims[i] for i in rot))

    def col(gidx, mi):
        return point_of[gidx] * m + mi

    strides = np.array([int(np.prod(dims[c + 1:])) for c in range(n)])
    gidx = np.arange(G)
    rows: List[np.ndarray] = []
    cols: List[np.ndarray] = []
    vals: List[np.ndarray] = []
    nrow = 0

    # equation rows
    interior = grid[0] >= 1
    for c in range(1, n):
        interior &= (grid[c] >= 1) & (grid[c] <= dims[c] - 2)
    eq_points = gidx[interior]
    n_eq = eq_points.size
    eq_rows = np.arange(n_eq)
    eq_cols = col(eq_points[:, None], np.arange(m)[None, :])
    nrow += n_eq

    # boundary rows
    bnd_points = gidx[np.asarray(boundary).reshape(-1)]
    bnd_rows = nrow + np.arange(bnd_points.size)
    rows.append(bnd_rows)
    cols.append(col(bnd_points, 0))
    vals.append(np.ones(bnd_points.size))
    nrow += bnd_points.size

    # 5-point stencil rows
    for c in range(n):
        d, h, pos = dims[c], float(steps[c]), grid[c]
        for k in (1, 2):
            offs = np.empty((G, 5), dtype=np.int64)
            w = np.empty((G, 5))
            left, right = pos < 2, pos >= d - 2
            mid = ~(left | right)
            offs[left] = np.arange(5)
            w[left] = _EDGE1 if k == 1 else _EDGE2
            offs[right] = -np.arange(5)
            w[right] = -_EDGE1 if k == 1 else _EDGE2
            offs[mid] = _CENTRAL[0]
            w[mid] = _CENTRAL[k]
            r = nrow + np.arange(G)
            nb = gidx[:, None] + offs * strides[c]
            rows += [np.repeat(r, 5), r]
            cols += [col(nb, 0).reshape(-1), col(gidx, 1 + c + (k - 1) * n)]
            vals += [w.reshape(-1), np.full(G, -h**k)]
            nrow += G

    # Taylor rows
    for c in range(n):
        d, h, pos = dims[c], float(steps[c]), grid[c]
        for sign in (1, -1):
            pts = gidx[pos < d - 1] if sign > 0 else gidx[pos > 0]
            hs = sign * h
            r = nrow + np.arange(pts.size)
            ent_cols = [col(pts, 0), col(pts, 1 + c), col(pts, 1 + n + c),
                        col(pts + sign * strides[c], 0)]
            ent_vals = [1.0, hs, hs * hs / 2, -1.0]
            for cc, vv in zip(ent_cols, ent_vals):
                rows.append(r)
                cols.append(cc)
                vals.append(np.full(pts.size, vv))
            nrow += pts.size

    return System(dims=dims, m=m, n_vars=G * m, n_rows=nrow,
                  rows=np.concatenate(rows), cols=np.concatenate(cols),
                  vals=np.concatenate(vals), eq_rows=eq_rows, eq_points=eq_points,
                  eq_cols=eq_cols, bnd_rows=bnd_rows, bnd_points=bnd_points,
                  point_of=point_of)
