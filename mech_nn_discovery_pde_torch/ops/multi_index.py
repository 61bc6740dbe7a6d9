"""Multi-index algebra and variable indexing for PDE grid systems.

Each grid point of an n-dimensional grid carries one unknown per allowed
derivative multi-index: the function value, all first partials, and (for total
order 2) all *pure* second partials — mixed second derivatives are excluded.
2D ordering: [u, u_t, u_x, u_tt, u_xx]; 3D: [u, u_t, u_x, u_y, u_tt, u_xx,
u_yy].  The flat variable index is the C-order ravel of (grid_point,
mi_index).

Parity: reference solver/lp_pde_central_diff.py:33-348 (QPVariableSet);
mi construction :274-338, variable ravel :96-107, edge predicates :198-235.
"""

from __future__ import annotations

import numpy as np


class VariableSet:
    """Variable indexing for a grid of `coord_dims` points with derivative
    unknowns up to total order `order` (1 or 2)."""

    def __init__(self, coord_dims, order: int):
        self.coord_dims = tuple(int(d) for d in coord_dims)
        self.n_coord = len(self.coord_dims)
        self.order = int(order)
        self.grid_size = int(np.prod(self.coord_dims))

        n = self.n_coord
        zero = (0,) * n

        def unit(i, k=1):
            v = [0] * n
            v[i] = k
            return tuple(v)

        if order == 2:
            # value, first partials, pure second partials
            self.mi_list = (zero,) + tuple(unit(i) for i in range(n)) + tuple(
                unit(i, 2) for i in range(n)
            )
        elif order == 1:
            self.mi_list = (zero,) + tuple(unit(i) for i in range(n))
        else:
            raise ValueError("unsupported total order (must be 1 or 2)")

        self.mi_to_index = {mi: i for i, mi in enumerate(self.mi_list)}
        self.n_mi = len(self.mi_list)

        # human-readable labels: u, u_x0, ..., u_x0x0, ...
        reprs = ["u"] + [f"u_x{i}" for i in range(n)]
        if order == 2:
            reprs += [f"u_x{i}x{i}" for i in range(n)]
        self.mi_repr = reprs

        self.num_vars = self.grid_size * self.n_mi

        # time-derivative mi indices (u_t and, for order 2, u_tt)
        self.t_deriv_mi_indices = [1] + ([1 + n] if order == 2 else [])

    # ---- index helpers ------------------------------------------------

    def first_deriv_index(self, coord: int) -> int:
        """mi index of the first partial along `coord`."""
        return 1 + coord

    def second_deriv_index(self, coord: int) -> int:
        """mi index of the pure second partial along `coord`."""
        if self.order < 2:
            raise ValueError("no second derivatives for order-1 system")
        return 1 + self.n_coord + coord

    def central_mi_indices(self, coord: int):
        """mi indices with nonzero order along `coord`, sorted by that order.

        For this mi set only the first and (order 2) pure-second partials
        along `coord` qualify.  Reference: get_higher_order_sorted_mi_indices
        (lp_pde_central_diff.py:247-272)."""
        out = [self.first_deriv_index(coord)]
        if self.order == 2:
            out.append(self.second_deriv_index(coord))
        return out

    def var_index(self, grid_flat, mi_index):
        """Flat variable index for (flat grid index, mi index); C-order."""
        return np.asarray(grid_flat) * self.n_mi + mi_index

    # ---- grid predicates (vectorized over a (npoints, n_coord) array) --

    def grid_indices(self) -> np.ndarray:
        """(grid_size, n_coord) array of grid coordinates in C-order."""
        return np.indices(self.coord_dims).reshape(self.n_coord, -1).T

    def is_boundary_or_initial(self, gi: np.ndarray) -> np.ndarray:
        """True where the equation constraint is NOT placed: the t=0 face and
        all spatial boundary faces (reference :228-235)."""
        gi = np.atleast_2d(gi)
        mask = gi[:, 0] == 0
        for c in range(1, self.n_coord):
            mask |= (gi[:, c] == 0) | (gi[:, c] == self.coord_dims[c] - 1)
        return mask

    def interior_flat_indices(self) -> np.ndarray:
        """Flat indices (C-order) of equation-constraint (interior) points."""
        gi = self.grid_indices()
        return np.nonzero(~self.is_boundary_or_initial(gi))[0]

    def solution_shape(self, bs: int):
        return (bs, self.grid_size, self.n_mi)
