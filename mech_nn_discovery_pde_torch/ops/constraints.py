"""Static constraint-pattern construction for PDE least-squares systems.

The constraint matrix `A` stacks three row blocks:

  [ equation ; initial/boundary ; derivative(smoothness) ]

The *sparsity pattern* (row/col index arrays) and the *static* (uniform-step)
values are built once here with vectorized NumPy.  Runtime values are filled
per forward pass by pure jitted JAX code (ops/stencil.py + ops/system.py) in
exactly the entry order constructed here, so a fill is just "compute a value
vector" — no sparse formats, no coalescing.

Constraint families (reference solver/lp_pde_central_diff.py):

1. Equation rows (:746-764): one row per interior grid point (skipping the
   t=0 face and all spatial boundary faces), Sum_mi c_mi(p) * var(p, mi) =
   rhs(p); coefficient values and rhs are runtime placeholders.
2. Initial/boundary rows (:1008-1033): driven by `init_index_mi_list`
   lambdas f(*coord_dims) -> (coord, mi_index, range_begin, range_end); one
   row 1*var(p, mi) = rhs per box point (repeated n_iv times).
3. Derivative rows, rhs = 0:
   - central 5-point 4th-order stencils relating the 5 neighboring *values*
     to the derivative var at the center (:944-991); points within 2 of an
     edge use one-sided 4th-order stencils (:886-941);
   - forward/backward Taylor chains u + h u_c + h^2/2 u_cc - u(next) = 0
     (:785-867, :877-884).

Entry ordering invariants (relied on by runtime fills):
  equation:   (interior point C-order) x (mi order)         -- :746-764
  derivative: [central | forward | backward], each looping
              coord -> grid point C-order -> mi -> stencil entries
  initial:    per init box (in list order) -> box point C-order -> iv repeat
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from mech_nn_discovery_pde_torch.ops.multi_index import VariableSet

# placeholder value for runtime-filled entries (reference Const.PH = -100)
PH = -100.0

# 4th-order uniform-step stencil weight tables (unscaled; the trailing
# derivative-var entry is -h^k).  Reference :926-940, :979-986.
_CENTRAL_W1 = np.array([1 / 12, -2 / 3, 0.0, 2 / 3, -1 / 12])
_CENTRAL_W2 = np.array([-1 / 12, 4 / 3, -5 / 2, 4 / 3, -1 / 12])
_EDGE_W1 = np.array([-25 / 12, 4.0, -3.0, 4 / 3, -1 / 4])
_EDGE_W2 = np.array([35 / 12, -104 / 12, 114 / 12, -56 / 12, 11 / 12])


@dataclass
class IVBox:
    """One initial/boundary constraint box."""

    coord: int
    mi_index: int
    begin: np.ndarray  # (n_coord,)
    end: np.ndarray  # (n_coord,) inclusive
    shape: Tuple[int, ...]  # end+1-begin
    flat_points: np.ndarray  # flat grid indices, box C-order

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


@dataclass
class ConstraintSpec:
    """Static structure of the stacked constraint system for one sample."""

    var_set: VariableSet
    coord_dims: Tuple[int, ...]
    order: int
    n_iv: int
    step_size: float

    # entry arrays per block (int32); rows are block-local and nondecreasing
    eq_rows: np.ndarray
    eq_cols: np.ndarray
    init_rows: np.ndarray
    init_cols: np.ndarray
    deriv_rows: np.ndarray
    deriv_cols: np.ndarray

    n_eq_rows: int
    n_init_rows: int
    n_deriv_rows: int

    # static (uniform-step) values; equation entries hold the PH placeholder
    eq_values_static: np.ndarray
    init_values_static: np.ndarray
    deriv_values_static: np.ndarray

    # initial/boundary metadata (for runtime rhs routing + MG downsampling)
    iv_boxes: List[IVBox] = field(default_factory=list)

    # evolution=True redirects equation-row time-derivative entries to the
    # previous time step (reference :756-761).  The structured/stencil fast
    # paths assume same-point equation entries and must not be used then.
    evolution: bool = False

    # per-coord central-stencil layout metadata used by the runtime fill
    # (n_central_mi = number of derivative orders handled per point per coord)
    n_central_mi: int = 0
    # sub-block boundaries inside the derivative block (central | fwd | bwd
    # taylor), in rows and entries — used for per-block spectral rescaling of
    # multigrid coarse operators
    n_central_rows: int = 0
    n_central_entries: int = 0

    # ---- derived -------------------------------------------------------

    @property
    def n_rows(self) -> int:
        return self.n_eq_rows + self.n_init_rows + self.n_deriv_rows

    @property
    def num_vars(self) -> int:
        return self.var_set.num_vars

    @property
    def rows_all(self) -> np.ndarray:
        """Global (stacked) row index per entry, in value-vector order
        [equation | initial | derivative]."""
        return np.concatenate(
            [
                self.eq_rows,
                self.init_rows + self.n_eq_rows,
                self.deriv_rows + self.n_eq_rows + self.n_init_rows,
            ]
        ).astype(np.int32)

    @property
    def cols_all(self) -> np.ndarray:
        return np.concatenate([self.eq_cols, self.init_cols, self.deriv_cols]).astype(
            np.int32
        )

    @property
    def values_static_all(self) -> np.ndarray:
        """Static values per entry, in value-vector order."""
        return np.concatenate(
            [self.eq_values_static, self.init_values_static, self.deriv_values_static]
        )

    def describe(self) -> str:
        return (
            f"ConstraintSpec(dims={self.coord_dims}, order={self.order}, "
            f"vars={self.num_vars}, rows: eq={self.n_eq_rows} "
            f"init={self.n_init_rows} deriv={self.n_deriv_rows}, "
            f"nnz={self.cols_all.shape[0]})"
        )


# ---------------------------------------------------------------------------
# constraint blocks
# ---------------------------------------------------------------------------


def _point_strides(coord_dims) -> np.ndarray:
    """C-order flat-index strides per coordinate (in grid points)."""
    n = len(coord_dims)
    strides = np.ones(n, dtype=np.int64)
    for c in range(n - 2, -1, -1):
        strides[c] = strides[c + 1] * coord_dims[c + 1]
    return strides


def _equation_block(vs: VariableSet, evolution: bool = False):
    """One row per interior point over all mi.  With evolution=True the
    time-derivative mi entries reference the *previous* time step's point
    (reference build_equation_constraints :756-761 + t_deriv_mi_index); every
    reference layer instantiates evolution=False."""
    interior = vs.interior_flat_indices()  # C-order
    n_rows = interior.shape[0]
    n_mi = vs.n_mi
    points = np.broadcast_to(interior[:, None], (n_rows, n_mi)).copy()
    if evolution:
        stride_t = _point_strides(vs.coord_dims)[0]
        for mi_idx in vs.t_deriv_mi_indices:
            points[:, mi_idx] -= stride_t  # interior points have t >= 1
    cols = (points * n_mi + np.arange(n_mi)[None, :]).reshape(-1)
    rows = np.repeat(np.arange(n_rows), n_mi)
    values = np.full(cols.shape[0], PH)
    return rows.astype(np.int32), cols.astype(np.int32), values, n_rows


def central_offset_table(d: int) -> np.ndarray:
    """(d, 5) neighbor offsets along a coordinate of extent d: one-sided
    ascending for the two left-edge positions, centered for the interior,
    one-sided descending for the two right-edge positions."""
    if d < 6:
        raise ValueError(f"coordinate extent {d} < 6: 5-point stencils need >=6")
    offs = np.empty((d, 5), dtype=np.int64)
    offs[0:2] = np.array([0, 1, 2, 3, 4])
    offs[2 : d - 2] = np.array([-2, -1, 0, 1, 2])
    offs[d - 2 : d] = np.array([0, -1, -2, -3, -4])
    return offs


def _central_block_coord(vs: VariableSet, coord: int, step_size: float):
    """Central/edge stencil constraints for one coordinate: for each grid
    point (C-order) and each derivative order k in (1, .., order) along
    `coord`, one row with 6 entries: 5 neighbor values + the derivative var.
    """
    dims = vs.coord_dims
    n_mi = vs.n_mi
    d = dims[coord]
    stride = _point_strides(dims)[coord]
    flat = np.arange(vs.grid_size, dtype=np.int64)
    pos = vs.grid_indices()[:, coord].astype(np.int64)

    offs = central_offset_table(d)  # (d, 5)
    point_offs = offs[pos]  # (grid, 5)
    neighbor_flat = flat[:, None] + point_offs * stride  # (grid, 5)

    mi_indices = vs.central_mi_indices(coord)  # [first, (second)]
    n_cmi = len(mi_indices)

    # cols: (grid, n_cmi, 6)
    cols = np.empty((vs.grid_size, n_cmi, 6), dtype=np.int64)
    cols[:, :, :5] = (neighbor_flat * n_mi)[:, None, :]  # value vars (mi=0)
    for k, mi_idx in enumerate(mi_indices):
        cols[:, k, 5] = flat * n_mi + mi_idx

    # static values per position class and derivative order
    h = step_size
    vtab = np.empty((d, n_cmi, 6))
    w1 = {True: _CENTRAL_W1, False: _EDGE_W1}
    # left edge rows use the forward one-sided weights; right edge rows the
    # mirrored ones (odd orders flip sign; even orders keep it) since the
    # neighbors are enumerated in descending order.
    for p in range(d):
        if p < 2:
            tabs = [( _EDGE_W1, h), (_EDGE_W2, h * h)]
        elif p >= d - 2:
            tabs = [(-_EDGE_W1, h), (_EDGE_W2, h * h)]
        else:
            tabs = [(_CENTRAL_W1, h), (_CENTRAL_W2, h * h)]
        for k in range(n_cmi):
            w, hk = tabs[k]
            vtab[p, k, :5] = w
            vtab[p, k, 5] = -hk
    values = vtab[pos]  # (grid, n_cmi, 6)

    rows = np.repeat(np.arange(vs.grid_size * n_cmi), 6)
    return (
        rows.astype(np.int32),
        cols.reshape(-1).astype(np.int32),
        values.reshape(-1),
        vs.grid_size * n_cmi,
    )


def _taylor_block_coord(vs: VariableSet, coord: int, step_size: float, forward: bool):
    """Forward/backward Taylor constraints along `coord`: for every point not
    on the far (forward) / near (backward) edge, one row
      u(p) + h u_c(p) [+ h^2/2 u_cc(p)] - u(p +- 1) = 0
    with h = +step (forward) or the same with h -> -h (backward)."""
    dims = vs.coord_dims
    n_mi = vs.n_mi
    d = dims[coord]
    stride = _point_strides(dims)[coord]
    pos = vs.grid_indices()[:, coord].astype(np.int64)
    flat = np.arange(vs.grid_size, dtype=np.int64)

    mask = (pos < d - 1) if forward else (pos > 0)
    pts = flat[mask]  # C-order preserved
    n_rows = pts.shape[0]

    n_terms = vs.order + 2  # chain terms + neighbor entry
    cols = np.empty((n_rows, n_terms), dtype=np.int64)
    cols[:, 0] = pts * n_mi  # u
    cols[:, 1] = pts * n_mi + vs.first_deriv_index(coord)
    if vs.order == 2:
        cols[:, 2] = pts * n_mi + vs.second_deriv_index(coord)
    cols[:, -1] = (pts + (stride if forward else -stride)) * n_mi  # u(next/prev)

    h = step_size if forward else -step_size
    vals_row = np.array(
        [h**j / math.factorial(j) for j in range(vs.order + 1)] + [-1.0]
    )
    values = np.broadcast_to(vals_row, (n_rows, n_terms))

    rows = np.repeat(np.arange(n_rows), n_terms)
    return (
        rows.astype(np.int32),
        cols.reshape(-1).astype(np.int32),
        values.reshape(-1).copy(),
        n_rows,
    )


def _initial_block(vs: VariableSet, init_index_mi_list, n_iv: int):
    dims = vs.coord_dims
    n_mi = vs.n_mi
    boxes: List[IVBox] = []
    cols_parts = []
    for f in init_index_mi_list:
        coord, mi_index, begin, end = f(*dims)
        begin = np.asarray(begin, dtype=np.int64)
        end = np.asarray(end, dtype=np.int64)
        shape = tuple((end + 1 - begin).tolist())
        box_idx = np.indices(shape).reshape(len(dims), -1) + begin[:, None]
        flat_pts = np.ravel_multi_index(box_idx, dims)  # box C-order
        boxes.append(IVBox(coord, mi_index, begin, end, shape, flat_pts))
        # n_iv repeats per point (reference :1024-1031 inner loop)
        c = np.repeat(flat_pts * n_mi + mi_index, n_iv)
        cols_parts.append(c)
    if cols_parts:
        cols = np.concatenate(cols_parts)
    else:
        cols = np.zeros(0, dtype=np.int64)
    n_rows = cols.shape[0]
    rows = np.arange(n_rows)
    values = np.ones(n_rows)
    return rows.astype(np.int32), cols.astype(np.int32), values, n_rows, boxes


# ---------------------------------------------------------------------------
# the whole static structure
# ---------------------------------------------------------------------------


def build_constraint_spec(
    coord_dims: Sequence[int],
    order: int = 2,
    init_index_mi_list: Optional[List[Callable]] = None,
    n_iv: int = 1,
    step_size: float = 0.25,
    evolution: bool = False,
) -> ConstraintSpec:
    """Build the full static constraint structure for one sample."""
    init_index_mi_list = init_index_mi_list or []
    vs = VariableSet(coord_dims, order)

    eq_rows, eq_cols, eq_vals, n_eq = _equation_block(vs, evolution=evolution)

    # derivative block: [central | forward | backward], each over coords
    dr_parts, dc_parts, dv_parts = [], [], []
    row_off = 0
    n_central_rows = n_central_entries = 0
    for make_block, kwargs in (
        (_central_block_coord, {}),
        (_taylor_block_coord, {"forward": True}),
        (_taylor_block_coord, {"forward": False}),
    ):
        for coord in range(vs.n_coord):
            r, c, v, n = make_block(vs, coord, step_size, **kwargs)
            dr_parts.append(r + row_off)
            dc_parts.append(c)
            dv_parts.append(v)
            row_off += n
            if make_block is _central_block_coord:
                n_central_rows += n
                n_central_entries += c.shape[0]
    deriv_rows = np.concatenate(dr_parts).astype(np.int32)
    deriv_cols = np.concatenate(dc_parts).astype(np.int32)
    deriv_vals = np.concatenate(dv_parts)

    init_rows, init_cols, init_vals, n_init, boxes = _initial_block(
        vs, init_index_mi_list, n_iv
    )

    return ConstraintSpec(
        var_set=vs,
        coord_dims=tuple(coord_dims),
        order=order,
        n_iv=n_iv,
        step_size=step_size,
        eq_rows=eq_rows,
        eq_cols=eq_cols,
        init_rows=init_rows,
        init_cols=init_cols,
        deriv_rows=deriv_rows,
        deriv_cols=deriv_cols,
        n_eq_rows=n_eq,
        n_init_rows=n_init,
        n_deriv_rows=row_off,
        eq_values_static=eq_vals,
        init_values_static=init_vals,
        deriv_values_static=deriv_vals,
        iv_boxes=boxes,
        evolution=evolution,
        n_central_mi=len(vs.central_mi_indices(0)),
        n_central_rows=n_central_rows,
        n_central_entries=n_central_entries,
    )


# ---------------------------------------------------------------------------
# human-readable constraint rendering (reference repr_eq/repr_taylor :690-744)
# ---------------------------------------------------------------------------


def render_rows(
    spec: ConstraintSpec,
    block: str,
    values: Optional[np.ndarray] = None,
    rhs: Optional[np.ndarray] = None,
    max_rows: Optional[int] = None,
) -> str:
    """Render constraints of one block ('equation'|'initial'|'derivative') as
    strings like "0.0833*u(0, 1) + ... =0" for eyeball/golden verification."""
    vs = spec.var_set
    rows, cols, static_vals = {
        "equation": (spec.eq_rows, spec.eq_cols, spec.eq_values_static),
        "initial": (spec.init_rows, spec.init_cols, spec.init_values_static),
        "derivative": (spec.deriv_rows, spec.deriv_cols, spec.deriv_values_static),
    }[block]
    values = static_vals if values is None else values
    gi = vs.grid_indices()
    out = []
    n_rows = int(rows[-1]) + 1 if rows.size else 0
    if max_rows is not None:
        n_rows = min(n_rows, max_rows)
    # entries are grouped by row already (rows nondecreasing)
    start = 0
    for r in range(n_rows):
        terms = []
        while start < rows.size and rows[start] == r:
            c = int(cols[start])
            point, mi = divmod(c, vs.n_mi)
            label = f"{vs.mi_repr[mi]}{tuple(int(x) for x in gi[point])}"
            terms.append(f"{values[start]}*{label}")
            start += 1
        rhs_val = 0.0 if rhs is None else rhs[r]
        if block == "equation" and rhs is None:
            rhs_val = PH
        out.append("+ ".join(terms) + f" ={rhs_val}")
    return "\n".join(out)
