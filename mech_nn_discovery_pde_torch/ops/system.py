"""PDESystem: static constraint structure + batched linear-algebra surface.

The structure (index arrays, pair tables) is NumPy, built once at layer
construction; index tensors are placed on a device the first time an
operator runs there.  Every runtime method takes a leading batch axis.

Value-vector layout (per sample): [equation | initial | derivative] entries,
each block in the construction order of ops/constraints.py.  RHS layout:
[equation rows (cropped grid) | iv rows | derivative rows (zeros)].

The JAX package's `PDESystem` (ops/system.py) and its counterparts here:
- fills: `fill_values`, `fill_rhs`, `equation_values`, `derivative_values`;
- A x and A^T y: COO (`matvec_coo` / `rmatvec_coo`, gather + index_add),
  ELL (`matvec` / `rmatvec`, packed per call; `pack_values` with
  `*_packed` packs once: the multigrid hierarchy's coarse rescale),
  structured (`matvec_s` / `rmatvec_s`, `structured_ops`;
  ops/structured.py);
- AtA: `normal_matvec` (ELL), `normal_matvec_s`, `normal_diag`,
  `normal_bound_vec`, dense `assemble_normal` (pair tables from the native
  builder, ops/native.py, or its NumPy twin) and `assemble_dense_A`;
- smoother blocks: `assemble_point_blocks` (grid, n_mi, n_mi) and
  `assemble_line_blocks` (time-line blocks); the line blocks' vector
  reshapes are `line_vec_to_blocks` / `line_blocks_to_vec` in
  ops/fused_smoother.py, next to the kernels that read that layout;
- `solution_reshaped`, `pad_eq_rows`, `split_values`, `describe`.
"""

from __future__ import annotations

from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from mech_nn_discovery_pde_torch.ops import native, stencil
from mech_nn_discovery_pde_torch.ops.constraints import (
    ConstraintSpec,
    build_constraint_spec,
)
from mech_nn_discovery_pde_torch.ops.structured import (
    matvec_structured,
    rmatvec_structured,
    split_values,
)


def _pair_tables(rows: np.ndarray, cols: np.ndarray):
    """All ordered entry pairs (a, b) sharing a row, as int64 entry-index
    arrays, grouped by row entry count (the block assemblies' pair order)."""
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    pa_parts, pb_parts = [], []
    for k in np.unique(counts):
        if k == 0:
            continue
        rws = np.nonzero(counts == k)[0]
        ent = order[offsets[rws][:, None] + np.arange(k)[None, :]]
        ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
        pa_parts.append(ent[:, ii.ravel()].ravel())
        pb_parts.append(ent[:, jj.ravel()].ravel())
    return np.concatenate(pa_parts), np.concatenate(pb_parts)


def _ell_pack(group_idx: np.ndarray, other_idx: np.ndarray, n_groups: int):
    """One ELL direction: (entry -> flat slot of the (n_groups, k) table,
    the table of `other_idx` per slot (0 in padding slots), k)."""
    order = np.argsort(group_idx, kind="stable")
    g = group_idx[order]
    counts = np.bincount(g, minlength=n_groups)
    k = int(counts.max()) if counts.size else 1
    offsets = np.concatenate([[0], np.cumsum(counts)])
    target = g * k + (np.arange(g.shape[0]) - offsets[g])
    idx_tab = np.zeros((n_groups, k), dtype=np.int64)
    idx_tab.reshape(-1)[target] = other_idx[order]
    entry_target = np.empty(g.shape[0], dtype=np.int64)
    entry_target[order] = target
    return entry_target, idx_tab, k


class PDESystem:
    """Constraint system with batched fills and linear operators."""

    def __init__(self, spec: ConstraintSpec):
        self.spec = spec
        self.var_set = spec.var_set
        self.coord_dims = spec.coord_dims
        self.num_vars = spec.num_vars
        self.n_rows = spec.n_rows
        self.n_eq_rows = spec.n_eq_rows
        self.n_init_rows = spec.n_init_rows
        self.n_deriv_rows = spec.n_deriv_rows

        self.rows_all = spec.rows_all.astype(np.int64)
        self.cols_all = spec.cols_all.astype(np.int64)
        self.n_entries = int(self.cols_all.shape[0])
        self.n_eq_entries = int(spec.eq_cols.shape[0])
        self.n_init_entries = int(spec.init_cols.shape[0])
        self.n_deriv_entries = int(spec.deriv_cols.shape[0])
        self._init_values = spec.init_values_static.copy()
        self._dev_cache = {}

    @classmethod
    def build(
        cls,
        coord_dims: Sequence[int],
        order: int = 2,
        init_index_mi_list=None,
        n_iv: int = 1,
        step_size: float = 0.25,
        evolution: bool = False,
    ) -> "PDESystem":
        return cls(
            build_constraint_spec(
                coord_dims, order, init_index_mi_list, n_iv, step_size, evolution
            )
        )

    def index(self, name: str, device) -> torch.Tensor:
        """Static int64 index array `name` as a tensor on `device` (cached)."""
        key = (name, str(torch.device(device)))
        t = self._dev_cache.get(key)
        if t is None:
            arr = getattr(self, name)
            t = torch.as_tensor(np.ascontiguousarray(arr), device=device)
            self._dev_cache[key] = t
        return t

    # ------------------------------------------------------------------
    # runtime fills (leading bs axis; differentiable)
    # ------------------------------------------------------------------

    def equation_values(self, coeffs: torch.Tensor) -> torch.Tensor:
        return stencil.equation_values(self.spec, coeffs)

    def derivative_values(self, steps_list) -> torch.Tensor:
        return stencil.derivative_values(self.spec, steps_list)

    def fill_values(self, coeffs: torch.Tensor, steps_list, dtype=None) -> torch.Tensor:
        """(bs, n_entries) full value vector."""
        eq = self.equation_values(coeffs)
        dv = self.derivative_values(steps_list)
        dtype = dtype or eq.dtype
        iv = torch.as_tensor(self._init_values, dtype=dtype, device=eq.device)
        iv = iv.expand(eq.shape[0], self.n_init_entries)
        return torch.cat([eq.to(dtype), iv, dv.to(dtype)], dim=1)

    def fill_rhs(self, rhs: torch.Tensor, iv_rhs: Optional[torch.Tensor], dtype=None):
        """(bs, n_rows) stacked rhs [equation | initial | derivative(0)]."""
        eq_rhs = stencil.crop_rhs(self.spec, rhs)
        bs = eq_rhs.shape[0]
        dtype = dtype or eq_rhs.dtype
        if iv_rhs is None:
            iv_rhs = eq_rhs.new_zeros((bs, 0), dtype=dtype)
        iv_rhs = iv_rhs.reshape(bs, -1).to(dtype)
        n_iv = self.spec.n_iv
        if n_iv > 1 and iv_rhs.shape[1] * n_iv == self.n_init_rows:
            iv_rhs = torch.repeat_interleave(iv_rhs, n_iv, dim=1)
        elif iv_rhs.shape[1] != self.n_init_rows:
            raise ValueError(
                f"iv_rhs has {iv_rhs.shape[1]} entries per sample; expected "
                f"{self.n_init_rows} (one per initial-constraint row)"
            )
        dz = eq_rhs.new_zeros((bs, self.n_deriv_rows), dtype=dtype)
        return torch.cat([eq_rhs.to(dtype), iv_rhs, dz], dim=1)

    # ------------------------------------------------------------------
    # linear operators (batched)
    # ------------------------------------------------------------------

    def split_values(self, values: torch.Tensor):
        return split_values(self.spec, values)

    def structured_ops(self):
        """(matvec, rmatvec) closures over StructuredValues (ops/structured.py),
        for any dtype (the JAX package builds them per dtype)."""
        return (lambda sv, x: matvec_structured(self.spec, sv, x),
                lambda sv, y: rmatvec_structured(self.spec, sv, y))

    @property
    def _use_structured(self) -> bool:
        # 1D (ODE-sized) systems use the COO path, as in the JAX package
        return len(self.coord_dims) > 1

    def matvec_s(self, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if not self._use_structured:
            return self.matvec_coo(values, x)
        return matvec_structured(self.spec, self.split_values(values), x)

    def rmatvec_s(self, values: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if not self._use_structured:
            return self.rmatvec_coo(values, y)
        return rmatvec_structured(self.spec, self.split_values(values), y)

    def normal_matvec_s(self, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.rmatvec_s(values, self.matvec_s(values, x))

    def matvec_coo(self, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A @ x by gather + scatter-add: (bs, n_entries), (bs, num_vars) ->
        (bs, n_rows)."""
        rows = self.index("rows_all", x.device)
        cols = self.index("cols_all", x.device)
        prod = values * x[:, cols]
        return prod.new_zeros((x.shape[0], self.n_rows)).index_add_(1, rows, prod)

    def rmatvec_coo(self, values: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        rows = self.index("rows_all", y.device)
        cols = self.index("cols_all", y.device)
        prod = values * y[:, rows]
        return prod.new_zeros((y.shape[0], self.num_vars)).index_add_(1, cols, prod)

    # ---- ELL layouts: both directions as gathers over (n, k) slot tables --

    @cached_property
    def _ell(self):
        """Row-major ELL (A x: slot targets `tgt_r`, column table `cols_ell`,
        k slots a row) and column-major (A^T y: `tgt_c`, `rows_ell`, kc)."""
        tgt_r, cols_ell, k = _ell_pack(self.rows_all, self.cols_all, self.n_rows)
        tgt_c, rows_ell, kc = _ell_pack(self.cols_all, self.rows_all, self.num_vars)
        return {"tgt_r": tgt_r, "cols_ell": cols_ell, "k": k,
                "tgt_c": tgt_c, "rows_ell": rows_ell, "kc": kc}

    @property
    def ell_tgt_r(self):
        return self._ell["tgt_r"]

    @property
    def ell_cols(self):
        return self._ell["cols_ell"].reshape(-1)

    @property
    def ell_tgt_c(self):
        return self._ell["tgt_c"]

    @property
    def ell_rows(self):
        return self._ell["rows_ell"].reshape(-1)

    def _ell_values(self, values: torch.Tensor, transpose: bool) -> torch.Tensor:
        """(bs, n, k) values in ELL slots (0 in padding slots)."""
        e = self._ell
        if transpose:
            tgt, n, k = self.index("ell_tgt_c", values.device), self.num_vars, e["kc"]
        else:
            tgt, n, k = self.index("ell_tgt_r", values.device), self.n_rows, e["k"]
        flat = values.new_zeros((values.shape[0], n * k))
        return flat.index_copy_(1, tgt, values).reshape(-1, n, k)

    def _ell_apply(self, slots: torch.Tensor, v: torch.Tensor, table: str) -> torch.Tensor:
        idx = self.index(table, v.device)
        return (slots * v[:, idx].reshape(slots.shape)).sum(-1)

    def matvec(self, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """A @ x (ELL): (bs, n_entries), (bs, num_vars) -> (bs, n_rows)."""
        return self._ell_apply(self._ell_values(values, False), x, "ell_cols")

    def rmatvec(self, values: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """A^T @ y (ELL): (bs, n_entries), (bs, n_rows) -> (bs, num_vars)."""
        return self._ell_apply(self._ell_values(values, True), y, "ell_rows")

    def pack_values(self, values: torch.Tensor, adjoint: bool = True):
        """The ELL tables of a value vector, packed once for repeated
        `matvec_packed` and, with adjoint, `rmatvec_packed` /
        `normal_matvec_packed`."""
        packed = {"r": self._ell_values(values, False)}
        if adjoint:
            packed["c"] = self._ell_values(values, True)
        return packed

    def matvec_packed(self, packed, x: torch.Tensor) -> torch.Tensor:
        return self._ell_apply(packed["r"], x, "ell_cols")

    def rmatvec_packed(self, packed, y: torch.Tensor) -> torch.Tensor:
        return self._ell_apply(packed["c"], y, "ell_rows")

    def normal_matvec_packed(self, packed, x: torch.Tensor) -> torch.Tensor:
        return self.rmatvec_packed(packed, self.matvec_packed(packed, x))

    def normal_matvec(self, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(A^T A) @ x, matrix-free (ELL)."""
        return self.rmatvec(values, self.matvec(values, x))

    def normal_diag(self, values: torch.Tensor) -> torch.Tensor:
        """diag(A^T A): the squared entry values summed per column."""
        cols = self.index("cols_all", values.device)
        return values.new_zeros((values.shape[0], self.num_vars)).index_add_(
            1, cols, values * values)

    def normal_bound_vec(self, values: torch.Tensor) -> torch.Tensor:
        """(|A|^T |A|) @ 1: row sums of an upper bound of |A^T A|, for
        eigenvalue bounds."""
        a = values.abs()
        return self.rmatvec(a, self.matvec(a, a.new_ones((a.shape[0], self.num_vars))))

    # ---- dense assembly (dense path, MG coarsest level) ------------------

    @cached_property
    def _raw_pairs(self):
        return _pair_tables(self.rows_all, self.cols_all)

    @cached_property
    def _pairs(self):
        """(pa, pb, lin) of `native.build_pairs_sorted`, from the native
        library where it loads (as the JAX package), else its NumPy twin."""
        out = native.build_pairs_sorted(self.rows_all, self.cols_all, self.num_vars)
        if out is None:
            out = native.pairs_sorted_numpy(self.rows_all, self.cols_all, self.num_vars)
        return out

    @property
    def pairs_a(self):
        return self._pairs[0]

    @property
    def pairs_b(self):
        return self._pairs[1]

    @property
    def pairs_lin(self):
        return self._pairs[2]

    @property
    def dense_lin(self):
        return self.rows_all * self.num_vars + self.cols_all

    def assemble_dense_A(self, values: torch.Tensor) -> torch.Tensor:
        """Dense A (bs, n_rows, num_vars) by one nnz-sized scatter-add."""
        lin = self.index("dense_lin", values.device)
        flat = values.new_zeros((values.shape[0], self.n_rows * self.num_vars))
        return flat.index_add_(1, lin, values).reshape(-1, self.n_rows, self.num_vars)

    def assemble_normal(self, values: torch.Tensor) -> torch.Tensor:
        """Dense AtA (bs, num_vars, num_vars) by pair-product scatter-add."""
        dev = values.device
        pa, pb = self.index("pairs_a", dev), self.index("pairs_b", dev)
        lin = self.index("pairs_lin", dev)
        prod = values[:, pa] * values[:, pb]
        n = self.num_vars
        flat = prod.new_zeros((values.shape[0], n * n)).index_add_(1, lin, prod)
        return flat.reshape(-1, n, n)

    @cached_property
    def _point_block_pairs(self):
        """Entry pairs sharing a row AND a grid point: the (n_mi x n_mi)
        point-diagonal blocks of AtA, for the point-block smoother."""
        pa, pb = self._raw_pairs
        n_mi = self.var_set.n_mi
        ca, cb = self.cols_all[pa], self.cols_all[pb]
        same = (ca // n_mi) == (cb // n_mi)
        pa, pb, ca, cb = pa[same], pb[same], ca[same], cb[same]
        lin = (ca // n_mi) * n_mi * n_mi + (ca % n_mi) * n_mi + cb % n_mi
        perm = np.argsort(lin, kind="stable")
        return pa[perm], pb[perm], lin[perm]

    @property
    def point_pairs_a(self):
        return self._point_block_pairs[0]

    @property
    def point_pairs_b(self):
        return self._point_block_pairs[1]

    @property
    def point_pairs_lin(self):
        return self._point_block_pairs[2]

    def assemble_point_blocks(self, values: torch.Tensor) -> torch.Tensor:
        """(bs, grid, n_mi, n_mi) point-diagonal blocks of AtA."""
        dev = values.device
        n_mi, grid = self.var_set.n_mi, self.var_set.grid_size
        pa, pb = self.index("point_pairs_a", dev), self.index("point_pairs_b", dev)
        lin = self.index("point_pairs_lin", dev)
        prod = values[:, pa] * values[:, pb]
        flat = prod.new_zeros((values.shape[0], grid * n_mi * n_mi)).index_add_(1, lin, prod)
        return flat.reshape(-1, grid, n_mi, n_mi)

    @cached_property
    def _line_pairs_axis0(self):
        """Entry pairs sharing a row AND a time-line: the (d0*n_mi)^2
        line-diagonal blocks of AtA.  Block id = flat index of the spatial
        point; within-block index = (time position, mi)."""
        pa, pb = self._raw_pairs
        n_mi = self.var_set.n_mi
        dims = self.var_set.coord_dims
        gi = self.var_set.grid_indices()
        ca, cb = self.cols_all[pa], self.cols_all[pb]
        pta, ptb = ca // n_mi, cb // n_mi
        other = list(range(1, len(dims)))
        if other:
            line_a = np.ravel_multi_index(
                tuple(gi[pta, c] for c in other), tuple(dims[c] for c in other)
            )
            line_b = np.ravel_multi_index(
                tuple(gi[ptb, c] for c in other), tuple(dims[c] for c in other)
            )
        else:
            line_a = np.zeros(pta.shape, dtype=np.int64)
            line_b = line_a
        same = line_a == line_b
        pa, pb = pa[same], pb[same]
        blk = line_a[same].astype(np.int64)
        wa = gi[ca[same] // n_mi, 0] * n_mi + ca[same] % n_mi
        wb = gi[cb[same] // n_mi, 0] * n_mi + cb[same] % n_mi
        bw = dims[0] * n_mi
        lin = blk * bw * bw + wa * bw + wb
        perm = np.argsort(lin, kind="stable")
        n_blocks = int(np.prod([dims[c] for c in other])) if other else 1
        return pa[perm], pb[perm], lin[perm], n_blocks, bw

    @property
    def line_pairs_a(self):
        return self._line_pairs_axis0[0]

    @property
    def line_pairs_b(self):
        return self._line_pairs_axis0[1]

    @property
    def line_pairs_lin(self):
        return self._line_pairs_axis0[2]

    def assemble_line_blocks(self, values: torch.Tensor) -> torch.Tensor:
        """(bs, n_lines, bw, bw) time-line diagonal blocks of AtA
        (bw = dims[0] * n_mi)."""
        dev = values.device
        _, _, _, n_blocks, bw = self._line_pairs_axis0
        pa, pb = self.index("line_pairs_a", dev), self.index("line_pairs_b", dev)
        lin = self.index("line_pairs_lin", dev)
        prod = values[:, pa] * values[:, pb]
        flat = prod.new_zeros((values.shape[0], n_blocks * bw * bw)).index_add_(1, lin, prod)
        return flat.reshape(-1, n_blocks, bw, bw)

    def solution_reshaped(self, x: torch.Tensor) -> torch.Tensor:
        """(bs, num_vars) -> (bs, grid, n_mi)."""
        return x.reshape(-1, self.var_set.grid_size, self.var_set.n_mi)

    def pad_eq_rows(self, vals: torch.Tensor) -> torch.Tensor:
        """Equation-row values (bs, n_eq_rows) on the zero-padded full grid
        (bs, grid): the inverse of the rhs crop."""
        return stencil.pad_rhs(self.spec, vals)

    def describe(self) -> str:
        return self.spec.describe()
