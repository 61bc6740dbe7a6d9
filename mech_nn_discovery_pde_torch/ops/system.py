"""PDESystem: static constraint structure + batched linear-algebra surface.

The structure (index arrays, pair tables) is NumPy, built once at layer
construction; index tensors are placed on a device the first time an
operator runs there.  Every runtime method takes a leading batch axis.

Value-vector layout (per sample): [equation | initial | derivative] entries,
each block in the construction order of ops/constraints.py.  RHS layout:
[equation rows (cropped grid) | iv rows | derivative rows (zeros)].
"""

from __future__ import annotations

from functools import cached_property
from typing import Optional, Sequence

import numpy as np
import torch

from mech_nn_discovery_pde_torch.ops import stencil
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
    arrays, grouped by row entry count."""
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

    def fill_values(self, coeffs: torch.Tensor, steps_list, dtype=None) -> torch.Tensor:
        """(bs, n_entries) full value vector."""
        eq = stencil.equation_values(self.spec, coeffs)
        dv = stencil.derivative_values(self.spec, steps_list)
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

    # the JAX package's ELL matvec computes the same product
    matvec = matvec_coo
    rmatvec = rmatvec_coo

    # ---- dense normal-equation assembly (MG coarsest level) ------------

    @cached_property
    def _raw_pairs(self):
        return _pair_tables(self.rows_all, self.cols_all)

    @cached_property
    def _pairs(self):
        pa, pb = self._raw_pairs
        lin = self.cols_all[pa] * self.num_vars + self.cols_all[pb]
        perm = np.argsort(lin, kind="stable")
        return pa[perm], pb[perm], lin[perm]

    @property
    def pairs_a(self):
        return self._pairs[0]

    @property
    def pairs_b(self):
        return self._pairs[1]

    @property
    def pairs_lin(self):
        return self._pairs[2]

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

    def describe(self) -> str:
        return self.spec.describe()
