"""PDEDenseLayer: the dense-path differentiable PDE layer.

Same contract as the JAX package's layer (layers/dense.py):

    layer = PDEDenseLayer(bs, coord_dims=..., order=2, n_ind_dim=1, n_iv=1,
                          init_index_mi_list=[...], solver_dbl=True)
    u0, u, stats = layer(coeffs, rhs, iv_rhs, steps_list)

  coeffs:  (bs, n_ind_dim?, grid_size, n_orders) coefficient grids
  rhs:     (bs, ..., grid_size) source term
  iv_rhs:  (bs, ..., n_boundary_rows) boundary values, per init box in box
           C-order (or None)
  steps_list: one (bs, ..., dim_c - 1) step vector per coordinate

Returns u0 = u[..., 0] (bs, n_ind_dim, grid_size), u (bs, n_ind_dim,
grid_size, n_orders), and the forward-solve stats when
`config.return_solve_stats` (None otherwise).  The solve is a batched dense
Cholesky of AtA (solvers/cholesky.py) with the implicit-function-theorem
backward of ops/normal_solve.py.

Precision: `solver_dbl=True` reads `config.precision`, where "auto" is
"f64" (the card has native float64); `solver_dbl=False` means "f32".  The
layer lives on one device (`device`, default "cuda"); inputs are moved there
and cast to the solver dtype (float64, or float32 for "f32").
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mech_nn_discovery_pde_torch.config import PDEConfig, default_config
from mech_nn_discovery_pde_torch.ops.normal_solve import default_stats_fn, make_lstsq_solve
from mech_nn_discovery_pde_torch.ops.system import PDESystem
from mech_nn_discovery_pde_torch.solvers.cholesky import PRECISIONS, DenseNormalSolver
from mech_nn_discovery_pde_torch.utils.profiling import span


class PDEDenseLayer:
    def __init__(
        self,
        bs: int,
        coord_dims: Sequence[int],
        order: int = 2,
        n_ind_dim: int = 1,
        n_iv: int = 1,
        init_index_mi_list=None,
        n_iv_steps: int = 1,
        solver_dbl: bool = True,
        double_ret: bool = False,
        evolution: bool = False,
        gamma: float = 0.5,
        alpha: float = 0.1,
        config: Optional[PDEConfig] = None,
        device="cuda",
    ):
        del n_iv_steps, gamma, alpha, double_ret
        self.bs = bs
        self.coord_dims = tuple(coord_dims)
        self.n_coord = len(self.coord_dims)
        self.order = order
        self.n_ind_dim = n_ind_dim
        self.n_iv = n_iv
        self.solver_dbl = solver_dbl
        self.config = config or default_config
        self.device = torch.device(device)

        self.system = PDESystem.build(
            self.coord_dims, order=order, init_index_mi_list=init_index_mi_list or [],
            n_iv=n_iv, step_size=0.01, evolution=evolution,
        )
        self.n_orders = self.system.var_set.n_mi
        self.grid_size = self.system.var_set.grid_size

        if solver_dbl:
            precision = self.config.precision
            if precision == "auto":
                precision = "f64"
        else:
            precision = "f32"
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; expected 'auto', 'f64', "
                             "'f32_ir' or 'f32'")
        self.precision = precision
        self.dtype = torch.float32 if precision == "f32" else torch.float64

        self.inner = DenseNormalSolver(self.system, precision=precision,
                                       ir_steps=self.config.ir_steps)
        stats_fn = None
        if self.config.log_solves or self.config.check_finite:
            stats_fn = default_stats_fn(check_finite=self.config.check_finite)
        self._solve = make_lstsq_solve(self.system, self.inner, stats_fn=stats_fn,
                                       return_stats=self.config.return_solve_stats)

    def _to(self, t):
        return t.to(device=self.device, dtype=self.dtype)

    def _prepare(self, coeffs, rhs, iv_rhs, steps_list):
        b = self.bs * self.n_ind_dim
        coeffs = self._to(coeffs).reshape(b, self.grid_size, self.n_orders)
        rhs = self._to(rhs).reshape(b, self.grid_size)
        if iv_rhs is not None:
            iv_rhs = self._to(iv_rhs).reshape(b, -1)
        steps_list = [self._to(steps_list[i]).reshape(b, self.coord_dims[i] - 1)
                      for i in range(self.n_coord)]
        values = self.system.fill_values(coeffs, steps_list, dtype=self.dtype)
        rhs_vec = self.system.fill_rhs(rhs, iv_rhs, dtype=self.dtype)
        return values, rhs_vec

    def __call__(self, coeffs, rhs, iv_rhs, steps_list):
        with span("layer.forward"):
            values, rhs_vec = self._prepare(coeffs, rhs, iv_rhs, steps_list)
            if self.config.return_solve_stats:
                x, stats = self._solve(values, rhs_vec, None)
            else:
                x, stats = self._solve(values, rhs_vec, None), None
            u = self.system.solution_reshaped(x)
            u = u.reshape(self.bs, self.n_ind_dim, self.grid_size, self.n_orders)
            return u[..., 0], u, stats

    @torch.no_grad()
    def backward_stats(self, coeffs, rhs, iv_rhs, steps_list, g):
        """Backward-solve diagnostic: solve AtA dz = g (g an output cotangent,
        (bs*n_ind_dim, num_vars)) with one factorization and report the
        residual quality per sample: 'rnorm', 'rel_rnorm', 'finite'."""
        values, rhs_vec = self._prepare(coeffs, rhs, iv_rhs, steps_list)
        _, aux = self.inner.solve(values, rhs_vec)
        g = self._to(g).reshape(values.shape[0], -1)
        dz, _ = self.inner.resolve(values, g, aux, backward=True)
        rn = torch.linalg.vector_norm(g - self.system.normal_matvec_s(values, dz), dim=1)
        gn = torch.clamp(torch.linalg.vector_norm(g, dim=1), min=1e-30)
        return {"rnorm": rn, "rel_rnorm": rn / gn, "finite": torch.isfinite(dz).all(dim=1)}

    @torch.no_grad()
    def solve_stats(self, coeffs, rhs, iv_rhs, steps_list):
        """Diagnostic forward solve: per-sample normal-equation residual norms
        and a finiteness flag (False where the Cholesky factorization failed:
        its solution is NaN)."""
        values, rhs_vec = self._prepare(coeffs, rhs, iv_rhs, steps_list)
        x, _ = self.inner.solve(values, rhs_vec)
        atb = self.system.rmatvec_s(values, rhs_vec)
        res = atb - self.system.normal_matvec_s(values, x)
        rnorm = torch.linalg.vector_norm(res, dim=1)
        bnorm = torch.clamp(torch.linalg.vector_norm(atb, dim=1), min=1e-30)
        return {"rnorm": rnorm, "rel_rnorm": rnorm / bnorm,
                "finite": torch.isfinite(x).all(dim=1)}
