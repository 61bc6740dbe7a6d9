"""MultigridLayer: the sparse-path differentiable PDE layer.

Same contract as the JAX package's layer: (coeffs, rhs, iv_rhs, steps_list)
-> (u0, u, eps), where the solve is FGMRES on the normal equations,
preconditioned by a geometric-multigrid V-cycle over re-discretized coarse
grids, and the third output carries the forward-solve stats when
`config.return_solve_stats` (None otherwise).

The layer lives on one device (`device`, default "cuda"); inputs are moved
there and cast to the solver dtype.  It takes every solver option of the
JAX package's layer on one device (evolution systems, the factored normal
operator, the Jacobi and point-block smoothers; solvers/multigrid.py);
`mesh` (the sp-sharded solve over several devices) raises
NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mech_nn_discovery_pde_torch.config import PDEConfig, default_config
from mech_nn_discovery_pde_torch.ops.normal_solve import default_stats_fn, make_lstsq_solve
from mech_nn_discovery_pde_torch.solvers.multigrid import (
    MultigridNormalSolver,
    MultigridSolver,
)


class MultigridLayer:
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
        downsample_first: bool = True,
        n_grid: int = 2,
        gamma: float = 0.5,
        alpha: float = 0.1,
        config: Optional[PDEConfig] = None,
        device="cuda",
        mesh=None,
    ):
        del n_iv_steps, gamma, alpha, double_ret
        self.bs = bs
        self.coord_dims = tuple(coord_dims)
        self.n_coord = len(self.coord_dims)
        self.order = order
        self.n_ind_dim = n_ind_dim
        self.n_iv = n_iv
        self.config = config or default_config
        self.device = torch.device(device)
        self.solver_dbl = solver_dbl

        self.mg_solver = MultigridSolver(
            bs=bs * n_ind_dim, order=order, n_ind_dim=n_ind_dim, n_iv=n_iv,
            init_index_mi_list=init_index_mi_list or [], coord_dims=self.coord_dims,
            solver_dbl=solver_dbl, evolution=evolution,
            downsample_first=downsample_first, n_grid=n_grid, config=self.config,
            device=self.device, mesh=mesh,
        )
        self.system = self.mg_solver.systems[0]
        self.n_orders = self.system.var_set.n_mi
        self.grid_size = self.system.var_set.grid_size
        self.dtype = self.mg_solver.dtype

        self.inner = MultigridNormalSolver(self.mg_solver)
        stats_fn = None
        if self.config.log_solves or self.config.check_finite:
            stats_fn = default_stats_fn(check_finite=self.config.check_finite)
        self._solve = make_lstsq_solve(
            self.system, self.inner, stats_fn=stats_fn,
            return_stats=self.config.return_solve_stats,
        )

    def _to(self, t):
        return t.to(device=self.device, dtype=self.dtype)

    def _prepare(self, coeffs, rhs, iv_rhs, steps_list):
        b = self.bs * self.n_ind_dim
        coeffs = self._to(coeffs).reshape(b, self.grid_size, self.n_orders)
        rhs = self._to(rhs).reshape(b, self.grid_size)
        if iv_rhs is not None:
            iv_rhs = self._to(iv_rhs).reshape(b, -1)
        steps_list = [
            self._to(steps_list[i]).reshape(b, self.coord_dims[i] - 1)
            for i in range(self.n_coord)
        ]
        values = self.system.fill_values(coeffs, steps_list, dtype=self.dtype)
        rhs_vec = self.system.fill_rhs(rhs, iv_rhs, dtype=self.dtype)
        hier = self.mg_solver.build_hierarchy(coeffs, rhs, iv_rhs, steps_list, values)
        return values, rhs_vec, hier

    def __call__(self, coeffs, rhs, iv_rhs, steps_list):
        values, rhs_vec, hier = self._prepare(coeffs, rhs, iv_rhs, steps_list)
        if self.config.return_solve_stats:
            x, stats = self._solve(values, rhs_vec, hier)
        else:
            x, stats = self._solve(values, rhs_vec, hier), None
        u = self.system.solution_reshaped(x)
        u = u.reshape(self.bs, self.n_ind_dim, self.grid_size, self.n_orders)
        return u[..., 0], u, stats

    @torch.no_grad()
    def backward_stats(self, coeffs, rhs, iv_rhs, steps_list, g):
        """Backward-solve diagnostic: solve AtA dz = g (g an output cotangent,
        (bs*n_ind_dim, num_vars)) with the backward budgets, on a hierarchy
        built fresh (no forward solve), and report per sample the FGMRES
        iterations, 'rnorm', 'rel_rnorm' and 'finite'.  Not differentiable;
        meant every few epochs, not per step."""
        values, _, hier = self._prepare(coeffs, rhs, iv_rhs, steps_list)
        g = self._to(g).reshape(values.shape[0], -1)
        dz, iters, rnorm = self.mg_solver.solve_normal(values, g, hier, back=True)
        gn = torch.clamp(torch.linalg.vector_norm(g, dim=1), min=1e-30)
        return {"iters": iters, "rnorm": rnorm, "rel_rnorm": rnorm / gn,
                "finite": torch.isfinite(dz).all(dim=1)}

    @torch.no_grad()
    def solve_stats(self, coeffs, rhs, iv_rhs, steps_list):
        """Diagnostic forward solve: per-sample FGMRES iteration counts and
        absolute/relative residual norms.  Not differentiable."""
        values, rhs_vec, hier = self._prepare(coeffs, rhs, iv_rhs, steps_list)
        _, iters, rnorm = self.mg_solver.solve_normal(values, rhs_vec, hier)
        bnorm = torch.linalg.vector_norm(self.system.rmatvec_coo(values, rhs_vec), dim=1)
        return {"iters": iters, "rnorm": rnorm,
                "rel_rnorm": rnorm / torch.clamp(bnorm, min=1e-30)}
