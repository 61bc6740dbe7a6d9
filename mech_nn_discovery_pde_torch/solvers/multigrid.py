"""Geometric multigrid preconditioner + FGMRES normal-equation solver.

Port of the JAX package's `MultigridSolver` (solvers/multigrid.py), batched
over a leading sample axis throughout:

- coarse operators by re-discretization: field data (coeffs, rhs, iv,
  steps) is downsampled (align-corners linear) and the constraint values
  re-filled on each level, then rescaled per constraint block against the
  finer operator on smooth probes;
- smoothing: Chebyshev on the time-line block-Jacobi preconditioned normal
  operator, one host loop of kernels K1 + K2 per step on CUDA
  (ops/fused_smoother.py), on every non-coarsest level;
- coarsest level: dense assembled AtA, equilibrated, explicit Cholesky
  inverse built in 512-column chunks;
- the preconditioner runs in float32; the outer flexible GMRES iterates in
  the solve dtype;
- storage (config.mg_precond_dtype): the stored operators are float32
  ('f32'), all bfloat16 ('bf16': block inverses, stencil fields, coarse
  inverse), or the block inverses' PSD square-root factors W = L^-T in
  bfloat16 ('bf16_factored': B^-1 r = W (W^T r), kernel K3).  Assembly,
  factorization, vectors and the lmax power iteration stay float32.

The hierarchy carries no gradient (it only affects convergence); gradients
flow through the IFT backward in ops/normal_solve.py.

Not ported yet (they raise): evolution systems and the factored normal
operator, the Jacobi and point-block smoothers, and the sp-sharded solve.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig, default_config
from mech_nn_discovery_pde_torch.ops.fused_smoother import (
    block_apply,
    chebyshev_schedule,
    chebyshev_smooth,
    factored_block_apply,
)
from mech_nn_discovery_pde_torch.ops.interp import apply_separable, interp_matrix
from mech_nn_discovery_pde_torch.ops.normal_stencil import (
    build_normal_coef,
    make_desc,
    stencil_apply,
)
from mech_nn_discovery_pde_torch.ops.system import PDESystem
from mech_nn_discovery_pde_torch.solvers import krylov


def _resolve_solve_dtype(msd: str, dtype: torch.dtype) -> torch.dtype:
    """'auto' -> 'solver' on every device the port runs on (see config)."""
    if msd == "auto":
        msd = "solver"
    if msd not in ("f32", "solver"):
        raise ValueError(f"unknown mg_solve_dtype {msd!r}")
    return torch.float32 if msd == "f32" else dtype


class MultigridSolver:
    """Grid hierarchy + V-cycle preconditioner for the PDE normal equations."""

    def __init__(
        self,
        bs: int,
        order: int,
        n_ind_dim: int,
        n_iv: int,
        init_index_mi_list,
        coord_dims: Sequence[int],
        n_iv_steps: int = 1,
        solver_dbl: bool = True,
        evolution: bool = False,
        downsample_first: bool = True,
        gamma: float = 0.5,
        alpha: float = 0.1,
        double_ret: bool = False,
        n_grid: int = 2,
        config: Optional[PDEConfig] = None,
        device="cuda",
    ):
        del n_iv_steps, gamma, alpha, double_ret
        self.bs = bs
        self.n_ind_dim = n_ind_dim
        self.order = order
        self.n_iv = n_iv
        self.n_grid = n_grid
        self.downsample_first = downsample_first
        self.init_index_mi_list = init_index_mi_list or []
        self.config = cfg = config or default_config
        self.device = torch.device(device)
        self.solver_dbl = solver_dbl
        self.dtype = torch.float64 if solver_dbl else torch.float32
        self.pdtype = torch.float32  # preconditioner assembly and vector dtype
        mpd = cfg.mg_precond_dtype
        if mpd not in ("f32", "bf16", "bf16_factored"):
            raise ValueError(f"unknown mg_precond_dtype {mpd!r}; expected 'f32', 'bf16' "
                             "or 'bf16_factored'")
        # storage dtypes (see config.mg_precond_dtype): 'bf16' rounds every
        # stored operator; 'bf16_factored' stores W = L^-T in bf16 (round(W)
        # round(W)^T stays PSD, unlike the entrywise-rounded inverse) and
        # keeps coef and the coarse inverse f32
        self.vdtype = torch.bfloat16 if mpd == "bf16" else torch.float32
        self._factored_binv = mpd == "bf16_factored"
        self.binv_dtype = torch.bfloat16 if mpd in ("bf16", "bf16_factored") else torch.float32
        unsupported = {
            "evolution": evolution,
            f"mg_normal_op={cfg.mg_normal_op!r}": cfg.mg_normal_op not in ("stencil", "stencil_pallas"),
            f"mg_smoother={cfg.mg_smoother!r}": cfg.mg_smoother not in ("chebyshev", "chebyshev_fused"),
            f"mg_block_smoother={cfg.mg_block_smoother!r}": cfg.mg_block_smoother != "line",
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")
        self.solve_dtype = _resolve_solve_dtype(cfg.mg_solve_dtype, self.dtype)

        # grid hierarchy
        dims = np.array(coord_dims)
        self.dim_list: List[Tuple[int, ...]] = []
        for _ in range(n_grid):
            if dims.min() < 6:
                raise ValueError(f"grid {tuple(dims)} too small for 5-pt stencils")
            self.dim_list.append(tuple(int(d) for d in dims))
            if downsample_first:
                dims = dims // 2
            else:
                dims = dims.copy()
                dims[1:] = dims[1:] // 2

        self.systems: List[PDESystem] = [
            PDESystem.build(d, order=order, init_index_mi_list=self.init_index_mi_list,
                            n_iv=n_iv, step_size=0.01)
            for d in self.dim_list
        ]
        self.descs = [make_desc(s.spec) for s in self.systems]

        # transfer matrices between consecutive levels (per axis)
        self._down = [
            [interp_matrix(o, n) for o, n in zip(self.dim_list[k], self.dim_list[k + 1])]
            for k in range(n_grid - 1)
        ]
        self._up = [
            [interp_matrix(n, o) for o, n in zip(self.dim_list[k], self.dim_list[k + 1])]
            for k in range(n_grid - 1)
        ]
        self._iv_down = []
        for k in range(n_grid - 1):
            mats_per_box = []
            for f in self.init_index_mi_list:
                _, _, b_old, e_old = f(*self.dim_list[k])
                _, _, b_new, e_new = f(*self.dim_list[k + 1])
                old_shape = np.asarray(e_old) + 1 - np.asarray(b_old)
                new_shape = np.asarray(e_new) + 1 - np.asarray(b_new)
                mats_per_box.append(
                    [interp_matrix(int(o), int(n)) for o, n in zip(old_shape, new_shape)]
                )
            self._iv_down.append(mats_per_box)
        self._mat_cache: Dict[Any, List[torch.Tensor]] = {}

    def _mats(self, kind: str, k: int, dtype, box: int = -1) -> List[torch.Tensor]:
        """Transfer matrices as tensors on the solver's device (cached)."""
        key = (kind, k, box, dtype)
        mats = self._mat_cache.get(key)
        if mats is None:
            src = {"down": self._down, "up": self._up}.get(kind)
            src = src[k] if src is not None else self._iv_down[k][box]
            mats = [torch.as_tensor(W, dtype=dtype, device=self.device) for W in src]
            self._mat_cache[key] = mats
        return mats

    # ------------------------------------------------------------------
    # data downsampling (level k -> k+1); batched
    # ------------------------------------------------------------------

    def downsample_coeffs(self, k: int, coeffs: torch.Tensor) -> torch.Tensor:
        """(bs, grid_k, n_mi) -> (bs, grid_{k+1}, n_mi)."""
        bs = coeffs.shape[0]
        n_mi = self.systems[k].var_set.n_mi
        x = coeffs.reshape((bs,) + self.dim_list[k] + (n_mi,))
        x = apply_separable(x, self._mats("down", k, x.dtype), offset=1)
        return x.reshape(bs, -1, n_mi)

    def downsample_rhs(self, k: int, rhs: torch.Tensor) -> torch.Tensor:
        bs = rhs.shape[0]
        x = rhs.reshape((bs,) + self.dim_list[k])
        x = apply_separable(x, self._mats("down", k, x.dtype), offset=1)
        return x.reshape(bs, -1)

    def downsample_steps(self, k: int, steps_list):
        """Pairwise-sum step downsampling: drop the last step, then sum
        adjacent pairs."""
        out = []
        for c, steps in enumerate(steps_list):
            old = self.dim_list[k][c]
            new = self.dim_list[k + 1][c]
            if new == old:
                out.append(steps)
            else:
                s = steps[:, : 2 * (new - 1) + 1][:, :-1]
                out.append(s.reshape(steps.shape[0], new - 1, 2).sum(dim=-1))
        return out

    def downsample_iv(self, k: int, iv_rhs: Optional[torch.Tensor]):
        if iv_rhs is None or iv_rhs.shape[-1] == 0:
            return iv_rhs
        bs = iv_rhs.shape[0]
        parts = []
        offset = 0
        for bi, f in enumerate(self.init_index_mi_list):
            _, _, b_old, e_old = f(*self.dim_list[k])
            old_shape = tuple(int(e - b + 1) for b, e in zip(b_old, e_old))
            size = int(np.prod(old_shape))
            box = iv_rhs[:, offset : offset + size].reshape((bs,) + old_shape)
            offset += size
            box = apply_separable(box, self._mats("iv", k, box.dtype, bi), offset=1)
            parts.append(box.reshape(bs, -1))
        return torch.cat(parts, dim=1)

    # ------------------------------------------------------------------
    # hierarchy setup
    # ------------------------------------------------------------------

    def _level_precond_data(self, k: int, values: torch.Tensor) -> Dict[str, Any]:
        """Per-level smoother data: time-line block inverses (1e-6 max-diag
        ridge, Cholesky, explicit inverse; or the factor W = L^-T), assembled
        stencil fields, both in their storage dtypes; lmax, estimated on the
        stored operators, and the Chebyshev schedules of the pre/post
        passes."""
        sysk = self.systems[k]
        v32 = values.to(self.pdtype)
        B = sysk.assemble_line_blocks(v32)  # (bs, S, bw, bw)
        nb = B.shape[-1]
        eye = torch.eye(nb, dtype=B.dtype, device=B.device)
        d = torch.diagonal(B, dim1=-2, dim2=-1)
        ridge = 1e-6 * torch.clamp(d.max(dim=-1, keepdim=True).values, min=1e-30)
        B = B + ridge[..., None] * eye
        L, _ = torch.linalg.cholesky_ex(B)
        if self._factored_binv:
            # B^-1 = L^-T L^-1 = W W^T with W = L^-T
            linv = torch.linalg.solve_triangular(L, eye.expand_as(B), upper=False)
            binv = linv.transpose(-1, -2).triu()
        else:
            binv = torch.cholesky_solve(eye.expand_as(B), L)
        del B, L
        coef = build_normal_coef(sysk.spec, self.descs[k], sysk.split_values(v32))
        # the rounded (or factored) operators must be stored before lmax is
        # estimated: Chebyshev amplifies any mode above an underestimate
        lvl = {"values": v32, "binv": binv.to(self.binv_dtype).contiguous(),
               "coef": coef.to(self.vdtype)}
        lvl["lmax"] = self._estimate_lmax(k, lvl)
        steps = max(self.config.mg_smoother_steps_pre, self.config.mg_smoother_steps_post)
        lvl["sched"] = chebyshev_schedule(lvl["lmax"], self.config.mg_chebyshev_ratio, steps)
        return lvl

    def _normal_apply(self, k: int, lvl, v: torch.Tensor, **epilogue) -> torch.Tensor:
        """(AtA) v on level k (kernel K1 on CUDA)."""
        return stencil_apply(self.descs[k], lvl["coef"], v, **epilogue)

    def _block_apply(self, k: int, lvl, r: torch.Tensor) -> torch.Tensor:
        """B^-1 r with the time-line block inverses (kernel K2 on CUDA), or
        W (W^T r) with their factors (kernel K3)."""
        apply = factored_block_apply if self._factored_binv else block_apply
        return apply(lvl["binv"], r, self.dim_list[k][0])

    def _estimate_lmax(self, k: int, lvl, iters: int = 20) -> torch.Tensor:
        """Power iteration on B^-1 AtA (batched), biased high by the
        load-bearing mg_lmax_margin: Chebyshev amplifies any mode above the
        assumed lmax explosively."""
        n = self.systems[k].num_vars
        bs = lvl["coef"].shape[0]
        x = torch.sin(torch.arange(n, dtype=self.pdtype, device=self.device) + 1.0)
        x = (x / torch.linalg.vector_norm(x)).expand(bs, n).contiguous()
        for _ in range(iters):
            y = self._block_apply(k, lvl, self._normal_apply(k, lvl, x))
            x = y / torch.clamp(torch.linalg.vector_norm(y, dim=1, keepdim=True), min=1e-30)
        y = self._block_apply(k, lvl, self._normal_apply(k, lvl, x))
        return self.config.mg_lmax_margin * (x * y).sum(dim=1)

    @staticmethod
    def _block_row_slices(sys: PDESystem):
        ne, ni = sys.n_eq_rows, sys.n_init_rows
        nc = sys.spec.n_central_rows
        return [(0, ne), (ne, ne + ni), (ne + ni, ne + ni + nc), (ne + ni + nc, sys.n_rows)]

    @staticmethod
    def _block_entry_slices(sys: PDESystem):
        ne, ni = sys.n_eq_entries, sys.n_init_entries
        nc = sys.spec.n_central_entries
        return [(0, ne), (ne, ne + ni), (ne + ni, ne + ni + nc), (ne + ni + nc, sys.n_entries)]

    def _probes(self, k: int):
        """Deterministic smooth probe vectors on level k's variable grid."""
        nmi = self.systems[k].var_set.n_mi
        dims = self.dim_list[k]
        grids = np.indices(dims).astype(np.float64)
        smooth = np.ones(dims)
        lin = np.zeros(dims)
        for c, d in enumerate(dims):
            smooth = smooth * np.sin(np.pi * (grids[c] + 0.5) / d)
            lin = lin + grids[c] / d
        p1 = np.ones(dims + (nmi,)).reshape(-1)
        p2 = np.repeat(smooth[..., None], nmi, axis=-1).reshape(-1)
        p3 = np.repeat(lin[..., None], nmi, axis=-1).reshape(-1)
        return [torch.as_tensor(p, dtype=self.pdtype, device=self.device) for p in (p1, p2, p3)]

    def _rescale_coarse_values(self, k: int, fine_vals32, coarse_vals32):
        """Per-constraint-block spectral rescaling of level-k values: scale
        each block by sqrt(<A_f P v>^2 / <A_c v>^2) summed over smooth probes,
        so the re-discretized coarse operator matches the finer one on the
        smooth subspace."""
        sysf, sysc = self.systems[k - 1], self.systems[k]
        bs = fine_vals32.shape[0]
        rf = self._block_row_slices(sysf)
        rc = self._block_row_slices(sysc)
        ec = self._block_entry_slices(sysc)
        tiny = torch.finfo(self.pdtype).tiny
        qf = [0.0] * 4
        qc = [0.0] * 4
        for v in self._probes(k):
            vb = v.expand(bs, -1)
            Av_f = sysf.matvec(fine_vals32, self._prolong_vec(k - 1, vb))
            Av_c = sysc.matvec(coarse_vals32, vb)
            for b in range(4):
                qf[b] = qf[b] + (Av_f[:, rf[b][0] : rf[b][1]] ** 2).sum(dim=1)
                qc[b] = qc[b] + (Av_c[:, rc[b][0] : rc[b][1]] ** 2).sum(dim=1)
        parts = []
        for b in range(4):
            s = torch.sqrt(qf[b] / torch.clamp(qc[b], min=tiny))
            s = torch.where(qc[b] > tiny, s, torch.ones_like(s))
            parts.append(coarse_vals32[:, ec[b][0] : ec[b][1]] * s[:, None])
        return torch.cat(parts, dim=1)

    @torch.no_grad()
    def build_hierarchy(self, coeffs, rhs, iv_rhs, steps_list, fine_values, ridge: float = 0.0):
        """All preconditioner data, with no gradient: per-level smoother data
        and the coarsest-level explicit inverse."""
        coeffs, rhs = coeffs.detach(), rhs.detach()
        steps_list = [s.detach() for s in steps_list]
        iv_rhs = iv_rhs.detach() if iv_rhs is not None else None

        levels = [self._level_precond_data(0, fine_values.detach())]
        for k in range(1, self.n_grid):
            coeffs = self.downsample_coeffs(k - 1, coeffs)
            rhs = self.downsample_rhs(k - 1, rhs)
            steps_list = self.downsample_steps(k - 1, steps_list)
            iv_rhs = self.downsample_iv(k - 1, iv_rhs)
            sysk = self.systems[k]
            values_k = sysk.fill_values(coeffs, steps_list, dtype=self.pdtype)
            values_k = self._rescale_coarse_values(k, levels[k - 1]["values"], values_k)
            if k < self.n_grid - 1:
                levels.append(self._level_precond_data(k, values_k))
            else:  # the coarsest level is solved directly, never smoothed
                levels.append({"values": values_k})

        # coarsest dense factorization (f32, equilibrated)
        sysc = self.systems[-1]
        ata = sysc.assemble_normal(levels[-1]["values"])
        n = sysc.num_vars
        eye = torch.eye(n, dtype=ata.dtype, device=ata.device)
        if ridge:
            ata = ata + ridge * eye
        d = torch.diagonal(ata, dim1=-2, dim2=-1)
        s = torch.rsqrt(torch.clamp(d, min=torch.finfo(ata.dtype).tiny))
        scaled = ata * s[:, :, None] * s[:, None, :] + 1e-6 * eye
        del ata
        L, _ = torch.linalg.cholesky_ex(scaled)
        del scaled
        # explicit inverse with the equilibration folded in, in column chunks
        # to bound the solve's temporaries
        chunk = min(512, n)
        cols = []
        for c0 in range(0, n, chunk):
            c1 = min(c0 + chunk, n)
            cols.append(torch.cholesky_solve(eye[:, c0:c1].expand(L.shape[0], n, c1 - c0), L))
        inv = torch.cat(cols, dim=-1)
        del cols, L
        coarse_inv = inv * s[:, :, None] * s[:, None, :]
        # 'bf16' rounds the stored inverse; it is kept as f32 values for the
        # coarse product, as the JAX package's einsum promotes it
        coarse_inv = coarse_inv.to(self.vdtype).to(self.pdtype)
        return {"levels": levels, "coarse_inv": coarse_inv}

    # ------------------------------------------------------------------
    # smoother and transfers (batched, f32)
    # ------------------------------------------------------------------

    def _smooth(self, k: int, lvl, b, x, steps: int, x0_zero: bool = False,
                want_residual: bool = False):
        """Chebyshev smoothing pass (ops/fused_smoother.chebyshev_smooth);
        with want_residual also returns r = b - A x from the recurrence."""
        x, r = chebyshev_smooth(self.descs[k], self.dim_list[k][0], lvl["coef"],
                                lvl["binv"], b, x, lvl["sched"], steps, x0_zero,
                                factored=self._factored_binv)
        return (x, r) if want_residual else x

    def _restrict_vec(self, k: int, r: torch.Tensor) -> torch.Tensor:
        bs = r.shape[0]
        n_mi = self.systems[k].var_set.n_mi
        x = r.reshape((bs,) + self.dim_list[k] + (n_mi,))
        x = apply_separable(x, self._mats("down", k, x.dtype), offset=1)
        return x.reshape(bs, -1)

    def _prolong_vec(self, k: int, r: torch.Tensor) -> torch.Tensor:
        """Level k+1 -> k."""
        bs = r.shape[0]
        n_mi = self.systems[k + 1].var_set.n_mi
        x = r.reshape((bs,) + self.dim_list[k + 1] + (n_mi,))
        x = apply_separable(x, self._mats("up", k, x.dtype), offset=1)
        return x.reshape(bs, -1)

    # ------------------------------------------------------------------
    # V-cycle
    # ------------------------------------------------------------------

    def v_cycle(self, hier, b, k: int = 0, return_residual: bool = False):
        cfg = self.config
        lvl = hier["levels"][k]
        if cfg.mg_smoother_residual:
            x, r = self._smooth(k, lvl, b, None, cfg.mg_smoother_steps_pre,
                                x0_zero=True, want_residual=True)
        else:
            x = self._smooth(k, lvl, b, None, cfg.mg_smoother_steps_pre, x0_zero=True)
            r = self._normal_apply(k, lvl, x, rin=b)
        rH = self._restrict_vec(k, r)
        if k == self.n_grid - 2:
            deltaH = torch.bmm(hier["coarse_inv"], rH[:, :, None])[..., 0]
        else:
            deltaH = self.v_cycle(hier, rH, k + 1)
        # raw (unit-step) coarse correction
        x = x + self._prolong_vec(k, deltaH)
        return self._smooth(k, lvl, b, x, cfg.mg_smoother_steps_post,
                            want_residual=return_residual)

    def precondition(self, hier, r: torch.Tensor, back: bool = False) -> torch.Tensor:
        """mg_steps V-cycles from a zero guess, in f32; cast at the boundary."""
        n_step = self.config.mg_steps_backward if back else self.config.mg_steps_forward
        rp = r.to(self.pdtype).contiguous()
        x = self.v_cycle(hier, rp, 0)
        for _ in range(n_step - 1):
            res = self._normal_apply(0, hier["levels"][0], x, rin=rp)
            x = x + self.v_cycle(hier, res, 0)
        return x.to(r.dtype)

    def precondition_with_Az(self, hier, r: torch.Tensor, back: bool = False):
        """(z, A z) for flexible GMRES, with A z = r - res_final taken from
        the post-smoother's residual invariant (no fine-level apply)."""
        n_step = self.config.mg_steps_backward if back else self.config.mg_steps_forward
        rp = r.to(self.pdtype).contiguous()
        x, res = self.v_cycle(hier, rp, 0, return_residual=True)
        for _ in range(n_step - 1):
            dx, res = self.v_cycle(hier, res, 0, return_residual=True)
            x = x + dx
        return x.to(r.dtype), (rp - res).to(r.dtype)

    # ------------------------------------------------------------------
    # FGMRES solve on the fine normal equations (batched)
    # ------------------------------------------------------------------

    def _fine_coef(self, hier, fine_values) -> torch.Tensor:
        """Fine-level stencil fields in the solve dtype, built once per
        hierarchy from the unrounded values (they equal the level-0 smoother
        fields when those are stored in the solve dtype)."""
        sdt = self.solve_dtype
        if hier["levels"][0]["coef"].dtype == sdt:
            return hier["levels"][0]["coef"]
        if "fine_coef" not in hier:
            sys0 = self.systems[0]
            sv = sys0.split_values(fine_values.detach().to(sdt))
            hier["fine_coef"] = build_normal_coef(sys0.spec, self.descs[0], sv)
        return hier["fine_coef"]

    @torch.no_grad()
    def solve_normal(self, fine_values, rhs_vec, hier, back: bool = False):
        """Solve AtA x = At rhs (forward) or AtA dz = g (backward, rhs_vec
        already in variable space).  Returns (x, iters, rnorm)."""
        cfg = self.config
        sys0 = self.systems[0]
        restart = cfg.mg_fgmres_restarts_backward if back else cfg.mg_fgmres_restarts_forward
        maxiter = cfg.mg_fgmres_max_iter_backward if back else cfg.mg_fgmres_max_iter_forward
        atb = rhs_vec if back else sys0.rmatvec_s(fine_values, rhs_vec)
        out_dtype = atb.dtype
        coef = self._fine_coef(hier, fine_values)
        desc0 = self.descs[0]
        pmv = None
        if cfg.mg_fused_matvec:
            pmv = lambda r: self.precondition_with_Az(hier, r, back=back)
        res = krylov.fgmres(
            lambda v: stencil_apply(desc0, coef, v),
            atb.to(self.solve_dtype),
            precond=lambda r: self.precondition(hier, r, back=back),
            restart=restart,
            maxiter=maxiter,
            atol=cfg.mg_fgmres_tol,
            tol=cfg.mg_fgmres_tol,
            precond_matvec=pmv,
        )
        return res.x.to(out_dtype), res.iters, res.rnorm.to(out_dtype)


class MultigridNormalSolver:
    """Inner-solver adapter for ops/normal_solve.py: forward/backward
    FGMRES+MG with separate budgets, hierarchy reused in backward."""

    def __init__(self, mg: MultigridSolver):
        self.mg = mg

    def solve(self, values, rhs, pdata):
        x, iters, rnorm = self.mg.solve_normal(values, rhs, pdata, back=False)
        return x, (pdata, iters, rnorm)

    def stats(self, aux):
        return {"iters": aux[1], "fgmres_rnorm": aux[2]}

    def resolve(self, values, g, aux, backward: bool):
        dz, _, _ = self.mg.solve_normal(values, g, aux[0], back=True)
        return dz
