"""Geometric multigrid preconditioner + FGMRES normal-equation solver.

Port of the JAX package's `MultigridSolver` (solvers/multigrid.py), batched
over a leading sample axis throughout:

- coarse operators by re-discretization: field data (coeffs, rhs, iv,
  steps) is downsampled (align-corners linear) and the constraint values
  re-filled on each level, then rescaled per constraint block against the
  finer operator on smooth probes;
- the normal operator AtA (config.mg_normal_op): the assembled block
  stencil ('stencil', kernel K1 on CUDA), or 'factored': A^T (A x) through
  the structured operators (ops/structured.py) on the level's values.
  Evolution systems (equation rows that read the previous time step) fall
  back to 'factored', as in the JAX package: the assembled stencil assumes
  same-point equation entries;
- smoothing (config.mg_smoother), on every non-coarsest level: Chebyshev
  on the block-Jacobi preconditioned normal operator, or weighted block
  Jacobi (jacobi_w on the backward solve, jacobi_w_forward on the forward);
  blocks (config.mg_block_smoother) are time lines ('line') or grid points
  ('point'), B^-1 applied by kernel K2 (K3 under 'bf16_factored') with the
  vector updates in the kernels' epilogues (ops/fused_smoother.py; a point
  block is a time line of length 1 there);
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

The sp-sharded solve (`mesh`, a DeviceMesh of parallel/mesh.py with an
`sp_axis`; the JAX package's explicit sharding of the fine level): grid
axis 0 of the fine level is split over the 'sp' group's ranks, each of
which runs the same solve on its planes.  It takes the stencil operator
and point blocks, as in the JAX package (a time-line block spans axis 0).
A rank holds its planes of the fine level's stencil fields (their halo
exchanged once per hierarchy; parallel/sharded_normal.py), point-block
inverses, smoother vectors and FGMRES basis; K1 applies AtA on its haloed
slab with an output window and K2 its point blocks.  The FGMRES dots and
norms and the lmax power iteration's norms are all-reduced over the group;
restriction applies the axis-0 matrix to the rank's columns and sums the
coarse vector over the group; prolongation computes the rank's rows.  The
coarse levels are replicated: every rank computes them alike.  Inputs and
outputs stay global: each solve takes its right-hand side's run and
gathers its solution, so the IFT backward runs unchanged on global arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig, default_config
from mech_nn_discovery_pde_torch.ops.fused_smoother import (
    block_apply,
    block_apply_route,
    chebyshev_schedule,
    chebyshev_smooth_op,
    factored_block_apply,
    jacobi_smooth,
)
from mech_nn_discovery_pde_torch.ops.interp import apply_separable, interp_matrix
from mech_nn_discovery_pde_torch.ops.normal_stencil import (
    build_normal_coef,
    make_desc,
    stencil_apply,
    stencil_epilogue,
)
from mech_nn_discovery_pde_torch.ops.structured import matvec_structured, rmatvec_structured
from mech_nn_discovery_pde_torch.ops.system import PDESystem
from mech_nn_discovery_pde_torch.parallel.mesh import all_gather_cat, all_reduce_sum_
from mech_nn_discovery_pde_torch.parallel.sharded_normal import (
    make_sharded_flat_ops,
    shard_layout,
)
from mech_nn_discovery_pde_torch.solvers import krylov
from mech_nn_discovery_pde_torch.utils.profiling import count, recording, span


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
        mesh=None,
        sp_axis: str = "sp",
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
        if cfg.mg_normal_op not in ("stencil", "stencil_pallas", "factored"):
            raise ValueError(f"unknown mg_normal_op {cfg.mg_normal_op!r}; expected "
                             "'stencil', 'stencil_pallas' or 'factored'")
        if cfg.mg_smoother not in ("chebyshev", "chebyshev_fused", "jacobi"):
            raise ValueError(f"unknown mg_smoother {cfg.mg_smoother!r}; expected "
                             "'chebyshev', 'chebyshev_fused' or 'jacobi'")
        if cfg.mg_block_smoother not in ("line", "point"):
            raise ValueError(f"unknown mg_block_smoother {cfg.mg_block_smoother!r}; "
                             "expected 'line' or 'point'")
        if cfg.mg_smoother == "chebyshev_fused":
            if evolution or cfg.mg_normal_op == "factored":
                raise ValueError(
                    "mg_smoother='chebyshev_fused' needs the assembled stencil operator "
                    "(mg_normal_op='stencil'); evolution systems fall back to 'factored' "
                    "and are unsupported")
            if cfg.mg_block_smoother != "line":
                raise ValueError("mg_smoother='chebyshev_fused' implements the 'line' "
                                 "block smoother only")
            if mesh is not None:
                raise ValueError("mg_smoother='chebyshev_fused' is incompatible with the "
                                 "sp-sharded solve (halo-extended fine coefficients)")
        if evolution and cfg.mg_normal_op != "factored":
            # evolution equation rows read the previous time step, which the
            # assembled stencil (same-point entries) does not model; the
            # factored A^T (A x) does
            self.config = cfg = dataclasses.replace(cfg, mg_normal_op="factored")
        if mesh is not None:
            if cfg.mg_normal_op != "stencil":
                raise ValueError("sp-sharded solve requires mg_normal_op='stencil' "
                                 f"(got {cfg.mg_normal_op!r})")
            if cfg.mg_block_smoother != "point":
                raise ValueError("sp-sharded solve requires mg_block_smoother='point': 'line' "
                                 "blocks span grid axis 0, which is the sharded axis (each "
                                 "time-line would straddle shards)")
        self._factored_op = cfg.mg_normal_op == "factored"
        self._point = cfg.mg_block_smoother == "point"
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
                            n_iv=n_iv, step_size=0.01, evolution=evolution)
            for d in self.dim_list
        ]
        # assembled block-stencil descriptors; none on the factored operator
        # (make_desc rejects evolution systems)
        self.descs = None if self._factored_op else [make_desc(s.spec) for s in self.systems]

        # the sp-sharded fine level: this rank's planes, the sharded apply
        # and the group's sum
        self._shard = None
        if mesh is not None:
            group = mesh.get_group(sp_axis)
            self._shard = shard_layout(self.descs[0], group)
            self._extend, self._sharded_apply = make_sharded_flat_ops(mesh, self.descs[0],
                                                                      sp_axis)
            self._sp_group = group
            m = self.systems[0].var_set.n_mi
            pts = self._shard.points
            self._vars = slice(pts.start * m, pts.stop * m)  # this rank's run of a vector

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

    def _sharded(self, k: int) -> bool:
        """Whether level k is split over the 'sp' ranks (the fine level
        under `mesh`)."""
        return k == 0 and self._shard is not None

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the 'sp' ranks, in place."""
        return all_reduce_sum_(t, self._sp_group)

    def _local_fields(self, coef: torch.Tensor) -> torch.Tensor:
        """The rank's planes of fine-level stencil fields (bs, NC, N), with
        their halo (exchanged here: once per hierarchy)."""
        return self._extend(coef[:, :, self._shard.points].contiguous())

    def _norm(self, k: int, t: torch.Tensor) -> torch.Tensor:
        """2-norms over the last axis of level-k vectors (of the whole
        vector, all ranks' runs, on the sharded level)."""
        if self._sharded(k):
            return torch.sqrt(self._sum((t * t).sum(dim=-1)))
        return torch.linalg.vector_norm(t, dim=-1)

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

    def _block_nt(self, k: int) -> int:
        """Time positions a smoother block spans on level k (1: point blocks)."""
        return 1 if self._point else self.dim_list[k][0]

    def _level_precond_data(self, k: int, values: torch.Tensor) -> Dict[str, Any]:
        """Per-level smoother data: block inverses (time-line or point
        blocks; 1e-6 max-diag ridge, Cholesky, explicit inverse; or the
        factor W = L^-T) and, on the stencil operator, the assembled stencil
        fields, both in their storage dtypes (the factored operator keeps the
        values' structured split); lmax, estimated on the stored operators,
        and the Chebyshev schedules of the pre/post passes.  Spans
        `hierarchy.level` (attr level) and, in it, `hierarchy.block_factor`."""
        with span("hierarchy.level", level=k):
            sysk = self.systems[k]
            v32 = values.to(self.pdtype)
            if self._point:
                B = sysk.assemble_point_blocks(v32)  # (bs, N, m, m)
                if self._sharded(k):
                    B = B[:, self._shard.points]  # this rank's points
            else:
                B = sysk.assemble_line_blocks(v32)  # (bs, S, bw, bw)
            with span("hierarchy.block_factor"):
                binv = self._block_inverse(B)
            del B
            # the rounded (or factored) operators must be stored before lmax is
            # estimated: Chebyshev amplifies any mode above an underestimate
            lvl = {"values": v32, "binv": binv.to(self.binv_dtype).contiguous()}
            if self._factored_op:
                lvl["sv"] = sysk.split_values(v32)
            else:
                coef = build_normal_coef(sysk.spec, self.descs[k], sysk.split_values(v32))
                coef = coef.to(self.vdtype)
                lvl["coef"] = self._local_fields(coef) if self._sharded(k) else coef
            lvl["lmax"] = self._estimate_lmax(k, lvl)
            steps = max(self.config.mg_smoother_steps_pre, self.config.mg_smoother_steps_post)
            lvl["sched"] = chebyshev_schedule(lvl["lmax"], self.config.mg_chebyshev_ratio, steps)
            return lvl

    def _block_inverse(self, B: torch.Tensor) -> torch.Tensor:
        """B^-1 of every block (a 1e-6 max-diag ridge, Cholesky, then the
        explicit inverse), or the factor W = L^-T (B^-1 = W W^T)."""
        nb = B.shape[-1]
        eye = torch.eye(nb, dtype=B.dtype, device=B.device)
        d = torch.diagonal(B, dim1=-2, dim2=-1)
        ridge = 1e-6 * torch.clamp(d.max(dim=-1, keepdim=True).values, min=1e-30)
        B = B + ridge[..., None] * eye
        L, _ = torch.linalg.cholesky_ex(B)
        if self._factored_binv:
            # B^-1 = L^-T L^-1 = W W^T with W = L^-T
            linv = torch.linalg.solve_triangular(L, eye.expand_as(B), upper=False)
            return linv.transpose(-1, -2).triu()
        return torch.cholesky_solve(eye.expand_as(B), L)

    def _normal_apply(self, k: int, lvl, v: torch.Tensor, **epilogue) -> torch.Tensor:
        """(AtA) v on level k with K1's epilogue (`stencil_apply`): kernel K1
        on CUDA (on the sharded level: on the rank's haloed slab, with the
        output window on its planes), or A^T (A v) through the structured
        operators."""
        if self._sharded(k):
            return self._sharded_apply(lvl["coef"], v, **epilogue)
        if self._factored_op:
            spec, sv = self.systems[k].spec, lvl["sv"]
            y = rmatvec_structured(spec, sv, matvec_structured(spec, sv, v))
            return stencil_epilogue(y, x=v, **epilogue)
        return stencil_apply(self.descs[k], lvl["coef"], v, **epilogue)

    def _block_apply(self, k: int, lvl, r: torch.Tensor, **epilogue) -> torch.Tensor:
        """B^-1 r with the block inverses (kernel K2 on CUDA), or W (W^T r)
        with their factors (kernel K3), with the kernels' epilogue: every
        smoother step's and the lmax iteration's.  While a profiler records,
        each call counts one under `block_apply.launches` (attrs as
        `_block_attrs`)."""
        if recording():
            count("block_apply.launches", 1, **self._block_attrs(k, lvl))
        apply = factored_block_apply if self._factored_binv else block_apply
        return apply(lvl["binv"], r, self._block_nt(k), **epilogue)

    def _block_attrs(self, k: int, lvl) -> Dict[str, Any]:
        """Level k's block applies described: `level`, `route` (the kernel
        its blocks take, ops/fused_smoother.block_apply_route) and `storage`
        (mg_precond_dtype)."""
        return {"level": k,
                "route": block_apply_route(lvl["binv"], self._block_nt(k), self._factored_binv),
                "storage": self.config.mg_precond_dtype}

    def _estimate_lmax(self, k: int, lvl, iters: int = 20) -> torch.Tensor:
        """Power iteration on B^-1 AtA (batched), biased high by the
        load-bearing mg_lmax_margin: Chebyshev amplifies any mode above the
        assumed lmax explosively.  On the sharded level each rank iterates
        on its run of the same start vector, with global norms and dot."""
        n = self.systems[k].num_vars
        bs = lvl["values"].shape[0]
        x = torch.sin(torch.arange(n, dtype=self.pdtype, device=self.device) + 1.0)
        if self._sharded(k):
            x = x[self._vars]
        x = (x / self._norm(k, x)).expand(bs, -1).contiguous()
        for _ in range(iters):
            y = self._block_apply(k, lvl, self._normal_apply(k, lvl, x))
            x = y / torch.clamp(self._norm(k, y)[:, None], min=1e-30)
        y = self._block_apply(k, lvl, self._normal_apply(k, lvl, x))
        xy = (x * y).sum(dim=1)
        if self._sharded(k):
            xy = self._sum(xy)
        return self.config.mg_lmax_margin * xy

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
        smooth subspace.  The products run in the ELL layout, packed once:
        the JAX package's summation order, which the coarse scales (and so
        an unconverged solve's last digits) follow."""
        sysf, sysc = self.systems[k - 1], self.systems[k]
        bs = fine_vals32.shape[0]
        pf = sysf.pack_values(fine_vals32, adjoint=False)
        pc = sysc.pack_values(coarse_vals32, adjoint=False)
        rf = self._block_row_slices(sysf)
        rc = self._block_row_slices(sysc)
        ec = self._block_entry_slices(sysc)
        tiny = torch.finfo(self.pdtype).tiny
        qf = [0.0] * 4
        qc = [0.0] * 4
        for v in self._probes(k):
            vb = v.expand(bs, -1)
            Av_f = sysf.matvec_packed(pf, self._prolong_vec(k - 1, vb, full=True))
            Av_c = sysc.matvec_packed(pc, vb)
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
        and the coarsest-level explicit inverse.  Spans `hierarchy` and, in
        it, `hierarchy.coarse_factor`."""
        with span("hierarchy"):
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
            with span("hierarchy.coarse_factor"):
                coarse_inv = self._coarse_inverse(levels[-1]["values"], ridge)
            return {"levels": levels, "coarse_inv": coarse_inv}

    def _coarse_inverse(self, values: torch.Tensor, ridge: float) -> torch.Tensor:
        """The coarsest level's dense factorization (f32, equilibrated):
        assembled AtA, explicit inverse in its storage rounding."""
        sysc = self.systems[-1]
        ata = sysc.assemble_normal(values)
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
        return coarse_inv.to(self.vdtype).to(self.pdtype)

    # ------------------------------------------------------------------
    # smoother and transfers (batched, f32)
    # ------------------------------------------------------------------

    def _smooth(self, k: int, lvl, b, x, steps: int, back: bool, x0_zero: bool = False,
                want_residual: bool = False):
        """One smoothing pass (ops/fused_smoother.py): Chebyshev, whose
        want_residual returns r = b - A x from the recurrence; or weighted
        block Jacobi (weight jacobi_w on the backward solve, jacobi_w_forward
        on the forward), which recomputes it.  Each block apply is the span
        `vcycle.block_apply` (attrs as `_block_attrs`)."""
        apply = lambda v, **ep: self._normal_apply(k, lvl, v, **ep)

        def block(r, **ep):
            if not recording():
                return self._block_apply(k, lvl, r, **ep)
            with span("vcycle.block_apply", **self._block_attrs(k, lvl)):
                return self._block_apply(k, lvl, r, **ep)

        cfg = self.config
        if cfg.mg_smoother == "jacobi":
            w = cfg.jacobi_w if back else cfg.jacobi_w_forward
            return jacobi_smooth(apply, block, b, x, steps, w, x0_zero, want_residual)
        x, r = chebyshev_smooth_op(apply, block, b, x, lvl["sched"], steps, x0_zero)
        return (x, r) if want_residual else x

    def _restrict_vec(self, k: int, r: torch.Tensor) -> torch.Tensor:
        """Level k -> k+1.  From the sharded level: the axis-0 matrix's
        columns of the rank's planes, then the sum over the ranks."""
        bs = r.shape[0]
        n_mi = self.systems[k].var_set.n_mi
        dims, mats = self.dim_list[k], self._mats("down", k, r.dtype)
        if self._sharded(k):
            dims = (self._shard.n_loc,) + dims[1:]
            mats = [mats[0][:, self._shard.planes]] + mats[1:]
        x = r.reshape((bs,) + dims + (n_mi,))
        x = apply_separable(x, mats, offset=1).reshape(bs, -1)
        return self._sum(x.contiguous()) if self._sharded(k) else x

    def _prolong_vec(self, k: int, r: torch.Tensor, full: bool = False) -> torch.Tensor:
        """Level k+1 -> k; to the sharded level the rows of the rank's
        planes, unless `full` (the coarse rescale's probes, on every rank)."""
        bs = r.shape[0]
        n_mi = self.systems[k + 1].var_set.n_mi
        x = r.reshape((bs,) + self.dim_list[k + 1] + (n_mi,))
        mats = self._mats("up", k, x.dtype)
        if self._sharded(k) and not full:
            mats = [mats[0][self._shard.planes]] + mats[1:]
        x = apply_separable(x, mats, offset=1)
        return x.reshape(bs, -1)

    # ------------------------------------------------------------------
    # V-cycle
    # ------------------------------------------------------------------

    def v_cycle(self, hier, b, k: int = 0, back: bool = False,
                return_residual: bool = False):
        """One V-cycle from level k down; spans `vcycle.smooth_pre`,
        `.restrict`, `.prolong`, `.smooth_post` (attr level k) and
        `vcycle.coarse` (attr level: the coarsest)."""
        cfg = self.config
        lvl = hier["levels"][k]
        with span("vcycle.smooth_pre", level=k):
            if cfg.mg_smoother_residual:
                x, r = self._smooth(k, lvl, b, None, cfg.mg_smoother_steps_pre, back,
                                    x0_zero=True, want_residual=True)
            else:
                x = self._smooth(k, lvl, b, None, cfg.mg_smoother_steps_pre, back, x0_zero=True)
                r = self._normal_apply(k, lvl, x, rin=b)
        with span("vcycle.restrict", level=k):
            rH = self._restrict_vec(k, r)
        if k == self.n_grid - 2:
            with span("vcycle.coarse", level=k + 1):
                deltaH = torch.bmm(hier["coarse_inv"], rH[:, :, None])[..., 0]
        else:
            deltaH = self.v_cycle(hier, rH, k + 1, back)
        with span("vcycle.prolong", level=k):
            # raw (unit-step) coarse correction
            x = x + self._prolong_vec(k, deltaH)
        with span("vcycle.smooth_post", level=k):
            return self._smooth(k, lvl, b, x, cfg.mg_smoother_steps_post, back,
                                want_residual=return_residual)

    def precondition(self, hier, r: torch.Tensor, back: bool = False) -> torch.Tensor:
        """mg_steps V-cycles from a zero guess, in f32; cast at the boundary."""
        n_step = self.config.mg_steps_backward if back else self.config.mg_steps_forward
        rp = r.to(self.pdtype).contiguous()
        x = self.v_cycle(hier, rp, 0, back)
        for _ in range(n_step - 1):
            res = self._normal_apply(0, hier["levels"][0], x, rin=rp)
            x = x + self.v_cycle(hier, res, 0, back)
        return x.to(r.dtype)

    def precondition_with_Az(self, hier, r: torch.Tensor, back: bool = False):
        """(z, A z) for flexible GMRES, with A z = r - res_final taken from
        the post-smoother's residual invariant (no fine-level apply)."""
        n_step = self.config.mg_steps_backward if back else self.config.mg_steps_forward
        rp = r.to(self.pdtype).contiguous()
        x, res = self.v_cycle(hier, rp, 0, back, return_residual=True)
        for _ in range(n_step - 1):
            dx, res = self.v_cycle(hier, res, 0, back, return_residual=True)
            x = x + dx
        return x.to(r.dtype), (rp - res).to(r.dtype)

    # ------------------------------------------------------------------
    # FGMRES solve on the fine normal equations (batched)
    # ------------------------------------------------------------------

    def _fine_op(self, hier, fine_values):
        """The fine-level AtA matvec in the solve dtype: K1 on the stencil
        fields, or A^T (A v) on the values' structured split."""
        if self._factored_op:
            spec = self.systems[0].spec
            sv = self.systems[0].split_values(fine_values.detach().to(self.solve_dtype))
            return lambda v: rmatvec_structured(spec, sv, matvec_structured(spec, sv, v))
        coef, desc0 = self._fine_coef(hier, fine_values), self.descs[0]
        if self._shard is not None:
            return lambda v: self._sharded_apply(coef, v)
        return lambda v: stencil_apply(desc0, coef, v)

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
            coef = build_normal_coef(sys0.spec, self.descs[0], sv)
            hier["fine_coef"] = self._local_fields(coef) if self._shard is not None else coef
        return hier["fine_coef"]

    @torch.no_grad()
    def solve_normal(self, fine_values, rhs_vec, hier, back: bool = False):
        """Solve AtA x = At rhs (forward) or AtA dz = g (backward, rhs_vec
        already in variable space).  Returns (x, iters, rnorm).  Sharded:
        each rank solves on its run of the right-hand side, the dots and
        norms summed over the ranks, and gathers x; every rank returns the
        same global x, iters and rnorm.  Span `fgmres` (attr back)."""
        cfg = self.config
        sys0 = self.systems[0]
        restart = cfg.mg_fgmres_restarts_backward if back else cfg.mg_fgmres_restarts_forward
        maxiter = cfg.mg_fgmres_max_iter_backward if back else cfg.mg_fgmres_max_iter_forward
        atb = rhs_vec if back else sys0.rmatvec_s(fine_values, rhs_vec)
        out_dtype = atb.dtype
        reduce = None
        if self._shard is not None:
            atb, reduce = atb[:, self._vars].contiguous(), self._sum
        pmv = None
        if cfg.mg_fused_matvec:
            pmv = lambda r: self.precondition_with_Az(hier, r, back=back)
        op = self._fine_op(hier, fine_values)
        with span("fgmres", back=back):
            res = krylov.fgmres(
                op,
                atb.to(self.solve_dtype),
                precond=lambda r: self.precondition(hier, r, back=back),
                restart=restart,
                maxiter=maxiter,
                atol=cfg.mg_fgmres_tol,
                tol=cfg.mg_fgmres_tol,
                precond_matvec=pmv,
                reduce=reduce,
            )
        x = res.x
        if self._shard is not None:
            x = all_gather_cat(x, self._sp_group, dim=1)
        return x.to(out_dtype), res.iters, res.rnorm.to(out_dtype)


class MultigridNormalSolver:
    """Inner-solver adapter for ops/normal_solve.py: forward/backward
    FGMRES+MG with separate budgets, hierarchy reused in backward.  While a
    profiler records, each solve keeps the counters `fgmres.iters.<side>`
    and `fgmres.rel_resid.<side>` (FGMRES's final true residual over the
    norm of its right-hand side), per sample, side `fwd` or `bwd`."""

    def __init__(self, mg: MultigridSolver):
        self.mg = mg

    def solve(self, values, rhs, pdata):
        x, iters, rnorm = self.mg.solve_normal(values, rhs, pdata, back=False)
        if recording():
            _count_solve("fwd", iters, rnorm, self.mg.systems[0].rmatvec_s(values, rhs))
        return x, (pdata, iters, rnorm)

    def stats(self, aux):
        return {"iters": aux[1], "fgmres_rnorm": aux[2]}

    def resolve(self, values, g, aux, backward: bool):
        dz, iters, rnorm = self.mg.solve_normal(values, g, aux[0], back=True)
        if recording():
            _count_solve("bwd", iters, rnorm, g)
        return dz, {"iters": iters, "fgmres_rnorm": rnorm}


def _count_solve(side: str, iters, rnorm, rhs) -> None:
    bnorm = torch.clamp(torch.linalg.vector_norm(rhs, dim=1), min=1e-30)
    count(f"fgmres.iters.{side}", iters)
    count(f"fgmres.rel_resid.{side}", rnorm / bnorm)
