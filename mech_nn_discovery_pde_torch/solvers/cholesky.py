"""Batched dense normal-equation solver (Cholesky) with the JAX package's
precision policies (config.PDEConfig.precision):

  'f64'    factor and solve in float64;
  'f32_ir' symmetric Jacobi equilibration of AtA, a 1e-6 ridge on the unit
           diagonal, a float32 factor, then fixed-step PCG on the float64
           normal operator (through A, matrix-free) preconditioned by that
           factor;
  'f32'    everything float32.

Port of the JAX package's solvers/cholesky.py.  Two differences, both for
the card:

- AtA is assembled by the pair-product scatter (`PDESystem.assemble_normal`)
  in every mode.  The JAX f32 modes form it as (dense A)^T (dense A), one MXU
  product per sample (9088 x 5120 x 5120 at Burgers (32, 32)), asking for
  Precision.HIGHEST because a reduced-precision product turns the marginally
  PSD AtA indefinite.  The scatter forms the same matrix in full float32
  (products and sums are plain f32 arithmetic, never TF32) from the nonzeros
  alone.
- `torch.linalg.cholesky` raises, with a host sync, on an indefinite input;
  JAX returns NaN.  `torch.linalg.cholesky_ex` reports the failure per sample
  without a sync, and the failed samples' factors are set to NaN, so their
  solutions are NaN and `solve_stats()["finite"]` reports them as the JAX
  package's does.

The PCG's dot products are per sample, (bs,).  Solvers follow the inner-solver
protocol of ops/normal_solve.py: solve(values, rhs, pdata) -> (x, aux) and
resolve(values, g, aux, backward) -> (dz, {}).  Spans (utils/profiling):
`dense.factor`, `dense.solve` and, in it, `dense.precond` around each
application of the f32_ir preconditioner.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from mech_nn_discovery_pde_torch.ops.system import PDESystem
from mech_nn_discovery_pde_torch.utils.profiling import span

PRECISIONS = ("f64", "f32_ir", "f32")


def cholesky_nan(a: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor of (bs, n, n), NaN for every sample whose
    matrix is not positive definite (JAX's convention), without a host
    sync."""
    L, info = torch.linalg.cholesky_ex(a)
    return L.masked_fill_((info != 0)[:, None, None], float("nan"))


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 b for a batch of lower factors (bs, n, n) and vectors
    (bs, n), as two triangular solves.  On an H100 `torch.cholesky_solve`
    takes magma's batched trsv, several times slower at the dense path's
    shapes (bs 10, n 5120; chip_smoke.py phase 7 times both)."""
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


class DenseNormalSolver:
    """Inner solver by batched dense Cholesky of AtA."""

    def __init__(self, system: PDESystem, precision: str = "f64", ir_steps: int = 3,
                 ridge: float = 0.0):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
        self.system = system
        self.precision = precision
        self.ir_steps = ir_steps
        self.ridge = ridge

    def factor(self, values: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Assemble and factor AtA for a batch of value vectors: (L, s) with
        s the f32_ir equilibration scale (in the values' dtype), else None.
        AtA is scaled in place (bs n^2 entries: 1 GB in f32 at Burgers'
        bs 10, (32, 32))."""
        with span("dense.factor"):
            if self.precision == "f64":
                ata = self.system.assemble_normal(values)
            else:
                ata = self.system.assemble_normal(values.float())
            diag = torch.diagonal(ata, dim1=-2, dim2=-1)
            if self.ridge:
                diag.add_(self.ridge)
            if self.precision != "f32_ir":
                return cholesky_nan(ata), None
            # the equilibrated matrix has a unit diagonal, so the 1e-6 ridge
            # gives an f32 positivity margin; the f64 PCG absorbs the
            # perturbation
            s = torch.rsqrt(torch.clamp(diag, min=torch.finfo(ata.dtype).tiny))
            ata.mul_(s[:, :, None]).mul_(s[:, None, :])
            diag.add_(1e-6)
            return cholesky_nan(ata), s.to(values.dtype)

    def _solve_factored(self, values: torch.Tensor, rhs_n: torch.Tensor, factor) -> torch.Tensor:
        """Solve AtA x = rhs_n (normal space) given `factor`.  f32_ir: fixed-
        step PCG, preconditioned by the f32 factor, with the curvature guard
        (alpha = 0 where p^T AtA p <= tiny: on this ill-conditioned system
        p^T AtA p can round negative for near-null p)."""
        with span("dense.solve"):
            L, s = factor
            if self.precision != "f32_ir":
                return cho_solve(L, rhs_n.to(L.dtype))

            def mv(x):
                return self.system.normal_matvec_s(values, x)

            def pc(r):
                with span("dense.precond"):
                    return cho_solve(L, (r * s).float()).to(r.dtype) * s

            b = rhs_n
            x = torch.zeros_like(b)
            r = b
            z = pc(r)
            p = z
            rz = _dot(r, z)
            tiny = torch.finfo(b.dtype).tiny
            zero = torch.zeros_like(rz)
            for _ in range(self.ir_steps):
                Ap = mv(p)
                pAp = _dot(p, Ap)
                alpha = torch.where(pAp > tiny, rz / torch.clamp(pAp, min=tiny), zero)
                x = x + alpha[:, None] * p
                r = r - alpha[:, None] * Ap
                z = pc(r)
                rz_new = _dot(r, z)
                beta = torch.where(rz > tiny, rz_new / torch.clamp(rz, min=tiny), zero)
                p = z + beta[:, None] * p
                rz = rz_new
            return x

    # ---- inner-solver protocol (ops/normal_solve.py) -------------------

    def solve(self, values: torch.Tensor, rhs: torch.Tensor, pdata: Any = None):
        factor = self.factor(values)
        atb = self.system.rmatvec_s(values, rhs)
        return self._solve_factored(values, atb, factor), factor

    def resolve(self, values: torch.Tensor, g: torch.Tensor, aux, backward: bool):
        return self._solve_factored(values, g, aux), {}
