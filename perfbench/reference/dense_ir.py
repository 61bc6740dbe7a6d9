"""Least squares by the dense 'f32_ir' algorithm, written plainly: the
normal matrix A^T A, equilibrated to a unit diagonal (s = diag^-1/2) with a
1e-6 ridge, factored once in float32; then a fixed number of conjugate-
gradient steps on the float64 normal operator A^T (A v), preconditioned by
that factor: M^-1 r = s (L L^T)^-1 (s r).  The forward solves A^T A x =
A^T b, the backward A^T A dz = g, each from zero, with the same factor.

It follows the steps, not a converged answer: at the Burgers sizes the
backward's right-hand side is far from the factor's reach and `ir_steps`
steps stop far from convergence, so the reference has to take the same
steps to compute the same gradient.  A^T A is formed from a dense A in
float64 (rounded to float32 once); `pcg_dtype` float32 is the lower-
precision control (the steps in float32 where float64 is stated).
"""

from __future__ import annotations

from typing import Callable

import torch


class DenseIR:
    def __init__(self, rows, cols, n_rows: int, n_vars: int, device, ir_steps: int,
                 pcg_dtype=torch.float64):
        self.n_rows, self.n_vars = n_rows, n_vars
        dev = torch.device(device)
        self.rows = torch.as_tensor(rows, device=dev)
        self.cols = torch.as_tensor(cols, device=dev)
        self.lin = self.rows * n_vars + self.cols
        self.ir_steps = ir_steps
        self.pcg_dtype = pcg_dtype

    def _dense(self, vals):
        A = vals.new_zeros((vals.shape[0], self.n_rows * self.n_vars))
        return A.index_add_(1, self.lin, vals).view(-1, self.n_rows, self.n_vars)

    def _pcg(self, A, L, s, rhs):
        dt = self.pcg_dtype
        A, s = A.to(dt), s.to(dt)

        def mv(v):
            return (A.mT @ (A @ v[..., None]))[..., 0]

        def pc(r):
            y = (r * s).float()[..., None]
            y = torch.linalg.solve_triangular(L, y, upper=False)
            y = torch.linalg.solve_triangular(L.mT, y, upper=True)
            return y[..., 0].to(dt) * s

        b = rhs.to(dt)
        x = torch.zeros_like(b)
        r = b
        z = pc(r)
        p = z
        rz = (r * z).sum(-1)
        tiny = torch.finfo(dt).tiny
        zero = torch.zeros_like(rz)
        for _ in range(self.ir_steps):
            Ap = mv(p)
            pAp = (p * Ap).sum(-1)
            alpha = torch.where(pAp > tiny, rz / torch.clamp(pAp, min=tiny), zero)
            x = x + alpha[:, None] * p
            r = r - alpha[:, None] * Ap
            z = pc(r)
            rz_new = (r * z).sum(-1)
            beta = torch.where(rz > tiny, rz_new / torch.clamp(rz, min=tiny), zero)
            p = z + beta[:, None] * p
            rz = rz_new
        return x.double()

    def solve(self, vals: torch.Tensor, b: torch.Tensor,
              gfn: Callable[[torch.Tensor, slice], torch.Tensor]):
        """(x, dL/dvals, dL/db) for the whole batch (see banded.BandedLstsq)."""
        A = self._dense(vals)
        ata = (A.mT @ A).float()
        d = torch.diagonal(ata, dim1=-2, dim2=-1)
        s = torch.rsqrt(torch.clamp(d, min=torch.finfo(torch.float32).tiny))
        ata.mul_(s[:, :, None]).mul_(s[:, None, :])
        torch.diagonal(ata, dim1=-2, dim2=-1).add_(1e-6)
        L, info = torch.linalg.cholesky_ex(ata)
        L = L.masked_fill((info != 0)[:, None, None], float("nan"))
        del ata
        s = s.double()
        atb = (A.mT @ b[..., None])[..., 0]
        x = self._pcg(A, L, s, atb)
        g = gfn(x, slice(0, vals.shape[0]))
        dz = self._pcg(A, L, s, g)
        lam = b - (A @ x[..., None])[..., 0]
        adz = (A @ dz[..., None])[..., 0]
        vbar = lam[:, self.rows] * dz[:, self.cols] - adz[:, self.rows] * x[:, self.cols]
        return x, vbar, adz
