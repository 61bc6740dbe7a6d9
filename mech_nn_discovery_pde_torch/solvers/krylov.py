"""Batched flexible GMRES (right-preconditioned, restarted).

Port of the JAX package's `fgmres` (solvers/krylov.py).  There the solver is
written per sample and vmapped: the batched `while_loop` runs while any
sample is unconverged and freezes the carry of converged ones.  Here the
batch is an explicit leading axis and that freeze is a per-sample mask:

- convergence (residual norm <= max(atol, tol * ||b||)) is checked only
  between restart windows, and a window adds `restart` to the iteration
  count, so `maxiter` moves in whole windows;
- every window runs for all samples; samples already converged keep their
  (x, iters, rnorm) unchanged;
- CGS2 orthogonalization, Givens-rotation QR of the Hessenberg columns and
  back-substitution, as in the reference;
- `precond_matvec(v) -> (z, A z)` replaces the separate precond + matvec in
  the Arnoldi loop when given; `matvec` still gives the true residuals at
  window boundaries.

The dot products and axpys are library calls (batched matmuls).  The window
loop reads one flag from the device per window.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    rnorm: torch.Tensor


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def fgmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond: Optional[Callable] = None,
    restart: int = 20,
    maxiter: int = 40,
    atol: float = 1e-5,
    tol: float = 1e-5,
    precond_matvec: Optional[Callable] = None,
) -> KrylovResult:
    """Flexible GMRES on a batch of right-hand sides b (bs, n)."""
    precond = precond or (lambda v: v)
    bs, n = b.shape
    x = torch.zeros_like(b) if x0 is None else x0
    thresh = torch.clamp(tol * torch.linalg.vector_norm(b, dim=1), min=atol)

    def restart_cycle(x):
        r = b - matvec(x)
        beta = torch.linalg.vector_norm(r, dim=1)
        V = b.new_zeros((bs, restart + 1, n))
        Z = b.new_zeros((bs, restart, n))
        V[:, 0] = _safe_div(r, beta[:, None])
        R = b.new_zeros((bs, restart, restart))
        g = b.new_zeros((bs, restart + 1))
        g[:, 0] = beta
        cs = b.new_zeros((bs, restart))
        sn = b.new_zeros((bs, restart))
        for j in range(restart):
            if precond_matvec is not None:
                z, u = precond_matvec(V[:, j])
            else:
                z = precond(V[:, j])
                u = matvec(z)
            Z[:, j] = z
            # CGS2: rows > j of V are zero, so the full product projects
            # exactly onto the built basis
            h1 = torch.bmm(V, u[:, :, None])[..., 0]
            u = u - torch.bmm(V.transpose(1, 2), h1[:, :, None])[..., 0]
            h2 = torch.bmm(V, u[:, :, None])[..., 0]
            u = u - torch.bmm(V.transpose(1, 2), h2[:, :, None])[..., 0]
            h = h1 + h2
            hn = torch.linalg.vector_norm(u, dim=1)
            V[:, j + 1] = _safe_div(u, hn[:, None])
            # previous rotations on the new column h[0..j], then h[j+1] = hn
            hcol = b.new_zeros((bs, restart + 1))
            hcol[:, :restart] = h[:, :restart]
            hcol[:, j + 1] = hn
            for i in range(j):
                hi, hi1 = hcol[:, i].clone(), hcol[:, i + 1].clone()
                hcol[:, i] = cs[:, i] * hi + sn[:, i] * hi1
                hcol[:, i + 1] = -sn[:, i] * hi + cs[:, i] * hi1
            # new rotation annihilating hcol[j+1]
            a_, b_ = hcol[:, j].clone(), hcol[:, j + 1].clone()
            denom = torch.sqrt(a_ * a_ + b_ * b_)
            c_ = torch.where(denom == 0, torch.ones_like(a_), _safe_div(a_, denom))
            s_ = _safe_div(b_, denom)
            cs[:, j] = c_
            sn[:, j] = s_
            hcol[:, j] = c_ * a_ + s_ * b_
            hcol[:, j + 1] = 0.0
            R[:, :, j] = hcol[:, :restart]
            gj = g[:, j].clone()
            g[:, j + 1] = -s_ * gj
            g[:, j] = c_ * gj
        # back-substitution R y = g[:restart]
        y = b.new_zeros((bs, restart))
        for i in range(restart - 1, -1, -1):
            resid = g[:, i] - (R[:, i] * y).sum(dim=1)
            y[:, i] = _safe_div(resid, R[:, i, i])
        return x + torch.bmm(Z.transpose(1, 2), y[:, :, None])[..., 0]

    rn = torch.linalg.vector_norm(b - matvec(x), dim=1)
    it = torch.zeros(bs, dtype=torch.int64, device=b.device)
    while True:
        active = (rn > thresh) & (it < maxiter)
        if not bool(active.any()):
            break
        x_new = restart_cycle(x)
        rn_new = torch.linalg.vector_norm(b - matvec(x_new), dim=1)
        x = torch.where(active[:, None], x_new, x)
        rn = torch.where(active, rn_new, rn)
        it = torch.where(active, it + restart, it)
    return KrylovResult(x, it, rn)
