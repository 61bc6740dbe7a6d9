"""Differentiable least-squares solve (implicit-function-theorem backward).

Solves min_x ||A(theta) x - b||^2 via the normal equations AtA x = At b,
as a `torch.autograd.Function` whose backward is the IFT:

  dz   = (AtA)^{-1} g            (reuses the forward's solver data)
  A_bar[r, c] = lam[r] dz[c] - (A dz)[r] x[c],   lam = b - A x
  b_bar = A dz

restricted to the static sparsity of A (a pair of gathers per entry).
Gradients w.r.t. coefficients and step sizes flow on through the fill
functions by ordinary autograd.  The preconditioner data (`pdata`, e.g. the
multigrid hierarchy) takes no gradient.

Inner solvers provide `solve(values, rhs, pdata) -> (x, aux)`,
`resolve(values, g, aux, backward) -> (dz, stats)` (stats: a dict of the
backward solve's own per-sample numbers, e.g. FGMRES 'iters'; may be empty)
and optionally `stats(aux)`.  The backward records the span `layer.backward`
(utils/profiling).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

import torch

from mech_nn_discovery_pde_torch.ops.system import PDESystem
from mech_nn_discovery_pde_torch.utils.profiling import span


class _LstsqSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, rhs, system: PDESystem, inner, pdata, side: Dict[str, Any]):
        x, aux = inner.solve(values, rhs, pdata)
        lam = rhs - system.matvec_s(values, x)
        ctx.save_for_backward(values, x, lam)
        ctx.system, ctx.inner, ctx.aux = system, inner, aux
        ctx.stats_fn = side.get("stats_fn")
        side["aux"], side["lam"] = aux, lam
        return x

    @staticmethod
    def backward(ctx, g):
        with span("layer.backward"):
            values, x, lam = ctx.saved_tensors
            system = ctx.system
            g = g.contiguous()
            dz, solve_stats = ctx.inner.resolve(values, g, ctx.aux, backward=True)
            if ctx.stats_fn is not None:
                rn = torch.linalg.vector_norm(g - system.normal_matvec_s(values, dz), dim=1)
                gn = torch.linalg.vector_norm(g, dim=1)
                ctx.stats_fn("backward", {
                    "rnorm": rn,
                    "rel_rnorm": rn / torch.clamp(gn, min=1e-30),
                    "finite": torch.isfinite(dz).all(dim=1),
                    **solve_stats,
                })
            w = system.matvec_s(values, dz)  # A dz
            rows = system.index("rows_all", values.device)
            cols = system.index("cols_all", values.device)
            values_bar = lam[:, rows] * dz[:, cols] - w[:, rows] * x[:, cols]
            return values_bar.to(values.dtype), w.to(values.dtype), None, None, None, None


def make_lstsq_solve(system: PDESystem, inner, stats_fn: Optional[Callable] = None,
                     return_stats: bool = False):
    """Batched differentiable solve: solve(values, rhs, pdata) -> x, or
    (x, stats) with return_stats.  The stats (forward solve; no gradient)
    are 'rnorm' / 'rel_rnorm' (normal-equation residual), 'finite' and the
    inner solver's entries (FGMRES 'iters', 'fgmres_rnorm').  `stats_fn`
    (phase, stats) is called after every forward and backward solve; the
    backward's stats are the same norms of its own solve, with the inner
    solver's resolve stats (FGMRES 'iters', 'fgmres_rnorm')."""

    def _fwd_stats(values, rhs, x, lam, aux):
        rn = torch.linalg.vector_norm(system.rmatvec_s(values, lam), dim=1)
        bn = torch.linalg.vector_norm(system.rmatvec_s(values, rhs), dim=1)
        stats = {
            "rnorm": rn,
            "rel_rnorm": rn / torch.clamp(bn, min=1e-30),
            "finite": torch.isfinite(x).all(dim=1),
        }
        extra = getattr(inner, "stats", None)
        if extra is not None:
            stats.update(extra(aux))
        return stats

    def solve(values, rhs, pdata):
        side = {"stats_fn": stats_fn}
        x = _LstsqSolve.apply(values, rhs, system, inner, pdata, side)
        if not (return_stats or stats_fn is not None):
            return x
        with torch.no_grad():
            stats = _fwd_stats(values.detach(), rhs.detach(), x.detach(),
                               side["lam"], side["aux"])
        if stats_fn is not None:
            stats_fn("forward", stats)
        return (x, stats) if return_stats else x

    return solve


def default_stats_fn(log=None, check_finite: bool = False, name: str = "pde"):
    """Per-solve stats consumer: logs summary norms and (optionally) raises
    on non-finite solutions."""
    log = log or logging.getLogger(name)

    def fn(phase, stats):
        rel = stats["rel_rnorm"].detach().cpu()
        finite = bool(stats["finite"].all())
        msg = f"solve[{phase}] rel_rnorm mean={rel.mean():.3e} max={rel.max():.3e}"
        if "iters" in stats:
            it = stats["iters"].detach().cpu().double()
            msg += f" iters mean={it.mean():.1f} max={int(it.max())}"
        if not finite:
            msg += " NON-FINITE SOLUTION"
            log.error(msg)
            if check_finite:
                raise FloatingPointError(f"{phase} PDE solve produced non-finite solution")
        else:
            log.info(msg)

    return fn
