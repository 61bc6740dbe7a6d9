"""A discovery training step, plainly: the problem's networks give the
equation's coefficients, right-hand side and boundary data; the constraint
system (constraints.py) is solved by least squares with its implicit-
function backward (banded.py or dense_ir.py); the loss's gradient reaches
every leaf by autograd; Adam (nets.py) updates the leaves.  In float64.

A problem (gl.py, burgers.py) gives `parts(w, idx)`: the coefficients (bs,
G, m), rhs (bs, G) and boundary data (bs, n_bnd) in grid order, the rest of
the loss (no solution in it) and `loss_x(x, samples, detach)`, the solution's
part of the loss for those samples (its other inputs detached with
`detach`), which must be a sum of per-sample terms."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.lib.common import log
from perfbench.reference import constraints
from perfbench.reference.nets import Adam


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for float32 matmuls and convolutions while open (the control's
    networks), or left as it is."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    old = [f.allow_tf32 for f in flags]
    if on:
        for f in flags:
            f.allow_tf32 = True
    try:
        yield
    finally:
        for f, o in zip(flags, old):
            f.allow_tf32 = o


class DiscoveryReference:
    def __init__(self, system: constraints.System, solver, device, lower: bool = False):
        """`lower`: the lower-precision control, which computes one step
        below each precision the configuration states: its networks in
        float32 with TF32 (the problem's `parts`), its solver's as the
        problem sets it up."""
        self.sys, self.solver, self.device = system, solver, torch.device(device)
        self.lower = lower
        s = system
        n_eq = s.eq_points.size
        self.eq_points = torch.as_tensor(s.eq_points, device=self.device)
        self.eq_rows = torch.as_tensor(s.eq_rows, device=self.device)
        self.bnd_rows = torch.as_tensor(s.bnd_rows, device=self.device)
        self.static_vals = torch.as_tensor(s.vals, device=self.device, dtype=torch.float64)
        self.value_cols = torch.as_tensor(s.value_col(np.arange(int(np.prod(s.dims)))),
                                          device=self.device)
        self.n_eq = n_eq
        rows, cols = self.entries(s)
        self.rows = torch.as_tensor(rows, device=self.device)
        self.cols = torch.as_tensor(cols, device=self.device)
        # unknown (grid point, mi) in grid order -> the reference's number
        self.grid_cols = (self.value_cols[:, None] + torch.arange(s.m, device=self.device)).reshape(-1)

    @staticmethod
    def entries(system: constraints.System):
        """(rows, cols) of every entry: the equation entries (point by point,
        mi within), then the static ones."""
        s = system
        rows = np.concatenate([np.repeat(s.eq_rows, s.m), s.rows])
        cols = np.concatenate([s.eq_cols.reshape(-1), s.cols])
        return rows, cols

    def solution_values(self, x: torch.Tensor) -> torch.Tensor:
        """u at every grid point (C order of dims) from the unknowns."""
        return x[:, self.value_cols]

    def residual(self, vals: torch.Tensor, b: torch.Tensor, u: torch.Tensor) -> float:
        """The normal equations' relative residual ||A^T (b - A x)|| / ||A^T b||
        of a solution u (bs, G, m) in grid order, the most over samples."""
        bs = vals.shape[0]
        x = vals.new_zeros((bs, self.sys.n_vars))
        x[:, self.grid_cols] = u.reshape(bs, -1).to(vals)
        ax = vals.new_zeros((bs, self.sys.n_rows)).index_add_(1, self.rows, vals * x[:, self.cols])
        at = lambda y: vals.new_zeros((bs, self.sys.n_vars)).index_add_(
            1, self.cols, vals * y[:, self.rows])
        return float((at(b - ax).norm(dim=1) / at(b).norm(dim=1)).max())

    def parts(self, w: Dict[str, torch.Tensor], idx: np.ndarray, capture: bool):
        raise NotImplementedError

    def step(self, w: Dict[str, torch.Tensor], idx: np.ndarray, capture: bool = False,
             judge: torch.Tensor = None):
        """(loss, grads by leaf, extras): one step's loss and gradient at w;
        with `capture` also the layer's inputs (coefficients and rhs, (bs,
        G m + G)), the solution (u0 (bs, G), all unknowns (bs, G, m)), the norms of the gradients of the layer's inputs, and the
        residual of the solution `judge` (another's, in grid order)."""
        wr = {n: t.detach().clone().requires_grad_(True) for n, t in w.items()}
        p = self.parts(wr, idx, capture)
        coeffs, rhs, iv = p["coeffs"], p["rhs"], p["iv"]
        if capture:
            for t in (coeffs, rhs, iv):
                t.retain_grad()
        bs = coeffs.shape[0]
        vals = torch.cat([coeffs[:, self.eq_points, :].reshape(bs, -1),
                          self.static_vals.expand(bs, -1)], dim=1)
        b = coeffs.new_zeros((bs, self.sys.n_rows))
        b[:, self.eq_rows] = rhs[:, self.eq_points]
        b[:, self.bnd_rows] = iv

        def gfn(xc, sl):
            xl = xc.detach().requires_grad_(True)
            return torch.autograd.grad(p["loss_x"](xl, sl, True), xl)[0]

        x, vbar, bbar = self.solver.solve(vals.detach(), b.detach(), gfn)
        loss = p["loss_x"](x.detach(), slice(0, bs), False) + p["loss_rest"]
        torch.autograd.backward([loss, vals, b], [torch.ones_like(loss), vbar, bbar])
        grads = {n: t.grad.detach() for n, t in wr.items()}
        extras = {}
        if capture:
            extras["layer_in"] = torch.cat([coeffs.detach().reshape(bs, -1),
                                            rhs.detach().reshape(bs, -1)], dim=1)
            extras["u0"] = self.solution_values(x).detach()
            extras["u"] = x[:, self.grid_cols].view(bs, -1, self.sys.m).detach()
            if judge is not None:
                extras["resid"] = self.residual(vals.detach(), b.detach(), judge)
            extras["grad_in"] = {k: float(t.grad.norm()) for k, t in
                                 (("coeffs", coeffs), ("rhs", rhs), ("iv", iv))}
        return float(loss.detach()), grads, extras

    def run(self, w0: Dict[str, torch.Tensor], indices: List[np.ndarray], lr: float,
            judge: torch.Tensor = None) -> Dict:
        """The reference's own steps from w0 over the check steps' batches:
        each step's loss, the first gradient, the change of every leaf
        after the last step, and the first step's extras (with `judge`, the
        residual of that first-step solution)."""
        w = {n: t.detach().double().clone() for n, t in w0.items()}
        opt = Adam(list(w), lr)
        with tf32(self.lower):
            return self._run(w, w0, opt, indices, judge)

    def _run(self, w, w0, opt, indices, judge):
        losses, first, extras = [], None, None
        for k, idx in enumerate(indices):
            t0 = time.perf_counter()
            loss, grads, ex = self.step(w, idx, capture=(k == 0), judge=judge if k == 0 else None)
            log(f"reference step {k + 1}: loss {loss!r}, {time.perf_counter() - t0:.2f} s")
            losses.append(loss)
            if k == 0:
                first, extras = grads, ex
            opt.step(w, grads)
        change = {n: (w[n] - w0[n].double()) for n in w}
        return {"losses": losses, "grad1": {n: float(g.norm()) for n, g in first.items()},
                "dparam": {n: float(c.norm()) for n, c in change.items()}, **extras}
