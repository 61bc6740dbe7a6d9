"""Plain reference of the `gl` configuration: Ginzburg-Landau discovery,

    u_t + p0(u, v) u + p1(u) u_xx + p2(u) u_yy = p3(v)

over the bases {1, u, u^2, v, v^2, uv} (p0), {1, u, u^2} (p1, p2) and
{v, v^2, v^3} (p3), each p's weights the head of a ParamNet; Dirichlet
data (u) on every face but t = end; loss mean|u0 - u| + 1e-4 sum|ParamNet
outputs| (the transforms are the identity without `nn_transform`).  The
least squares is solved exactly (banded.py), in float64."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench.reference import constraints
from perfbench.reference.banded import BandedLstsq
from perfbench.reference.discovery import DiscoveryReference
from perfbench.reference.nets import paramnet


class Reference(DiscoveryReference):
    def __init__(self, cfg: Dict, data: Dict[str, np.ndarray], device, lower: bool = False,
                 budget_bytes=None):
        """`lower`: the control, with both solutions rounded to bfloat16
        (the stated operator and FGMRES precision is float32): the best
        answer a bfloat16 solve could give, finite where a bfloat16 normal
        matrix breaks down in Cholesky."""
        dims = tuple(cfg["solver_dim"])
        g = np.indices(dims)
        boundary = (g[0] == 0)
        for c in (1, 2):
            boundary |= (g[c] == 0) | (g[c] == dims[c] - 1)
        system = constraints.build(dims, cfg["steps"], boundary)
        rows, cols = self.entries(system)
        plane = int(np.prod(dims[:-1])) * system.m
        solver = BandedLstsq(rows, cols, system.n_rows, system.n_vars, plane, device,
                             budget_bytes, torch.bfloat16 if lower else None)
        super().__init__(system, solver, device, lower)
        self.cfg, self.dims = cfg, dims
        self.u = torch.as_tensor(np.ascontiguousarray(data["u"]), device=self.device)
        self.v = torch.as_tensor(np.ascontiguousarray(data["v"]), device=self.device)
        self.bnd_points = torch.as_tensor(system.bnd_points, device=self.device)

    def _patches(self, field, idx):
        d0, d1, d2 = self.dims
        t = torch.as_tensor(idx[:, 0], device=self.device)[:, None, None, None]
        x = torch.as_tensor(idx[:, 1], device=self.device)[:, None, None, None]
        y = torch.as_tensor(idx[:, 2], device=self.device)[:, None, None, None]
        ar = lambda n: torch.arange(n, device=self.device)
        return field[t + ar(d0)[:, None, None], x + ar(d1)[None, :, None], y + ar(d2)[None, None, :]]

    def parts(self, w, idx, capture):
        bs = idx.shape[0]
        # the control's networks in float32 (TF32 on while it runs)
        nw = {k: v.float() for k, v in w.items()} if self.lower else w
        depth = self.cfg["paramnets"]["depth"]
        u = self._patches(self.u, idx).reshape(bs, -1)
        v = self._patches(self.v, idx).reshape(bs, -1)
        pl = [paramnet(nw, f"pnets.{i}", depth).double()
              for i in range(self.cfg["paramnets"]["count"])]
        one, zero = torch.ones_like(u), torch.zeros_like(u)
        p0 = sum(c * t for c, t in zip(pl[0][:6], (one, u, u * u, v, v * v, u * v)))
        p1 = sum(c * t for c, t in zip(pl[1][:3], (one, u, u * u)))
        p2 = sum(c * t for c, t in zip(pl[2][:3], (one, u, u * u)))
        p3 = sum(c * t for c, t in zip(pl[3][:3], (v, v * v, v * v * v)))
        # unknowns' order: u, u_t, u_x, u_y, u_tt, u_xx, u_yy
        coeffs = torch.stack([p0, one, zero, zero, zero, p1, p2], dim=-1)
        iv = u[:, self.bnd_points]
        if capture:
            iv = iv.clone().requires_grad_(True)

        def loss_x(x, sl, detach):
            u0 = self.solution_values(x)
            return (u0 - u[sl]).abs().mean(dim=-1).sum() / bs

        loss_rest = 1e-4 * sum(p.abs().sum() for p in pl)
        return {"coeffs": coeffs, "rhs": p3, "iv": iv, "loss_x": loss_x, "loss_rest": loss_rest}
