"""Plain reference of the `burgers` configuration: viscous Burgers discovery,

    u_t + p(u) u_x + q(u) u_xx = r(u)

over the basis {1, u, u^2, u^3, u^4} for each of p, q, r, the weights the
heads of three ParamNets; a 2D ResNet denoises the whole field once a step,
the patches and their boundary data (t = 0, x = 0, x = end) are taken from
the denoised field; loss mean|u0 - u| + mean|u' - u0| + l1 mean|weights|.
The least squares follows the 'f32_ir' steps (dense_ir.py)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench.reference import constraints
from perfbench.reference.dense_ir import DenseIR
from perfbench.reference.discovery import DiscoveryReference
from perfbench.reference.nets import paramnet, resnet


class Reference(DiscoveryReference):
    def __init__(self, cfg: Dict, data: Dict[str, np.ndarray], device, lower: bool = False):
        """`lower`: the control, with the conjugate-gradient steps in
        float32."""
        dims = tuple(cfg["solver_dim"])
        g = np.indices(dims)
        boundary = (g[0] == 0) | (g[1] == 0) | (g[1] == dims[1] - 1)
        system = constraints.build(dims, cfg["steps"], boundary)
        rows, cols = self.entries(system)
        solver = DenseIR(rows, cols, system.n_rows, system.n_vars, device,
                         cfg["pde"]["ir_steps"], torch.float32 if lower else torch.float64)
        super().__init__(system, solver, device, lower)
        self.cfg, self.dims = cfg, dims
        self.u = torch.as_tensor(np.ascontiguousarray(data["u"]), device=self.device)
        self.bnd_points = torch.as_tensor(system.bnd_points, device=self.device)

    def _patches(self, field, idx):
        d0, d1 = self.dims
        t = torch.as_tensor(idx[:, 0], device=self.device)[:, None, None]
        x = torch.as_tensor(idx[:, 1], device=self.device)[:, None, None]
        return field[t + torch.arange(d0, device=self.device)[:, None],
                     x + torch.arange(d1, device=self.device)[None, :]]

    def parts(self, w, idx, capture):
        bs = idx.shape[0]
        # the control's networks in float32 (TF32 on while it runs)
        nw = {k: v.float() for k, v in w.items()} if self.lower else w
        n_convs = self.cfg["resnet"]["depth"] + 2
        full = resnet(nw, "resnet", n_convs, self.u[None, None].to(nw["resnet.convs.0.weight"]))
        full = full[0, 0].double()
        up = self._patches(full, idx).reshape(bs, -1)
        target = self._patches(self.u, idx).reshape(bs, -1)
        depth = self.cfg["paramnets"]["depth"]
        bp = torch.stack([paramnet(nw, f"pnets.{i}", depth).double()
                          for i in range(self.cfg["paramnets"]["count"])])
        basis = (torch.ones_like(up), up, up**2, up**3, up**4)
        p, q, r = (sum(c * t for c, t in zip(bp[j], basis)) for j in range(3))
        zero, one = torch.zeros_like(up), torch.ones_like(up)
        # unknowns' order: u, u_t, u_x, u_tt, u_xx
        coeffs = torch.stack([zero, one, p, zero, q], dim=-1)
        iv = up[:, self.bnd_points]

        def loss_x(x, sl, detach):
            u0 = self.solution_values(x)
            upd = up[sl].detach() if detach else up[sl]
            return ((u0 - target[sl]).abs().mean(-1).sum() + (upd - u0).abs().mean(-1).sum()) / bs

        loss_rest = self.cfg["param_l1"] * bp.abs().mean()
        return {"coeffs": coeffs, "rhs": r, "iv": iv, "loss_x": loss_x, "loss_rest": loss_rest}
