"""Ginzburg-Landau reaction-diffusion discovery (sparse multigrid path).

Learn one equation of the coupled complex GL system (u = Re A, v = Im A) as

    u_t + p0(u, v) u + p1(u) u_xx + p2(u) u_yy = p3(v)

over bases {1, u, u^2, v, v^2, uv} for p0, {1, u, u^2} for p1/p2 and
{v, v^2, v^3} for p3, from (8, 32, 32) t-x-y patches through the
MultigridLayer (n_grid 3, downsample_first=False).  Five boundary faces
provide Dirichlet data.

Port of the JAX package's discovery/ginzburg_landau.py with
`nn_transform=False` (its default); the ResNet transform, checkpoints and
resume are not ported yet.

Run:  python -m mech_nn_discovery_pde_torch.discovery.ginzburg_landau
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.data.datasets import PatchLoader, ReactDiffDataset
from mech_nn_discovery_pde_torch.discovery.common import fixed_steps, make_update
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer
from mech_nn_discovery_pde_torch.models.paramnet import ParamNet
from mech_nn_discovery_pde_torch.models.paramnet import state_dict_from_flax as paramnet_state_dict


@dataclass
class GLConfig:
    solver_dim: tuple = (8, 32, 32)
    n_grid: int = 3
    batch_size: int = 32
    lr: float = 1e-5
    epochs: int = 500
    steps_per_epoch: Optional[int] = None
    threshold: float = 0.1
    first_equation: bool = True
    nn_transform: bool = False
    downsample: int = 2
    noise_percent: float = 0.0
    seed: int = 10
    data_root: str = "data"
    # f32 outer FGMRES, per-solve forward diagnostics returned in-band
    pde: PDEConfig = field(
        default_factory=lambda: PDEConfig(
            precision="f32_ir", mg_solve_dtype="f32", log_solves=True,
            return_solve_stats=True,
        )
    )


BASIS_TEXT = [
    "{0:.4f} u + {1:.4f} u^2 + {2:.4f} u^3 + {3:.4f} u*v + {4:.4f} u*v^2 + {5:.4f} u^2*v",
    "{0:.4f} u_xx + {1:.4f} u*u_xx + {2:.4f} u^2*u_xx",
    "{0:.4f} u_yy + {1:.4f} u*u_yy + {2:.4f} u^2*u_yy",
    "{0:.4f} v + {1:.4f} v^2 + {2:.4f} v^3",
]


def print_eq(params) -> str:
    return (
        "u_t + " + BASIS_TEXT[0].format(*params[0][:6]) + "\n"
        + BASIS_TEXT[1].format(*params[1][:3]) + "\n"
        + BASIS_TEXT[2].format(*params[2][:3]) + "\n"
        + " = " + BASIS_TEXT[3].format(*params[3][:3])
    )


class GLDiscovery(nn.Module):
    # five Dirichlet boundary faces
    IV_LIST = [
        lambda nt, nx, ny: (0, 0, [0, 0, 0], [0, nx - 1, ny - 1]),
        lambda nt, nx, ny: (1, 0, [1, 0, 0], [nt - 1, 0, ny - 1]),
        lambda nt, nx, ny: (2, 0, [1, 1, 0], [nt - 1, nx - 1, 0]),
        lambda nt, nx, ny: (1, 0, [1, nx - 1, 1], [nt - 1, nx - 1, ny - 1]),
        lambda nt, nx, ny: (2, 0, [1, 1, ny - 1], [nt - 1, nx - 2, ny - 1]),
    ]

    def __init__(self, cfg: GLConfig, ds: ReactDiffDataset, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.nn_transform:
            raise NotImplementedError("nn_transform=True (ResNet transform) is not ported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        dims = cfg.solver_dim
        self.layer = MultigridLayer(
            bs=cfg.batch_size, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
            init_index_mi_list=self.IV_LIST, solver_dbl=True,
            n_grid=cfg.n_grid, downsample_first=False, config=cfg.pde, device=device,
        )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.pnets = nn.ModuleList(
            ParamNet(n_out=10, depth=2, device=device, generator=generator) for _ in range(4)
        )
        self.steps = [
            fixed_steps(ds.t_step_size, cfg.batch_size, dims[0], device=device),
            fixed_steps(ds.x_step_size, cfg.batch_size, dims[1], device=device),
            fixed_steps(ds.y_step_size, cfg.batch_size, dims[2], device=device),
        ]

    def get_params(self):
        return [p()[0] for p in self.pnets]

    def get_iv(self, u):
        """Dirichlet data for the five faces, in box C-order."""
        bs = u.shape[0]
        d0, d1, d2 = self.cfg.solver_dim
        return torch.cat([
            u[:, 0, :, :].reshape(bs, -1),
            u[:, 1:d0, 0, :].reshape(bs, -1),
            u[:, 1:d0, 1:d1, 0].reshape(bs, -1),
            u[:, 1:d0, d1 - 1, 1:d2].reshape(bs, -1),
            u[:, 1:d0, 1 : d1 - 1, d2 - 1].reshape(bs, -1),
        ], dim=-1)

    def _assemble(self, u, v):
        """(coeffs, rhs, iv_rhs, pl) for one batch."""
        iv_rhs = self.get_iv(u)
        bs = self.cfg.batch_size
        up0 = u.reshape(bs, -1)
        vp0 = v.reshape(bs, -1)
        pl = self.get_params()
        one = torch.ones_like(up0)
        basis0 = torch.stack([one, up0, up0**2, vp0, vp0**2, up0 * vp0], dim=-1)
        basis2 = torch.stack([one, up0, up0**2], dim=-1)
        basis3 = torch.stack([vp0, vp0**2, vp0**3], dim=-1)
        p0 = (basis0 * pl[0][:6]).sum(-1)
        p1 = (basis2 * pl[1][:3]).sum(-1)
        p2 = (basis2 * pl[2][:3]).sum(-1)
        p3 = (basis3 * pl[3][:3]).sum(-1)
        zero = torch.zeros_like(p0)
        # 3D mi order: [u, u_t, u_x, u_y, u_tt, u_xx, u_yy]
        coeffs = torch.stack([p0, torch.ones_like(p0), zero, zero, zero, p1, p2], dim=-1)
        return coeffs, p3, iv_rhs, pl

    def forward(self, u, v):
        bs = self.cfg.batch_size
        coeffs, rhs, iv_rhs, pl = self._assemble(u, v)
        u0, _, stats = self.layer(coeffs, rhs, iv_rhs, list(self.steps))
        return u0.reshape(bs, -1), pl, stats

    def loss_fn(self, u, v):
        """|u0 - u| + |u' - u| + |v' - v| + 1e-4 L1(params); u' = u and
        v' = v without the learned transform."""
        bs = self.cfg.batch_size
        u = torch.as_tensor(u, device=self.device)
        v = torch.as_tensor(v, device=self.device)
        u0, pl, stats = self(u, v)
        target_u = u.reshape(bs, -1)
        target_v = v.reshape(bs, -1)
        u_loss = (u0 - target_u).abs().mean(dim=-1)
        var_u_loss = (target_u - target_u).abs().mean(dim=-1)
        var_v_loss = (target_v - target_v).abs().mean(dim=-1)
        param_loss = sum(p.abs().sum() for p in pl)
        loss = u_loss.mean() + var_u_loss.mean() + var_v_loss.mean() + 1e-4 * param_loss
        aux = {"u_loss": u_loss.mean().detach(), "var_u_loss": var_u_loss.mean().detach()}
        if stats is not None:
            aux["fwd_iters"] = stats["iters"].double().mean()
            aux["fwd_rel_rnorm"] = stats["rel_rnorm"].max()
        return loss, aux


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's `GLDiscovery.init` parameters (flax pytree, numpy
    arrays) as this module's state_dict.  The ResNet entries (unused with
    nn_transform=False) are dropped."""
    sd = {}
    for i, p in enumerate(params["pnets"]):
        sd.update({f"pnets.{i}.{k}": v for k, v in paramnet_state_dict(p).items()})
    return sd


def train(cfg: Optional[GLConfig] = None, log=None, device="cuda"):
    """Adam training loop; logs the loss and forward-solve stats per epoch."""
    cfg = cfg or GLConfig()
    log = log or logging.getLogger("gl")
    log.info(f"Ginzburg-Landau discovery, solver dim {cfg.solver_dim}")
    ds = ReactDiffDataset(
        solver_dim=cfg.solver_dim, data_root=cfg.data_root,
        downsample=cfg.downsample, first_equation=cfg.first_equation,
        noise_percent=cfg.noise_percent,
    )
    model = GLDiscovery(cfg, ds, device=device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    update = make_update(model.loss_fn, optimizer)
    loader = PatchLoader(ds, cfg.batch_size, seed=cfg.seed)
    for epoch in range(cfg.epochs):
        losses, aux = [], {}
        t0 = time.perf_counter()
        for i, (u, v, _, _, _) in enumerate(loader):
            if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
                break
            loss, aux = update(u, v)
            losses.append(float(loss))
        pl = [p.detach().cpu().numpy() for p in model.get_params()]
        log.info(print_eq(pl))
        msg = (f"epoch {epoch}, loss {np.mean(losses):.3E}, "
               f"{time.perf_counter() - t0:.1f} s")
        if "fwd_iters" in aux:
            msg += (f"  fwd solve iters {float(aux['fwd_iters']):.1f}"
                    f" rel_rnorm {float(aux['fwd_rel_rnorm']):.2e}")
        log.info(msg)
    return model


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    train()
