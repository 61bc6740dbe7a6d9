"""Viscous Burgers equation discovery (dense path).

Learn the coefficients of

    u_t + p(u) u_x + q(u) u_xx = r(u)

over the basis {1, u, u^2, u^3, u^4} for each of p, q, r, from (32, 32)
patches of a viscous Burgers trajectory, through the differentiable dense
PDE layer.  True equation: u_t + u u_x - nu u_xx = 0.

Port of the JAX package's discovery/burgers.py: a 2D ResNet denoises the
full field once per step (`nn_transform`), patches are gathered at the
batch's (t, x) offsets, three depth-3 ParamNets emit 5 basis coefficients
each, boundary values come from the denoised patches, and the loss is
|u0 - data| * frame_mask + |up - u0| + l1 * |params|.  The training loop is
plain Adam; checkpoints and resume are not ported yet.

Run:  python -m mech_nn_discovery_pde_torch.discovery.burgers [--epochs N]
      [--steps-per-epoch N] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.data.datasets import BurgersDataset, PatchLoader
from mech_nn_discovery_pde_torch.discovery.common import fixed_steps, make_update
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer
from mech_nn_discovery_pde_torch.models import resnet
from mech_nn_discovery_pde_torch.models.paramnet import ParamNet
from mech_nn_discovery_pde_torch.models.paramnet import state_dict_from_flax as paramnet_state_dict


@dataclass
class BurgersConfig:
    solver_dim: tuple = (32, 32)
    batch_size: int = 10
    lr: float = 5e-6
    param_l1: float = 0.005
    nn_transform: bool = True
    noise_percent: float = 0.0
    frame_drop_prob: float = 0.0
    epochs: int = 5000
    steps_per_epoch: Optional[int] = None  # None = full pass
    seed: int = 10
    data_root: str = "data"
    pde: PDEConfig = field(
        default_factory=lambda: PDEConfig(precision="f32_ir", log_solves=True)
    )


BASIS_TEXT = [
    "{0:.4f} u_x + {1:.4f} u*u_x + {2:.4f} u^2*u_x + {3:.4f} u^3*u_x + {4:.4f} u^4*u_x",
    "{0:.4f} u_xx + {1:.4f} u*u_xx + {2:.4f} u^2*u_xx + {3:.4f} u^3*u_xx + {4:.4f} u^4*u_xx",
    "{0:.4f} + {1:.4f} u + {2:.4f} u^2 + {3:.4f} u^3 + {4:.4f} u^4",
]


def print_eq(params: np.ndarray) -> str:
    return (
        "u_t + " + BASIS_TEXT[0].format(*params[0]) + "\n"
        + BASIS_TEXT[1].format(*params[1]) + "\n"
        + " = " + BASIS_TEXT[2].format(*params[2])
    )


class BurgersDiscovery(nn.Module):
    # boundary boxes: t=0 row, x=0 column, x=end column
    IV_LIST = [
        lambda nx, ny: (0, 0, [0, 0], [0, ny - 2]),
        lambda nx, ny: (1, 0, [1, 0], [nx - 1, 0]),
        lambda nx, ny: (1, 0, [0, ny - 1], [nx - 1, ny - 1]),
    ]

    def __init__(self, cfg: BurgersConfig, ds: BurgersDataset, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        dims = cfg.solver_dim
        self.layer = PDEDenseLayer(
            bs=cfg.batch_size, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
            init_index_mi_list=self.IV_LIST, solver_dbl=True, config=cfg.pde, device=device,
        )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.resnet = resnet.ResNet(out_channels=1, in_channels=1, device=device,
                                    generator=generator)
        self.pnets = nn.ModuleList(
            ParamNet(n_out=5, depth=3, device=device, generator=generator) for _ in range(3))
        self.steps = [
            fixed_steps(ds.t_step, cfg.batch_size, dims[0], 0.005, 0.5, device=device),
            fixed_steps(ds.x_step, cfg.batch_size, dims[1], 0.005, 0.5, device=device),
        ]
        # the data, not parameters: plain attributes, outside the state_dict
        self.data_all = torch.as_tensor(ds.data, device=self.device)
        self.frame_mask = torch.as_tensor(ds.frame_mask, device=self.device)

    def get_params(self) -> torch.Tensor:
        """(3, 5) basis coefficients."""
        return torch.cat([p() for p in self.pnets], dim=0)

    def _gather_patches(self, field, t_idx, x_idx):
        d0, d1 = self.cfg.solver_dim
        ti = t_idx[:, None, None] + torch.arange(d0, device=field.device)[None, :, None]
        xi = x_idx[:, None, None] + torch.arange(d1, device=field.device)[None, None, :]
        return field[ti, xi]

    def get_iv_bc(self, up):
        """Boundary values from the (denoised) patch: t=0 row (first ny-1
        columns), x=0 column (rows 1..), x=end column (all rows)."""
        d0, d1 = self.cfg.solver_dim
        return torch.cat([up[:, 0, : d1 - 1], up[:, 1:d0, 0], up[:, 0:d0, d1 - 1]], dim=-1)

    def forward(self, t_idx, x_idx):
        bs = self.cfg.batch_size
        if self.cfg.nn_transform:
            # the network runs in f32; the solver boundary casts to the solve dtype
            full = self.resnet(self.data_all.float()[None, :, :, None])[0, :, :, 0]
            full = full.to(self.data_all.dtype)
        else:
            full = self.data_all
        up = self._gather_patches(full, t_idx, x_idx)  # (bs, nt, nx)

        iv_rhs = self.get_iv_bc(up)
        upf = up.reshape(bs, -1)
        basis = torch.stack([torch.ones_like(upf), upf, upf**2, upf**3, upf**4], dim=-1)
        bp = self.get_params()
        p = (basis * bp[0]).sum(-1)
        q = (basis * bp[1]).sum(-1)
        r = (basis * bp[2]).sum(-1)
        cols = [torch.zeros_like(p)] * self.layer.n_orders
        cols[1], cols[2], cols[4] = torch.ones_like(p), p, q  # u_t, u_x, u_xx
        coeffs = torch.stack(cols, dim=-1)
        u0, _, _ = self.layer(coeffs, r, iv_rhs, list(self.steps))
        return u0.reshape(bs, -1), upf, bp

    def loss_fn(self, u_patches, t_idx, x_idx):
        bs = self.cfg.batch_size
        t_idx = torch.as_tensor(t_idx, device=self.device)
        x_idx = torch.as_tensor(x_idx, device=self.device)
        u0, up, bp = self(t_idx, x_idx)
        target = torch.as_tensor(u_patches, device=self.device).reshape(bs, -1)
        dmask = self.frame_mask[t_idx][:, None]  # whole-patch mask by first frame
        x_loss = (u0 * dmask - target * dmask).abs().mean(dim=-1)
        var_loss = (up - u0).abs().mean(dim=-1)
        param_loss = bp.abs().mean()
        loss = x_loss.mean() + var_loss.mean() + self.cfg.param_l1 * param_loss
        return loss, {"x_loss": x_loss.mean().detach(), "var_loss": var_loss.mean().detach()}


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's `BurgersDiscovery.init` parameters (flax pytree,
    numpy arrays) as this module's state_dict."""
    sd = {f"resnet.{k}": v for k, v in resnet.state_dict_from_flax(params["resnet"]).items()}
    for i, p in enumerate(params["pnets"]):
        sd.update({f"pnets.{i}.{k}": v for k, v in paramnet_state_dict(p).items()})
    return sd


def train(cfg: Optional[BurgersConfig] = None, log=None, device="cuda"):
    """Adam training loop; logs the loss and the learned equation per epoch."""
    cfg = cfg or BurgersConfig()
    log = log or logging.getLogger("burgers")
    log.info(f"Burgers viscous discovery, solver dim {cfg.solver_dim}")
    ds = BurgersDataset(solver_dim=cfg.solver_dim, data_root=cfg.data_root,
                        noise_percent=cfg.noise_percent, frame_drop_prob=cfg.frame_drop_prob)
    model = BurgersDiscovery(cfg, ds, device=device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    update = make_update(model.loss_fn, optimizer)
    loader = PatchLoader(ds, cfg.batch_size, seed=cfg.seed)
    for epoch in range(cfg.epochs):
        losses = []
        t0 = time.perf_counter()
        for i, (patch, t_idx, x_idx) in enumerate(loader):
            if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
                break
            loss, _ = update(patch, t_idx, x_idx)
            losses.append(float(loss))
        log.info("Learned\n" + print_eq(model.get_params().detach().cpu().numpy()))
        log.info(f"epoch {epoch}, loss {np.mean(losses):.3E}, "
                 f"{time.perf_counter() - t0:.1f} s")
    return model


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="Burgers discovery (dense path)")
    ap.add_argument("--epochs", type=int, default=BurgersConfig.epochs)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    train(BurgersConfig(epochs=a.epochs, steps_per_epoch=a.steps_per_epoch), device=a.device)
