"""Sine-surface PDE fit (inverse problem, dense path).

Fit a damped sine surface on a (32, 32) grid by learning constant PDE
coefficients and a source term directly (no discovery bases): MLP heads over
a learned latent produce the per-mi coefficients and the rhs grid; boundary
values are the data's four edges.  Port of the JAX package's fit/sine_fit.py:
an Adam loop that logs into a run directory (logs/sine_fit/<n>).

Run:  python -m mech_nn_discovery_pde_torch.fit.sine_fit [--epochs N] [--device cuda]
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.data.generate import damped_sine
from mech_nn_discovery_pde_torch.discovery.common import fixed_steps, make_update
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer
from mech_nn_discovery_pde_torch.models.paramnet import lecun_normal_
from mech_nn_discovery_pde_torch.utils import logger as logging_util
from mech_nn_discovery_pde_torch.utils import rundir


@dataclass
class SineFitConfig:
    coord_dims: tuple = (32, 32)
    lr: float = 1e-4
    epochs: int = 100
    time_varying_source: bool = True
    seed: int = 0
    pde: PDEConfig = field(default_factory=lambda: PDEConfig(precision="f32_ir"))


class SineHeads(nn.Module):
    """Learned latent (1, 1024) -> two ReLU layers of 1024 -> (coefficients
    (1, n_orders), constant over the grid; rhs (1, grid_size), or zeros)."""

    def __init__(self, grid_size: int, n_orders: int, time_varying_source: bool = True,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid_size = grid_size
        self.latent = nn.Parameter(torch.empty((1, 1024), device=device))
        self.trunk = nn.ModuleList(nn.Linear(1024, 1024, device=device) for _ in range(2))
        self.coeffs = nn.Linear(1024, n_orders, device=device)
        self.rhs = nn.Linear(1024, grid_size, device=device) if time_varying_source else None
        with torch.no_grad():
            self.latent.normal_(0.0, 1.0, generator=generator)
        for lin in (*self.trunk, self.coeffs, *([self.rhs] if self.rhs is not None else [])):
            lecun_normal_(lin, generator)

    def forward(self):
        h = self.latent
        for lin in self.trunk:
            h = torch.relu(lin(h))
        if self.rhs is None:
            return self.coeffs(h), h.new_zeros((1, self.grid_size))
        return self.coeffs(h), self.rhs(h)


def heads_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's `SineHeads` parameters (flax pytree, numpy arrays)
    as a SineHeads state_dict: flax Dense kernels are (in, out), nn.Linear
    weights (out, in)."""
    p = params.get("params", params)
    names = ["trunk.0", "trunk.1", "coeffs", "rhs"]
    sd = {"latent": np.asarray(p["latent"])}
    i = 0
    while f"Dense_{i}" in p:
        sd[f"{names[i]}.weight"] = np.asarray(p[f"Dense_{i}"]["kernel"]).T
        sd[f"{names[i]}.bias"] = np.asarray(p[f"Dense_{i}"]["bias"])
        i += 1
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


class SineFit(nn.Module):
    # boundary boxes: all four edges Dirichlet
    IV_LIST = [
        lambda nx, ny: (0, 0, [0, 0], [0, ny - 2]),
        lambda nx, ny: (1, 0, [1, 0], [nx - 1, 0]),
        lambda nx, ny: (0, 0, [nx - 1, 1], [nx - 1, ny - 2]),
        lambda nx, ny: (1, 0, [0, ny - 1], [nx - 1, ny - 1]),
    ]

    def __init__(self, cfg: SineFitConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.layer = PDEDenseLayer(
            bs=1, coord_dims=cfg.coord_dims, order=2, n_ind_dim=1, n_iv=1,
            init_index_mi_list=self.IV_LIST, solver_dbl=True, config=cfg.pde, device=device,
        )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.heads = SineHeads(self.layer.grid_size, self.layer.n_orders,
                               cfg.time_varying_source, device=device, generator=generator)
        self.steps = [fixed_steps(0.05, 1, d, 0.005, 0.1, device=device) for d in cfg.coord_dims]

    @staticmethod
    def boundary_from_data(y: torch.Tensor) -> torch.Tensor:
        """Edge values in IV_LIST order, (1, n_boundary)."""
        return torch.cat([y[0, 0:-1], y[1:, 0], y[-1, 1:-1], y[:, -1]])[None, :]

    def forward(self, y):
        coeffs_c, rhs = self.heads()
        coeffs = coeffs_c[:, None, :].expand(1, self.layer.grid_size, self.layer.n_orders)
        u0, u, _ = self.layer(coeffs, rhs, self.boundary_from_data(y), list(self.steps))
        return u0.reshape(self.cfg.coord_dims), coeffs_c, u

    def loss_fn(self, y):
        y = torch.as_tensor(y, device=self.device)
        u0, _, _ = self(y)
        return ((u0 - y) ** 2).mean(), {"u0": u0.detach()}


def train(cfg: Optional[SineFitConfig] = None, log=None, device="cuda"):
    """Adam on the mean squared error; returns (model, loss history)."""
    cfg = cfg or SineFitConfig()
    log_dir, _ = rundir.create_log_dir(root="logs/sine_fit", reuse=False)
    log = log or logging_util.setup(log_dir, name="sine_fit")
    log.info(f"Sine PDE fit, grid {cfg.coord_dims}")
    model = SineFit(cfg, device=device)
    y = torch.as_tensor(damped_sine(cfg.coord_dims), device=model.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    update = make_update(model.loss_fn, optimizer)
    history = []
    for epoch in range(cfg.epochs):
        loss, _ = update(y)
        history.append(float(loss))
        if epoch % 10 == 0 or epoch == cfg.epochs - 1:
            log.info(f"epoch {epoch} train_loss {history[-1]:.4E}")
    return model, history


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Sine-surface PDE fit (dense path)")
    ap.add_argument("--epochs", type=int, default=SineFitConfig.epochs)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    train(SineFitConfig(epochs=a.epochs), device=a.device)
