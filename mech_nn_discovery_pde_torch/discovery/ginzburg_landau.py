"""Ginzburg-Landau reaction-diffusion discovery (sparse multigrid path).

Learn one equation of the coupled complex GL system (u = Re A, v = Im A) as

    u_t + p0(u, v) u + p1(u) u_xx + p2(u) u_yy = p3(v)

over bases {1, u, u^2, v, v^2, uv} for p0, {1, u, u^2} for p1/p2 and
{v, v^2, v^3} for p3, from (8, 32, 32) t-x-y patches through the
MultigridLayer (n_grid 3; `downsample_first` False, the published setting,
halves x and y only from level to level, True halves t too, which a long
time window such as (50, 32, 32) needs: its coarsest level then holds
(12, 8, 8) points, not (50, 8, 8)).  Five boundary faces provide Dirichlet
data.  With `nn_transform`, two 2D ResNets (width 128, depth 12) denoise u
and v frame by frame, in float32, before the bases and the boundary data
are built.

Port of the JAX package's discovery/ginzburg_landau.py: the training loop
writes a run directory (logs/gl/<n>) with a log, source provenance and
checkpoints, resumes from one (`resume_from`), and can probe the backward
solve's convergence every few epochs (`backward_probe_every`).

Run:  python -m mech_nn_discovery_pde_torch.discovery.ginzburg_landau
      [--epochs N] [--steps-per-epoch N] [--resume-from RUN_DIR] [--device cuda]
      [--solver-dim T X Y] [--batch-size N] [--downsample-first]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.data.datasets import PatchLoader, ReactDiffDataset
from mech_nn_discovery_pde_torch.discovery.common import TrainHarness, fixed_steps, make_update
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer
from mech_nn_discovery_pde_torch.models import resnet
from mech_nn_discovery_pde_torch.models.paramnet import ParamNet
from mech_nn_discovery_pde_torch.models.paramnet import state_dict_from_flax as paramnet_state_dict
from mech_nn_discovery_pde_torch.utils import logger as logging_util
from mech_nn_discovery_pde_torch.utils import rundir


@dataclass
class GLConfig:
    solver_dim: tuple = (8, 32, 32)
    n_grid: int = 3
    # coarsen the time axis too (see the module docstring)
    downsample_first: bool = False
    batch_size: int = 32
    lr: float = 1e-5
    epochs: int = 500
    steps_per_epoch: Optional[int] = None
    resume_from: Optional[str] = None
    ckpt_every: int = 25
    threshold: float = 0.1
    first_equation: bool = True
    nn_transform: bool = False
    downsample: int = 2
    noise_percent: float = 0.0
    seed: int = 10
    data_root: str = "data"
    # run the backward-solve convergence probe every N epochs (0 = off)
    backward_probe_every: int = 0
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
        self.cfg = cfg
        self.device = torch.device(device)
        dims = cfg.solver_dim
        self.layer = MultigridLayer(
            bs=cfg.batch_size, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1,
            init_index_mi_list=self.IV_LIST, solver_dbl=True,
            n_grid=cfg.n_grid, downsample_first=cfg.downsample_first, config=cfg.pde,
            device=device,
        )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        if cfg.nn_transform:  # the JAX package builds them always, applies them only here
            self.rnet1 = resnet.ResNet(out_channels=1, in_channels=1, device=device,
                                       generator=generator)
            self.rnet2 = resnet.ResNet(out_channels=1, in_channels=1, device=device,
                                       generator=generator)
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

    def _transform(self, net, w):
        """The ResNet on each time frame of w (bs, nt, nx, ny), in float32,
        cast back to w's dtype."""
        bs, dims = self.cfg.batch_size, self.cfg.solver_dim
        x = w.reshape(bs * dims[0], dims[1], dims[2], 1).float()
        return net(x).reshape(bs, *dims).to(w.dtype)

    def _assemble(self, u, v):
        """(coeffs, rhs, iv_rhs, up, vp, pl) for one batch, shared by the
        training forward and the backward-convergence probe; up and vp are
        the (possibly identity) learned transforms of u and v."""
        if self.cfg.nn_transform:
            up, vp = self._transform(self.rnet1, u), self._transform(self.rnet2, v)
        else:
            up, vp = u, v
        iv_rhs = self.get_iv(up)
        bs = self.cfg.batch_size
        up0 = up.reshape(bs, -1)
        vp0 = vp.reshape(bs, -1)
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
        return coeffs, p3, iv_rhs, up0, vp0, pl

    def forward(self, u, v):
        """(u0, up, vp, pl, stats), u0/up/vp flattened to (bs, grid)."""
        bs = self.cfg.batch_size
        coeffs, rhs, iv_rhs, up, vp, pl = self._assemble(u, v)
        u0, _, stats = self.layer(coeffs, rhs, iv_rhs, list(self.steps))
        return u0.reshape(bs, -1), up, vp, pl, stats

    @torch.no_grad()
    def backward_probe(self, u, v):
        """Backward-solve convergence on a representative cotangent (the
        normalized data field scattered into the solution-value slots):
        `MultigridLayer.backward_stats` on this batch's system."""
        bs = self.cfg.batch_size
        u = torch.as_tensor(u, device=self.device)
        v = torch.as_tensor(v, device=self.device)
        coeffs, rhs, iv_rhs, _, _, _ = self._assemble(u, v)
        gu = u.reshape(bs, -1)
        gu = gu / torch.clamp(torch.linalg.vector_norm(gu, dim=1, keepdim=True), min=1e-30)
        g = torch.zeros((bs, self.layer.grid_size, self.layer.n_orders), dtype=gu.dtype,
                        device=gu.device)
        g[..., 0] = gu
        return self.layer.backward_stats(coeffs, rhs, iv_rhs, list(self.steps),
                                         g.reshape(bs, -1))

    def loss_fn(self, u, v):
        """|u0 - u| + |u' - u| + |v' - v| + 1e-4 L1(params), where u'/v' are
        the (possibly identity) learned transforms of the raw fields.  The
        JAX package applies rnet2 to v a second time here; its value is the
        vp of the forward (the same function of the same inputs)."""
        bs = self.cfg.batch_size
        u = torch.as_tensor(u, device=self.device)
        v = torch.as_tensor(v, device=self.device)
        u0, up, vp, pl, stats = self(u, v)
        target_u = u.reshape(bs, -1)
        target_v = v.reshape(bs, -1)
        u_loss = (u0 - target_u).abs().mean(dim=-1)
        var_u_loss = (up - target_u).abs().mean(dim=-1)
        var_v_loss = (vp - target_v).abs().mean(dim=-1)
        param_loss = sum(p.abs().sum() for p in pl)
        loss = u_loss.mean() + var_u_loss.mean() + var_v_loss.mean() + 1e-4 * param_loss
        aux = {"u_loss": u_loss.mean().detach(), "var_u_loss": var_u_loss.mean().detach()}
        if stats is not None:
            aux["fwd_iters"] = stats["iters"].double().mean()
            aux["fwd_rel_rnorm"] = stats["rel_rnorm"].max()
        return loss, aux


def state_dict_from_flax(params, nn_transform: bool = False) -> Dict[str, torch.Tensor]:
    """The JAX package's `GLDiscovery.init` parameters (flax pytree, numpy
    arrays) as the state_dict of a model built with `nn_transform`: the
    ResNet entries map to rnet1/rnet2 with it and are dropped without it
    (the port builds the ResNets only where it applies them)."""
    sd = {}
    if nn_transform:
        for name in ("rnet1", "rnet2"):
            sd.update({f"{name}.{k}": v
                       for k, v in resnet.state_dict_from_flax(params[name]).items()})
    for i, p in enumerate(params["pnets"]):
        sd.update({f"pnets.{i}.{k}": v for k, v in paramnet_state_dict(p).items()})
    return sd


def train(cfg: Optional[GLConfig] = None, log=None, device="cuda"):
    """Adam training loop in a run directory (logs/gl/<n>, or
    `cfg.resume_from`, whose latest checkpoint it resumes); logs the learned
    equation, the loss and forward-solve stats per epoch, the backward
    probe every `backward_probe_every` epochs, and checkpoints every
    `ckpt_every`.  Returns the model."""
    cfg = cfg or GLConfig()
    if cfg.resume_from:
        log_dir, run_id = cfg.resume_from, cfg.resume_from
    else:
        log_dir, run_id = rundir.create_log_dir(root="logs/gl", reuse=False)
    rundir.write_source_files(log_dir)
    log = log or logging_util.setup(log_dir, name="gl")
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
    harness = TrainHarness(log_dir, model, optimizer, log=log, ckpt_every=cfg.ckpt_every,
                           device=device)
    for epoch in range(harness.start_epoch, cfg.epochs):
        losses, aux = [], {}
        t0 = time.perf_counter()
        for i, (u, v, _, _, _) in enumerate(loader):
            if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
                break
            with harness.timer.phase("update"):
                loss, aux = update(u, v)
                losses.append(float(loss))
        pl = [p.detach().cpu().numpy() for p in model.get_params()]
        log.info(print_eq(pl))
        msg = (f"run {run_id} epoch {epoch}, loss {np.mean(losses):.3E}, "
               f"{time.perf_counter() - t0:.1f} s")
        if "fwd_iters" in aux:
            msg += (f"  fwd solve iters {float(aux['fwd_iters']):.1f}"
                    f" rel_rnorm {float(aux['fwd_rel_rnorm']):.2e}")
        log.info(msg)
        if cfg.backward_probe_every and (epoch + 1) % cfg.backward_probe_every == 0:
            with harness.timer.phase("backward_probe"):
                bs_ = model.backward_probe(u, v)
                log.info(f"bwd solve iters {float(bs_['iters'].double().mean()):.1f} "
                         f"rel_rnorm {float(bs_['rel_rnorm'].max()):.2e} "
                         f"finite {bool(bs_['finite'].all())}")
        harness.end_epoch(epoch)
    return model


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Ginzburg-Landau discovery (multigrid path)")
    ap.add_argument("--epochs", type=int, default=GLConfig.epochs)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--solver-dim", type=int, nargs=3, default=GLConfig.solver_dim)
    ap.add_argument("--batch-size", type=int, default=GLConfig.batch_size)
    ap.add_argument("--downsample-first", action="store_true",
                    help="coarsen the time axis too (a long time window)")
    a = ap.parse_args()
    train(GLConfig(epochs=a.epochs, steps_per_epoch=a.steps_per_epoch,
                   resume_from=a.resume_from, solver_dim=tuple(a.solver_dim),
                   batch_size=a.batch_size, downsample_first=a.downsample_first),
          device=a.device)
