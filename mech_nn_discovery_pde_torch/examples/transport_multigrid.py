"""Transport on a large (8, 512) grid through the multigrid-FGMRES layer.

Counterpart of the repository's examples/transport_multigrid.py: an n_grid 6
hierarchy (512 -> 16 in space), `downsample_first=False`, 20 forward and
backward FGMRES restarts and otherwise the default PDEConfig (a float64
outer FGMRES of 40 iterations per restart, Chebyshev 10 + 10 smoothing on
time-line blocks of bw 40), marching autoregressively over 4 windows of
u_t + u_x = 0 with u(0, x) = sin(k x), k = i + 1 for sample i.  Prints the
interior advection error of sample 0 after the last window against
sin(x - t).  On CUDA the outer FGMRES applies the normal operator with K1's
float64 instantiation and the V-cycle smooths with K1 (float32) and K2.

Run:  python -m mech_nn_discovery_pde_torch.examples.transport_multigrid [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.layers.multigrid import MultigridLayer

T_STEP = 0.005


def build(device="cuda", bs: int = 5, coord_dims=(8, 512), n_grid: int = 6):
    """The example's layer and its first window's inputs: (layer, coeffs,
    rhs, iv_rhs, steps, x) with x the spatial grid."""
    iv_list = [lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])]
    cfg = PDEConfig(mg_fgmres_restarts_forward=20, mg_fgmres_restarts_backward=20)
    pde = MultigridLayer(bs=bs, coord_dims=coord_dims, order=2, n_ind_dim=1, n_iv=1,
                         init_index_mi_list=iv_list, solver_dbl=True, n_grid=n_grid,
                         downsample_first=False, config=cfg, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    x_step = 2 * np.pi / coord_dims[1]
    steps = [torch.full((bs, coord_dims[0] - 1), T_STEP, **f64),
             torch.full((bs, coord_dims[1] - 1), float(np.clip(x_step, 1e-3, 0.1)), **f64)]
    coeffs = torch.zeros((bs, pde.grid_size, pde.n_orders), **f64)
    coeffs[..., 1] = 1.0
    coeffs[..., 2] = 1.0
    rhs = torch.zeros((bs, pde.grid_size), **f64)
    x = torch.linspace(0, 2 * np.pi, coord_dims[1], **f64)
    iv_rhs = torch.stack([torch.sin((i + 1) * x) for i in range(bs)])
    return pde, coeffs, rhs, iv_rhs, steps, x


def main(device="cuda", windows: int = 4, bs: int = 5, coord_dims=(8, 512), n_grid: int = 6):
    """Returns (u (bs, windows * nt, nx) numpy, interior advection error)."""
    pde, coeffs, rhs, iv_rhs, steps, x = build(device, bs, coord_dims, n_grid)
    u_list = []
    with torch.no_grad():
        for _ in range(windows):
            u0 = pde(coeffs, rhs, iv_rhs, steps)[0].reshape(bs, *coord_dims)
            iv_rhs = u0[:, -1]
            u_list.append(u0.cpu().numpy())
    u = np.concatenate(u_list, axis=1)
    total_t = u.shape[1] * T_STEP
    expect = np.sin(x.cpu().numpy() - total_t)
    err = float(np.abs(u[0, -1] - expect)[8:-8].max())
    print("marched solution shape:", u.shape)
    print(f"interior advection error: {err:.3e}")
    return u, err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="multigrid transport example")
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
