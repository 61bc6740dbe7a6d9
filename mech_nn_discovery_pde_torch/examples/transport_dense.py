"""Transport equation solved with the dense PDE layer, marching in time.

Counterpart of the repository's examples/transport_dense.py: solve
u_t + u_x = 0 on (8, 64) windows with u(0, x) = sin(k x), k = (i + 1) / 2
for sample i, then march forward by seeding each window's initial values
from the previous window's last time slice.  Prints the advection error of
sample 0 after the last window against sin(x / 2 - t).

Run:  python -m mech_nn_discovery_pde_torch.examples.transport_dense [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer


def main(device="cuda", windows: int = 8, bs: int = 5):
    """Returns (u (bs, windows * 8, 64) numpy, advection error)."""
    coord_dims = (8, 64)
    iv_list = [lambda nt, nx: (0, 0, [0, 0], [0, nx - 1])]
    pde = PDEDenseLayer(bs=bs, coord_dims=coord_dims, order=2, n_ind_dim=1, n_iv=1,
                        init_index_mi_list=iv_list, solver_dbl=True, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    t_step = 0.005
    x_step = 2 * np.pi / coord_dims[1]
    steps = [torch.full((bs, coord_dims[0] - 1), float(np.clip(t_step, 1e-3, 0.1)), **f64),
             torch.full((bs, coord_dims[1] - 1), float(np.clip(x_step, 1e-3, 0.1)), **f64)]
    # u_t + u_x = 0
    coeffs = torch.zeros((bs, pde.grid_size, pde.n_orders), **f64)
    coeffs[..., 1] = 1.0
    coeffs[..., 2] = 1.0
    rhs = torch.zeros((bs, pde.grid_size), **f64)
    x = torch.linspace(0, 2 * np.pi, coord_dims[1], **f64)
    iv_rhs = torch.stack([torch.sin((i + 1) / 2 * x) for i in range(bs)])
    u_list = []
    with torch.no_grad():
        for _ in range(windows):
            u0 = pde(coeffs, rhs, iv_rhs, steps)[0].reshape(bs, *coord_dims)
            iv_rhs = u0[:, -1]  # seed the next window from the last time slice
            u_list.append(u0.cpu().numpy())
    u = np.concatenate(u_list, axis=1)
    total_t = u.shape[1] * t_step
    expect = np.sin(0.5 * (x.cpu().numpy() - total_t))
    err = float(np.abs(u[0, -1] - expect).max())
    print("marched solution shape:", u.shape)
    print(f"advection error after {u.shape[1]} marched steps (k=1/2): {err:.3e}")
    return u, err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="dense transport example")
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
