"""The dense path's forward step as a function and its arguments: the torch
counterpart of the JAX package's `__graft_entry__.entry()`.

    fn, args = entry()          # on "cuda"; entry(device="cpu") for the CPU
    u0 = fn(*args)              # (10, 1, 1024)

It is the Burgers discovery layer's solve: a (32, 32) grid, bs 10, the
"f32_ir" precision, coefficients of u_t + 0.5 u_x + 0.1 u_xx = 0, and
boundary values from np.random.default_rng(0), the same arrays as the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from mech_nn_discovery_pde_torch.config import PDEConfig
from mech_nn_discovery_pde_torch.layers.dense import PDEDenseLayer

# boundary boxes: t=0 row, x=0 column, x=end column
IV_LIST = [
    lambda nx, ny: (0, 0, [0, 0], [0, ny - 2]),
    lambda nx, ny: (1, 0, [1, 0], [nx - 1, 0]),
    lambda nx, ny: (1, 0, [0, ny - 1], [nx - 1, ny - 1]),
]


def entry(device="cuda"):
    """(fn, args): fn(coeffs, rhs, iv, steps0, steps1) -> u0.  `fn.layer` is
    the PDEDenseLayer, for its diagnostics (`solve_stats`)."""
    bs, dims = 10, (32, 32)
    layer = PDEDenseLayer(
        bs=bs, coord_dims=dims, order=2, n_ind_dim=1, n_iv=1, init_index_mi_list=IV_LIST,
        solver_dbl=True, config=PDEConfig(precision="f32_ir"), device=device,
    )
    rng = np.random.default_rng(0)
    coeffs = np.zeros((bs, layer.grid_size, layer.n_orders))
    coeffs[..., 1] = 1.0
    coeffs[..., 2] = 0.5
    coeffs[..., 4] = 0.1
    rhs = np.zeros((bs, layer.grid_size))
    iv = 0.1 * rng.standard_normal((bs, 31 + 31 + 32))
    steps0 = np.full((bs, 31), 0.025)
    steps1 = np.full((bs, 31), 0.078)

    def fn(coeffs, rhs, iv, steps0, steps1):
        u0, _, _ = layer(coeffs, rhs, iv, [steps0, steps1])
        return u0

    fn.layer = layer
    args = tuple(torch.as_tensor(a, device=device) for a in (coeffs, rhs, iv, steps0, steps1))
    return fn, args
