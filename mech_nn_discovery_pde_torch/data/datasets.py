"""Patch-slicing dataset + a simple batch loader (numpy).

Copy of the JAX package's data/datasets.py: `BurgersDataset`,
`KamaniDataset`, `ReactDiffDataset`, `SineDataset` and `PatchLoader`, with the data-fault
knobs (percent Gaussian noise, frame dropping with a loss
mask) seeded as there, so both packages make the same arrays.
"""

from __future__ import annotations

import numpy as np

from mech_nn_discovery_pde_torch.data import generate
from mech_nn_discovery_pde_torch.utils.profiling import span


def add_percent_noise(data: np.ndarray, percent: float, rng) -> np.ndarray:
    """Gaussian noise at `percent`% of the data RMS (reference :96-100)."""
    rmse = np.sqrt(np.mean(data**2))
    return data + rng.normal(0, rmse * percent / 100.0, data.shape)


class BurgersDataset:
    """Slices the (nt, nx) Burgers field into (solver_dim) patches: time is
    tiled in strides of solver_dim[0]; space slides by 1.  Items: (patch,
    t_idx, x_idx)."""

    def __init__(
        self,
        solver_dim=(32, 32),
        data_root: str = "data",
        noise_percent: float = 0.0,
        frame_drop_prob: float = 0.0,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        data = generate.ensure_dataset("burgers", data_root)["u"]
        self.t_step = 0.025
        self.x_step = 20.0 / data.shape[1]
        if noise_percent:
            data = add_percent_noise(data, noise_percent, rng)
        # frame dropping: zero whole time frames, expose the mask for losses
        self.frame_mask = (rng.random(data.shape[0]) > frame_drop_prob).astype(data.dtype)
        data = data * self.frame_mask[:, None]
        self.data = data
        self.solver_dim = solver_dim
        self.num_t_idx = data.shape[0] // solver_dim[0]
        self.num_x_idx = data.shape[1] - solver_dim[1] + 1

    def __len__(self):
        return self.num_t_idx * self.num_x_idx

    def __getitem__(self, idx):
        t_i, x_i = np.unravel_index(idx, (self.num_t_idx, self.num_x_idx))
        t0 = t_i * self.solver_dim[0]
        patch = self.data[t0 : t0 + self.solver_dim[0], x_i : x_i + self.solver_dim[1]]
        return patch, t0, x_i


class KamaniDataset:
    """Kamani stress trajectories under oscillatory shear: slices the
    (nt, n_amp) array into time windows per amplitude; items carry the shear
    and its derivatives: (t, u, shear, shear_d, shear_dd)."""

    def __init__(self, solver_dim=(24,), data_root: str = "data",
                 noise_percent: float = 0.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        d = generate.ensure_dataset("kamani", data_root)
        u, t = d["u"], d["t"]
        if noise_percent:
            u = add_percent_noise(u, noise_percent, rng)
        self.u = u
        self.t = t
        self.t_step = float(t[1] - t[0])
        self.amps = np.logspace(-3, 1, u.shape[1])
        self.solver_dim = solver_dim
        self.num_t_idx = u.shape[0] // solver_dim[0]
        self.num_amp_idx = u.shape[1]

    def __len__(self):
        return self.num_t_idx * self.num_amp_idx

    def __getitem__(self, idx):
        amp_i, t_i = np.unravel_index(idx, (self.num_amp_idx, self.num_t_idx))
        t0 = t_i * self.solver_dim[0]
        sl = slice(t0, t0 + self.solver_dim[0])
        t = self.t[sl]
        amp = self.amps[amp_i]
        shear = amp * np.sin(t)
        shear_d = amp * np.cos(t)
        shear_dd = -amp * np.sin(t)
        return t, self.u[sl, amp_i], shear, shear_d, shear_dd


class ReactDiffDataset:
    """Ginzburg-Landau (u, v) fields sliced into (nt, nx, ny) patches tiled in
    all three axes (reference ginzburg_landau.py:75-185).  Items:
    (u_patch, v_patch, t, x, y)."""

    def __init__(
        self,
        solver_dim=(8, 32, 32),
        data_root: str = "data",
        downsample: int = 2,
        first_equation: bool = True,
        noise_percent: float = 0.0,
        seed: int = 0,
    ):
        rng = np.random.default_rng(seed)
        d = generate.ensure_dataset("ginzburg", data_root)
        u, v = d["u"][::downsample], d["v"][::downsample]
        if not first_equation:
            u, v = v, u
        if noise_percent:
            u = add_percent_noise(u, noise_percent, rng)
            v = add_percent_noise(v, noise_percent, rng)
        self.t_step_size = 0.1 * downsample
        self.x_step_size = self.y_step_size = 0.3906
        self.u, self.v = u, v
        self.solver_dim = solver_dim
        self.counts = tuple(s // p for s, p in zip(u.shape, solver_dim))

    def __len__(self):
        return int(np.prod(self.counts))

    def __getitem__(self, idx):
        ti, xi, yi = np.unravel_index(idx, self.counts)
        sl = tuple(
            slice(i * p, (i + 1) * p) for i, p in zip((ti, xi, yi), self.solver_dim)
        )
        return (
            self.u[sl],
            self.v[sl],
            np.broadcast_to(
                np.linspace(0, 1, self.u.shape[0])[sl[0], None, None],
                tuple(self.solver_dim),
            ),
            np.broadcast_to(
                np.linspace(0, 1, self.u.shape[1])[None, sl[1], None],
                tuple(self.solver_dim),
            ),
            np.broadcast_to(
                np.linspace(0, 1, self.u.shape[2])[None, None, sl[2]],
                tuple(self.solver_dim),
            ),
        )


class SineDataset:
    """Single damped-sine surface (reference fit/sine_pde_dense.py:18-35)."""

    def __init__(self, coord_dims=(32, 32), end: float = 1.0):
        self.y = generate.damped_sine(coord_dims, end)

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        return self.y


class PatchLoader:
    """Shuffling batch iterator over an indexable dataset; stacks item tuples
    into batched numpy arrays (drop_last semantics like the reference
    DataLoaders).  Fetching and stacking a batch is the span `batch`
    (utils/profiling)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def __iter__(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            with span("batch"):
                items = [self.ds[int(i)] for i in idx[b * self.bs : (b + 1) * self.bs]]
                if isinstance(items[0], tuple):
                    batch = tuple(np.stack([np.asarray(it[j]) for it in items])
                                  for j in range(len(items[0])))
                else:
                    batch = np.stack([np.asarray(it) for it in items])
            yield batch
