"""Synthetic dataset generation for the Ginzburg-Landau workload.

Copy of the JAX package's data/generate.py (numpy only), limited to what the
GL slice needs: the complex Ginzburg-Landau generator and the cached loader
for `ensure_dataset("ginzburg")`.  Files live under data_root/ginzburg/ in
the same format (Ar.npy, Ai.npy), so either package reads the other's data.

- Ginzburg-Landau: complex GL  A_t = A + (1+ia) lap A - (1+ib)|A|^2 A on a
  periodic 2D grid, spectral RK4; real/imag parts saved as u/v
"""

from __future__ import annotations

import os

import numpy as np

# ---------------------------------------------------------------------------
# complex Ginzburg-Landau (2D periodic, spectral ETD)
# ---------------------------------------------------------------------------


def ginzburg_landau(
    nt: int = 256,
    nx: int = 128,
    ny: int = 128,
    t_step: float = 0.1,
    domain: float = 50.0,
    a: float = 0.0,
    b: float = -1.5,
    seed: int = 1,
    substeps: int = 10,
    skip: float = 20.0,
):
    """(nt, nx, ny) complex field A(t, x, y) of the 2D complex Ginzburg-Landau
    equation A_t = A + (1 + i a) lap A - (1 + i b)|A|^2 A, periodic, spectral
    RK4; an initial transient of `skip` time units is discarded."""
    rng = np.random.default_rng(seed)
    kx = 2 * np.pi * np.fft.fftfreq(nx, d=domain / nx)
    ky = 2 * np.pi * np.fft.fftfreq(ny, d=domain / ny)
    k2 = kx[:, None] ** 2 + ky[None, :] ** 2
    A = 0.1 * (rng.standard_normal((nx, ny)) + 1j * rng.standard_normal((nx, ny)))

    def rhs(A):
        Ah = np.fft.fft2(A)
        lap = np.fft.ifft2(-k2 * Ah)
        return A + (1 + 1j * a) * lap - (1 + 1j * b) * np.abs(A) ** 2 * A

    dt = t_step / substeps

    def step(A, nsub):
        for _ in range(nsub):
            k1 = rhs(A)
            k2_ = rhs(A + 0.5 * dt * k1)
            k3 = rhs(A + 0.5 * dt * k2_)
            k4 = rhs(A + dt * k3)
            A = A + dt / 6 * (k1 + 2 * k2_ + 2 * k3 + k4)
        return A

    A = step(A, int(round(skip / dt)))
    out = np.empty((nt, nx, ny), dtype=np.complex128)
    for it in range(nt):
        out[it] = A
        A = step(A, substeps)
    return out


# ---------------------------------------------------------------------------
# cached generation
# ---------------------------------------------------------------------------


def ensure_dataset(name: str, data_root: str = "data", **gen_kwargs) -> dict:
    """Generate (or load cached) arrays for one workload; returns a dict of
    numpy arrays.  Files live under data_root/<name>/.  `gen_kwargs` go to
    the generator when the files do not exist yet."""
    d = os.path.join(data_root, name)
    os.makedirs(d, exist_ok=True)

    def cached(fname, fn):
        path = os.path.join(d, fname)
        if os.path.exists(path):
            return np.load(path)
        arr = fn()
        np.save(path, arr)
        return arr

    if name == "ginzburg":
        def gen_r():
            A = ginzburg_landau(**gen_kwargs)
            np.save(os.path.join(d, "Ai.npy"), A.imag.astype(np.float64))
            return A.real.astype(np.float64)
        Ar = cached("Ar.npy", gen_r)
        Ai = np.load(os.path.join(d, "Ai.npy"))
        return {"u": Ar, "v": Ai}
    raise ValueError(f"unknown dataset {name} (the port generates 'ginzburg' only)")
