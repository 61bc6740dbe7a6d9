"""Inputs of the `burgers` configuration, made from the run's seed: a viscous
Burgers trajectory u_t + u u_x = nu u_xx (periodic, pseudo-spectral RK4 from
a smooth random start of four low modes: the port's data generator's
equation and parameters), written where the port's BurgersDataset reads it
(<root>/burgers/burgers_nu0.1_128x256.npy); and the ResNet's and ParamNets'
weights, made on the device in one draw."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from perfbench.lib.seeds import draw_weights, loader_plan, numpy_rng


def _field(f: Dict, seed: int) -> np.ndarray:
    nt, nx, L, nu = f["nt"], f["nx"], f["domain"], f["nu"]
    rng = numpy_rng(seed, "field")
    x = np.linspace(0, L, nx, endpoint=False)
    k = 2 * np.pi * np.fft.rfftfreq(nx, d=L / nx)
    u = np.zeros(nx)
    for m in range(1, 5):
        u += rng.normal(0, 1.0 / m) * np.sin(2 * np.pi * m * x / L + rng.uniform(0, 2 * np.pi))

    def rhs(u):
        uh = np.fft.rfft(u)
        return -u * np.fft.irfft(1j * k * uh, n=nx) + nu * np.fft.irfft(-(k**2) * uh, n=nx)

    dt = f["t_step"] / f["substeps"]
    out = np.empty((nt, nx))
    for it in range(nt):
        out[it] = u
        for _ in range(f["substeps"]):
            k1 = rhs(u)
            k2 = rhs(u + 0.5 * dt * k1)
            k3 = rhs(u + 0.5 * dt * k2)
            k4 = rhs(u + dt * k3)
            u = u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return out


def make_data(cfg: Dict, seed: int, root: str, device) -> Dict[str, np.ndarray]:
    u = _field(cfg["field"], seed)
    d = os.path.join(root, cfg["program"]["data_dir"])
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, cfg["program"]["data_file"]), u)
    return {"u": u}


def weight_shapes(cfg: Dict) -> Dict[str, tuple]:
    r, p = cfg["resnet"], cfg["paramnets"]
    k = r["kernel"]
    chans = [1] + [r["width"]] * (r["depth"] + 1) + [1]
    shapes = {}
    for i, (a, b) in enumerate(zip(chans[:-1], chans[1:])):
        shapes[f"resnet.convs.{i}.weight"] = (b, a, k, k)
        shapes[f"resnet.convs.{i}.bias"] = (b,)
    for i in range(p["count"]):
        shapes[f"pnets.{i}.input"] = (1, p["in_dim"])
        dims = [p["in_dim"]] + [p["width"]] * p["depth"] + [p["n_out"]]
        for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            shapes[f"pnets.{i}.layers.{j}.weight"] = (b, a)
            shapes[f"pnets.{i}.layers.{j}.bias"] = (b,)
    return shapes


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return draw_weights(weight_shapes(cfg), seed, device)


def batch_plan(cfg: Dict, loader_seed: int, n: int) -> List[np.ndarray]:
    """The patch origins (bs, 2) of the loader's first n batches: time tiled
    in strides of the patch, space sliding by one, numbered in C order."""
    d = cfg["solver_dim"]
    counts = (cfg["field"]["nt"] // d[0], cfg["field"]["nx"] - d[1] + 1)
    out = []
    for b in loader_plan(counts[0] * counts[1], cfg["batch_size"], loader_seed, n):
        t, x = np.unravel_index(b, counts)
        out.append(np.stack([t * d[0], x], axis=1))
    return out


def batch_args(batch):
    """The arguments of one training step: (patches, t_idx, x_idx)."""
    return batch[0], batch[1], batch[2]
