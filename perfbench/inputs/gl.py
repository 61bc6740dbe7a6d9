"""Inputs of the `gl` configuration, made from the run's seed: the complex
Ginzburg-Landau field A_t = A + (1 + i a) lap A - (1 + i b)|A|^2 A on a
periodic square (spectral RK4, the port's data generator's equation and
parameters, its initial transient discarded), made on the device and written
where the port's ReactDiffDataset reads it (<root>/ginzburg/Ar.npy, Ai.npy);
and the ParamNets' weights, made on the device in one draw."""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

from perfbench.lib.seeds import draw_weights, generator, loader_plan


def _field(f: Dict, seed: int, device, graph: bool = True) -> torch.Tensor:
    nt, nx, ny = f["nt"], f["nx"], f["ny"]
    L = f["domain"]
    g = generator(seed, "field", device)
    kx = 2 * math.pi * torch.fft.fftfreq(nx, d=L / nx, device=device, dtype=torch.float64)
    ky = 2 * math.pi * torch.fft.fftfreq(ny, d=L / ny, device=device, dtype=torch.float64)
    neg_k2 = -(kx[:, None] ** 2 + ky[None, :] ** 2)
    A = 0.1 * torch.complex(torch.randn((nx, ny), generator=g, device=device, dtype=torch.float64),
                            torch.randn((nx, ny), generator=g, device=device, dtype=torch.float64))
    ca, cb = complex(1, f["a"]), complex(1, f["b"])
    dt = f["t_step"] / f["substeps"]

    def rhs(A):
        lap = torch.fft.ifft2(torch.fft.fft2(A) * neg_k2)
        return A + ca * lap - cb * (A.real**2 + A.imag**2) * A

    def step(A, n):
        for _ in range(n):
            k1 = rhs(A)
            k2 = rhs(A + 0.5 * dt * k1)
            k3 = rhs(A + 0.5 * dt * k2)
            k4 = rhs(A + dt * k3)
            A = A + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        return A

    n_sub, n_skip = f["substeps"], int(round(f["skip"] / dt))
    advance = lambda A, n: step(A, n)
    if graph and A.is_cuda and n_skip % n_sub == 0:
        advance = _graphed(step, A, n_sub)
    A = advance(A, n_skip)
    out = torch.empty((nt, nx, ny), dtype=torch.complex128, device=device)
    for it in range(nt):
        out[it] = A
        A = advance(A, n_sub)
    return out


def _graphed(step, A, n_sub):
    """`step` over n_sub substeps captured once in a CUDA graph and replayed:
    the same kernels on the same operands, without the host's launches."""
    static = A.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(static, n_sub)  # warm-up: cuFFT's plans are made outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        result = step(static, n_sub)

    def advance(A, n):
        static.copy_(A)
        for _ in range(n // n_sub):
            graph.replay()
            static.copy_(result)
        return static.clone()

    return advance


def make_data(cfg: Dict, seed: int, root: str, device) -> Dict[str, np.ndarray]:
    """Writes the field for the program; returns (u, v) at the dataset's
    time resolution (every `downsample`-th frame), for the reference."""
    A = _field(cfg["field"], seed, device)
    u, v = A.real.cpu().numpy(), A.imag.cpu().numpy()
    d = os.path.join(root, cfg["program"]["data_dir"])
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "Ar.npy"), u)
    np.save(os.path.join(d, "Ai.npy"), v)
    ds = cfg["downsample"]
    return {"u": u[::ds], "v": v[::ds]}


def weight_shapes(cfg: Dict) -> Dict[str, tuple]:
    p = cfg["paramnets"]
    shapes = {}
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
    """The patch origins (bs, 3) of the loader's first n batches: patches
    tiled in all three axes, numbered in C order."""
    d = cfg["solver_dim"]
    counts = ((cfg["field"]["nt"] // cfg["downsample"]) // d[0],
              cfg["field"]["nx"] // d[1], cfg["field"]["ny"] // d[2])
    return [np.stack(np.unravel_index(b, counts), axis=1) * np.asarray(d)
            for b in loader_plan(int(np.prod(counts)), cfg["batch_size"], loader_seed, n)]


def batch_args(batch):
    """The arguments of one training step: (u, v)."""
    return batch[0], batch[1]
