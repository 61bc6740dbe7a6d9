"""Separable align-corners linear interpolation as per-axis matrices.

Multigrid restriction/prolongation and coarse-grid data downsampling apply an
(new, old) interpolation matrix per grid axis, one tensordot per axis (the
same contraction the JAX package runs).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def interp_matrix(old: int, new: int, dtype=np.float64) -> np.ndarray:
    """(new, old) align-corners linear interpolation matrix.

    Output sample j sits at input position j * (old - 1) / (new - 1); for
    new == 1 the first input sample is taken."""
    W = np.zeros((new, old), dtype=dtype)
    if new == 1:
        W[0, 0] = 1.0
        return W
    pos = np.arange(new) * (old - 1) / (new - 1)
    i0 = np.clip(np.floor(pos).astype(int), 0, old - 2)
    frac = pos - i0
    np.add.at(W, (np.arange(new), i0), 1.0 - frac)
    np.add.at(W, (np.arange(new), i0 + 1), frac)
    return W


def apply_separable(x: torch.Tensor, mats: Sequence[np.ndarray], offset: int = 1):
    """Apply per-axis matrices to axes [offset, offset + len(mats)) of x.

    x: (..., d0, d1, ..., tail) with the grid axes starting at `offset`.
    Each mats[c] is (new_c, old_c), numpy or a tensor; it is brought to x's
    dtype/device (a no-op for tensors the caller already placed there)."""
    for c, W in enumerate(mats):
        axis = offset + c
        Wt = torch.as_tensor(W).to(device=x.device, dtype=x.dtype)
        x = torch.tensordot(x, Wt, dims=([axis], [1]))
        # tensordot moves the contracted axis to the end; bring it back
        x = torch.movedim(x, -1, axis)
    return x


def resize_grid(x: torch.Tensor, old_shape: Tuple[int, ...], new_shape: Tuple[int, ...]):
    """Align-corners resize of (bs, *old_shape) or (bs, C, *old_shape)."""
    offset = x.ndim - len(old_shape)
    mats = [interp_matrix(o, n) for o, n in zip(old_shape, new_shape)]
    return apply_separable(x, mats, offset=offset)
