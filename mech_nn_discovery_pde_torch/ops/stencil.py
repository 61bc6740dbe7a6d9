"""Runtime constraint-value fills (differentiable PyTorch).

Derivative-constraint values are regenerated every forward pass from the
per-coordinate step vectors `steps_list[c]` of shape (bs, dim_c - 1), so
autograd reaches the step sizes.  5-point stencil weights for non-uniform
steps come from Fornberg's recursion; forward/backward Taylor values are
(+-h)^k / k! chains.

Value ordering matches ops/constraints.py exactly:
  derivative = [central | forward | backward], each looping
  coord -> grid point C-order -> derivative order -> stencil entries.

For the one-sided edge stencils the natural indexing steps[p:p+4] is used
(the same choice as the JAX package).
"""

from __future__ import annotations

from typing import Sequence

import torch

from mech_nn_discovery_pde_torch.ops.constraints import ConstraintSpec


def _stencil_distances(steps: torch.Tensor, d: int) -> torch.Tensor:
    """(bs, d, 5) signed distances from each grid position to its 5 stencil
    points, matching constraints.central_offset_table: one-sided ascending for
    positions {0, 1}, centered for [2, d-3], one-sided descending for
    {d-2, d-1}.  `steps` is (bs, d-1)."""
    zero = torch.zeros_like(steps[:, :1])

    left = []
    for p in range(2):
        c = torch.cumsum(steps[:, p : p + 4], dim=1)
        left.append(torch.cat([zero, c], dim=1))
    left = torch.stack(left, dim=1)  # (bs, 2, 5)

    # centered: [-h_{p-2}-h_{p-1}, -h_{p-1}, 0, h_p, h_p+h_{p+1}]
    hp2 = steps[:, 0 : d - 4]
    hp1 = steps[:, 1 : d - 3]
    hn1 = steps[:, 2 : d - 2]
    hn2 = steps[:, 3 : d - 1]
    center = torch.stack(
        [-hp1 - hp2, -hp1, torch.zeros_like(hn1), hn1, hn1 + hn2], dim=-1
    )  # (bs, d-4, 5)

    right = []
    for p in (d - 2, d - 1):
        seg = steps[:, p - 4 : p]  # h_{p-4} .. h_{p-1}
        c = torch.cumsum(torch.flip(seg, dims=[1]), dim=1)
        right.append(torch.cat([zero, -c], dim=1))
    right = torch.stack(right, dim=1)  # (bs, 2, 5)

    return torch.cat([left, center, right], dim=1)  # (bs, d, 5)


def fornberg_weights(x: torch.Tensor, n_deriv: int) -> torch.Tensor:
    """Finite-difference weights at evaluation point 0 for arbitrarily spaced
    stencil points, via Fornberg's recursion (Fornberg 1988).

    x: (..., p) distinct stencil point coordinates (relative to 0).
    Returns (..., p, n_deriv + 1) weights for derivative orders 0..n_deriv.
    Closed-form and differentiable; all loops are static."""
    p = x.shape[-1]
    zero = torch.zeros_like(x[..., 0])
    one = torch.ones_like(zero)
    C = [[zero] * (n_deriv + 1) for _ in range(p)]
    C[0][0] = one
    c1 = one
    c4 = x[..., 0]
    for i in range(1, p):
        mn = min(i, n_deriv)
        c2 = one
        c5 = c4
        c4 = x[..., i]
        for j in range(i):
            c3 = x[..., i] - x[..., j]
            c2 = c2 * c3
            if j == i - 1:
                for k in range(mn, 0, -1):
                    C[i][k] = c1 * (k * C[i - 1][k - 1] - c5 * C[i - 1][k]) / c2
                C[i][0] = -c1 * c5 * C[i - 1][0] / c2
            for k in range(mn, 0, -1):
                C[j][k] = (c4 * C[j][k] - k * C[j][k - 1]) / c3
            C[j][0] = c4 * C[j][0] / c3
        c1 = c2
    return torch.stack(
        [torch.stack([C[j][k] for k in range(n_deriv + 1)], dim=-1) for j in range(p)],
        dim=-2,
    )


def stencil_weights(steps: torch.Tensor, d: int, order: int) -> torch.Tensor:
    """4th-order 5-point derivative weights at every grid position.

    Returns (bs, d, n_cmi, 6): for derivative order k (1-based), entries
    [w_0..w_4 scaled by h^k, -h^k] where h is the local reference step."""
    x = _stencil_distances(steps, d)  # (bs, d, 5)
    w = fornberg_weights(x, order)[..., 1:]  # (bs, d, 5, order)
    # local scale h: steps[p] for p < d-1, steps[d-2] for the last position
    h = torch.cat([steps, steps[:, -1:]], dim=1)  # (bs, d)
    out = []
    for k in range(order):
        hk = h ** (k + 1)
        out.append(torch.cat([w[..., k] * hk[..., None], -hk[..., None]], dim=-1))
    return torch.stack(out, dim=2)  # (bs, d, n_cmi, 6)


def _broadcast_over_grid(vals: torch.Tensor, dims, coord: int) -> torch.Tensor:
    """vals (bs, dims[coord], ...tail) -> (bs, *dims, ...tail) flattened to
    (bs, prod(dims) * prod(tail)), replicating over the other grid axes in
    C-order."""
    bs = vals.shape[0]
    tail = tuple(vals.shape[2:])
    shape = [bs] + [1] * len(dims) + list(tail)
    shape[1 + coord] = vals.shape[1]
    target = (bs,) + tuple(dims) + tail
    return vals.reshape(shape).expand(target).reshape(bs, -1)


def central_values(spec: ConstraintSpec, steps_list: Sequence[torch.Tensor]):
    dims = spec.coord_dims
    parts = []
    for coord, steps in enumerate(steps_list):
        w = stencil_weights(steps, dims[coord], spec.order)
        parts.append(_broadcast_over_grid(w, dims, coord))
    return torch.cat(parts, dim=1)


def taylor_values(spec: ConstraintSpec, steps_list, forward: bool):
    dims = spec.coord_dims
    order = spec.order
    parts = []
    for coord, steps in enumerate(steps_list):
        h = steps if forward else -steps  # (bs, d-1)
        cols = [torch.ones_like(h), h]
        if order == 2:
            cols.append(h * h / 2.0)
        cols.append(-torch.ones_like(h))
        vals = torch.stack(cols, dim=-1)  # (bs, d-1, order+2)
        reduced = list(dims)
        reduced[coord] = dims[coord] - 1
        parts.append(_broadcast_over_grid(vals, tuple(reduced), coord))
    return torch.cat(parts, dim=1)


def derivative_values(spec: ConstraintSpec, steps_list) -> torch.Tensor:
    """(bs, n_deriv_entries) in [central | forward | backward] order."""
    cv = central_values(spec, steps_list)
    fv = taylor_values(spec, steps_list, forward=True)
    bv = taylor_values(spec, steps_list, forward=False)
    return torch.cat([cv, fv, bv], dim=1)


def _interior(nd: int):
    """Time axis loses its first slice; spatial axes lose both boundaries."""
    return (slice(None), slice(1, None)) + (slice(1, -1),) * (nd - 1)


def equation_values(spec: ConstraintSpec, coeffs: torch.Tensor) -> torch.Tensor:
    """Crop a full coefficient grid (bs, grid, n_mi) to interior rows and
    flatten to the equation-entry order (interior point C-order x mi)."""
    dims = spec.coord_dims
    bs = coeffs.shape[0]
    x = coeffs.reshape((bs,) + tuple(dims) + (spec.var_set.n_mi,))
    return x[_interior(len(dims)) + (slice(None),)].reshape(bs, -1)


def crop_rhs(spec: ConstraintSpec, rhs: torch.Tensor) -> torch.Tensor:
    """Crop a full rhs grid (bs, grid) to interior points (equation rows)."""
    dims = spec.coord_dims
    bs = rhs.shape[0]
    x = rhs.reshape((bs,) + tuple(dims))
    return x[_interior(len(dims))].reshape(bs, -1)
