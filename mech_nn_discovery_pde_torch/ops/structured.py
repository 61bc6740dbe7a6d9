"""Structured matvec: A x and A^T y as shifted-slice arithmetic (batched).

The constraint matrix is a fixed-stencil operator; every row family's action
is a weighted sum of statically shifted slices of the solution field
U = x.reshape(bs, *dims, n_mi):

  equation rows    sum_mi c[p, mi] U[p, mi]             (interior crop)
  initial rows     U[box, mi]                           (rectangular slices)
  central rows     sum_j w_j[p] U0[p + off_j e_c] - h^k U[p, mi_k]
                   with three static regions along coord c
  Taylor rows      u + h u_c (+ h^2/2 u_cc) - u(next/prev)

The JAX package derives A^T y with `jax.linear_transpose`; here the adjoint
`rmatvec_structured` is written out by hand, slice for slice (the adjoint of
reading a slice is adding into it), and tested against <Ax, y> = <x, A^T y>.

Values are consumed in structured layout, split from the flat value vector
by `split_values`.  Evolution systems (previous-time-step equation entries)
are not ported yet.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from mech_nn_discovery_pde_torch.ops.constraints import ConstraintSpec


class StructuredValues(NamedTuple):
    """Constraint values in grid layout, leading batch axis.

    eq:      (bs, d0-1, d1-2, ..., n_mi)   interior coefficients
    init:    (bs, n_init_entries)
    central: per coord, (bs, d0, ..., dn-1, n_cmi, 6)
    fwd/bwd: per coord, (bs, reduced dims, order + 2)
    """

    eq: torch.Tensor
    init: torch.Tensor
    central: List[torch.Tensor]
    fwd: List[torch.Tensor]
    bwd: List[torch.Tensor]


def split_values(spec: ConstraintSpec, values: torch.Tensor) -> StructuredValues:
    """Flat (bs, n_entries) value vector -> structured layout."""
    vs = spec.var_set
    dims = tuple(spec.coord_dims)
    n_mi = vs.n_mi
    n_cmi = spec.n_central_mi
    bs = values.shape[0]
    off = 0

    interior_shape = (dims[0] - 1,) + tuple(d - 2 for d in dims[1:])
    n_eq = int(np.prod(interior_shape)) * n_mi
    eq = values[:, off : off + n_eq].reshape((bs,) + interior_shape + (n_mi,))
    off += n_eq
    n_init = spec.init_rows.shape[0]
    init = values[:, off : off + n_init]
    off += n_init

    central = []
    for _ in range(len(dims)):
        n = int(np.prod(dims)) * n_cmi * 6
        central.append(values[:, off : off + n].reshape((bs,) + dims + (n_cmi, 6)))
        off += n
    fwd, bwd = [], []
    terms = spec.order + 2
    for lst in (fwd, bwd):
        for c in range(len(dims)):
            red = list(dims)
            red[c] -= 1
            n = int(np.prod(red)) * terms
            lst.append(values[:, off : off + n].reshape((bs,) + tuple(red) + (terms,)))
            off += n
    if off != values.shape[1]:
        raise ValueError(f"value vector has {values.shape[1]} entries; spec needs {off}")
    return StructuredValues(eq, init, central, fwd, bwd)


def _shift_slices(d: int):
    """(region slice of the output, 5-point neighbor offsets for that region)
    along one axis."""
    return [
        (slice(0, 2), (0, 1, 2, 3, 4)),
        (slice(2, d - 2), (-2, -1, 0, 1, 2)),
        (slice(d - 2, d), (0, -1, -2, -3, -4)),
    ]


def _ax(nd: int, c: int, sl: slice):
    """Index tuple (batch axis first) selecting `sl` along grid axis c."""
    idx = [slice(None)] * (nd + 1)
    idx[1 + c] = sl
    return tuple(idx)


def _shifted(sl: slice, off: int) -> slice:
    return slice(sl.start + off, sl.stop + off)


def _eq_slice(nd: int):
    return (slice(None), slice(1, None)) + (slice(1, -1),) * (nd - 1)


def _box_slice(box):
    return (slice(None),) + tuple(
        slice(int(b), int(e) + 1) for b, e in zip(box.begin, box.end)
    )


def _taylor_slices(nd: int, c: int, d: int, forward: bool):
    base = _ax(nd, c, slice(0, d - 1) if forward else slice(1, d))
    nbr = _ax(nd, c, slice(1, d) if forward else slice(0, d - 1))
    return base, nbr


def matvec_structured(
    spec: ConstraintSpec, sv: StructuredValues, x: torch.Tensor
) -> torch.Tensor:
    """A @ x: (bs, num_vars) -> (bs, n_rows), rows in
    [equation | initial | derivative] order."""
    if spec.evolution:
        raise NotImplementedError("evolution systems are not ported yet")
    vs = spec.var_set
    dims = tuple(spec.coord_dims)
    nd = len(dims)
    bs = x.shape[0]
    U = x.reshape((bs,) + dims + (vs.n_mi,))
    U0 = U[..., 0]
    parts = [(sv.eq * U[_eq_slice(nd)]).sum(-1).reshape(bs, -1)]

    off = 0
    for box in spec.iv_boxes:
        vals = U[_box_slice(box) + (box.mi_index,)].reshape(bs, -1)
        if spec.n_iv > 1:
            vals = torch.repeat_interleave(vals, spec.n_iv, dim=1)
        n = vals.shape[1]
        parts.append(sv.init[:, off : off + n] * vals)
        off += n

    for c in range(nd):
        w = sv.central[c]  # (bs, dims..., n_cmi, 6)
        out = []
        for region, offs in _shift_slices(dims[c]):
            wr = w[_ax(nd, c, region)]
            acc = 0.0
            for j, o in enumerate(offs):
                acc = acc + wr[..., j] * U0[_ax(nd, c, _shifted(region, o))][..., None]
            out.append(acc)
        out = torch.cat(out, dim=1 + c)  # (bs, dims..., n_cmi)
        deriv = torch.stack(
            [w[..., k, 5] * U[..., mi] for k, mi in enumerate(vs.central_mi_indices(c))],
            dim=-1,
        )
        parts.append((out + deriv).reshape(bs, -1))

    for vals_list, forward in ((sv.fwd, True), (sv.bwd, False)):
        for c in range(nd):
            v = vals_list[c]
            base, nbr = _taylor_slices(nd, c, dims[c], forward)
            acc = v[..., 0] * U0[base] + v[..., 1] * U[base + (vs.first_deriv_index(c),)]
            t = 2
            if spec.order == 2:
                acc = acc + v[..., 2] * U[base + (vs.second_deriv_index(c),)]
                t = 3
            acc = acc + v[..., t] * U0[nbr]
            parts.append(acc.reshape(bs, -1))

    return torch.cat(parts, dim=1)


def rmatvec_structured(
    spec: ConstraintSpec, sv: StructuredValues, y: torch.Tensor
) -> torch.Tensor:
    """A^T @ y: (bs, n_rows) -> (bs, num_vars), the exact adjoint of
    matvec_structured (each slice read there is an add into the same slice
    here)."""
    if spec.evolution:
        raise NotImplementedError("evolution systems are not ported yet")
    vs = spec.var_set
    dims = tuple(spec.coord_dims)
    nd = len(dims)
    bs = y.shape[0]
    G = y.new_zeros((bs,) + dims + (vs.n_mi,))
    G0 = G[..., 0]  # view: adds into G0 land in G
    off = 0

    n_eq = spec.n_eq_rows
    ye = y[:, :n_eq].reshape(sv.eq.shape[:-1])
    G[_eq_slice(nd)] += sv.eq * ye[..., None]
    off += n_eq

    ioff = 0
    for box in spec.iv_boxes:
        n = box.size * spec.n_iv
        contrib = (sv.init[:, ioff : ioff + n] * y[:, off : off + n]).reshape(
            (bs,) + tuple(box.shape) + (spec.n_iv,)
        ).sum(-1)
        G[_box_slice(box) + (box.mi_index,)] += contrib
        ioff += n
        off += n

    for c in range(nd):
        w = sv.central[c]
        n = int(np.prod(dims)) * spec.n_central_mi
        yc = y[:, off : off + n].reshape((bs,) + dims + (spec.n_central_mi,))
        off += n
        for region, offs in _shift_slices(dims[c]):
            wr = w[_ax(nd, c, region)]
            yr = yc[_ax(nd, c, region)]
            for j, o in enumerate(offs):
                G0[_ax(nd, c, _shifted(region, o))] += (wr[..., j] * yr).sum(-1)
        for k, mi in enumerate(vs.central_mi_indices(c)):
            G[..., mi] += w[..., k, 5] * yc[..., k]

    for vals_list, forward in ((sv.fwd, True), (sv.bwd, False)):
        for c in range(nd):
            v = vals_list[c]
            base, nbr = _taylor_slices(nd, c, dims[c], forward)
            n = v[..., 0].numel() // bs
            yt = y[:, off : off + n].reshape(v.shape[:-1])
            off += n
            G0[base] += v[..., 0] * yt
            G[base + (vs.first_deriv_index(c),)] += v[..., 1] * yt
            t = 2
            if spec.order == 2:
                G[base + (vs.second_deriv_index(c),)] += v[..., 2] * yt
                t = 3
            G0[nbr] += v[..., t] * yt

    return G.reshape(bs, -1)
