"""The assembled normal operator AtA with grid axis 0 split over the mesh's
'sp' axis.

Port of the JAX package's parallel/sharded_normal.py.  Group rank r of the
'sp' group holds the n_loc = d0 / n_sp planes r n_loc .. (r+1) n_loc - 1 of
axis 0 (R = prod(dims[1:]) points each): its run of the flat point-major
vector, and its planes of the stencil fields.

Why one exchange of x per matvec is enough: every AtA coupling is
axis-aligned with offset <= HALO = 4 planes, so only the couplings along
axis 0 cross a rank's edge; couplings along the other axes that wrap
across a plane on the flat grid have structurally zero band fields.  Kernel
K1 computes y[p] from g[p] x[p + s] and g[p - s] x[p - s] (the reversed
band read where the JAX package's TPU kernel would scatter), so a rank's
outputs need x and the fields on its slab of n_loc + 2 HALO planes.  The
fields are fixed for a solve: their halo is exchanged once
(`extend`), and each matvec exchanges the HALO planes of x on each side
(`apply`).  K1 then runs on the slab with its output window on the rank's
own n_loc R points; the global ends' halos are zeros, which reads as the
unsharded apply's zero neighbours off the grid.

Per matvec and rank boundary that moves 2 HALO R m values each way: the
surface of the slab, while the work is its volume.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mech_nn_discovery_pde_torch.ops.normal_stencil import NormalStencilDesc, stencil_apply
from mech_nn_discovery_pde_torch.parallel.halo import HALO, exchange_halo


class ShardLayout(NamedTuple):
    """Where a rank's planes of grid axis 0 lie."""

    n_sp: int  # ranks of the 'sp' group
    rank: int  # this rank's place in it
    d0: int  # planes of axis 0
    R: int  # points per plane
    n_loc: int  # planes per rank

    @property
    def points(self) -> slice:
        """This rank's run of the flat grid points."""
        return slice(self.rank * self.n_loc * self.R, (self.rank + 1) * self.n_loc * self.R)

    @property
    def planes(self) -> slice:
        return slice(self.rank * self.n_loc, (self.rank + 1) * self.n_loc)


def shard_layout(desc: NormalStencilDesc, group) -> ShardLayout:
    """The layout of `desc`'s grid over `group`.  Raises ValueError where the
    JAX package asserts: d0 not divisible by the group's size, or fewer than
    HALO planes per rank."""
    dims = desc.coord_dims
    d0, R = dims[0], int(np.prod(dims[1:])) if len(dims) > 1 else 1
    n_sp = dist.get_world_size(group)
    if d0 % n_sp:
        raise ValueError(f"grid axis 0 ({d0} planes) does not split over {n_sp} 'sp' ranks")
    n_loc = d0 // n_sp
    if n_loc < HALO:
        raise ValueError(f"each 'sp' rank must hold >= {HALO} planes of grid axis 0 "
                         f"(got {n_loc}); use fewer 'sp' ranks or a larger grid")
    return ShardLayout(n_sp, dist.get_rank(group), d0, R, n_loc)


def slab_desc(desc: NormalStencilDesc, lay: ShardLayout) -> NormalStencilDesc:
    """The descriptor of a rank's slab, n_loc + 2 HALO planes: the same
    bands (every stride is that of axes 1.. or R), a shorter axis 0."""
    n = lay.n_loc + 2 * HALO
    return desc._replace(coord_dims=(n,) + tuple(desc.coord_dims[1:]), grid_size=n * lay.R)


def make_sharded_flat_ops(mesh, desc: NormalStencilDesc, sp_axis: str = "sp"
                          ) -> Tuple[Callable, Callable]:
    """(extend, apply) in the solver's batched point-major layout, for the
    rank's planes:

      coef_h = extend(coef)   coef (bs, NC, n_loc R) -> (bs, NC, (n_loc + 2 HALO) R),
                              the fields' halo, exchanged once per solve
      y = apply(coef_h, x, **epilogue)
                              x (bs, n_loc R m) -> (AtA x) on the rank's points,
                              with K1's epilogue (`stencil_apply`: rin, out,
                              xin, xout, all (bs, n_loc R m))

    Every rank of the 'sp' group must make each call.  K1 runs on the slab
    with the output window (HALO R, n_loc R)."""
    group = mesh.get_group(sp_axis)
    lay = shard_layout(desc, group)
    sdesc = slab_desc(desc, lay)
    R, n_loc, m = lay.R, lay.n_loc, desc.n_mi
    window = (HALO * R, n_loc * R)

    def extend(coef: torch.Tensor) -> torch.Tensor:
        bs, nc = coef.shape[:2]
        c4 = exchange_halo(coef.reshape(bs, nc, n_loc, R), group, axis=2)
        return c4.reshape(bs, nc, -1)

    def apply(coef_h: torch.Tensor, x: torch.Tensor, **epilogue) -> torch.Tensor:
        bs = x.shape[0]
        xh = exchange_halo(x.reshape(bs, n_loc, R * m), group, axis=1)
        return stencil_apply(sdesc, coef_h, xh.reshape(bs, -1), window=window, **epilogue)

    return extend, apply


def make_sharded_normal_ops(mesh, desc: NormalStencilDesc, sp_axis: str = "sp"
                            ) -> Tuple[Callable, Callable]:
    """(extend_coef, apply) on one sample in the JAX package's channel-major
    layout, for the rank's planes:

      coef_h = extend_coef(coef3)   coef3 (NC, n_loc, R) -> (NC, n_loc + 2 HALO, R)
      y3 = apply(coef_h, x3)        x3 (m, n_loc, R) -> (m, n_loc, R)

    (`coef_to_grid` and `to_channel_major_grid` give the global layouts.)"""
    extend_flat, apply_flat = make_sharded_flat_ops(mesh, desc, sp_axis)
    m, nc = desc.n_mi, desc.n_channels

    def extend_coef(coef3: torch.Tensor) -> torch.Tensor:
        n_loc, R = coef3.shape[1:]
        return extend_flat(coef3.reshape(1, nc, -1)).reshape(nc, -1, R)

    def apply(coef_h: torch.Tensor, x3: torch.Tensor) -> torch.Tensor:
        _, n_loc, R = x3.shape
        xf = x3.permute(1, 2, 0).reshape(1, -1)
        y = apply_flat(coef_h.reshape(1, nc, -1), xf)
        return y.reshape(n_loc, R, m).permute(2, 0, 1)

    return extend_coef, apply


def _plane_shape(desc: NormalStencilDesc) -> Tuple[int, int]:
    dims = desc.coord_dims
    return dims[0], int(np.prod(dims[1:])) if len(dims) > 1 else 1


def to_channel_major_grid(desc: NormalStencilDesc, x: torch.Tensor) -> torch.Tensor:
    """(num_vars,) point-major -> (m, d0, R)."""
    d0, R = _plane_shape(desc)
    return x.reshape(d0, R, desc.n_mi).permute(2, 0, 1)


def from_channel_major_grid(desc: NormalStencilDesc, y: torch.Tensor) -> torch.Tensor:
    """(m, d0, R) -> (num_vars,)."""
    return y.permute(1, 2, 0).reshape(-1)


def coef_to_grid(desc: NormalStencilDesc, coef: torch.Tensor) -> torch.Tensor:
    """(NC, grid_size) -> (NC, d0, R)."""
    d0, R = _plane_shape(desc)
    return coef.reshape(desc.n_channels, d0, R)
