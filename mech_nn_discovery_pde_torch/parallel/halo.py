"""Halo exchange along a sharded grid axis.

Port of the JAX package's parallel/halo.py.  A grid axis split into
contiguous blocks over the ranks of a process group (group rank r holds
block r): a stencil that reaches at most HALO points along the axis needs
the HALO edge planes of each neighbouring block, which `exchange_halo`
fetches in one batch of point-to-point sends and receives (the JAX
package's two `ppermute`s).  The global ends read zeros.

Under gloo the exchanged planes travel through host memory (gloo's send and
recv take host tensors); NCCL sends CUDA tensors as they are.  The
computation stays on the tensors' device either way.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

HALO = 4  # exchanged planes each side: the 5-point edge stencils reach 4


def exchange_halo(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """x with its neighbours' edge slabs around it along `axis`:
    (.., n, ..) -> (.., HALO + n + HALO, ..); zero-filled at the global ends
    (group ranks 0 and size-1).  Every rank of the group must call it."""
    n_shards, r = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[axis]
    if n < HALO:
        raise ValueError(f"exchange_halo: a block of {n} planes along axis {axis} cannot "
                         f"give its neighbours {HALO}")
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    buf = torch.device("cpu") if host else x.device
    shape = list(x.shape)
    shape[axis] = HALO
    from_left = torch.zeros(shape, dtype=x.dtype, device=buf)
    from_right = torch.zeros(shape, dtype=x.dtype, device=buf)
    ops = []
    for nb, edge, recv in ((r - 1, x.narrow(axis, 0, HALO), from_left),
                           (r + 1, x.narrow(axis, n - HALO, HALO), from_right)):
        if 0 <= nb < n_shards:
            peer = dist.get_global_rank(group, nb)
            ops.append(dist.P2POp(dist.isend, edge.to(buf).contiguous(), peer, group))
            ops.append(dist.P2POp(dist.irecv, recv, peer, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_left.to(x.device), x, from_right.to(x.device)], dim=axis)


def sharded_stencil_apply(group, fn_local: Callable[[torch.Tensor], torch.Tensor],
                          axis: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rank-local form of a halo-consuming stencil: apply(x) gives
    fn_local the local block with HALO ghost planes on both sides of `axis`;
    fn_local returns the output of the local (unhaloed) extent."""

    def apply(x):
        return fn_local(exchange_halo(x, group, axis))

    return apply


def sharded_axis_derivative(group, weights_5pt) -> Callable[[torch.Tensor], torch.Tensor]:
    """The 5-point first derivative along the sharded axis 0 (interior
    weights `weights_5pt`, uniform step; the global edges read zeros, as in
    the JAX package)."""
    w = [float(v) for v in weights_5pt]

    def local(xh):
        n = xh.shape[0] - 2 * HALO
        out = torch.zeros_like(xh[HALO : HALO + n])
        for k in range(5):
            out = out + w[k] * xh[HALO - 2 + k : HALO - 2 + k + n]
        return out

    return sharded_stencil_apply(group, local, axis=0)
