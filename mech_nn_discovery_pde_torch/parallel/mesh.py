"""Device mesh and data-parallel helpers.

Port of the JAX package's parallel/mesh.py.  There a `Mesh` names the
devices and XLA inserts the collectives under `jit`; here each device is
one process of a `torch.distributed` group, the mesh is a
`torch.distributed.device_mesh.DeviceMesh` whose axes give process groups
(`mesh.get_group(name)`), and every collective is explicit:

- 'dp' axis: batch parallelism.  `shard_batch` gives a rank its contiguous
  slice of the batch, and `allreduce_mean_` averages the gradients (the
  psum XLA inserts for a loss that is a mean over the batch).
- 'sp' axis: spatial parallelism.  Grid axis 0 of the multigrid solver's
  fine level is split over it (`MultigridSolver(mesh=...)`,
  parallel/sharded_normal.py), with a halo exchange (parallel/halo.py).

Collectives go through the group's backend: NCCL takes CUDA tensors as
they are; gloo (several processes sharing one card, or the CPU) takes the
CUDA tensors it is given through host copies made here, and copies the
result back (`host_staged`).
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Tuple[str, ...] = ("dp", "sp"),
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the default process group (initialised by
    the caller), ranks in C order over `shape`.  The default shape puts
    every rank on the first axis ((n, 1) for two axes)."""
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} with axes {axis_names} does not hold {n} ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_batch(mesh: DeviceMesh, tree, axis: str = "dp"):
    """This rank's contiguous slice, along `axis`, of the leading axis of
    every tensor in `tree` whose leading size the axis divides; any other
    leaf is left whole (replicated, as the JAX package's shard_batch_tree)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)

    def take(x):
        if x.ndim >= 1 and x.shape[0] % n == 0:
            k = x.shape[0] // n
            return x[r * k : (r + 1) * k]
        return x

    return _tree_map(take, tree)


@contextlib.contextmanager
def host_staged(group, t: torch.Tensor):
    """Yield the tensor an in-place collective of `group` runs on for `t`:
    `t` itself, or a contiguous copy (on the host under gloo for a CUDA
    tensor: gloo's send, recv and reductions take host memory), copied back
    into `t` when the block ends."""
    host = t.is_cuda and dist.get_backend(group) == "gloo"
    if not host and t.is_contiguous():
        yield t
        return
    h = t.cpu() if host else t.contiguous()
    yield h
    t.copy_(h)


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place; returns it."""
    with host_staged(group, t) as h:
        dist.all_reduce(h, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = t.contiguous()
    if src.is_cuda and dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def replicate(mesh: DeviceMesh, tree):
    """Broadcast every tensor of `tree` in place from mesh coordinate (0, ..)
    to every rank of the mesh (axis by axis, each from its group's rank 0).
    Returns the tree."""

    def bcast(x):
        for name in mesh.mesh_dim_names:
            g = mesh.get_group(name)
            with host_staged(g, x) as h:
                dist.broadcast(h, src=dist.get_global_rank(g, 0), group=g)
        return x

    return _tree_map(bcast, tree)


def allreduce_mean_(tensors: Iterable[torch.Tensor], mesh: DeviceMesh, axis: str = "dp"):
    """Average each tensor in place over the ranks of `axis` (the gradients
    of a loss that is a mean over the dp-sharded batch); None entries (no
    gradient) are skipped."""
    g = mesh.get_group(axis)
    n = dist.get_world_size(g)
    for t in tensors:
        if t is None:
            continue
        all_reduce_sum_(t, g)
        t.div_(n)
