"""Chebyshev smoothing pass on the line-block-preconditioned normal operator,
and kernel K2 (time-line block-Jacobi apply) that carries its block half.

The TPU kernel `_fused_chebyshev_kernel`
(mech_nn_discovery_pde_tpu/ops/fused_smoother.py) keeps a whole sample in
VMEM for the entire multi-step pass.  On the GL fine level that is the block
inverse (12.25 MiB) plus the stencil fields (3.4 MiB) per sample, against at
most 227 KB of shared memory on a Hopper SM, so here the pass is a host loop
of two launches per Chebyshev step, with the vector updates fused into their
epilogues:

  K1 (ops/normal_stencil.stencil_apply):  x <- x + d,  r <- r - A d
  K2 (block_apply, csrc/line_block.cu):   d <- c1 d + c2 B^-1 r

The recurrence is the JAX package's (`MultigridSolver._smooth` chebyshev
branch and `_fused_chebyshev_kernel`): Chebyshev over [lmax/ratio, lmax],
`x0_zero` starts from x = 0 without an apply, and the final residual
r = b - A x is the recurrence's own invariant, returned at no extra cost.
The per-step scalars c1, c2 depend only on lmax, so `chebyshev_schedule`
computes them once per hierarchy level.

Vectors are the flat point-major (bs, N*m) solver layout; the block inverse
is (bs, S, bw, bw) row-major with block row i = ti*m + mi (bw = nt*m, S
spatial lines).  On CUDA tensors both halves launch kernels; on CPU tensors
they run their plain versions (`block_apply_plain`, `stencil_apply_plain`).
"""

from __future__ import annotations

from typing import Optional

import torch

from mech_nn_discovery_pde_torch.ops import _cuda
from mech_nn_discovery_pde_torch.ops.normal_stencil import (
    NormalStencilDesc,
    stencil_apply,
    stencil_apply_plain,
)


def line_vec_to_blocks(r: torch.Tensor, nt: int, m: int) -> torch.Tensor:
    """(bs, nt*S*m) point-major -> (bs, S, nt*m) time-line blocks."""
    bs = r.shape[0]
    return r.reshape(bs, nt, -1, m).transpose(1, 2).reshape(bs, -1, nt * m)


def line_blocks_to_vec(z: torch.Tensor, nt: int, m: int) -> torch.Tensor:
    bs = z.shape[0]
    return z.reshape(bs, -1, nt, m).transpose(1, 2).reshape(bs, -1)


def block_apply_plain(
    binv: torch.Tensor,
    r: torch.Tensor,
    nt: int,
    d: Optional[torch.Tensor] = None,
    c1: Optional[torch.Tensor] = None,
    c2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K2's plain version: one einsum over the line blocks, then the same
    epilogue as `block_apply`."""
    m = r.shape[1] // (nt * binv.shape[1])
    t = torch.einsum("bsij,bsj->bsi", binv, line_vec_to_blocks(r, nt, m))
    t = line_blocks_to_vec(t, nt, m)
    if c2 is not None:
        t = c2[:, None] * t
    if c1 is not None:
        t = t + c1[:, None] * d
    if d is None:
        return t
    d.copy_(t)
    return d


def block_apply(
    binv: torch.Tensor,
    r: torch.Tensor,
    nt: int,
    d: Optional[torch.Tensor] = None,
    c1: Optional[torch.Tensor] = None,
    c2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """t = B^-1 r per time-line block, batched over (sample, line).

    binv (bs, S, bw, bw); r (bs, N*m) point-major.  With `d` given, writes
    d = c1 d + c2 t into d and returns it (c1 None reads as 0, and d is then
    not read; c2 None as 1; both per-sample (bs,) tensors); else returns t.
    CUDA tensors launch kernel K2; CPU tensors run the plain version."""
    if binv.is_cuda:
        return _block_apply_k2(binv, r, nt, d, c1, c2)
    if binv.device.type != "cpu":
        raise ValueError(f"block_apply: unsupported device {binv.device}")
    return block_apply_plain(binv, r, nt, d, c1, c2)


def _block_apply_k2(binv, r, nt, d, c1, c2):
    bs, S, bw, bw2 = binv.shape
    if bw != bw2 or bw % nt:
        raise ValueError(f"block_apply: bad block shape {tuple(binv.shape)} for nt={nt}")
    m = bw // nt
    if tuple(r.shape) != (bs, nt * S * m):
        raise ValueError(f"block_apply: r {tuple(r.shape)} does not match binv")
    for t in (binv, r, d, c1, c2):
        if t is not None and t.dtype != torch.float32:
            raise ValueError("block_apply: K2 takes float32 operands")
    if d is None:
        d = torch.empty_like(r)
    elif tuple(d.shape) != tuple(r.shape) or d.data_ptr() == r.data_ptr():
        raise ValueError("block_apply: d must match r's shape and not alias it")
    for c in (c1, c2):
        if c is not None and tuple(c.shape) != (bs,):
            raise ValueError("block_apply: c1/c2 must be per-sample (bs,) tensors")
    _cuda.require_cuda(binv, r, d, c1, c2)
    lib = _cuda.library("line_block")
    code = lib.k2_line_block_apply_f32(
        binv.data_ptr(), r.data_ptr(), d.data_ptr(), _cuda.ptr(c1), _cuda.ptr(c2),
        m, nt, S, bs, _cuda.stream_ptr(binv.device),
    )
    _cuda.check("line_block", "k2_line_block_apply", code)
    return d


def chebyshev_schedule(lmax: torch.Tensor, ratio: float, steps: int) -> torch.Tensor:
    """Per-step Chebyshev scalars for a batch of lmax (bs,) f32:
    (steps+1, 2, bs) with [0, 1] = 1/theta (first direction d = B^-1 r /
    theta) and [i+1] = (c1, c2) = (rho_new rho, 2 rho_new / delta) of step
    i's update d <- c1 d + c2 B^-1 r."""
    lmin = lmax / ratio
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma = theta / delta
    rho = 1.0 / sigma
    out = [torch.stack([torch.zeros_like(theta), 1.0 / theta])]
    for _ in range(steps):
        rho_new = 1.0 / (2.0 * sigma - rho)
        out.append(torch.stack([rho_new * rho, 2.0 * rho_new / delta]))
        rho = rho_new
    return torch.stack(out).contiguous()


def chebyshev_smooth_plain(desc, nt, coef, binv, b, x, lmax, ratio: float, steps: int,
                           x0_zero: bool = False):
    """The smoothing pass's plain version: the JAX package's `_smooth`
    Chebyshev recurrence step by step on the plain applies (no fused
    epilogues, no precomputed schedule).  Returns (x, r = b - A x)."""
    A = lambda v: stencil_apply_plain(desc, coef, v)
    Binv = lambda r: block_apply_plain(binv, r, nt)
    lmin = lmax / ratio
    theta = ((lmax + lmin) / 2.0)[:, None]
    delta = ((lmax - lmin) / 2.0)[:, None]
    sigma = theta / delta
    rho = 1.0 / sigma
    x = torch.zeros_like(b) if x0_zero else x
    r = b - A(x)
    d = Binv(r) / theta
    for _ in range(steps):
        x = x + d
        r = r - A(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * Binv(r)
        rho = rho_new
    return x, r


def chebyshev_smooth(
    desc: NormalStencilDesc,
    nt: int,
    coef: torch.Tensor,
    binv: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
    sched: torch.Tensor,
    steps: int,
    x0_zero: bool = False,
):
    """`steps` Chebyshev iterations on B^-1 AtA from x (ignored when
    x0_zero): returns (x, r) with r = b - A x maintained by the recurrence.

    sched is `chebyshev_schedule(lmax, ratio, >= steps)`.  Neither b nor x
    is written."""
    if x0_zero:
        r, xcur = b, None
    else:
        r, xcur = stencil_apply(desc, coef, x, rin=b), x
    if steps == 0:
        return (torch.zeros_like(b) if xcur is None else xcur), r
    d = block_apply(binv, r, nt, c2=sched[0, 1])
    xnew = torch.empty_like(b)
    rnew = torch.empty_like(b) if r is b else r
    for i in range(steps):
        # x <- x + d and r <- r - A d in one K1 launch
        stencil_apply(desc, coef, d, rin=r, out=rnew, xin=xcur, xout=xnew)
        r, xcur = rnew, xnew
        if i + 1 < steps:  # the last direction would go unused
            block_apply(binv, r, nt, d=d, c1=sched[i + 1, 0], c2=sched[i + 1, 1])
    return xcur, r
