"""Chebyshev smoothing pass on the line-block-preconditioned normal operator,
and kernels K2 and K3 (time-line block-Jacobi applies) that carry its block
half.

The TPU kernel `_fused_chebyshev_kernel`
(mech_nn_discovery_pde_tpu/ops/fused_smoother.py) keeps a whole sample in
VMEM for the entire multi-step pass.  On the GL fine level that is the block
inverse (12.25 MiB) plus the stencil fields (3.4 MiB) per sample, against at
most 227 KB of shared memory on a Hopper SM, so here the pass is a host loop
of two launches per Chebyshev step, with the vector updates fused into their
epilogues:

  K1 (ops/normal_stencil.stencil_apply):  x <- x + d,  r <- r - A d
  K2 (block_apply, csrc/line_block.cu):   d <- c1 d + c2 B^-1 r
  K3 (factored_block_apply, same file):   d <- c1 d + c2 W (W^T r)

K3 replaces K2 under mg_precond_dtype='bf16_factored', where the level
stores the PSD square-root factor W = L^-T of B^-1 = W W^T in bfloat16 (the
TPU kernel's `factored=True`, `_emit_factored_block_apply`).  Both launch
persistent CTAs that stream the blocks through a shared-memory ring; their
launch geometry (`line_block_geometry`) is computed here from the shapes
and the card's SM count.  A block too large for one CTA's shared memory
takes the kernels' row-tiled path, which streams it in panels of rows.

The recurrence is the JAX package's (`MultigridSolver._smooth` chebyshev
branch and `_fused_chebyshev_kernel`): Chebyshev over [lmax/ratio, lmax],
`x0_zero` starts from x = 0 without an apply, and the final residual
r = b - A x is the recurrence's own invariant, returned at no extra cost.
The per-step scalars c1, c2 depend only on lmax, so `chebyshev_schedule`
computes them once per hierarchy level.  `chebyshev_smooth_op` runs the
pass on any normal operator with K1's epilogue contract (the solver's
factored A^T (A x) on levels without stencil fields), and `jacobi_smooth`
the JAX package's weighted block-Jacobi branch (`_smooth`, mg_smoother=
'jacobi'): x <- x + w B^-1 (b - A x), the update in K2's epilogue.

Point blocks (mg_block_smoother='point': the n_mi x n_mi diagonal block of
each grid point) are time lines of length 1 in this layout: the same
kernels apply them with nt = 1, bw = n_mi.

Vectors are the flat point-major (bs, N*m) solver layout, float32; the
block inverse (or W) is (bs, S, bw, bw) row-major with block row
i = ti*m + mi (bw = nt*m, S spatial lines), float32 or bfloat16.  On CUDA
tensors both halves launch kernels; on CPU tensors they run their plain
versions (`block_apply_plain`, `factored_block_apply_plain`,
`stencil_apply_plain`), which upcast a bfloat16 operand first.
"""

from __future__ import annotations

import dataclasses
import functools
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


def line_blocks_from_jax(arr, nt: int, m: int, layout: str) -> torch.Tensor:
    """A JAX-package line-block preconditioner array (numpy) as the port's
    (bs, S, bw, bw) row-major tensor, in its stored dtype.

    layout "rows": the XLA path's (bs, S, bw, bw); "fused": the fused
    smoother's column-major (bs, bw, m, nt, S) with
    w[j][mi, ti, s] = M_s[ti*m + mi, j].  numpy has no bfloat16 of its own:
    a bfloat16 array (JAX's ml_dtypes type) goes through float32, exactly."""
    bw = nt * m
    bf16 = arr.dtype.name == "bfloat16"
    t = torch.tensor(arr.astype("float32") if bf16 else arr)
    if layout == "fused":
        if t.ndim != 5 or tuple(t.shape[1:4]) != (bw, m, nt):
            raise ValueError(f"fused layout wants (bs, {bw}, {m}, {nt}, S), got {tuple(t.shape)}")
        t = t.permute(0, 4, 3, 2, 1).reshape(t.shape[0], t.shape[4], bw, bw)
    elif layout != "rows":
        raise ValueError(f"unknown layout {layout!r}; expected 'rows' or 'fused'")
    if t.ndim != 4 or tuple(t.shape[2:]) != (bw, bw):
        raise ValueError(f"want (bs, S, {bw}, {bw}) blocks, got {tuple(t.shape)}")
    t = t.contiguous()
    return t.to(torch.bfloat16) if bf16 else t


def _epilogue(t, d, c1, c2):
    """d = c1 d + c2 t (see `block_apply`)."""
    if c2 is not None:
        t = c2[:, None] * t
    if c1 is not None:
        t = t + c1[:, None] * d
    if d is None:
        return t
    d.copy_(t)
    return d


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
    t = torch.einsum("bsij,bsj->bsi", binv.to(r.dtype), line_vec_to_blocks(r, nt, m))
    return _epilogue(line_blocks_to_vec(t, nt, m), d, c1, c2)


def factored_block_apply_plain(
    w: torch.Tensor,
    r: torch.Tensor,
    nt: int,
    d: Optional[torch.Tensor] = None,
    c1: Optional[torch.Tensor] = None,
    c2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3's plain version: u = W^T r and t = W u over the line blocks with W
    upcast to float32 (the JAX package's factored `_block_apply`), then the
    same epilogue as `block_apply`."""
    m = r.shape[1] // (nt * w.shape[1])
    wf = w.to(r.dtype)
    u = torch.einsum("bsij,bsi->bsj", wf, line_vec_to_blocks(r, nt, m))
    t = torch.einsum("bsij,bsj->bsi", wf, u)
    return _epilogue(line_blocks_to_vec(t, nt, m), d, c1, c2)


def block_apply(
    binv: torch.Tensor,
    r: torch.Tensor,
    nt: int,
    d: Optional[torch.Tensor] = None,
    c1: Optional[torch.Tensor] = None,
    c2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """t = B^-1 r per time-line block, batched over (sample, line).

    binv (bs, S, bw, bw) float32 or bfloat16; r (bs, N*m) point-major
    float32.  With `d` given, writes d = c1 d + c2 t into d and returns it
    (c1 None reads as 0, and d is then not read; c2 None as 1; both
    per-sample (bs,) tensors); else returns t.  CUDA tensors launch kernel
    K2; CPU tensors run the plain version.  K2 takes any bw: a block larger
    than one CTA's shared memory (bw > 240 in float32, > 339 in bfloat16)
    streams in panels of rows (`line_block_geometry`)."""
    if binv.is_cuda:
        launcher = _K2_FN.get(binv.dtype)
        if launcher is None:
            raise ValueError(f"block_apply: K2 takes a float32 or bfloat16 B^-1, got {binv.dtype}")
        return _launch_line_block(launcher, binv, r, nt, d, c1, c2)
    if binv.device.type != "cpu":
        raise ValueError(f"block_apply: unsupported device {binv.device}")
    return block_apply_plain(binv, r, nt, d, c1, c2)


def factored_block_apply(
    w: torch.Tensor,
    r: torch.Tensor,
    nt: int,
    d: Optional[torch.Tensor] = None,
    c1: Optional[torch.Tensor] = None,
    c2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """t = W (W^T r) = B^-1 r per time-line block, from the bfloat16 factor
    W = L^-T of mg_precond_dtype='bf16_factored' (bs, S, bw, bw); same
    vectors and epilogue as `block_apply`.  CUDA tensors launch kernel K3;
    CPU tensors run the plain version.

    Contract: W is upper-triangular, with an exactly zero strict lower
    triangle (the solver stores L^-T with `.triu()`).  K3 reads only the
    upper triangle; the plain version reads all of W.  K3 takes any bw; a
    block with bw > 337 streams in panels of rows, twice (`block_apply`)."""
    if w.is_cuda:
        if w.dtype != torch.bfloat16:
            raise ValueError(f"factored_block_apply: K3 takes a bfloat16 W, got {w.dtype}")
        return _launch_line_block(_K3_FN, w, r, nt, d, c1, c2)
    if w.device.type != "cpu":
        raise ValueError(f"factored_block_apply: unsupported device {w.device}")
    return factored_block_apply_plain(w, r, nt, d, c1, c2)


# stored block dtype -> (launcher, launch-count name, factored)
_K2_FN = {
    torch.float32: ("k2_line_block_apply_f32", "k2_line_block_apply", False),
    torch.bfloat16: ("k2_line_block_apply_bf16", "k2_line_block_apply_bf16", False),
}
_K3_FN = ("k3_factored_line_block_apply_bf16", "k3_factored_line_block_apply", True)

# Hopper SM shared memory: 227 KB a block may use, 228 KB an SM holds with
# 1 KB reserved per resident block
_SMEM_PER_BLOCK = 232448
_SMEM_PER_SM = 233472
_SMEM_RESERVED = 1024
# the ring: CTAs per SM and stages per CTA.  A CTA computes one item at a
# time, so the CTAs per SM set how many items' shared-memory reads overlap;
# 2 stages let each CTA's next block load while one is computed on
_CTAS_PER_SM = 8
_STAGES = 2
# the row-tiled path's panels: a multiple of 8 rows (so a panel's bytes are a
# multiple of 16 and it takes the bulk copy), and the most CTAs per SM whose
# panels still hold one full warp of rows
_PANEL_ROW_STEP = 8
_PANEL_MIN_ROWS = 32


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class LineBlockGeometry:
    """Launch geometry of K2/K3 (csrc/line_block.cu): `ctas` persistent CTAs
    (one producer warp and ceil(panel_rows/32) consumer warps each), each
    with a ring of `stages` stages in `smem_bytes` of dynamic shared memory;
    CTA c takes the items (sample, line) c, c + ctas, ... of the bs*S items.
    `panel_rows`: bw where a stage holds a whole block (the streamed path),
    else the rows of the panels a block streams in (the row-tiled path).
    `bulk`: each block or panel is moved by one 1-D bulk copy (its bytes a
    multiple of 16); else the kernel's own load path copies it."""

    ctas: int
    stages: int
    smem_bytes: int
    bulk: bool
    panel_rows: int


def line_block_smem_bytes(bw: int, stages: int, entry_bytes: int, factored: bool,
                          rows: Optional[int] = None) -> int:
    """The kernel's shared-memory layout.  Streamed path (`rows` None or bw;
    `make_layout` in line_block.cu): 2 mbarriers per stage, K3's
    double-buffered f32 u, and per stage the block and r's line, each padded
    to 16 bytes.  Row-tiled path (rows < bw; `make_tiled_layout`): the
    mbarriers, K3's u, r's line double-buffered, and per stage a panel of
    `rows` block rows."""
    u = _pad16(2 * 4 * bw) if factored else 0
    if rows is None or rows >= bw:
        stage = _pad16(bw * bw * entry_bytes) + _pad16(4 * bw)
        return 16 * stages + u + stages * stage
    return 16 * stages + u + _pad16(2 * 4 * bw) + stages * _pad16(rows * bw * entry_bytes)


def _panel_rows(bw: int, stages: int, entry_bytes: int, factored: bool, budget: int) -> int:
    """The most panel rows (< bw; a multiple of _PANEL_ROW_STEP where that
    leaves any) whose layout fits `budget` bytes; 0 if none."""
    fixed = line_block_smem_bytes(bw, stages, entry_bytes, factored, rows=0)
    rows = min(bw - 1, max(0, (budget - fixed) // (stages * bw * entry_bytes)))
    if rows >= _PANEL_ROW_STEP:
        rows -= rows % _PANEL_ROW_STEP
    while rows > 0 and line_block_smem_bytes(bw, stages, entry_bytes, factored, rows) > budget:
        rows -= 1
    return rows


@functools.lru_cache(maxsize=64)
def line_block_geometry(bs: int, S: int, bw: int, entry_bytes: int, n_sm: int,
                        factored: bool = False) -> LineBlockGeometry:
    """Choose K2/K3's launch geometry for bs*S blocks of bw x bw entries of
    `entry_bytes` on a card of `n_sm` SMs: _CTAS_PER_SM CTAs of _STAGES
    stages each, fewer CTAs per SM where shared memory does not hold them,
    then one stage.  A block that does not fit one CTA's shared memory
    (227 KB; bw > 240 in f32, > 339 in bf16, > 337 for K3) takes the
    row-tiled path: _STAGES stages of panels, the most CTAs per SM whose
    panels hold _PANEL_MIN_ROWS rows (else one CTA, and one stage if two do
    not fit).  Raises ValueError for a bad shape, and for a bw so large that
    r's line (and K3's u) leave no room for one row: above about 12,900 for
    K3, 19,300 for K2 in f32."""
    if min(bs, S, bw, entry_bytes, n_sm) < 1:
        raise ValueError(f"line_block_geometry: bad shape bs={bs} S={S} bw={bw} n_sm={n_sm}")
    per_sm, stages = _CTAS_PER_SM, _STAGES

    def smem(st):
        return line_block_smem_bytes(bw, st, entry_bytes, factored)

    while per_sm * (smem(stages) + _SMEM_RESERVED) > _SMEM_PER_SM:
        if per_sm > 1:
            per_sm -= 1
        elif stages > 1:
            stages = 1
        else:
            break
    if smem(stages) <= _SMEM_PER_BLOCK:
        return LineBlockGeometry(ctas=min(bs * S, n_sm * per_sm), stages=stages,
                                 smem_bytes=smem(stages), bulk=bw * bw * entry_bytes % 16 == 0,
                                 panel_rows=bw)
    stages = _STAGES
    for per_sm in range(_CTAS_PER_SM, 0, -1):
        budget = min(_SMEM_PER_SM // per_sm - _SMEM_RESERVED, _SMEM_PER_BLOCK)
        rows = _panel_rows(bw, stages, entry_bytes, factored, budget)
        if rows >= _PANEL_MIN_ROWS:
            break
    if rows < 1:
        stages = 1
        rows = _panel_rows(bw, stages, entry_bytes, factored, _SMEM_PER_BLOCK)
    if rows < 1:
        raise ValueError(f"line_block_geometry: bw={bw} leaves no room for a panel row")
    bulk = bw * bw * entry_bytes % 16 == 0 and rows * bw * entry_bytes % 16 == 0
    return LineBlockGeometry(ctas=min(bs * S, n_sm * per_sm), stages=stages,
                             smem_bytes=line_block_smem_bytes(bw, stages, entry_bytes, factored,
                                                              rows),
                             bulk=bulk, panel_rows=rows)


def _launch_line_block(launcher, blocks, r, nt, d, c1, c2):
    """Check the operands of a csrc/line_block.cu kernel and launch it."""
    fn, counted, factored = launcher
    bs, S, bw, bw2 = blocks.shape
    if bw != bw2 or bw % nt:
        raise ValueError(f"{fn}: bad block shape {tuple(blocks.shape)} for nt={nt}")
    m = bw // nt
    if tuple(r.shape) != (bs, nt * S * m):
        raise ValueError(f"{fn}: r {tuple(r.shape)} does not match the blocks")
    for t in (r, d, c1, c2):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{fn}: vectors and coefficients must be float32")
    if d is None:
        d = torch.empty_like(r)
    elif tuple(d.shape) != tuple(r.shape) or d.data_ptr() == r.data_ptr():
        raise ValueError(f"{fn}: d must match r's shape and not alias it")
    for c in (c1, c2):
        if c is not None and tuple(c.shape) != (bs,):
            raise ValueError(f"{fn}: c1/c2 must be per-sample (bs,) tensors")
    _cuda.require_cuda(blocks, r, d, c1, c2)
    geom = line_block_geometry(bs, S, bw, blocks.element_size(),
                               _cuda.sm_count(blocks.device), factored)
    bulk = geom.bulk and blocks.data_ptr() % 16 == 0
    lib = _cuda.library("line_block")
    code = getattr(lib, fn)(
        blocks.data_ptr(), r.data_ptr(), d.data_ptr(), _cuda.ptr(c1), _cuda.ptr(c2),
        m, nt, S, bs, geom.ctas, geom.panel_rows, geom.stages, geom.smem_bytes, int(bulk),
        _cuda.stream_ptr(blocks.device),
    )
    _cuda.check("line_block", counted, code)
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
                           x0_zero: bool = False, factored: bool = False):
    """The smoothing pass's plain version: the JAX package's `_smooth`
    Chebyshev recurrence step by step on the plain applies (no fused
    epilogues, no precomputed schedule).  Returns (x, r = b - A x)."""
    A = lambda v: stencil_apply_plain(desc, coef, v)
    block = factored_block_apply_plain if factored else block_apply_plain
    Binv = lambda r: block(binv, r, nt)
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


def chebyshev_smooth_op(apply, block, b, x, sched, steps: int, x0_zero: bool = False):
    """`steps` Chebyshev iterations on B^-1 A from x (ignored when x0_zero):
    returns (x, r) with r = b - A x maintained by the recurrence.

    apply(v, rin=, out=, xin=, xout=) is A v with K1's epilogue
    (`stencil_apply`); block(r, d=, c1=, c2=) is B^-1 r with K2's
    (`block_apply`).  sched is `chebyshev_schedule(lmax, ratio, >= steps)`.
    Neither b nor x is written."""
    if x0_zero:
        r, xcur = b, None
    else:
        r, xcur = apply(x, rin=b), x
    if steps == 0:
        return (torch.zeros_like(b) if xcur is None else xcur), r
    d = block(r, c2=sched[0, 1])
    xnew = torch.empty_like(b)
    rnew = torch.empty_like(b) if r is b else r
    for i in range(steps):
        # x <- x + d and r <- r - A d in one K1 launch
        apply(d, rin=r, out=rnew, xin=xcur, xout=xnew)
        r, xcur = rnew, xnew
        if i + 1 < steps:  # the last direction would go unused
            block(r, d=d, c1=sched[i + 1, 0], c2=sched[i + 1, 1])
    return xcur, r


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
    factored: bool = False,
):
    """`chebyshev_smooth_op` on the assembled stencil (`stencil_apply`, K1)
    and the blocks binv, B^-1 (`block_apply`, K2) or with `factored` the
    factor W (`factored_block_apply`, K3).  The kernel tests' entry point,
    for operands given directly; the solver composes `chebyshev_smooth_op`
    with its own level closures (`MultigridSolver._smooth`)."""
    blk = factored_block_apply if factored else block_apply
    return chebyshev_smooth_op(
        lambda v, **ep: stencil_apply(desc, coef, v, **ep),
        lambda r, **ep: blk(binv, r, nt, **ep), b, x, sched, steps, x0_zero)


def jacobi_smooth(apply, block, b, x, steps: int, w: float, x0_zero: bool = False,
                  want_residual: bool = False):
    """`steps` weighted block-Jacobi iterations r = b - A x, x <- x + w B^-1 r
    from x (ignored when x0_zero; A 0 = 0 takes no apply); `apply` and
    `block` as in `chebyshev_smooth_op`.  Returns x, and with
    want_residual also b - A x, recomputed.  Neither b nor x is written."""
    wv = torch.full((b.shape[0],), w, dtype=b.dtype, device=b.device)
    one = torch.ones_like(wv)
    x = None if x0_zero else x.clone()
    for _ in range(steps):
        if x is None:
            x = block(b, c2=wv)
        else:
            block(apply(x, rin=b), d=x, c1=one, c2=wv)
    if x is None:
        x = torch.zeros_like(b)
    if want_residual:
        return x, apply(x, rin=b)
    return x
