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
persistent CTAs that stream the blocks through a shared-memory ring, each
block by a bulk copy whatever its alignment; their launch geometry
(`line_block_geometry`) and column walk (`line_block_walk`, at most 2-way
bank-conflicted) are computed here from the shapes and the card's SM
count.  A block wider than the streamed kernels' crossover (bw > 137 in
f32, > 240 in bf16, > 168 for K3) takes a row-tiled kernel: K2 the panel
kernel (units of one item's panel of rows), K3 the cluster kernel (a
thread-block cluster holds the block, so W is read once) or, past 8 CTAs'
shared memory, the two-sweep one.

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
each grid point) are time lines of length 1 in this layout (nt = 1, bw =
n_mi).  There the items are contiguous in the blocks and the vectors, and
`block_apply` and `factored_block_apply` launch the point-block kernels of
csrc/point_block.cu, which stream tiles of many blocks per ring stage
(`point_block_geometry`); every launch with nt > 1 takes the line kernels.

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
from typing import NamedTuple, Optional

import numpy as np
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
    K2 (its point-block kernel where `point_path(nt, bw)`); CPU tensors run
    the plain version.  K2 takes any bw: a block wider than the streamed
    kernel's crossover (bw > 137 in float32, > 240 in bfloat16) takes the
    panel kernel, whose units are (item, panel of rows) pairs
    (`line_block_geometry`)."""
    if binv.is_cuda:
        kernels = _K2_FN.get(binv.dtype)
        if kernels is None:
            raise ValueError(f"block_apply: K2 takes a float32 or bfloat16 B^-1, got {binv.dtype}")
        return _launch_line_block(kernels, binv, r, nt, d, c1, c2)
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
    vectors and epilogue as `block_apply`.  CUDA tensors launch kernel K3
    (its point-block kernel where `point_path(nt, bw)`); CPU tensors run the
    plain version.

    Contract: W is upper-triangular, with an exactly zero strict lower
    triangle (the solver stores L^-T with `.triu()`).  K3 reads only the
    upper triangle; the plain version reads all of W.  K3 takes any bw: a
    block with bw > 168 is held by a thread-block cluster of up to 8 CTAs,
    which read W once (to bw 916), and a wider one streams in panels of
    rows, twice (`line_block_geometry`)."""
    if w.is_cuda:
        if w.dtype != torch.bfloat16:
            raise ValueError(f"factored_block_apply: K3 takes a bfloat16 W, got {w.dtype}")
        return _launch_line_block(_K3_FN, w, r, nt, d, c1, c2)
    if w.device.type != "cpu":
        raise ValueError(f"factored_block_apply: unsupported device {w.device}")
    return factored_block_apply_plain(w, r, nt, d, c1, c2)


class _Kernels(NamedTuple):
    """A block apply's launchers and launch-count names: the line kernels
    (csrc/line_block.cu; one launcher, counted by the kernel its geometry's
    route takes) and the point-block ones (csrc/point_block.cu)."""

    line_fn: str
    line_counted: dict
    point_fn: str
    point_counted: str
    factored: bool


# stored block dtype -> K2's kernels
_K2_FN = {
    torch.float32: _Kernels("k2_line_block_apply_f32",
                            {"streamed": "k2_line_block_apply",
                             "panels": "k2_line_block_apply_panels"},
                            "k2_point_block_apply_f32", "k2_point_block_apply", False),
    torch.bfloat16: _Kernels("k2_line_block_apply_bf16",
                             {"streamed": "k2_line_block_apply_bf16",
                              "panels": "k2_line_block_apply_panels_bf16"},
                             "k2_point_block_apply_bf16", "k2_point_block_apply_bf16", False),
}
_K3_FN = _Kernels("k3_factored_line_block_apply_bf16",
                  {"streamed": "k3_factored_line_block_apply",
                   "cluster": "k3_factored_line_block_apply_cluster",
                   "two_sweep": "k3_factored_line_block_apply_tiled"},
                  "k3_point_block_apply_bf16", "k3_point_block_apply", True)

# Hopper SM shared memory: 227 KB a block may use, 228 KB an SM holds with
# 1 KB reserved per resident block
_SMEM_PER_BLOCK = 232448
_SMEM_PER_SM = 233472
_SMEM_RESERVED = 1024
# the streamed ring: CTAs per SM and stages per CTA.  A CTA computes one
# item at a time, so the CTAs per SM set how many items' shared-memory reads
# overlap; 2 stages let each CTA's next block load while one is computed on
_CTAS_PER_SM = 8
_STAGES = 2
# the widest block each streamed kernel takes, by (entry bytes, factored); a
# wider one takes a row-tiled kernel.  tools/line_block_sweep.py --mid on an
# H100 (bs 8 x 256 lines, bw 40 to 238): K2 f32 streamed while the SM keeps
# 2 blocks in flight (2 CTAs of 2 stages, one of 3: bw 137), the panel
# kernel beyond; K2 bf16 streamed wherever one CTA holds 2 stages (bw 240:
# it beat the panel kernel at every width swept); K3 streamed while 2 CTAs
# hold 2 stages (bw 168), the cluster kernel beyond
_STREAMED_MAX_BW = {(4, False): 137, (2, False): 240, (2, True): 168}
# a streamed CTA alone on its SM takes up to this many stages
_STREAMED_MAX_STAGES = 3
# the bytes of blocks (or panels) in flight per SM that the ring keeps while
# each CTA computes on one, where shared memory allows
_BYTES_IN_FLIGHT = 32 * 1024
# the row-tiled kernels' panels: a multiple of 8 rows (so a panel's bytes
# are a multiple of 16)
_PANEL_ROW_STEP = 8
# the panel kernel (K2): a consumer warp per _ROWS_PER_WARP panel rows, at
# most _PANEL_MAX_ROWS rows (6 consumer warps), _PANEL_CTAS_PER_SM CTAs an
# SM of _PANEL_STAGES stages each, more stages where that keeps less than
# _BYTES_IN_FLIGHT in flight, up to _PANEL_MAX_STAGES
# (tools/line_block_sweep.py at bw 350, bs 8 x 1024 lines, on an H100: the
# fastest geometry it tries in bf16, within 4 % of the fastest in f32)
_ROWS_PER_WARP = 4
_PANEL_MAX_ROWS = 24
_PANEL_CTAS_PER_SM = 3
_PANEL_STAGES = 2
_PANEL_MAX_STAGES = 4
# the cluster kernel (K3): at most _MAX_CLUSTER CTAs a cluster (the portable
# limit), at most _CLUSTER_CTAS_PER_SM CTAs an SM, one stage each, but 2
# stages in clusters of 2 where _CLUSTER_CTAS_PER_SM CTAs an SM hold them
# (mid widths, bw 169 to 190: tools/line_block_sweep.py --mid)
_MAX_CLUSTER = 8
_CLUSTER_CTAS_PER_SM = 3
# the two-sweep K3 (blocks too wide for a cluster): the most CTAs per SM
# whose panels still hold one full warp of rows
_PANEL_MIN_ROWS = 32


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class LineBlockGeometry:
    """Launch geometry of K2/K3 (csrc/line_block.cu): `ctas` persistent CTAs,
    each with a ring of `stages` stages in `smem_bytes` of dynamic shared
    memory.  `route` names the kernel, which follows from the launch's rows
    (`line_block_route`):
      "streamed"  (panel_rows == bw) a stage holds a whole block; one
                  producer warp and ceil(bw/32) consumer warps; CTA c takes
                  the items (sample, line) c, c + ctas, ... of the bs*S;
                  `walk` is the consumers' column walk (`line_block_walk`);
      "panels"    K2 row-tiled: a stage holds a panel of `panel_rows` rows
                  and r's line; one producer warp and a consumer warp per 4
                  panel rows; CTA c takes the units (item, panel) c,
                  c + ctas, ... of the bs*S*ceil(bw/panel_rows);
      "cluster"   K3 row-tiled: clusters of `cluster` = ceil(bw/panel_rows)
                  CTAs, CTA k of a cluster holding rows k*panel_rows, ... of
                  its item's block (W read once); one producer and 8
                  consumer warps; cluster c takes the items c, c + clusters,
                  ... (the launcher caps the clusters at those resident at
                  once);
      "two_sweep" K3 at blocks too wide for a cluster: a stage holds a panel
                  of `panel_rows` rows, streamed twice per item; one
                  producer warp and ceil(panel_rows/32) consumer warps.
    `bulk`: each block or panel is moved by one 1-D bulk copy (the streamed,
    panel and cluster kernels: of the whole block where it is 16-byte
    aligned, else of its 16-byte-aligned interior, at any alignment of the
    entries); else (the two-sweep kernel only) its own load path copies it.
    `smem_bytes` is the layout for a 16-byte-aligned pointer
    (`line_block_launch_args` adds the room a misaligned one needs)."""

    ctas: int
    stages: int
    smem_bytes: int
    bulk: bool
    panel_rows: int
    route: str = "streamed"
    cluster: int = 1
    walk: int = 0


def line_block_route(bw: int, rows: Optional[int], factored: bool) -> str:
    """The kernel a launch of block width bw and `rows` takes (`route_of` in
    line_block.cu): "streamed" where rows is None or bw, else "panels" for
    K2, and for K3 "cluster" where ceil(bw / rows) <= _MAX_CLUSTER CTAs
    hold the block, else "two_sweep".  Which rows a width gets, and so the
    crossover from the streamed kernels to the row-tiled ones, is
    `line_block_geometry`'s."""
    if rows is None or rows >= bw:
        return "streamed"
    if not factored:
        return "panels"
    return "cluster" if -(-bw // rows) <= _MAX_CLUSTER else "two_sweep"


def line_block_smem_bytes(bw: int, stages: int, entry_bytes: int, factored: bool,
                          rows: Optional[int] = None, whole: Optional[bool] = None) -> int:
    """The shared-memory layout of the kernel `line_block_route` picks.
    Streamed (`make_layout` in line_block.cu): 2 mbarriers per stage, K3's
    double-buffered f32 u, and per stage the block and r's line, each padded
    to 16 bytes, the block with 16 more for its shift unless every block is
    16-byte aligned (`whole`; None: the block's bytes are a multiple of 16,
    as for a 16-byte-aligned pointer).  Panels (`make_panel_layout`): the
    mbarriers, and per stage a panel of `rows` block rows padded to 16 bytes
    plus 16 for its shift, and r's line.  Cluster (`make_cluster_layout`,
    bf16): the mbarriers and 2 more, the double-buffered partial u (bw f32),
    u, d's old entries of the CTA's rows (double-buffered), and per stage
    the CTA's rows (plus 16 bytes) and their r.  Two-sweep
    (`make_tiled_layout`): the mbarriers, K3's u, r's line double-buffered,
    and per stage a panel of `rows`."""
    route = line_block_route(bw, rows, factored)
    if route == "streamed":
        bb = bw * bw * entry_bytes
        if whole is None:
            whole = bb % 16 == 0
        u = _pad16(2 * 4 * bw) if factored else 0
        stage = _pad16(bb) + (0 if whole else 16) + _pad16(4 * bw)
        return 16 * stages + u + stages * stage
    if route == "panels":
        return 16 * stages + stages * (_pad16(rows * bw * entry_bytes) + 16 + _pad16(4 * bw))
    if route == "cluster":
        stage = _pad16(rows * bw * 2) + 16 + _pad16(4 * rows)
        return (16 * stages + 16 + _pad16(2 * 4 * bw) + _pad16(4 * bw) + _pad16(2 * 4 * rows)
                + stages * stage)
    return _two_sweep_smem_bytes(bw, rows, stages, entry_bytes)


def _two_sweep_smem_bytes(bw: int, rows: int, stages: int, entry_bytes: int) -> int:
    return (16 * stages + _pad16(2 * 4 * bw) + _pad16(2 * 4 * bw)
            + stages * _pad16(rows * bw * entry_bytes))


# ---- shared-memory banks of the streamed kernels' column walks

def _bank_ways(addr: np.ndarray, live: np.ndarray) -> int:
    """The most distinct 4-byte words any of the 32 banks is asked for by one
    warp-wide load (one word read by several lanes is a broadcast), over the
    loads of `addr` (..., 32 lanes: byte addresses; `live` marks the lanes
    that load)."""
    addr, live = np.broadcast_arrays(addr, live)
    addr, live = addr.reshape(-1, addr.shape[-1]), live.reshape(-1, addr.shape[-1])
    words = addr // 4
    # an idle lane asks a bank of its own (33, 34, ...) for one word
    bank = np.where(live, words % 32, 33 + np.arange(addr.shape[-1]))
    key = np.sort(bank * (1 << 40) + np.where(live, words, 0), axis=1)
    new_word = np.ones(key.shape, dtype=bool)
    new_word[:, 1:] = key[:, 1:] != key[:, :-1]
    new_bank = np.ones(key.shape, dtype=bool)
    new_bank[:, 1:] = (key[:, 1:] >> 40) != (key[:, :-1] >> 40)
    seen = np.cumsum(new_word, axis=1)
    before = np.maximum.accumulate(np.where(new_bank, seen - 1, 0), axis=1)
    return int((seen - before).max())


def line_block_bank_ways(bw: int, entry_bytes: int, factored: bool, walk: int) -> int:
    """The worst shared-memory bank conflict (ways; 1 is conflict-free) of the
    streamed kernel's consumer loads at block width bw with column walk
    `walk`, over every warp, every step of the walk and every placement of
    the block in its stage (its address mod 16, a multiple of the entry's
    bytes; placements a whole word apart shift every bank alike).  Lane l of
    warp w is consumer thread i = 32 w + l (block row or column i), and the
    lanes take step q together:
      K2 (`walk` a): thread i reads B[i, c] and r[c], c = (a i + q) mod bw;
      K3 pass 1: thread j reads W[q, j] for q <= j (r[q] is a broadcast);
      K3 pass 2: thread i reads W[i, c] and u[c] for c >= i, c = i + q
                 (walk 0, from the diagonal up) or bw - 1 - q (walk 1, from
                 the last column down)."""
    q = np.arange(bw)[:, None]
    shifts = (0,) if entry_bytes % 4 == 0 else range(0, 4, entry_bytes)
    worst = 1
    for w0 in range(0, bw, 32):
        i = np.arange(w0, w0 + 32)[None, :]
        row = i < bw
        for shift in shifts:
            if not factored:
                col = (walk * i % bw + q) % bw
                worst = max(worst, _bank_ways(shift + (i * bw + col) * entry_bytes, row),
                            _bank_ways(col * 4, row))
                continue
            worst = max(worst, _bank_ways(shift + (q * bw + i) * entry_bytes, row & (q <= i)))
            col = i + q if walk == 0 else bw - 1 - q + 0 * i
            live = row & (col >= i) & (col < bw)
            worst = max(worst, _bank_ways(shift + (i * bw + col) * entry_bytes, live),
                        _bank_ways(col * 4, live))
    return worst


# K2's skews in order of preference (1, the walk the GL shapes were tuned
# with, first; one of the three is at most 2-way at every streamed width),
# and K3's pass-2 walks (0, from the diagonal up, first)
_K2_WALKS = (1, 0, 3)
_K3_WALKS = (0, 1)


@functools.lru_cache(maxsize=256)
def line_block_walk(bw: int, entry_bytes: int, factored: bool) -> int:
    """The streamed kernel's column walk at block width bw: the first of
    _K2_WALKS (K2) or _K3_WALKS (K3's pass 2) whose loads are at most 2-way
    bank-conflicted (`line_block_bank_ways`), else the least conflicted.
    K2 keeps thread i's start at column i (a = 1) at most widths, starts
    every thread at column 0 where that conflicts and this does not (in
    f32 at bw = 3 (mod 4): B[i, q] is i bw + q words apart, a bank of its
    own per thread at an odd bw), and skews by 3 at six bf16 widths (72,
    80, 136, 144, 200, 208); K3's pass 2 walks down from the last column at
    bw = 7 (mod 8), whose rows are bw + 1 entries apart from diagonal to
    diagonal (88 words at bw 175)."""
    walks = _K3_WALKS if factored else _K2_WALKS
    ways = {}
    for walk in walks:
        ways[walk] = line_block_bank_ways(bw, entry_bytes, factored, walk)
        if ways[walk] <= 2:
            return walk
    return min(walks, key=lambda w: ways[w])


def _most_stages(bw, rows, entry_bytes, factored, budget, most):
    """The most stages (<= most) of the layout at `rows` within budget; 0 if
    not even one fits."""
    stages = most
    while stages and line_block_smem_bytes(bw, stages, entry_bytes, factored, rows) > budget:
        stages -= 1
    return stages


def _streamed_geometry(bs, S, bw, entry_bytes, n_sm, factored):
    """The streamed kernels, or None past _STREAMED_MAX_BW or where one CTA
    does not hold _STAGES stages: up to _CTAS_PER_SM CTAs an SM of _STAGES
    stages each, or a CTA alone on its SM of up to _STREAMED_MAX_STAGES;
    the column walk of `line_block_walk`."""
    if bw > _STREAMED_MAX_BW.get((entry_bytes, factored), bw):
        return None
    per_sm = min(_CTAS_PER_SM, _SMEM_PER_SM // (
        line_block_smem_bytes(bw, _STAGES, entry_bytes, factored) + _SMEM_RESERVED))
    budget = min(_SMEM_PER_SM - _SMEM_RESERVED, _SMEM_PER_BLOCK)
    stages = _STAGES if per_sm > 1 else _most_stages(bw, None, entry_bytes, factored, budget,
                                                     _STREAMED_MAX_STAGES)
    if stages < _STAGES:
        return None
    return LineBlockGeometry(ctas=min(bs * S, n_sm * max(per_sm, 1)), stages=stages,
                             smem_bytes=line_block_smem_bytes(bw, stages, entry_bytes, factored),
                             bulk=True, panel_rows=bw,
                             walk=line_block_walk(bw, entry_bytes, factored))


def _panel_geometry(bs, S, bw, entry_bytes, n_sm):
    """K2's panel kernel: the most rows (a multiple of _PANEL_ROW_STEP, at
    most _PANEL_MAX_ROWS) at which _PANEL_CTAS_PER_SM CTAs an SM hold
    _PANEL_STAGES stages each, then 2 CTAs, then 1; a block too wide for 8
    rows (about bw > 3,200 in f32) takes fewer rows, then 1 stage.  Where
    the CTAs an SM keep less than _BYTES_IN_FLIGHT of panels in flight
    ((stages - 1) each), more stages, as many as fit up to
    _PANEL_MAX_STAGES."""
    def fits(rows, stages):
        return _most_stages(bw, rows, entry_bytes, False, budget, stages) == stages

    for per_sm in range(_PANEL_CTAS_PER_SM, 0, -1):
        budget = min(_SMEM_PER_SM // per_sm - _SMEM_RESERVED, _SMEM_PER_BLOCK)
        rows = next((r for r in range(_PANEL_MAX_ROWS, 0, -_PANEL_ROW_STEP)
                     if fits(r, _PANEL_STAGES)), 0)
        if rows:
            break
    else:
        rows = next((r for want in (_PANEL_STAGES, 1) for r in range(_PANEL_ROW_STEP - 1, 0, -1)
                     if fits(r, want)), 0)
        if not rows:
            raise ValueError(f"line_block_geometry: bw={bw} leaves no room for a panel row")
    stages = _most_stages(bw, rows, entry_bytes, False, budget, _PANEL_STAGES)
    want = 1 + -(-_BYTES_IN_FLIGHT // (per_sm * rows * bw * entry_bytes))
    if stages == _PANEL_STAGES and want > stages:
        stages = _most_stages(bw, rows, entry_bytes, False, budget, min(want, _PANEL_MAX_STAGES))
    units = bs * S * -(-bw // rows)
    return LineBlockGeometry(ctas=min(units, n_sm * per_sm), stages=stages,
                             smem_bytes=line_block_smem_bytes(bw, stages, entry_bytes, False, rows),
                             bulk=True, panel_rows=rows, route="panels")


def _cluster_geometry(bs, S, bw, n_sm):
    """K3's cluster kernel, or None where no cluster of _MAX_CLUSTER CTAs
    holds the block.  A CTA computes one item at a time, and each item's
    sweeps wait on the cluster's slowest CTA, so a CTA's time per item is
    latency more than bytes: one stage a CTA (its next item loads while the
    other CTAs on its SM compute), the most CTAs an SM (at most
    _CLUSTER_CTAS_PER_SM), and at that the smallest cluster C (rows a
    multiple of 8, at least bw / C), so the most clusters are resident.  At
    bw 350: C 4 of 88 rows (67 KB), 3 CTAs an SM.  But where clusters of 2
    hold the block in 2 stages, _CLUSTER_CTAS_PER_SM an SM (bw 169 to 190),
    those: an item's rows load while the CTA computes on the last's (bw 175:
    88 rows, 69 KB)."""
    rows = _PANEL_ROW_STEP * -(-bw // (2 * _PANEL_ROW_STEP))
    smem = line_block_smem_bytes(bw, 2, 2, True, rows)
    if rows < bw and _CLUSTER_CTAS_PER_SM * (smem + _SMEM_RESERVED) <= _SMEM_PER_SM:
        return LineBlockGeometry(ctas=2 * min(bs * S, n_sm * _CLUSTER_CTAS_PER_SM // 2), stages=2,
                                 smem_bytes=smem, bulk=True, panel_rows=rows, route="cluster",
                                 cluster=2)
    for per_sm in range(_CLUSTER_CTAS_PER_SM, 0, -1):
        budget = min(_SMEM_PER_SM // per_sm - _SMEM_RESERVED, _SMEM_PER_BLOCK)
        for c in range(2, _MAX_CLUSTER + 1):
            rows = _PANEL_ROW_STEP * -(-bw // (_PANEL_ROW_STEP * c))
            smem = line_block_smem_bytes(bw, 1, 2, True, rows)
            if rows < bw and smem <= budget:
                cluster = -(-bw // rows)
                return LineBlockGeometry(ctas=cluster * min(bs * S, n_sm * per_sm // cluster),
                                         stages=1, smem_bytes=smem, bulk=True, panel_rows=rows,
                                         route="cluster", cluster=cluster)
    return None


def _two_sweep_rows(bw: int, stages: int, entry_bytes: int, budget: int) -> int:
    """The most panel rows (< bw; a multiple of _PANEL_ROW_STEP where that
    leaves any) whose two-sweep layout fits `budget` bytes; 0 if none."""
    fixed = _two_sweep_smem_bytes(bw, 0, stages, entry_bytes)
    rows = min(bw - 1, max(0, (budget - fixed) // (stages * bw * entry_bytes)))
    if rows >= _PANEL_ROW_STEP:
        rows -= rows % _PANEL_ROW_STEP
    while rows > 0 and _two_sweep_smem_bytes(bw, rows, stages, entry_bytes) > budget:
        rows -= 1
    return rows


def _two_sweep_geometry(bs, S, bw, entry_bytes, n_sm):
    """The two-sweep K3: _STAGES stages of panels, the most CTAs per SM
    whose panels hold _PANEL_MIN_ROWS rows (else one CTA, and one stage if
    two do not fit)."""
    stages = _STAGES
    for per_sm in range(_CTAS_PER_SM, 0, -1):
        budget = min(_SMEM_PER_SM // per_sm - _SMEM_RESERVED, _SMEM_PER_BLOCK)
        rows = _two_sweep_rows(bw, stages, entry_bytes, budget)
        if rows >= _PANEL_MIN_ROWS:
            break
    if rows < 1:
        stages = 1
        rows = _two_sweep_rows(bw, stages, entry_bytes, _SMEM_PER_BLOCK)
    if rows < 1:
        raise ValueError(f"line_block_geometry: bw={bw} leaves no room for a panel row")
    if line_block_route(bw, rows, True) != "two_sweep":
        raise ValueError(f"line_block_geometry: bw={bw} two-sweep panels of {rows} rows would "
                         "take the cluster kernel")
    bulk = bw * bw * entry_bytes % 16 == 0 and rows * bw * entry_bytes % 16 == 0
    return LineBlockGeometry(ctas=min(bs * S, n_sm * per_sm), stages=stages,
                             smem_bytes=_two_sweep_smem_bytes(bw, rows, stages, entry_bytes),
                             bulk=bulk, panel_rows=rows, route="two_sweep")


@functools.lru_cache(maxsize=64)
def line_block_geometry(bs: int, S: int, bw: int, entry_bytes: int, n_sm: int,
                        factored: bool = False) -> LineBlockGeometry:
    """Choose K2/K3's launch geometry for bs*S blocks of bw x bw entries of
    `entry_bytes` on a card of `n_sm` SMs.  A block up to the streamed
    kernels' crossover (_STREAMED_MAX_BW: bw <= 137 in f32, <= 240 in bf16,
    <= 168 for K3) takes the streamed kernels (`_streamed_geometry`: up to
    _CTAS_PER_SM CTAs an SM of _STAGES stages, a lone CTA up to 3; the
    column walk of `line_block_walk`; the GL shapes 8 CTAs of 2); a wider
    block takes a row-tiled kernel, by width alone (no launch falls back to
    another):
      - K2: the panel kernel (`_panel_geometry`: panels of 24 rows or fewer,
        3 CTAs an SM of 2 stages each, more stages where they keep less
        than 32 KB in flight; 24 rows at bw 175, 280 and 350);
      - K3: the cluster kernel where at most 8 CTAs hold a block
        (`_cluster_geometry`: 2 CTAs of 2 stages, 3 an SM, at bw 169 to
        190, bw 175: 88 rows; else one stage a CTA, the most CTAs an SM up
        to 3, then the smallest cluster, bw 350: 4 CTAs of 88 rows, 3 an
        SM), which is up to bw 916 (8 CTAs, one an SM); a wider block takes
        the two-sweep kernel (`_two_sweep_geometry`), which reads W twice.
    Raises ValueError for a bad shape, and for a bw so large that r's line
    (and K3's u) leave no room for one row: above about 12,900 for K3,
    19,300 for K2 in f32."""
    if min(bs, S, bw, entry_bytes, n_sm) < 1:
        raise ValueError(f"line_block_geometry: bad shape bs={bs} S={S} bw={bw} n_sm={n_sm}")
    geo = _streamed_geometry(bs, S, bw, entry_bytes, n_sm, factored)
    if geo is not None:
        return geo
    if not factored:
        return _panel_geometry(bs, S, bw, entry_bytes, n_sm)
    return (_cluster_geometry(bs, S, bw, n_sm)
            or _two_sweep_geometry(bs, S, bw, entry_bytes, n_sm))


def line_block_launch_args(geo: LineBlockGeometry, bw: int, entry_bytes: int, factored: bool,
                           ptr: int):
    """(smem_bytes, flags) of a launch of `geo` on blocks at address ptr.  The
    C launcher's `flags`: bit 0 `whole` (every block, or the two-sweep
    kernel's every panel, 16-byte aligned: its bytes a multiple of 16 at a
    16-byte-aligned ptr) and, above it, the streamed walk.  A streamed
    launch whose blocks are not all aligned lays out 16 more bytes a stage
    for the shift."""
    if geo.route == "two_sweep":
        return geo.smem_bytes, int(geo.bulk and ptr % 16 == 0)
    if geo.route != "streamed":
        return geo.smem_bytes, 0
    whole = bw * bw * entry_bytes % 16 == 0 and ptr % 16 == 0
    return (line_block_smem_bytes(bw, geo.stages, entry_bytes, factored, whole=whole),
            int(whole) | geo.walk << 1)


# point blocks: the widths csrc/point_block.cu instantiates (n_mi of
# VariableSet's six layouts: order 1 or 2 in 1, 2 or 3 coordinates)
POINT_WIDTHS = (2, 3, 4, 5, 7)
# the point kernels' tiles: a multiple of 32 items (so a full tile's blocks
# and r are multiples of 16 bytes in f32 and bf16 and take the bulk copy),
# at most this many block rows (consumer threads) a tile
_POINT_MAX_CONSUMERS = 256
# CTAs per SM (the kernels' __launch_bounds__), the most stages, and the
# bytes of blocks the stages keep in flight per SM at least, where the
# stage count allows
_POINT_CTAS_PER_SM = 4
_POINT_MAX_STAGES = 8
_POINT_BYTES_IN_FLIGHT = 64 * 1024


def point_path(nt: int, bw: int) -> bool:
    """Whether a block apply launches the point-block kernels: nt == 1 (the
    solver's point blocks; its time lines span at least 6 positions) at a
    width they instantiate.  A one-position block of another width, which
    the solver never makes, keeps the line kernels."""
    return nt == 1 and bw in POINT_WIDTHS


@dataclasses.dataclass(frozen=True)
class PointBlockGeometry:
    """Launch geometry of the point-block kernels (csrc/point_block.cu):
    `ctas` persistent CTAs of one producer warp and `tile * bw` consumer
    threads, each with a ring of `stages` stages of `tile` consecutive items
    in `smem_bytes` of dynamic shared memory; CTA c takes the tiles c,
    c + ctas, ... of the ceil(bs*N / tile) tiles, the last one partial
    where tile does not divide bs*N.  `bulk`: a full
    tile's blocks and r are each moved by one 1-D bulk copy (their bytes
    and offsets multiples of 16); the partial tile, or every tile where
    this is false, takes the kernels' own load path."""

    tile: int
    ctas: int
    stages: int
    smem_bytes: int
    bulk: bool


def point_block_smem_bytes(bw: int, tile: int, stages: int, entry_bytes: int,
                           factored: bool) -> int:
    """The point kernels' shared-memory layout (`make_layout` in
    point_block.cu): 2 mbarriers per stage, K3's double-buffered f32 u of a
    tile, and per stage the tile's blocks and its r, each padded to 16
    bytes."""
    u = _pad16(2 * 4 * tile * bw) if factored else 0
    stage = _pad16(tile * bw * bw * entry_bytes) + _pad16(4 * tile * bw)
    return 16 * stages + u + stages * stage


@functools.lru_cache(maxsize=64)
def point_block_geometry(bs: int, N: int, bw: int, entry_bytes: int, n_sm: int,
                         factored: bool = False) -> PointBlockGeometry:
    """Choose the point kernels' launch geometry for bs*N point blocks of
    bw x bw entries of `entry_bytes` on a card of `n_sm` SMs: tiles of 32
    items (64 at bw 3 and 4, 128 at bw 2: at most _POINT_MAX_CONSUMERS
    rows), _POINT_CTAS_PER_SM CTAs per SM, and the fewest stages (at most
    _POINT_MAX_STAGES) that keep _POINT_BYTES_IN_FLIGHT of blocks per SM
    in flight while each CTA computes on one.  Raises ValueError for a bad
    shape or a width the kernels do not instantiate."""
    if min(bs, N, n_sm) < 1 or entry_bytes not in (2, 4):
        raise ValueError(f"point_block_geometry: bad shape bs={bs} N={N} n_sm={n_sm} "
                         f"entry_bytes={entry_bytes}")
    if bw not in POINT_WIDTHS:
        raise ValueError(f"point_block_geometry: bw={bw} is not a point width {POINT_WIDTHS}")
    tile = 32 * max(1, _POINT_MAX_CONSUMERS // (32 * bw))
    tile_bytes = tile * bw * bw * entry_bytes
    in_flight = -(-_POINT_BYTES_IN_FLIGHT // (_POINT_CTAS_PER_SM * tile_bytes))
    stages = min(_POINT_MAX_STAGES, 1 + in_flight)
    tiles = -(-bs * N // tile)
    return PointBlockGeometry(
        tile=tile, ctas=min(tiles, n_sm * _POINT_CTAS_PER_SM), stages=stages,
        smem_bytes=point_block_smem_bytes(bw, tile, stages, entry_bytes, factored),
        bulk=tile_bytes % 16 == 0 and 4 * tile * bw % 16 == 0)


def block_apply_route(blocks: torch.Tensor, nt: int, factored: bool) -> str:
    """The route a block apply of `blocks` (bs, S, bw, bw) takes: "plain"
    off CUDA (the plain versions), "point" on the point-block kernels
    (`point_path`), else the line kernel that `line_block_geometry` picks
    ("streamed", "panels", "cluster" or "two_sweep"; `line_block_route`)."""
    if not blocks.is_cuda:
        return "plain"
    bs, S, bw, _ = blocks.shape
    if point_path(nt, bw):
        return "point"
    return line_block_geometry(bs, S, bw, blocks.element_size(), _cuda.sm_count(blocks.device),
                               factored).route


def _launch_line_block(kernels, blocks, r, nt, d, c1, c2):
    """Check the operands of a block apply and launch its kernel: the
    point-block one where `point_path(nt, bw)`, else the line one."""
    bs, S, bw, bw2 = blocks.shape
    fn = kernels.line_fn
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
    n_sm = _cuda.sm_count(blocks.device)
    stream = _cuda.stream_ptr(blocks.device)
    if point_path(nt, bw):
        geom = point_block_geometry(bs, S, bw, blocks.element_size(), n_sm, kernels.factored)
        bulk = geom.bulk and blocks.data_ptr() % 16 == 0 and r.data_ptr() % 16 == 0
        code = getattr(_cuda.library("point_block"), kernels.point_fn)(
            blocks.data_ptr(), r.data_ptr(), d.data_ptr(), _cuda.ptr(c1), _cuda.ptr(c2),
            bw, S, bs, geom.ctas, geom.tile, geom.stages, geom.smem_bytes, int(bulk), stream)
        _cuda.check("point_block", kernels.point_counted, code)
        return d
    eb = blocks.element_size()
    geom = line_block_geometry(bs, S, bw, eb, n_sm, kernels.factored)
    smem, flags = line_block_launch_args(geom, bw, eb, kernels.factored, blocks.data_ptr())
    code = getattr(_cuda.library("line_block"), fn)(
        blocks.data_ptr(), r.data_ptr(), d.data_ptr(), _cuda.ptr(c1), _cuda.ptr(c2),
        m, nt, S, bs, geom.ctas, geom.panel_rows, geom.stages, smem, flags, stream,
    )
    _cuda.check("line_block", kernels.line_counted[geom.route], code)
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
