"""Assembled block-stencil normal operator AtA, and kernel K1 that applies it.

Every constraint row couples variables along at most one coordinate axis, so
(AtA)[(p,i),(q,j)] is nonzero only for q = p + delta * e_c with |delta| <= 4,
and the only channel pairs at delta != 0 are (value, value), (value,
deriv_c) and (deriv_c, value).  AtA is assembled once per solve into

  coef[b, ch, point] (channel-major) with channels =
      [ dense n_mi x n_mi offset-0 block (row-major) |
        per axis c, per delta in 1..4:
            vv   : (value@p,   value@p+d)
            vd_k : (value@p,   deriv_k@p+d)   k over central_mi_indices(c)
            dv_k : (deriv_k@p, value@p+d) ]

Band fields are stored on the full grid and are zero wherever the coupling
does not exist (every point whose axis-c index exceeds d-1-delta), so shifted
multiply-adds on the C-order flat grid never pick up contributions across
axis edges.  Symmetry is applied, not stored: each band entry acts in both
directions.

`stencil_apply` is the one entry point for y = (AtA) x.  On CUDA tensors it
launches kernel K1 (csrc/stencil_apply.cu), which replaces the TPU kernel
`_stencil_kernel_body` of mech_nn_discovery_pde_tpu/ops/normal_stencil.py;
on CPU tensors it runs `stencil_apply_plain`, the same gather form written
as a few whole-tensor PyTorch gathers.  Both carry the same epilogue
(residual update, iterate update).  K1 is compiled for each (n_coord,
order) layout (`K1_LAYOUTS`) with every channel index a constant;
`k1_layout_args` checks a descriptor against that layout before the first
launch, and `stencil_geometry` picks the points per thread and the grid.
The stored fields may be bfloat16 (mg_precond_dtype='bf16') with float32
vectors: K1 widens each coefficient in-register, the plain version upcasts
the fields first; every sum is float32.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mech_nn_discovery_pde_torch.ops import _cuda
from mech_nn_discovery_pde_torch.ops.constraints import ConstraintSpec, _point_strides
from mech_nn_discovery_pde_torch.ops.structured import StructuredValues, _shift_slices

MAX_DELTA = 4  # largest axis offset in AtA (one-sided 5-point edge stencils)


class Band(NamedTuple):
    coord: int
    delta: int
    stride: int  # flat grid-point stride = delta * stride_c
    kind: str  # 'vv' | 'vd' | 'dv'
    mi_k: int  # deriv channel (unused for 'vv')
    ch: int  # channel index in coef


class NormalStencilDesc(NamedTuple):
    coord_dims: Tuple[int, ...]
    n_mi: int
    grid_size: int
    n_channels: int
    bands: Tuple[Band, ...]


def make_desc(spec: ConstraintSpec) -> NormalStencilDesc:
    if spec.evolution:
        raise NotImplementedError(
            "evolution=True equation rows reference the previous time step; "
            "the assembled block-stencil normal operator assumes same-point "
            "equation entries"
        )
    vs = spec.var_set
    m = vs.n_mi
    strides = _point_strides(spec.coord_dims)
    ch = m * m
    bands: List[Band] = []
    for c in range(vs.n_coord):
        for delta in range(1, MAX_DELTA + 1):
            s = int(delta * strides[c])
            bands.append(Band(c, delta, s, "vv", 0, ch))
            ch += 1
            for mik in vs.central_mi_indices(c):
                bands.append(Band(c, delta, s, "vd", mik, ch))
                ch += 1
                bands.append(Band(c, delta, s, "dv", mik, ch))
                ch += 1
    return NormalStencilDesc(
        coord_dims=tuple(spec.coord_dims),
        n_mi=m,
        grid_size=vs.grid_size,
        n_channels=ch,
        bands=tuple(bands),
    )


def _band_channel(desc: NormalStencilDesc, coord, delta, kind, mi_k=0) -> int:
    for b in desc.bands:
        if (
            b.coord == coord
            and b.delta == delta
            and b.kind == kind
            and (kind == "vv" or b.mi_k == mi_k)
        ):
            return b.ch
    raise KeyError((coord, delta, kind, mi_k))


def _band_channels(b: Band) -> Tuple[int, int]:
    """(mi channel at p, mi channel at p+stride) of a band entry."""
    if b.kind == "vv":
        return 0, 0
    if b.kind == "vd":
        return 0, b.mi_k
    return b.mi_k, 0  # 'dv'


def build_normal_coef(
    spec: ConstraintSpec, desc: NormalStencilDesc, sv: StructuredValues
) -> torch.Tensor:
    """Assemble the AtA stencil fields from batched StructuredValues.

    Returns channel-major (bs, n_channels, grid_size), contiguous.  Assembly
    runs point-major on grid slices and transposes once at the end.  Runs
    once per solve per level; not a hot path."""
    vs = spec.var_set
    dims = tuple(spec.coord_dims)
    nd = len(dims)
    m = vs.n_mi
    bs = sv.eq.shape[0]
    C = sv.eq.new_zeros((bs,) + dims + (desc.n_channels,))

    def dch(i: int, j: int) -> int:
        return i * m + j

    def ax(c: int, lo: int, hi: int):
        idx = [slice(None)] * (nd + 1)
        idx[1 + c] = slice(lo, hi)
        return tuple(idx)

    # ---- equation rows: full mi outer product at interior points ----------
    interior = (slice(None), slice(1, None)) + (slice(1, -1),) * (nd - 1)
    outer = sv.eq[..., :, None] * sv.eq[..., None, :]
    C[interior + (slice(0, m * m),)] += outer.reshape(outer.shape[:-2] + (m * m,))

    # ---- initial rows: squared weights on the diagonal --------------------
    off = 0
    for box in spec.iv_boxes:
        size = box.size * spec.n_iv
        v = sv.init[:, off : off + size].reshape((bs,) + tuple(box.shape) + (spec.n_iv,))
        bsl = (slice(None),) + tuple(
            slice(int(b), int(e) + 1) for b, e in zip(box.begin, box.end)
        )
        C[bsl + (dch(box.mi_index, box.mi_index),)] += (v * v).sum(-1)
        off += size

    # ---- central rows ------------------------------------------------------
    for c in range(nd):
        w = sv.central[c]  # (bs, dims..., n_cmi, 6)
        cmi = vs.central_mi_indices(c)
        for rs, offs in _shift_slices(dims[c]):
            q_lo, q_hi = rs.start, rs.stop
            wreg = w[ax(c, q_lo, q_hi)]
            # value-value pairs (summed over derivative orders k)
            for j1 in range(5):
                for j2 in range(j1, 5):
                    o1, o2 = offs[j1], offs[j2]
                    prod = (wreg[..., :, j1] * wreg[..., :, j2]).sum(-1)
                    if j1 == j2:
                        C[ax(c, q_lo + o1, q_hi + o1) + (dch(0, 0),)] += prod
                    else:
                        lo_o, hi_o = min(o1, o2), max(o1, o2)
                        chv = _band_channel(desc, c, hi_o - lo_o, "vv")
                        C[ax(c, q_lo + lo_o, q_hi + lo_o) + (chv,)] += prod
            # value-derivative and derivative-derivative pairs
            for k, mik in enumerate(cmi):
                w5 = wreg[..., k, 5]
                for j in range(5):
                    o = offs[j]
                    prod = wreg[..., k, j] * w5
                    if o == 0:
                        C[ax(c, q_lo, q_hi) + (dch(0, mik),)] += prod
                        C[ax(c, q_lo, q_hi) + (dch(mik, 0),)] += prod
                    elif o < 0:
                        chb = _band_channel(desc, c, -o, "vd", mik)
                        C[ax(c, q_lo + o, q_hi + o) + (chb,)] += prod
                    else:
                        chb = _band_channel(desc, c, o, "dv", mik)
                        C[ax(c, q_lo, q_hi) + (chb,)] += prod
                C[ax(c, q_lo, q_hi) + (dch(mik, mik),)] += w5 * w5

    # ---- Taylor rows -------------------------------------------------------
    n_lead = spec.order + 1
    for c in range(nd):
        d = dims[c]
        cmi = vs.central_mi_indices(c)
        term_mi = [0] + list(cmi)
        for v, forward in ((sv.fwd[c], True), (sv.bwd[c], False)):
            row_sl = ax(c, 0, d - 1) if forward else ax(c, 1, d)
            lo_sl = ax(c, 0, d - 1)
            vlast = v[..., n_lead]
            for a in range(n_lead):
                for b in range(a, n_lead):
                    prod = v[..., a] * v[..., b]
                    ma, mb = term_mi[a], term_mi[b]
                    if a == b:
                        C[row_sl + (dch(ma, ma),)] += prod
                    else:
                        C[row_sl + (dch(ma, mb),)] += prod
                        C[row_sl + (dch(mb, ma),)] += prod
            nbr_sl = ax(c, 1, d) if forward else ax(c, 0, d - 1)
            C[nbr_sl + (dch(0, 0),)] += vlast * vlast
            # cross pairs (row terms x neighbor value), stored at the
            # smaller-index point of the pair
            C[lo_sl + (_band_channel(desc, c, 1, "vv"),)] += v[..., 0] * vlast
            for k, mik in enumerate(cmi):
                kind = "dv" if forward else "vd"
                chb = _band_channel(desc, c, 1, kind, mik)
                C[lo_sl + (chb,)] += v[..., 1 + k] * vlast

    return C.reshape(bs, vs.grid_size, desc.n_channels).transpose(1, 2).contiguous()


_GATHER: Dict[Tuple[NormalStencilDesc, str], Tuple[torch.Tensor, ...]] = {}


def _gather_tables(desc: NormalStencilDesc, device) -> Tuple[torch.Tensor, ...]:
    """Index tables of the plain apply, on `device` (cached): per band k its
    coefficient channel and channels ci, cj, and flat gather indices into
    (rows, N + 1) tensors whose column N is zero: x[p + s_k, cj],
    x[p - s_k, ci] and g_k[p - s_k] for every point p, column N where the
    neighbour lies off the flat grid."""
    key = (desc, str(device))
    t = _GATHER.get(key)
    if t is None:
        N = desc.grid_size
        p = torch.arange(N)
        s = torch.tensor([b.stride for b in desc.bands])[:, None]
        fwd = torch.where(p + s < N, p + s, N)
        bwd = torch.where(p >= s, p - s, N)
        ch = torch.tensor([b.ch for b in desc.bands])
        ci = torch.tensor([_band_channels(b)[0] for b in desc.bands])
        cj = torch.tensor([_band_channels(b)[1] for b in desc.bands])
        rows = torch.arange(len(desc.bands))
        flat = [(c[:, None] * (N + 1) + q).reshape(-1) for c, q in ((cj, fwd), (ci, bwd), (rows, bwd))]
        t = tuple(a.to(device) for a in (ch, ci, cj, *flat))
        _GATHER[key] = t
    return t


def stencil_epilogue(y, rin=None, out=None, x=None, xin=None, xout=None):
    """K1's epilogue on y = (AtA) x (see `stencil_apply`); any normal
    operator written in PyTorch takes it to serve the same callers."""
    val = y if rin is None else rin - y
    if xout is not None:
        xout.copy_(x if xin is None else xin + x)
    if out is None:
        return val
    out.copy_(val)
    return out


def stencil_apply_plain(
    desc: NormalStencilDesc,
    coef: torch.Tensor,
    x: torch.Tensor,
    rin: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    xin: Optional[torch.Tensor] = None,
    xout: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K1's plain version: K1's gather form over all bands at once,
      y[p, ci] += g_k[p] x[p + s_k, cj]   and   y[p, cj] += g_k[p - s_k] x[p - s_k, ci]
    for every band k, a neighbour off the flat grid reading as zero.

    coef (bs, NC, N), x (bs, N*m) point-major -> (AtA) x, with K1's
    epilogue (see `stencil_apply`)."""
    if coef.dtype == torch.bfloat16:
        coef = coef.float()
    N, m = desc.grid_size, desc.n_mi
    bs = x.shape[0]
    ch, ci, cj, x_fwd, x_bwd, g_bwd = _gather_tables(desc, coef.device)
    nb = len(ch)
    X = x.reshape(bs, N, m).transpose(1, 2)  # (bs, m, N)
    D = coef[:, : m * m].reshape(bs, m, m, N)
    Y = (D * X[:, None]).sum(2)  # the dense offset-0 block
    G = coef.index_select(1, ch)  # (bs, nb, N)
    # column N of each row reads as zero
    Xz = torch.cat([X, X.new_zeros(bs, m, 1)], dim=2).reshape(bs, -1)
    Gz = torch.cat([G, G.new_zeros(bs, nb, 1)], dim=2).reshape(bs, -1)
    take = lambda t, idx: t.index_select(1, idx).reshape(bs, nb, N)
    Y.index_add_(1, ci, G * take(Xz, x_fwd))
    Y.index_add_(1, cj, take(Gz, g_bwd) * take(Xz, x_bwd))
    y = Y.transpose(1, 2).reshape(bs, -1)
    return stencil_epilogue(y, rin, out, x, xin, xout)


# (n_coord, order) pairs K1 is instantiated for: every pair VariableSet takes
K1_LAYOUTS = ((1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2))


def k1_band_layout(n_coord: int, order: int) -> Tuple[Tuple[int, int, str, int, int], ...]:
    """K1's compile-time channel layout: (coord, delta, kind, mi_k, ch) of
    every band, in `make_desc`'s order.  Axis c's bands at offset delta
    start at channel m*m + (4c + delta - 1)(1 + 2 order) with vv, then
    (vd_k, dv_k) for each k over central_mi_indices(c) = 1 + c + k n_coord.
    Raises ValueError for a pair K1 is not instantiated for."""
    if (n_coord, order) not in K1_LAYOUTS:
        raise ValueError(f"K1: no layout for n_coord={n_coord}, order={order} "
                         f"(instantiated: {K1_LAYOUTS})")
    m = 1 + n_coord * order
    per = 1 + 2 * order
    out = []
    for c in range(n_coord):
        for delta in range(1, MAX_DELTA + 1):
            ch = m * m + (c * MAX_DELTA + delta - 1) * per
            out.append((c, delta, "vv", 0, ch))
            for k in range(order):
                mik = 1 + c + k * n_coord
                out.append((c, delta, "vd", mik, ch + 1 + 2 * k))
                out.append((c, delta, "dv", mik, ch + 2 + 2 * k))
    return tuple(out)


def k1_layout_args(desc: NormalStencilDesc) -> Tuple[int, int, int, int]:
    """(n_coord, order, s0, s1): the layout K1 is instantiated for and the
    flat strides of axes 0 and 1 where they are not the last (0 otherwise;
    the last axis has stride 1).  Checks that the descriptor's bands are
    K1's compile-time layout; raises ValueError if not."""
    n_coord, m = len(desc.coord_dims), desc.n_mi
    order = (m - 1) // n_coord
    if 1 + n_coord * order != m:
        raise ValueError(f"K1: n_mi={m} is no layout of {n_coord} axes")
    layout = k1_band_layout(n_coord, order)
    strides = _point_strides(desc.coord_dims)
    got = [(b.coord, b.delta, b.kind, b.mi_k, b.ch) for b in desc.bands]
    if (got != list(layout) or desc.n_channels != m * m + len(layout)
            or desc.grid_size != int(np.prod(desc.coord_dims))
            or any(b.stride != b.delta * strides[b.coord] for b in desc.bands)):
        raise ValueError("K1: the descriptor's bands are not K1's compile-time layout "
                         "(make_desc's channel order)")
    s = [int(strides[c]) for c in range(n_coord - 1)] + [0, 0]
    return n_coord, order, s[0], s[1]


K1_THREADS = 128  # threads per CTA, csrc/stencil_apply.cu kThreads


class StencilGeometry(NamedTuple):
    P: int  # consecutive points per thread
    threads: int  # threads per CTA
    grid: Tuple[int, int]  # (CTAs per sample, samples)


def stencil_geometry(N: int, bs: int, itemsize: int, n_sm: int,
                     aligned: bool = True) -> StencilGeometry:
    """K1's launch geometry for bs samples of N points with vectors of
    `itemsize` bytes (4: f32, also with bf16 fields; 8: f64) on a card of
    `n_sm` SMs.  Thread t of CTA (i, b) takes the P points
    (i * threads + t) * P + q, q < P, of sample b that lie below N.

    P = 16 // itemsize (16-byte loads) where the rows allow it (N % P == 0
    and `aligned`: every operand 16-byte aligned) and the grid then still
    gives every SM two CTAs; else P = 1 (the GL level-1 shape)."""
    if min(N, bs, n_sm) < 1 or itemsize not in (4, 8):
        raise ValueError(f"stencil_geometry: bad shape N={N} bs={bs} itemsize={itemsize} "
                         f"n_sm={n_sm}")

    def ctas(P):
        return -(-N // (P * K1_THREADS))

    P = 16 // itemsize
    if not aligned or N % P or ctas(P) * bs < 2 * n_sm:
        P = 1
    return StencilGeometry(P, K1_THREADS, (ctas(P), bs))


def stencil_apply(
    desc: NormalStencilDesc,
    coef: torch.Tensor,
    x: torch.Tensor,
    rin: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    xin: Optional[torch.Tensor] = None,
    xout: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """y = (AtA) x for a batch: coef (bs, NC, N), x (bs, N*m) point-major;
    coef float32/float64 with x of the same dtype, or bfloat16 with float32 x.

    Epilogue: returns rin - y when `rin` is given, else y (written into `out`
    when given, which may be rin itself); with `xout` also writes
    xout = xin + x (xin None reads as zero; xout may be xin itself).

    CUDA tensors launch kernel K1; CPU tensors run the plain version."""
    if coef.is_cuda:
        return _stencil_apply_k1(desc, coef, x, rin, out, xin, xout)
    if coef.device.type != "cpu":
        raise ValueError(f"stencil_apply: unsupported device {coef.device}")
    return stencil_apply_plain(desc, coef, x, rin, out, xin, xout)


# (coef dtype, vector dtype) -> (launcher, launch-count name); the float64
# instantiation (the outer FGMRES at mg_solve_dtype 'solver') counts apart
_K1_FN = {
    (torch.float32, torch.float32): ("k1_stencil_apply_f32", "k1_stencil_apply"),
    (torch.float64, torch.float64): ("k1_stencil_apply_f64", "k1_stencil_apply_f64"),
    (torch.bfloat16, torch.float32): ("k1_stencil_apply_bf16", "k1_stencil_apply_bf16"),
}


_K1_PLANS: Dict[tuple, tuple] = {}


def _k1_plan(desc, coef, x):
    """K1's launch for operands of these shapes, dtypes and device, checked
    once and cached: (launcher, launch-count name, k1_layout_args, the
    geometry for 16-byte aligned operands)."""
    key = (desc, coef.shape, x.shape, coef.dtype, x.dtype, coef.device)
    plan = _K1_PLANS.get(key)
    if plan is None:
        bs, NC, N = coef.shape
        m = desc.n_mi
        if (NC, N) != (desc.n_channels, desc.grid_size) or tuple(x.shape) != (bs, N * m):
            raise ValueError(
                f"stencil_apply: coef {tuple(coef.shape)} / x {tuple(x.shape)} do not "
                f"match the descriptor (NC={desc.n_channels}, N={desc.grid_size}, m={m})"
            )
        fn = _K1_FN.get((coef.dtype, x.dtype))
        if fn is None:
            raise ValueError(f"stencil_apply: K1 takes coef/x float32/float32, float64/float64 "
                             f"or bfloat16/float32, got {coef.dtype}/{x.dtype}")
        layout = k1_layout_args(desc)
        geo = stencil_geometry(N, bs, x.element_size(), _cuda.sm_count(coef.device))
        plan = _K1_PLANS[key] = (*fn, layout, geo)
    return plan


def _stencil_apply_k1(desc, coef, x, rin, out, xin, xout):
    launcher, counted, (n_coord, order, s0, s1), geo = _k1_plan(desc, coef, x)
    if out is None:
        out = torch.empty_like(x)
    for t in (rin, out, xin, xout):
        if t is not None and (t.dtype != x.dtype or t.shape != x.shape):
            raise ValueError("stencil_apply: epilogue operand dtype/shape mismatch")
    for t in (out, xout):
        if t is not None and t.data_ptr() == x.data_ptr():
            raise ValueError("stencil_apply: outputs must not alias x (read at neighbours)")
    ops = (coef, x, rin, out, xin, xout)
    _cuda.require_cuda(*ops)
    bs, _, N = coef.shape
    if geo.P > 1 and any(t.data_ptr() % 16 for t in ops if t is not None):
        geo = stencil_geometry(N, bs, x.element_size(), _cuda.sm_count(coef.device),
                               aligned=False)
    code = getattr(_cuda.library("stencil_apply"), launcher)(
        coef.data_ptr(), x.data_ptr(), n_coord, order, s0, s1, N, bs, geo.P, geo.threads,
        geo.grid[0], _cuda.ptr(rin), out.data_ptr(), _cuda.ptr(xin), _cuda.ptr(xout),
        _cuda.stream_ptr(coef.device),
    )
    _cuda.check("stencil_apply", counted, code)
    return out
