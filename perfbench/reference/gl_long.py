"""Plain reference of the `gl_long` configuration: the `gl` problem (gl.py:
the same equation, bases, ParamNets, boundary faces and loss) on the long
time window, whose least squares banded.py's exact solve cannot hold there
(its blocks of 4 y-planes would be 44,800 unknowns wide, 16 GB each in
float64, 15 of them a sample).

The least squares is solved by conjugate gradients on the column-
equilibrated normal equations, in float64 (`SchurCG`), for the forward x
and for the implicit-function backward's dz = (A^T A)^-1 g alike.  The
preconditioner is the normal matrix's own factorization with every point's
derivative unknowns eliminated: each row holds the derivative unknowns of
one point at most (constraints.py), so they couple in 6 x 6 blocks, one a
point, and their Schur complement on the values u alone is block
tridiagonal over groups of y-planes (51,200 unknowns, blocks of 6,400 at
(50, 32, 32)), factored exactly by block Cholesky as banded.py does.  CG
then only removes the factorization's rounding.

A solve stops when every sample's relative normal residual ||A^T (b - A x)||
/ ||A^T b|| (the backward's ||g - A^T A dz|| / ||g||), recomputed from x, is
at most TOL; a sample still above it after MAX_ITER iterations solves to
NaN, so such a run is never `correct`.  Each solve's iterations, residual
and seconds are logged."""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from perfbench.lib.common import log
from perfbench.reference import constraints
from perfbench.reference.discovery import DiscoveryReference
from perfbench.reference.gl import Reference as GLReference

TOL = 1e-10
MAX_ITER = 50
PLANES_PER_BLOCK = 4


def _table(keys: np.ndarray, n: int, pad: int) -> np.ndarray:
    """(n, most entries of a key) entry indexes of each key 0..n-1 in
    `keys`, padded with `pad`."""
    order = np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=n)
    slot = np.arange(keys.size) - np.repeat(np.cumsum(counts) - counts, counts)
    out = np.full((n, int(counts.max())), pad, dtype=np.int64)
    out[keys[order], slot] = order
    return out


def _two_prod(a, b):
    """a * b as an unevaluated sum hi + lo, exactly (Dekker's product; each
    operation its own rounded kernel)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _split(a):
    c = 134217729.0 * a  # 2^27 + 1
    hi = c - (c - a)
    return hi, a - hi


def _dd_add(ah, al, bh, bl):
    """(ah + al) + (bh + bl) in double-double (Knuth's two-sum of the high
    parts, then renormalised)."""
    s = ah + bh
    v = s - ah
    e = (ah - (s - v)) + (bh - v) + (al + bl)
    hi = s + e
    return hi, e - (hi - s)


def _pairs(rows: np.ndarray, n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every ordered pair (a, b) of entries that share a row (a == b too),
    as entry indexes."""
    E = _table(rows, n_rows, -1)
    K = E.shape[1]
    a = np.broadcast_to(E[:, :, None], (n_rows, K, K)).reshape(-1)
    b = np.broadcast_to(E[:, None, :], (n_rows, K, K)).reshape(-1)
    ok = (a >= 0) & (b >= 0)
    return a[ok], b[ok]


class SchurCG:
    """min ||A x - b|| per sample by preconditioned conjugate gradients on
    the normal equations, the preconditioner exact (module docstring).

    Unknowns in the reference's numbering (constraints.py): point P (the
    last grid axis outermost) times m, plus mi; mi 0 is the value u, 1..m-1
    the derivatives d.  With column scales s and N = (A S)^T (A S):
        N_dd  per point, (m-1) x (m-1)           (Ld: its Cholesky factor)
        N_du  per point p, against the K values u(q) it couples to (`qmap`)
        R = N_uu - sum_p N_du[p]^T N_dd[p]^-1 N_du[p]
    and R, numbered by point, is block tridiagonal in blocks of `ppb`
    planes of the outermost axis; L_k L_k^T = D_k - S_k S_k^T,
    S_k = C_k L_{k-1}^{-T}."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, n_rows: int, n_vars: int,
                 m: int, plane_points: int, device, budget_bytes: float = None,
                 round_dtype: torch.dtype = None):
        """`round_dtype` (the lower-precision control): both solutions, the
        forward's x and the backward's dz, rounded to that type."""
        self.n_rows, self.n_vars, self.m, self.dtype = n_rows, n_vars, m, torch.float64
        self.round = (lambda t: t.to(round_dtype).to(self.dtype)) if round_dtype else (lambda t: t)
        self.device = dev = torch.device(device)
        G = self.G = n_vars // m
        md = m - 1
        pt, mi = cols // m, cols % m
        a, b = _pairs(rows, n_rows)
        pa, pb, da, db = pt[a], pt[b], mi[a] > 0, mi[b] > 0
        dd, du, uu = da & db, da & ~db, ~da & ~db
        if np.any(pa[dd] != pb[dd]):
            raise ValueError("a row holds the derivative unknowns of two points")
        # N_dd: (point, i, j)
        self.dd = (a[dd], b[dd], (pa[dd] * md + mi[a[dd]] - 1) * md + mi[b[dd]] - 1)
        # N_du: (point p, i, slot of q among the values p couples to)
        p, q = pa[du], pb[du]
        keys, inv = np.unique(p * G + q, return_inverse=True)
        kp, kq = np.divmod(keys, G)
        first = np.searchsorted(kp, np.arange(G))
        slot = np.arange(keys.size) - first[kp]
        K = self.K = int(slot.max()) + 1
        qmap = np.zeros((G, K), dtype=np.int64)  # padding: value 0, with N_du 0 there
        qmap[kp, slot] = kq
        valid = np.zeros((G, K), dtype=bool)
        valid[kp, slot] = True
        self.du = (a[du], b[du], (p * md + mi[a[du]] - 1) * K + slot[inv])
        # R's blocks: the fewest planes (at least PLANES_PER_BLOCK) that
        # divide the outermost axis and keep R block tridiagonal
        n_planes = G // plane_points
        pts, fi, fj = np.nonzero(valid[:, :, None] & valid[:, None, :])
        qi, qj = qmap[pts, fi], qmap[pts, fj]
        ua, ub = pa[uu], pb[uu]
        for ppb in range(min(PLANES_PER_BLOCK, n_planes), n_planes + 1):
            B = ppb * plane_points
            if n_planes % ppb == 0 and all(np.abs(x // B - y // B).max() <= 1
                                           for x, y in ((ua, ub), (qi, qj))):
                break
        self.B, self.nblk = B, n_planes // ppb
        keep, tgt = self._lower(ua, ub)
        self.uu = (a[uu][keep], b[uu][keep], tgt[keep])
        # the Schur complement's fill: entry (point, i, j) of N_du^T W, and
        # where it goes
        keep, tgt = self._lower(qi, qj)
        self.fill = (((pts * K + fi) * K + fj)[keep], tgt[keep])
        t = lambda v: torch.as_tensor(v, device=dev)
        self.dd = tuple(map(t, self.dd))
        self.du = tuple(map(t, self.du))
        self.uu = tuple(map(t, self.uu))
        self.fill = tuple(map(t, self.fill))
        self.qmap = t(qmap)
        self.rows, self.cols = t(rows), t(cols)
        # the residual's tables (`_residual`): each row's entries, and each
        # column's, the values' columns and the derivatives' apart (up to 55
        # entries and up to 4 at (50, 32, 32)); padding: entry nnz
        nnz = rows.size
        self.rows_e, self.cols_e = t(np.append(rows, 0)), t(np.append(cols, 0))
        self.row_e = t(_table(rows, n_rows, nnz))
        by_col = _table(cols, n_vars, nnz)
        self.col_e = []
        mi_of = np.arange(n_vars) % m
        for mine in (mi_of == 0, mi_of > 0):
            cols_k = np.nonzero(mine)[0]
            tab = by_col[cols_k]
            tab = tab[:, : int((tab < nnz).sum(axis=1).max())]
            self.col_e.append((t(tab), t(cols_k)))
        self.per_sample = 8 * ((2 * self.nblk - 1) * B * B + G * K * (K + 2 * md) + G * md * md)
        if budget_bytes is None:
            if dev.type == "cuda":
                budget_bytes = 0.5 * torch.cuda.mem_get_info(dev)[0]
            else:
                budget_bytes = self.per_sample
        self.chunk = max(1, int(budget_bytes // self.per_sample))

    def _lower(self, qa: np.ndarray, qb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(keep, target): which pairs of values (qa, qb) lie in R's stored
        lower part (the diagonal blocks whole, the blocks below them), and
        where, in a buffer of the diagonal blocks then those below."""
        B, nb = self.B, self.nblk
        ba, bb = qa // B, qb // B
        keep = ba >= bb
        slot = np.where(ba == bb, ba, nb + ba - 1)
        return keep, (slot * B + qa % B) * B + qb % B

    # -- operators on entry values (c, nnz) --------------------------------
    def matvec(self, vals, x):
        out = vals.new_zeros((vals.shape[0], self.n_rows))
        return out.index_add_(1, self.rows, vals * x[:, self.cols])

    def rmatvec(self, vals, y):
        out = vals.new_zeros((vals.shape[0], self.n_vars))
        return out.index_add_(1, self.cols, vals * y[:, self.rows])

    # -- the preconditioner: N's exact factorization ---------------------------
    def _factor(self, vs):
        """The factors of N for equilibrated entry values vs (c, nnz): Ld
        (c, G, m-1, m-1), N_du (c, G, m-1, K), W = N_dd^-1 N_du, and R's
        block Cholesky factor D (c, nb, B, B), C (c, nb-1, B, B)."""
        c, G, K, md, B, nb = vs.shape[0], self.G, self.K, self.m - 1, self.B, self.nblk
        prod = lambda a, b: vs[:, a] * vs[:, b]
        a, b, tgt = self.dd
        Ndd = vs.new_zeros((c, G * md * md)).index_add_(1, tgt, prod(a, b)).view(c, G, md, md)
        Ld, info = torch.linalg.cholesky_ex(Ndd)
        bad = (info != 0).any(dim=1)
        del Ndd
        a, b, tgt = self.du
        Ndu = vs.new_zeros((c, G * md * K)).index_add_(1, tgt, prod(a, b)).view(c, G, md, K)
        W = torch.cholesky_solve(Ndu, Ld)
        buf = vs.new_zeros((c, (2 * nb - 1) * B * B))
        a, b, tgt = self.uu
        buf.index_add_(1, tgt, prod(a, b))
        idx, tgt = self.fill
        buf.index_add_(1, tgt, -(Ndu.mT @ W).reshape(c, -1)[:, idx])
        buf = buf.view(c, 2 * nb - 1, B, B)
        D, C = buf[:, :nb], buf[:, nb:]
        for k in range(nb):
            if k:
                S = torch.linalg.solve_triangular(D[:, k - 1].mT, C[:, k - 1], upper=True,
                                                  left=False)
                C[:, k - 1] = S
                D[:, k].baddbmm_(S, S.mT, alpha=-1.0)
                del S
            L, info = torch.linalg.cholesky_ex(D[:, k])
            bad |= info != 0
            D[:, k] = L
            del L
        # a sample whose normal matrix is not positive definite solves to NaN
        D.masked_fill_(bad[:, None, None, None], float("nan"))
        return Ld, Ndu, W, D, C

    def _apply(self, f, r):
        """N^-1 r for r (c, n_vars) in the reference's numbering."""
        Ld, Ndu, W, D, C = f
        c, nb, B = r.shape[0], self.nblk, self.B
        r3 = r.view(c, self.G, self.m)
        rd = r3[..., 1:]
        ru = r3[..., 0].index_add(1, self.qmap.view(-1),
                                  -(W * rd[..., None]).sum(dim=2).view(c, -1))
        ru = ru.view(c, nb, B, 1)
        y = []
        for k in range(nb):
            rk = ru[:, k] if k == 0 else ru[:, k] - C[:, k - 1] @ y[k - 1]
            y.append(torch.linalg.solve_triangular(D[:, k], rk, upper=False))
        u = [None] * nb
        for k in reversed(range(nb)):
            yk = y[k] if k == nb - 1 else y[k] - C[:, k].mT @ u[k + 1]
            u[k] = torch.linalg.solve_triangular(D[:, k].mT, yk, upper=True)
        u = torch.cat(u, dim=1).view(c, self.G)
        d = torch.cholesky_solve((rd - (Ndu @ u[:, self.qmap][..., None])[..., 0])[..., None], Ld)
        return torch.cat([u[..., None], d[..., 0]], dim=2).view(c, -1)

    # -- the residual, in double-double ----------------------------------------
    def _residual(self, v, xh, xl, b=None, g=None):
        """rhs - A^T A x for x = xh + xl (double-double), rhs = A^T b
        (forward) or g (backward), as A^T (b - A x) or g - A^T (A x) with
        every product and sum in double-double (`_two_prod`, `_dd_add`),
        rounded once at the end."""
        c = v.shape[0]
        ve = torch.cat([v, v.new_zeros((c, 1))], dim=1)  # entry nnz: the padding, 0
        rv, rc = ve[:, self.row_e], self.cols_e[self.row_e]
        hi = lo = None
        for k in range(rv.shape[-1]):  # -A x, row by row
            ph, pl = _two_prod(-rv[..., k], xh[:, rc[:, k]])
            pl = pl - rv[..., k] * xl[:, rc[:, k]]
            hi, lo = (ph, pl) if hi is None else _dd_add(hi, lo, ph, pl)
        if b is not None:
            hi, lo = _dd_add(hi, lo, b, torch.zeros_like(b))
        out_hi = xh.new_empty((c, self.n_vars))
        out_lo = xh.new_empty((c, self.n_vars))
        for col_e, cols in self.col_e:  # A^T y, column by column
            cv, cr = ve[:, col_e], self.rows_e[col_e]
            th = tl = None
            for k in range(cv.shape[-1]):
                ph, pl = _two_prod(cv[..., k], hi[:, cr[:, k]])
                pl = pl + cv[..., k] * lo[:, cr[:, k]]
                th, tl = (ph, pl) if th is None else _dd_add(th, tl, ph, pl)
            out_hi[:, cols], out_lo[:, cols] = th, tl
        if g is not None:
            out_hi, out_lo = _dd_add(out_hi, out_lo, g, torch.zeros_like(g))
        return out_hi + out_lo

    # -- conjugate gradients ----------------------------------------------------
    def _cg(self, v, s, f, b=None, g=None, side: str = "forward"):
        """x with A^T A x = rhs for the chunk's samples (entry values v,
        column scales s, N's factors f; rhs = A^T b, or g): preconditioned
        CG from x = 0, the preconditioner (A^T A)^-1 = S N^-1 S by N's
        factors, until every sample's ||rhs - A^T A x|| / ||rhs|| is at most
        TOL; NaN where a sample is not there after MAX_ITER iterations.

        x is held in double-double and its residual recomputed from it each
        iteration (`_residual`): CG's own recurrence drifts from the true
        residual, and a float64 x alone leaves a floor near eps kappa(A^T A)
        that an ill-conditioned sample's backward solve stays above (2.6e-10
        to 3.3e-9 at kappa 3e7 to 4e8 on the card).  The solution returned
        is x rounded to float64, the same x to its last bit."""
        t0 = time.perf_counter()
        rhs = self.rmatvec(v, b) if g is None else g
        bn = torch.linalg.vector_norm(rhs, dim=1)
        rel = lambda r: torch.linalg.vector_norm(r, dim=1) / bn.clamp_min(1e-300)
        precond = lambda r: s * self._apply(f, s * r)
        xh, xl, r = torch.zeros_like(rhs), torch.zeros_like(rhs), rhs
        res = rel(r)
        z = precond(r)
        p, rz = z, (r * z).sum(dim=1)
        it = 0
        while it < MAX_ITER and not bool((res <= TOL).all()):
            live = (res > TOL)[:, None]
            q = self.rmatvec(v, self.matvec(v, p))
            step = torch.where(live, (rz / (p * q).sum(dim=1))[:, None] * p, 0.0)
            xh, xl = _dd_add(xh, xl, step, torch.zeros_like(step))
            r = self._residual(v, xh, xl, b, g)
            res = rel(r)
            it += 1
            z = precond(r)
            rz_new = (r * z).sum(dim=1)
            p = torch.where(live, z + (rz_new / rz)[:, None] * p, p)
            rz = rz_new
        x = xh + xl
        x[res > TOL] = float("nan")
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        log(f"reference {side} solve: {it} CG iterations, residual {float(res.max()):.3e} "
            f"(most over {x.shape[0]} samples), {time.perf_counter() - t0:.2f} s")
        return x

    def solve(self, vals: torch.Tensor, b: torch.Tensor,
              gfn: Callable[[torch.Tensor, slice], torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x, dL/dvals, dL/db) for a batch: vals (bs, nnz) and b (bs, n_rows)
        float64, with gfn(x_chunk, samples) -> dL/dx of those samples; the
        backward as banded.py's (the implicit-function one of least squares):
            dz = (A^T A)^-1 g,   dL/dA[r, c] = lam[r] dz[c] - (A dz)[r] x[c],
            dL/db = A dz,   lam = b - A x."""
        bs, out_dtype = vals.shape[0], vals.dtype
        xs, vbars, bbars = [], [], []
        for s0 in range(0, bs, self.chunk):
            sl = slice(s0, min(bs, s0 + self.chunk))
            v, bb = vals[sl].to(self.dtype), b[sl].to(self.dtype)
            t0 = time.perf_counter()
            d = v.new_zeros((v.shape[0], self.n_vars)).index_add_(1, self.cols, v * v)
            s = torch.rsqrt(d)
            f = self._factor(v * s[:, self.cols])
            if v.is_cuda:
                torch.cuda.synchronize(v.device)
            peak = f", peak {torch.cuda.max_memory_allocated(v.device) / 2**30:.2f} GiB" if v.is_cuda else ""
            log(f"reference factor: {v.shape[0]} samples, {time.perf_counter() - t0:.2f} s{peak}")
            x = self.round(self._cg(v, s, f, b=bb, side="forward"))
            g = gfn(x.to(out_dtype), sl).to(self.dtype)
            dz = self.round(self._cg(v, s, f, g=g, side="backward"))
            del f
            lam = bb - self.matvec(v, x)
            adz = self.matvec(v, dz)
            vbars.append(lam[:, self.rows] * dz[:, self.cols] - adz[:, self.rows] * x[:, self.cols])
            bbars.append(adz)
            xs.append(x)
        return tuple(torch.cat(t).to(out_dtype) for t in (xs, vbars, bbars))


class Reference(GLReference):
    def __init__(self, cfg: Dict, data: Dict[str, np.ndarray], device, lower: bool = False,
                 budget_bytes=None):
        """`lower`: the control, as gl.py's: both solutions rounded to
        bfloat16 (the stated operator and FGMRES precision is float32), the
        networks in float32 with TF32."""
        t0 = time.perf_counter()
        dims = tuple(cfg["solver_dim"])
        g = np.indices(dims)
        boundary = (g[0] == 0)
        for c in (1, 2):
            boundary |= (g[c] == 0) | (g[c] == dims[c] - 1)
        system = constraints.build(dims, cfg["steps"], boundary)
        rows, cols = self.entries(system)
        solver = SchurCG(rows, cols, system.n_rows, system.n_vars, system.m,
                         int(np.prod(dims[:-1])), device, budget_bytes,
                         torch.bfloat16 if lower else None)
        DiscoveryReference.__init__(self, system, solver, device, lower)
        self.cfg, self.dims = cfg, dims
        self.u = torch.as_tensor(np.ascontiguousarray(data["u"]), device=self.device)
        self.v = torch.as_tensor(np.ascontiguousarray(data["v"]), device=self.device)
        self.bnd_points = torch.as_tensor(system.bnd_points, device=self.device)
        log(f"reference set-up: {time.perf_counter() - t0:.2f} s, chunks of {solver.chunk} "
            f"samples, {solver.per_sample / 2**30:.2f} GiB of factors a sample")
