"""Exact least squares through the normal equations, in float64, for a
system whose normal matrix is block tridiagonal in the reference's numbering
(constraints.py: planes of the outermost axis, each coupled to the planes
within 4 of it; a block is 4 planes).

Per sample: the columns are equilibrated (s_c = 1 / ||A e_c||), the blocks
of (A S)^T (A S) are assembled from the products of the entries that share
a row, and factored by block Cholesky:
    L_k L_k^T = D_k - S_k S_k^T,   S_k = C_k L_{k-1}^{-T}
(C_k the block below the diagonal).  x = S y with (A S)^T (A S) y = S A^T b.

The backward of x(A, b) is the implicit-function one of least squares:
    dz = (A^T A)^{-1} g,   dL/dA[r, c] = lam[r] dz[c] - (A dz)[r] x[c],
    dL/db = A dz,   lam = b - A x.
A sample's factor is used for both solves and then freed, so the samples
go through in chunks that fit the device; the caller gives g for a chunk
from that chunk's x (`gfn`).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

PLANES_PER_BLOCK = 4


class BandedLstsq:
    def __init__(self, rows: np.ndarray, cols: np.ndarray, n_rows: int, n_vars: int,
                 plane_vars: int, device, budget_bytes: float = None,
                 round_dtype: torch.dtype = None):
        """The lower-precision control: `round_dtype` (bfloat16) rounds
        the exact solutions of both solves, the forward's x and the
        backward's dz, to that type: the best answer a solve in it could
        give."""
        self.n_rows, self.n_vars, self.dtype = n_rows, n_vars, torch.float64
        self.round = (lambda t: t.to(round_dtype).to(self.dtype)) if round_dtype else (lambda t: t)
        B = plane_vars * PLANES_PER_BLOCK
        if n_vars % B:
            raise ValueError(f"{n_vars} unknowns are not whole blocks of {B}")
        self.B, self.nblk = B, n_vars // B
        self.device = torch.device(device)
        order = np.argsort(rows, kind="stable")
        counts = np.bincount(rows, minlength=n_rows)
        K = int(counts.max())
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(rows.size) - np.repeat(starts, counts)
        E = np.full((n_rows, K), -1, dtype=np.int64)
        E[rows[order], slot] = order
        a = np.broadcast_to(E[:, :, None], (n_rows, K, K)).reshape(-1)
        b = np.broadcast_to(E[:, None, :], (n_rows, K, K)).reshape(-1)
        ok = (a >= 0) & (b >= 0)
        a, b = a[ok], b[ok]
        ca, cb = cols[a], cols[b]
        ba, bb = ca // B, cb // B
        if np.any(np.abs(ba - bb) > 1):
            raise ValueError("normal matrix is not block tridiagonal at this block size")
        keep = ba >= bb
        a, b, ca, cb, ba, bb = a[keep], b[keep], ca[keep], cb[keep], ba[keep], bb[keep]
        slot_blk = np.where(ba == bb, ba, self.nblk + ba - 1)
        tgt = (slot_blk * B + ca % B) * B + cb % B
        dev = self.device
        self.rows = torch.as_tensor(rows, device=dev)
        self.cols = torch.as_tensor(cols, device=dev)
        self.pa = torch.as_tensor(a, device=dev)
        self.pb = torch.as_tensor(b, device=dev)
        self.tgt = torch.as_tensor(tgt, device=dev)
        per_sample = (2 * self.nblk - 1) * B * B * torch.finfo(self.dtype).bits // 8
        if budget_bytes is None:
            if self.device.type == "cuda":
                budget_bytes = 0.45 * torch.cuda.mem_get_info(self.device)[0]
            else:
                budget_bytes = per_sample
        self.chunk = max(1, int(budget_bytes // per_sample))

    # -- operators on entry values (c, nnz) --------------------------------
    def matvec(self, vals, x):
        out = vals.new_zeros((vals.shape[0], self.n_rows))
        return out.index_add_(1, self.rows, vals * x[:, self.cols])

    def rmatvec(self, vals, y):
        out = vals.new_zeros((vals.shape[0], self.n_vars))
        return out.index_add_(1, self.cols, vals * y[:, self.rows])

    def _factor(self, vs):
        c, B, nb = vs.shape[0], self.B, self.nblk
        buf = vs.new_zeros((c, (2 * nb - 1) * B * B))
        buf.index_add_(1, self.tgt, vs[:, self.pa] * vs[:, self.pb])
        D = buf[:, : nb * B * B].view(c, nb, B, B)
        C = buf[:, nb * B * B:].view(c, nb - 1, B, B)
        for k in range(nb):
            if k:
                S = torch.linalg.solve_triangular(D[:, k - 1].mT, C[:, k - 1], upper=True,
                                                  left=False)
                C[:, k - 1] = S
                D[:, k].baddbmm_(S, S.mT, alpha=-1.0)
                del S
            L, info = torch.linalg.cholesky_ex(D[:, k])
            # a sample whose matrix is not positive definite solves to NaN
            D[:, k] = L.masked_fill_((info != 0)[:, None, None], float("nan"))
            del L
        return D, C

    def _solve(self, D, C, r):
        c, nb, B = r.shape[0], self.nblk, self.B
        r = r.view(c, nb, B, 1)
        y = []
        for k in range(nb):
            rk = r[:, k] if k == 0 else r[:, k] - C[:, k - 1] @ y[k - 1]
            y.append(torch.linalg.solve_triangular(D[:, k], rk, upper=False))
        x = [None] * nb
        for k in reversed(range(nb)):
            yk = y[k] if k == nb - 1 else y[k] - C[:, k].mT @ x[k + 1]
            x[k] = torch.linalg.solve_triangular(D[:, k].mT, yk, upper=True)
        return torch.cat(x, dim=1).reshape(c, -1)

    def solve(self, vals: torch.Tensor, b: torch.Tensor,
              gfn: Callable[[torch.Tensor, slice], torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x, dL/dvals, dL/db) for a batch: vals (bs, nnz) and b (bs, n_rows)
        float64, with gfn(x_chunk, samples) -> dL/dx of those samples."""
        bs, out_dtype = vals.shape[0], vals.dtype
        xs, vbars, bbars = [], [], []
        for s0 in range(0, bs, self.chunk):
            sl = slice(s0, min(bs, s0 + self.chunk))
            v, bb = vals[sl].to(self.dtype), b[sl].to(self.dtype)
            d = v.new_zeros((v.shape[0], self.n_vars)).index_add_(1, self.cols, v * v)
            s = torch.rsqrt(d)
            D, C = self._factor(v * s[:, self.cols])
            x = self.round(s * self._solve(D, C, s * self.rmatvec(v, bb)))
            g = gfn(x.to(out_dtype), sl).to(self.dtype)
            dz = self.round(s * self._solve(D, C, s * g))
            del D, C
            lam = bb - self.matvec(v, x)
            adz = self.matvec(v, dz)
            vbars.append(lam[:, self.rows] * dz[:, self.cols] - adz[:, self.rows] * x[:, self.cols])
            bbars.append(adz)
            xs.append(x)
        return tuple(torch.cat(t).to(out_dtype) for t in (xs, vbars, bbars))
