"""Batched Krylov solvers: flexible GMRES (right-preconditioned,
restarted), GMRES, LGMRES, CG, MINRES, CG on the normal equations, and the
fixed-loop masked block CG.

Port of the JAX package's solvers/krylov.py.  There each solver is written
per sample and vmapped: the batched `while_loop` runs while any sample
continues and freezes the carry of finished ones (its iteration count
included).  Here the batch is an explicit leading axis (b is (bs, n); every
operator maps (bs, n) -> (bs, n)) and that freeze is a per-sample mask:
each iteration computes every sample's update and keeps it only where the
sample's own test still passes (`_while_masked`).  A frozen sample never
moves, so the host reads the "any sample still running" flag only every
`CHECK_EVERY` iterations (and never runs past `maxiter`) and the results
equal a check on every iteration.

The solvers keep the reference's guards: CG's curvature guards (pAp > tiny,
rz > tiny), `_safe_div`, and LGMRES's epsilon-ridged Cholesky of the
augmentation Gram matrix.  `cg_block` is the JAX package's explicit
block formulation (a fixed loop over all samples with 0/1 continue masks).

FGMRES:

- convergence (residual norm <= max(atol, tol * ||b||)) is checked only
  between restart windows, and a window adds `restart` to the iteration
  count, so `maxiter` moves in whole windows;
- every window runs for all samples; samples already converged keep their
  (x, iters, rnorm) unchanged;
- CGS2 orthogonalization, Givens-rotation QR of the Hessenberg columns and
  back-substitution, as in the reference;
- `precond_matvec(v) -> (z, A z)` replaces the separate precond + matvec in
  the Arnoldi loop when given; `matvec` still gives the true residuals at
  window boundaries.

The dot products and axpys are library calls (batched matmuls).  The window
loop reads one flag from the device per window.  While a profiler records,
FGMRES records spans (utils/profiling): `fgmres.matvec` and
`fgmres.precond` around each call of the operator and of the
preconditioner, `fgmres.ortho` (CGS2, once an iteration), `fgmres.givens`,
`fgmres.backsub` (with the update x + Z y) and `fgmres.check` (a window's
true residual and the flag read).

`reduce` (fgmres; `_dot`, `_norm`): where each rank holds a run of every
vector (the sp-sharded solve), the per-sample partial sums of the dots and
squared norms go through reduce (an all-reduce over the ranks) before use:
one call per Gram-Schmidt pass for all its (bs, restart+1) dots, one per
norm.  Every rank then holds the same norms, so all take the same stopping
decisions and issue the same collectives.  None (the default) is one
device: the sums are the unsharded ones, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from mech_nn_discovery_pde_torch.utils.profiling import span

# iterations between two reads of the "any sample still running" flag
CHECK_EVERY = 8


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    rnorm: torch.Tensor


def _safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def _dot(a, b, reduce: Optional[Callable] = None):
    """Per-sample inner products (bs,) of (bs, n) tensors."""
    d = (a * b).sum(dim=1)
    return d if reduce is None else reduce(d)


def _norm(a, reduce: Optional[Callable] = None):
    """Per-sample 2-norms (bs,) of a (bs, n) tensor."""
    if reduce is None:
        return torch.linalg.vector_norm(a, dim=1)
    return torch.sqrt(reduce((a * a).sum(dim=1)))


def _in_span(name: str, fn: Callable) -> Callable:
    """fn, each call recorded as the span `name`."""

    def call(v):
        with span(name):
            return fn(v)

    return call


def _while_masked(cond: Callable, body: Callable, state: Dict[str, torch.Tensor],
                  maxiter: int, step: int = 1) -> Dict[str, torch.Tensor]:
    """The batched `while_loop` of a vmapped per-sample solver: each pass
    computes body(state) for every sample and keeps it where cond(state)
    holds (per sample; every state entry has the leading bs axis).  A
    sample's iteration count moves `step` a pass, only while it runs, and
    cond stays false once it fails (a frozen sample does not move), so the
    flag is read every CHECK_EVERY passes and the loop stops at maxiter."""
    done = 0
    while done < maxiter and bool(cond(state).any()):
        for _ in range(min(CHECK_EVERY, -(-(maxiter - done) // step))):
            active = cond(state)
            new = body(state)
            state = {k: torch.where(active.view((-1,) + (1,) * (v.ndim - 1)), new[k], v)
                     for k, v in state.items()}
            done += step
    return state


def fgmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond: Optional[Callable] = None,
    restart: int = 20,
    maxiter: int = 40,
    atol: float = 1e-5,
    tol: float = 1e-5,
    precond_matvec: Optional[Callable] = None,
    reduce: Optional[Callable] = None,
) -> KrylovResult:
    """Flexible GMRES on a batch of right-hand sides b (bs, n)."""
    precond = precond or (lambda v: v)
    bs, n = b.shape
    x = torch.zeros_like(b) if x0 is None else x0
    thresh = torch.clamp(tol * _norm(b, reduce), min=atol)
    red = reduce or (lambda t: t)

    mv = _in_span("fgmres.matvec", matvec)
    pc = _in_span("fgmres.precond", precond)
    pc_mv = _in_span("fgmres.precond", precond_matvec)

    def restart_cycle(x):
        r = b - mv(x)
        beta = _norm(r, reduce)
        V = b.new_zeros((bs, restart + 1, n))
        Z = b.new_zeros((bs, restart, n))
        V[:, 0] = _safe_div(r, beta[:, None])
        R = b.new_zeros((bs, restart, restart))
        g = b.new_zeros((bs, restart + 1))
        g[:, 0] = beta
        cs = b.new_zeros((bs, restart))
        sn = b.new_zeros((bs, restart))
        for j in range(restart):
            vj = V[:, j].contiguous()  # operators (kernels) take contiguous vectors
            if precond_matvec is not None:
                z, u = pc_mv(vj)
            else:
                z = pc(vj)
                u = mv(z)
            Z[:, j] = z
            with span("fgmres.ortho"):
                # CGS2: rows > j of V are zero, so the full product projects
                # exactly onto the built basis
                h1 = red(torch.bmm(V, u[:, :, None])[..., 0])
                u = u - torch.bmm(V.transpose(1, 2), h1[:, :, None])[..., 0]
                h2 = red(torch.bmm(V, u[:, :, None])[..., 0])
                u = u - torch.bmm(V.transpose(1, 2), h2[:, :, None])[..., 0]
                h = h1 + h2
                hn = _norm(u, reduce)
                V[:, j + 1] = _safe_div(u, hn[:, None])
            with span("fgmres.givens"):
                # previous rotations on the new column h[0..j], then h[j+1] = hn
                hcol = b.new_zeros((bs, restart + 1))
                hcol[:, :restart] = h[:, :restart]
                hcol[:, j + 1] = hn
                for i in range(j):
                    hi, hi1 = hcol[:, i].clone(), hcol[:, i + 1].clone()
                    hcol[:, i] = cs[:, i] * hi + sn[:, i] * hi1
                    hcol[:, i + 1] = -sn[:, i] * hi + cs[:, i] * hi1
                # new rotation annihilating hcol[j+1]
                a_, b_ = hcol[:, j].clone(), hcol[:, j + 1].clone()
                denom = torch.sqrt(a_ * a_ + b_ * b_)
                c_ = torch.where(denom == 0, torch.ones_like(a_), _safe_div(a_, denom))
                s_ = _safe_div(b_, denom)
                cs[:, j] = c_
                sn[:, j] = s_
                hcol[:, j] = c_ * a_ + s_ * b_
                hcol[:, j + 1] = 0.0
                R[:, :, j] = hcol[:, :restart]
                gj = g[:, j].clone()
                g[:, j + 1] = -s_ * gj
                g[:, j] = c_ * gj
        with span("fgmres.backsub"):
            # back-substitution R y = g[:restart], then x + Z y
            y = b.new_zeros((bs, restart))
            for i in range(restart - 1, -1, -1):
                resid = g[:, i] - (R[:, i] * y).sum(dim=1)
                y[:, i] = _safe_div(resid, R[:, i, i])
            return x + torch.bmm(Z.transpose(1, 2), y[:, :, None])[..., 0]

    # a window's true residual, its samples' freeze and the flag read
    with span("fgmres.check"):
        rn = _norm(b - mv(x), reduce)
        it = torch.zeros(bs, dtype=torch.int64, device=b.device)
        active = (rn > thresh) & (it < maxiter)
        running = bool(active.any())
    while running:
        x_new = restart_cycle(x)
        with span("fgmres.check"):
            rn_new = _norm(b - mv(x_new), reduce)
            x = torch.where(active[:, None], x_new, x)
            rn = torch.where(active, rn_new, rn)
            it = torch.where(active, it + restart, it)
            active = (rn > thresh) & (it < maxiter)
            running = bool(active.any())
    return KrylovResult(x, it, rn)


def gmres(matvec, b, x0=None, *, restart=20, maxiter=40, atol=1e-5, tol=1e-5):
    """Plain restarted GMRES (unpreconditioned FGMRES)."""
    return fgmres(matvec, b, x0, precond=None, restart=restart, maxiter=maxiter,
                  atol=atol, tol=tol)


def lgmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 20,
    n_aug: int = 3,
    maxiter: int = 100,
    atol: float = 1e-8,
    tol: float = 1e-8,
) -> KrylovResult:
    """LGMRES: restarted GMRES whose cycles start from a minimal-residual
    update over the `n_aug` most recent (normalized) corrections, then run
    one FGMRES window.  A cycle adds `restart` to the iteration count."""
    x = torch.zeros_like(b) if x0 is None else x0
    bs, n = b.shape
    dtype = b.dtype
    eps, tiny = torch.finfo(dtype).eps, torch.finfo(dtype).tiny
    thresh = torch.clamp(tol * _norm(b), min=atol)
    eye = torch.eye(n_aug, dtype=dtype, device=b.device)

    def body(s):
        x, Z = s["x"], s["Z"]
        r = b - matvec(x)
        # minimal-residual projection over the stored corrections
        AZ = torch.stack([matvec(Z[:, j].contiguous()) for j in range(n_aug)], dim=1)
        G = AZ @ AZ.transpose(1, 2) + eye * eps
        Lg, _ = torch.linalg.cholesky_ex(G)
        y = torch.cholesky_solve(torch.bmm(AZ, r[:, :, None]), Lg)
        x = x + torch.bmm(Z.transpose(1, 2), y)[..., 0]
        xn = fgmres(matvec, b, x, restart=restart, maxiter=restart, atol=0.0, tol=0.0).x
        dx = xn - x
        nrm = torch.clamp(_norm(dx), min=tiny)
        Z = torch.cat([(dx / nrm[:, None])[:, None], Z[:, :-1]], dim=1)
        return {"x": xn, "Z": Z, "it": s["it"] + restart, "rn": _norm(b - matvec(xn))}

    state = {"x": x, "Z": b.new_zeros((bs, n_aug, n)),
             "it": torch.zeros(bs, dtype=torch.int64, device=b.device),
             "rn": _norm(b - matvec(x))}
    state = _while_masked(lambda s: (s["rn"] > thresh) & (s["it"] < maxiter), body, state,
                          maxiter, step=restart)
    return KrylovResult(state["x"], state["it"], state["rn"])


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond: Optional[Callable] = None,
    maxiter: int = 100,
    tol: float = 1e-6,
    atol: float = 0.0,
) -> KrylovResult:
    """Preconditioned conjugate gradients on an SPD operator; rnorm is the
    recurrence's residual norm."""
    precond = precond or (lambda v: v)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    tiny = torch.finfo(b.dtype).tiny
    thresh = torch.clamp(tol * _norm(b), min=atol)

    def body(s):
        x, r, p, rz = s["x"], s["r"], s["p"], s["rz"]
        Ap = matvec(p)
        # curvature guard: near-null p can round p^T A p to <= 0; freeze the
        # update instead of dividing by ~0
        pAp = _dot(p, Ap)
        alpha = torch.where(pAp > tiny, rz / torch.clamp(pAp, min=tiny), torch.zeros_like(pAp))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Ap
        z = precond(r)
        rz_new = _dot(r, z)
        beta = torch.where(rz > tiny, rz_new / torch.clamp(rz, min=tiny), torch.zeros_like(rz))
        p = z + beta[:, None] * p
        return {"x": x, "r": r, "p": p, "rz": rz_new, "it": s["it"] + 1}

    state = {"x": x, "r": r, "p": z, "rz": _dot(r, z),
             "it": torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)}
    state = _while_masked(lambda s: (_norm(s["r"]) > thresh) & (s["it"] < maxiter), body,
                          state, maxiter)
    return KrylovResult(state["x"], state["it"], _norm(state["r"]))


def minres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    maxiter: int = 200,
    tol: float = 1e-6,
    atol: float = 0.0,
) -> KrylovResult:
    """MINRES for symmetric (possibly indefinite) systems: Lanczos with the
    implicit QR recurrences; rnorm is the recurrence's |phibar|."""
    x = torch.zeros_like(b) if x0 is None else x0
    r1 = b - matvec(x)
    beta = _norm(r1)
    thresh = torch.clamp(tol * torch.clamp(beta, min=1e-30), min=atol)
    zero = torch.zeros_like(beta)

    def body(s):
        v = _safe_div(s["r2"], s["beta"][:, None])
        y = matvec(v)
        y = torch.where((s["it"] > 0)[:, None],
                        y - _safe_div(s["beta"], s["beta_prev"])[:, None] * s["r1"], y)
        alfa = _dot(v, y)
        y = y - _safe_div(alfa, s["beta"])[:, None] * s["r2"]
        beta_new = _norm(y)
        cs, sn, dbar = s["cs"], s["sn"], s["dbar"]
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        gamma = torch.clamp(torch.sqrt(gbar * gbar + beta_new * beta_new), min=1e-30)
        cs_new = gbar / gamma
        sn_new = beta_new / gamma
        w = _safe_div(v - s["eps"][:, None] * s["w0"] - delta[:, None] * s["w1"], gamma[:, None])
        return {
            "x": s["x"] + (cs_new * s["phibar"])[:, None] * w,
            "r1": s["r2"], "r2": y, "w0": s["w1"], "w1": w,
            "beta": beta_new, "beta_prev": s["beta"],
            "phibar": sn_new * s["phibar"], "cs": cs_new, "sn": sn_new,
            "dbar": -cs * beta_new, "eps": sn * beta_new, "it": s["it"] + 1,
        }

    state = {
        "x": x, "r1": torch.zeros_like(b), "r2": r1, "w0": torch.zeros_like(b),
        "w1": torch.zeros_like(b), "beta": beta, "beta_prev": zero, "phibar": beta,
        "cs": torch.full_like(beta, -1.0), "sn": zero, "dbar": zero, "eps": zero,
        "it": torch.zeros(b.shape[0], dtype=torch.int64, device=b.device),
    }
    state = _while_masked(lambda s: (s["phibar"].abs() > thresh) & (s["it"] < maxiter),
                          body, state, maxiter)
    return KrylovResult(state["x"], state["it"], state["phibar"].abs())


def cg_normal(system_matvec: Callable, system_rmatvec: Callable, b: torch.Tensor,
              **kw) -> KrylovResult:
    """CG on the normal equations A^T A x = b as the matvec chain
    A^T (A x)."""
    return cg(lambda x: system_rmatvec(system_matvec(x)), b, **kw)


def cg_block(
    matvec_b: Callable,
    b: torch.Tensor,
    *,
    tol: float = 1e-12,
    maxiter: int = 100,
    atol: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched CG with per-sample 0/1 continue masks: every sample runs the
    full fixed loop of `maxiter` iterations, converged or degenerate ones
    (||b|| <= 1e-9) frozen by the mask; unpreconditioned.  Returns (x, the
    final per-sample residual norms)."""
    b_norm = _norm(b)
    cont = (b_norm > 1e-9).to(b.dtype)
    athr = tol * b_norm if atol is None else torch.clamp(tol * b_norm, min=atol)
    tiny = torch.finfo(b.dtype).tiny
    x = torch.zeros_like(b)
    r = b - matvec_b(x)
    p = torch.zeros_like(b)
    rho = torch.zeros_like(b_norm)
    for i in range(maxiter):
        z = r
        rho_new = _dot(r, z)
        beta = torch.where(rho > tiny, rho_new / torch.clamp(rho, min=tiny),
                           torch.zeros_like(rho))
        p = z if i == 0 else z + beta[:, None] * p
        q = matvec_b(p)
        pq = _dot(p, q)
        alpha = torch.where(pq > tiny, rho_new / torch.clamp(pq, min=tiny),
                            torch.zeros_like(pq)) * cont
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * q
        cont = cont * (_norm(r) > athr).to(b.dtype)
        rho = rho_new
    return x, _norm(r)
